"""The plain reference: what the benchmark holds the port's outputs to.

Plain NumPy and PyTorch on the CPU in float64; it imports nothing of the
port and takes none of its derived tables. It reads the program's outputs
and the inputs the program was handed (the tile sources, the alignment's
inputs, the window's observations) only to judge them:

- ``sim3_align`` / ``ate``: the pose trace against the generator's
  ground-truth trajectory (Umeyama's similarity alignment);
- ``gather``: a tile gather (``extract_tiles`` / ``extract_tiles_ring``):
  the origin arithmetic and the R×T windows, exactly;
- ``align_evaluate`` / ``align_gap``: one pyramid level of sparse image
  alignment: the photometric cost at the state the kernel returns;
  ``align_keep_best``, the level's LM keep-best loop from the kernel's
  input state, and ``align_shortfall``, how far the kernel's state falls
  short of the cost that loop reaches;
- ``window_visual_chi2``: the backend window's robust reprojection cost;
  ``window_cost``: the whole cost the window solve minimises (reprojection,
  IMU preintegration factors, marginalization prior, bias and
  zero-velocity priors), at which ``solve_kept`` holds a sampled solve's
  returned window against the window its LM loop started from.

``tf32`` rounds float32 values to TF32's 10-bit mantissa: with it the
reference computes in the precision just below the configuration's
(float32 with TF32 off), which is the control that the checks must fail.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest in TF32 (10 mantissa bits)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + (1 << 12)) & ~((1 << 13) - 1)
    return b.view(torch.float32)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# trajectory
# ---------------------------------------------------------------------------

def sim3_align(est: np.ndarray, gt: np.ndarray):
    """(s, R, t) minimising |gt − (s R est + t)|² (Umeyama)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    de, dg = est - mu_e, gt - mu_g
    C = dg.T @ de / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_e = (de ** 2).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-300))
    return s, R, mu_g - s * R @ mu_e


def ate(est: np.ndarray, gt: np.ndarray) -> tuple[float, tuple]:
    """Sim3-aligned RMS position error and the alignment."""
    s, R, t = sim3_align(est, gt)
    err = gt - (s * est @ R.T + t)
    return float(np.sqrt((err ** 2).sum(-1).mean())), (s, R, t)


# ---------------------------------------------------------------------------
# tile gathers
# ---------------------------------------------------------------------------

def gather(src: torch.Tensor, args: tuple, ring: bool, rnd=_identity):
    """(tiles [N, R, T], y0, x0, lh, lw) of one gather call: tiles of R×T
    centred on (y, x) in level coordinates, the origin clipped into the
    padded source, the level (and keyframe) index clipped to its range."""
    if ring:
        kf, level, cyx, R, T = args
        K, L, H, W = src.shape
    else:
        level, cyx, R, T = args
        L, H, W = src.shape
    lv = torch.clamp(level.long(), 0, L - 1)
    lh, lw = H >> lv, W >> lv
    y0 = torch.clamp(torch.round(cyx[:, 0]).long() - R // 2, 0, H - R)
    x0 = torch.clamp(torch.round(cyx[:, 1]).long() - T // 2, 0, W - T)
    rows = y0[:, None, None] + torch.arange(R)[None, :, None]
    cols = x0[:, None, None] + torch.arange(T)[None, None, :]
    s = rnd(src)
    if ring:
        kc = torch.clamp(kf.long(), 0, K - 1)
        tiles = s[kc[:, None, None], lv[:, None, None], rows, cols]
    else:
        tiles = s[lv[:, None, None], rows, cols]
    return tiles, y0, x0, lh, lw


def gather_mismatches(sample: dict, ring: bool, rnd=_identity) -> int:
    """Values of one sampled gather (tiles and origins) that differ from
    the reference's; with ``rnd`` the reference run in that precision
    stands in the program's place (the control)."""
    src, *args = sample["args"]
    ref = gather(src, tuple(args), ring)
    got = (sample["out"] if rnd is _identity
           else gather(src, tuple(args), ring, rnd))
    n = 0
    for a, b in zip(got, ref):
        a, b = a.reshape(-1), b.reshape(-1)
        if a.shape != b.shape:
            return max(a.numel(), b.numel())
        n += int((a.to(b.dtype) != b).sum())
    return n


# ---------------------------------------------------------------------------
# sparse image alignment, one pyramid level
# ---------------------------------------------------------------------------

def _qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _qrot(q, v):
    qw, qv = q[..., :1], q[..., 1:]
    uv = torch.linalg.cross(qv.expand_as(v), v, dim=-1)
    return v + 2.0 * (qw * uv + torch.linalg.cross(qv.expand_as(v), uv,
                                                   dim=-1))


def _qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def _compose(a, b):
    """(q, t) ∘ (q, t)."""
    q = _qmul(a[0], b[0])
    return q / torch.linalg.norm(q), _qrot(a[0], b[1]) + a[1]


def _inverse(a):
    qi = _qconj(a[0])
    return qi, -_qrot(qi, a[1])


def _skew(w):
    z = torch.zeros((), dtype=w.dtype)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _exp(tw):
    """Twist [v, w] → (q, t)."""
    v, w = tw[:3], tw[3:6]
    th2 = torch.dot(w, w)
    th = torch.sqrt(th2)
    if float(th2) < 1e-16:
        q = torch.cat([torch.ones(1, dtype=tw.dtype), 0.5 * w])
        V = torch.eye(3, dtype=tw.dtype) + 0.5 * _skew(w)
    else:
        q = torch.cat([torch.cos(th / 2)[None], torch.sin(th / 2) / th * w])
        W = _skew(w)
        V = (torch.eye(3, dtype=tw.dtype) + (1 - torch.cos(th)) / th2 * W
             + (th - torch.sin(th)) / (th2 * th) * W @ W)
    return q / torch.linalg.norm(q), V @ v


def _project(intr, xyz):
    fx, fy, cx, cy = intr.unbind(0)
    z = xyz[:, 2]
    zs = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    return torch.stack([fx * xyz[:, 0] / zs + cx, fy * xyz[:, 1] / zs + cy],
                       -1)


AMBIGUOUS_PX = 1e-3
MAX_FLIPS = 6


def align_evaluate(cam: dict, q, t, alpha, beta, level: int, P: int,
                   rnd=_identity):
    """The photometric cost of one camera at the state: (H [8, 8], g [8],
    chi2, n) summed over the features whose patch lies inside tile and
    level, in front of the camera and valid. Bilinear samples of the tile
    at the projected patch, residual cur·(1+α) + β − template, the
    inverse-compositional Jacobian of the template. Also (Δchi2, Δn) of
    each feature that lies within ``AMBIGUOUS_PX`` of the visibility test's
    edge."""
    Tcb = (cam["T_cam_body"].q.to(F64), cam["T_cam_body"].t.to(F64))
    T_cur_ref = _compose(_compose(Tcb, (q, t)), _inverse(Tcb))
    xyz = _qrot(T_cur_ref[0], cam["xyz_ref"].to(F64)) + T_cur_ref[1]
    uv = _project(cam["intrinsics"].to(F64), xyz)
    scale = 1.0 / (1 << level)
    c = (P - 1) / 2.0
    ys0, xs0 = uv[:, 1] * scale - c, uv[:, 0] * scale - c
    ty, tx = ys0 - cam["y0"].to(F64), xs0 - cam["x0"].to(F64)
    tiles = rnd(cam["tiles"]).to(F64)
    n, R, T = tiles.shape
    eps = 1e-6
    lh = (cam["lh"] - 1).to(F64) - eps
    lw = (cam["lw"] - 1).to(F64) - eps
    # signed distances (px) to each edge of the visibility test: positive
    # inside; a feature within ``AMBIGUOUS_PX`` of an edge may fall either
    # way in float32
    edge = torch.stack([ty, R - 1 + eps - (ty + P - 1), tx,
                        T - 1 + eps - (tx + P - 1), ys0, lh - (ys0 + P - 1),
                        xs0, lw - (xs0 + P - 1)], -1).amin(-1)
    ok = (xyz[:, 2] > 0.0) & cam["ok"]
    vis = (edge >= 0) & ok
    ambiguous = (torch.abs(edge) < AMBIGUOUS_PX) & ok
    iy0, ix0 = torch.floor(ty), torch.floor(tx)
    fy, fx = (ty - iy0)[:, None, None], (tx - ix0)[:, None, None]
    ar = torch.arange(P)
    ry, cx_ = iy0.long()[:, None] + ar[None], ix0.long()[:, None] + ar[None]
    r0, r1 = torch.clamp(ry, 0, R - 1), torch.clamp(ry + 1, 0, R - 1)
    c0, c1 = torch.clamp(cx_, 0, T - 1), torch.clamp(cx_ + 1, 0, T - 1)
    b = torch.arange(n)[:, None, None]

    def at(r, cc):
        return tiles[b, r[:, :, None], cc[:, None, :]]
    cur = ((1 - fy) * (1 - fx) * at(r0, c0) + (1 - fy) * fx * at(r0, c1)
           + fy * (1 - fx) * at(r1, c0) + fy * fx * at(r1, c1))
    cur = rnd(cur.reshape(n, P * P).float()).to(F64)
    res = cur * (1.0 + alpha) + beta - rnd(cam["ref_patch"]).to(F64)
    w = vis.to(F64)
    jac = rnd(cam["jac"]).to(F64)
    Jw = jac * w[:, None, None]
    H = torch.einsum("npi,npj->ij", Jw, jac)
    g = -torch.einsum("npi,np->i", Jw, res)
    per = torch.sum(res * res, -1)
    chi2 = torch.sum(per * w)
    # the features whose visibility rounding may flip: (Δchi2, Δn) of each
    flips = torch.stack([torch.where(vis, -per, per)[ambiguous],
                         torch.where(vis, -1.0, 1.0)[ambiguous].to(F64)], -1)
    return H, g, chi2, torch.sum(w), flips


def _level_cost(sample: dict, q, t, alpha, beta, rnd=_identity):
    """Summed over the cameras: (H, g, normalized chi2, n)."""
    o = sample["opts"]
    P = o["patch_size"]
    H = torch.zeros((8, 8), dtype=F64)
    g = torch.zeros(8, dtype=F64)
    c2 = torch.zeros((), dtype=F64)
    nm = torch.zeros((), dtype=F64)
    flips = []
    for cam in sample["cams"]:
        h_, g_, c_, n_, f_ = align_evaluate(cam, q, t, alpha, beta,
                                            sample["level"], P, rnd)
        H, g, c2, nm = H + h_, g + g_, c2 + c_, nm + n_
        flips.append(f_)
    fixed = torch.tensor([False] * 6 + [not o["estimate_alpha"],
                                        not o["estimate_beta"]])
    H = torch.where(torch.diag(fixed), 1.0, H)
    g = torch.where(fixed, 0.0, g)
    return H, g, c2, nm, torch.cat(flips)


def _normalized(c2, nm) -> float:
    return float(c2 / torch.clamp(nm, min=1.0))


def _state(st):
    T = st.T_icur_iref
    return (T.q.to(F64), T.t.to(F64), st.alpha.to(F64).reshape(()),
            st.beta.to(F64).reshape(()))


def align_keep_best(sample: dict, rnd=_identity):
    """The level's LM keep-best loop from the sampled input state, in
    float64: (best q, t, α, β, best chi2)."""
    o = sample["opts"]
    q, t, a, b = _state(sample["state"])
    H, g, c2, nm, _ = _level_cost(sample, q, t, a, b, rnd)
    best = _normalized(c2, nm)
    best_st = st = (q, t, a, b)
    mu = 0.1
    for _ in range(o["max_iter"]):
        Hd = H + torch.diag(mu * torch.diagonal(H) + 1e-8)
        dx = torch.linalg.solve(Hd, g)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        qn, tn = _compose((st[0], st[1]), _exp(-dx[:6]))
        den = 1.0 + dx[6]
        cand = (qn, tn, (st[2] - dx[6]) / den, (st[3] - dx[7]) / den)
        H_new, g_new, c2, nm, _ = _level_cost(sample, *cand, rnd=rnd)
        c_new = _normalized(c2, nm)
        if c_new < best:
            best_st, best, st, H, g = cand, c_new, cand, H_new, g_new
            mu *= 0.5
        else:
            mu *= 4.0
        if float(torch.sum(dx[:6] ** 2)) < o["min_update_squared"]:
            break
    return best_st, best


def align_gap(sample: dict, rnd=None) -> float:
    """The relative gap between the chi2 one sampled ``align_level`` call
    reports and the reference's cost at the state it returns. With
    ``rnd`` the program's output is replaced by the reference's own
    keep-best loop run in that precision (the control)."""
    if rnd is None:
        best_st, chi2_prog, _, _ = sample["out"]
        st = _state(best_st)
        chi2_prog = float(chi2_prog)
    else:
        st, chi2_prog = align_keep_best(sample, rnd)
    _, _, c2, nm, flips = _level_cost(sample, *st)
    return min(abs(chi2_prog - c) / max(abs(c), 1e-12)
               for c in _flipped_costs(c2, nm, flips))


def _flipped_costs(c2, nm, flips) -> list[float]:
    """The normalized cost with each ambiguous feature in or out, as the
    float32 visibility test may have put it (the first ``MAX_FLIPS``)."""
    k = min(len(flips), MAX_FLIPS)
    out = []
    for mask in range(1 << k):
        pick = torch.tensor([(mask >> i) & 1 for i in range(k)], dtype=F64)
        d = (pick[:, None] * flips[:k]).sum(0)
        out.append(_normalized(c2 + d[0], nm + d[1]))
    return out


def align_shortfall(sample: dict, rnd=None) -> float:
    """How far the state one sampled ``align_level`` call returns falls
    short of the reference's keep-best loop from the same input state:
    (cost at the returned state − the loop's best) / the loop's best, the
    cost taken in float64 with the ambiguous features placed as favours
    the returned state. With ``rnd`` the returned state is the
    reference's own loop run in that precision (the control)."""
    if rnd is None:
        st = _state(sample["out"][0])
    else:
        st = align_keep_best(sample, rnd)[0]
    _, best = align_keep_best(sample)
    cost = min(_flipped_costs(*_level_cost(sample, *st)[2:]))
    return (cost - best) / max(abs(best), 1e-12)


# ---------------------------------------------------------------------------
# the backend window
# ---------------------------------------------------------------------------

def _quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def window_visual_chi2(win: dict, T_cam_body, focal: float,
                       pixel_sigma: float, huber: float, rnd=_identity
                       ) -> float:
    """Σ w·|e|² over the window's valid observations: e the unit-plane
    reprojection error of each landmark in its state's camera, w the Huber
    weight (threshold ``huber`` in units of ``pixel_sigma / focal``) over
    σ²."""
    def f(x):
        return rnd(x).to(F64)
    S, L = win["q"].shape[0], win["lm_pos"].shape[0]
    s = torch.clamp(win["obs_state"], 0, S - 1)
    lm = torch.clamp(win["obs_lm"], 0, L - 1)
    q = f(win["q"])[s]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    R_wb = _quat_to_matrix(q)
    p_b = torch.einsum("nji,nj->ni", R_wb, f(win["lm_pos"])[lm]
                       - f(win["p"])[s])
    R_cb = _quat_to_matrix(T_cam_body[0].to(F64))
    p_c = p_b @ R_cb.T + T_cam_body[1].to(F64)
    z = p_c[:, 2]
    uv = p_c[:, :2] / torch.where(torch.abs(z) > 1e-8, z, 1e-8)[:, None]
    ob = f(win["obs_f"])
    meas = ob[:, :2] / torch.where(torch.abs(ob[:, 2:3]) > 1e-8,
                                   ob[:, 2:3], 1e-8)
    e = meas - uv
    valid = (win["obs_valid"] & win["state_valid"][s] & win["lm_valid"][lm]
             & (z > 1e-6))
    sigma = pixel_sigma / focal
    ew = torch.linalg.norm(e, dim=-1) / sigma
    hub = torch.where(ew <= huber, 1.0, huber / torch.clamp(ew, min=1e-12))
    w = torch.where(valid, hub / sigma ** 2, 0.0)
    return float(torch.sum((e * e).sum(-1) * w))


def _so3_exp(phi):
    """Rotation vectors [..., 3] → unit quaternions (wxyz)."""
    th = torch.linalg.norm(phi, dim=-1, keepdim=True)
    small = th < 1e-10
    k = torch.where(small, 0.5 - th * th / 48.0,
                    torch.sin(th / 2) / torch.where(small, 1.0, th))
    return torch.cat([torch.cos(th / 2), k * phi], -1)


def _so3_log(q):
    """Unit quaternions (wxyz) → rotation vectors, the angle in [0, π]."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    v = q[..., 1:]
    s = torch.linalg.norm(v, dim=-1, keepdim=True)
    th = 2.0 * torch.atan2(s, q[..., :1])
    small = s < 1e-10
    return torch.where(small, 2.0 / q[..., :1], th / torch.where(
        small, 1.0, s)) * v


def window_cost(win: dict, T_cam_body, focal: float, opts: dict) -> float:
    """The window solve's whole cost at a window, in float64: the robust
    reprojection cost, Σ rᵀ Λ r over the valid IMU preintegration factors
    (r the rotation, velocity and position residuals corrected to first
    order for the bias change, and the bias random walks), the
    marginalization prior δᵀ H δ − 2 bᵀ δ at the window's linearization
    point (while the window holds one), and the weak bias and zero-velocity
    priors. ``win`` holds the program's ``Window`` fields; ``opts`` its
    ``BAOptions``."""
    def f(x):
        return x.to(F64)
    cost = window_visual_chi2(win, T_cam_body, focal, opts["pixel_sigma"],
                              opts["huber_reproj"])
    q = f(win["q"])
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    p, v, bg, ba = (f(win[k]) for k in ("p", "v", "bg", "ba"))
    sv = win["state_valid"]
    im = win["imu"]
    g = torch.tensor(opts["gravity"], dtype=F64)
    dt = f(im.dt)[:, None]
    dbg, dba = bg[:-1] - f(im.bias_gyr), ba[:-1] - f(im.bias_acc)

    def mv(M, x):
        return torch.einsum("nij,nj->ni", f(M), x)
    dq = _qmul(f(im.delta_q), _so3_exp(mv(im.J_q_bg, dbg)))
    r_R = _so3_log(_qmul(_qconj(dq), _qmul(_qconj(q[:-1]), q[1:])))
    R_iT = _quat_to_matrix(q[:-1]).transpose(-1, -2)
    r_v = (torch.einsum("nij,nj->ni", R_iT, v[1:] - v[:-1] - g * dt)
           - (f(im.delta_v) + mv(im.J_v_bg, dbg) + mv(im.J_v_ba, dba)))
    r_p = (torch.einsum("nij,nj->ni", R_iT, p[1:] - p[:-1] - v[:-1] * dt
                        - 0.5 * g * dt * dt)
           - (f(im.delta_p) + mv(im.J_p_bg, dbg) + mv(im.J_p_ba, dba)))
    r = torch.cat([r_R, r_v, r_p, bg[1:] - bg[:-1], ba[1:] - ba[:-1]], -1)
    r = torch.where(torch.isfinite(r), r, 0.0)
    on = win["imu_valid"] & sv[:-1] & sv[1:]
    info = f(win["imu_info"]) * on[:, None, None]
    cost += float(torch.einsum("nr,nrc,nc->", r, info, r))

    if bool(win["has_prior"]):
        q0 = f(win["q0"])
        q0 = q0 / torch.linalg.norm(q0, dim=-1, keepdim=True)
        d = torch.cat([p - f(win["p0"]), _so3_log(_qmul(_qconj(q0), q)),
                       v - f(win["v0"]), bg - f(win["bg0"]),
                       ba - f(win["ba0"])], -1).reshape(-1)
        H, b = f(win["H_prior"]), f(win["b_prior"])
        cost += float(d @ H @ d - 2.0 * b @ d)
    live = sv.to(F64)[:, None]
    cost += float(torch.sum(live * (bg * bg / opts["gyr_bias_prior_sigma"]
                                    ** 2 + ba * ba
                                    / opts["acc_bias_prior_sigma"] ** 2)))
    cost += float(torch.sum((f(win["zupt"])[:, None] * live) * v * v))
    return cost


WINDOW_FIELDS = ("q", "p", "v", "bg", "ba", "state_valid", "lm_pos",
                 "lm_valid", "obs_state", "obs_lm", "obs_f", "obs_valid",
                 "imu", "imu_info", "imu_valid", "zupt", "H_prior",
                 "b_prior", "q0", "p0", "v0", "bg0", "ba0", "has_prior")


def solve_kept(samples: list) -> float:
    """The share of its starting cost that the sampled window solves
    leave: Σ cost(returned window) / Σ cost(the window the LM loop started
    from), the cost ``window_cost``'s. A solve that returns its start
    unchanged keeps 1."""
    kept = start = 0.0
    for sm in samples:
        args = ((sm["T_cam_body"].q, sm["T_cam_body"].t),
                float(sm["focal"]), sm["opts"])
        w0 = sm["start"] if sm["start"] is not None else sm["window"]
        start += window_cost({k: getattr(w0, k) for k in WINDOW_FIELDS},
                             *args)
        kept += window_cost({k: getattr(sm["out"], k)
                             for k in WINDOW_FIELDS}, *args)
    return kept / start if start > 0 else float("inf")
