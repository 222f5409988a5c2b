"""Sparse-alignment kernels (CUDA, ``csrc/align.cu``) with their plain
versions.

- ``fused_evaluate`` — one Gauss-Newton evaluate: counterpart of
  ``svo_pro_universal_tpu/ops/pallas_align.py`` (``fused_evaluate``
  :126-179, kernel :47-123).
- ``align_level`` — one pyramid level of sparse image alignment, the whole
  LM keep-best loop in one cluster launch: the redesign of the fused
  evaluate for the card, which replaces the JAX ``lax.while_loop`` around
  it (``svo_pro_universal_tpu/ops/sparse_img_align.py:341-376``). Its plain
  version ``align_level_plain`` is that loop in tensor ops, evaluating
  through ``fused_evaluate_plain``.

The source header notes what bounds each kernel on Hopper and how the
reductions stay deterministic. Dispatch: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops import _cuda
from svo_pro_universal_tpu_torch.ops import tiles as tl
from svo_pro_universal_tpu_torch.utils.transform import SE3, se3_exp, se3_log

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float

FUSED_EVALUATE = _cuda.register(_cuda.Kernel(
    "fused_evaluate", "align.cu", "svo_fused_evaluate",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "svo_pro_universal_tpu/ops/pallas_align.py:126"))

ALIGN_LEVEL = _cuda.register(_cuda.Kernel(
    "align_level", "align.cu", "svo_align_level",
    [_P] * 14 + [_I] * 6 + [_U, _I, _I, _F, _F, _F, _P],
    "svo_pro_universal_tpu/ops/pallas_align.py:126"))

_FEAT_PER_BLOCK = 8
_N_OUT = 74
_MAX_CAMS = 8


class AlignState(NamedTuple):
    T_icur_iref: SE3
    alpha: torch.Tensor
    beta: torch.Tensor


class LevelCamera(NamedTuple):
    """One camera's inputs to one pyramid level of sparse alignment."""
    cam: proj.Camera
    T_cam_body: SE3
    xyz_ref: torch.Tensor     # [N, 3] reference points
    ref_patch: torch.Tensor   # [N, P²] templates
    jac: torch.Tensor         # [N, P², 8] inverse-compositional Jacobian
    ok: torch.Tensor          # [N] bool: template ok and feature valid
    tb: tl.TileBatch          # the level's cur tiles


def fused_evaluate_plain(tiles: torch.Tensor, ty: torch.Tensor,
                         tx: torch.Tensor, weight: torch.Tensor,
                         ref_patch: torch.Tensor, jac: torch.Tensor,
                         ab: torch.Tensor, patch_size: int = 4):
    """The Pallas kernel's arithmetic in tensor ops: the patch is sampled
    with one-hot row/column weight matrices (a tap outside the tile matches
    no row or column and contributes nothing), then
    H = Σ w·JᵀJ, g = −Σ w·Jᵀr, chi2 = Σ w·r², n = Σ w."""
    n, R, T = tiles.shape
    P = patch_size
    dev = tiles.device
    alpha, beta = ab[0], ab[1]
    y0f = torch.floor(ty)
    x0f = torch.floor(tx)
    fy = (ty - y0f)[:, None, None]
    fx = (tx - x0f)[:, None, None]
    ip = torch.arange(P, device=dev)[None, :, None]
    dr = (torch.arange(R, device=dev)[None, None, :]
          - y0f.long()[:, None, None] - ip)
    RowW = (torch.where(dr == 0, 1.0 - fy, 0.0)
            + torch.where(dr == 1, fy, 0.0))                   # [N, P, R]
    dc = (torch.arange(T, device=dev)[None, None, :]
          - x0f.long()[:, None, None] - ip)
    ColW = (torch.where(dc == 0, 1.0 - fx, 0.0)
            + torch.where(dc == 1, fx, 0.0))                   # [N, P, T]
    tmp = torch.bmm(RowW, tiles)                               # [N, P, T]
    cur = torch.bmm(tmp, ColW.transpose(1, 2)).reshape(n, P * P)
    res = cur * (1.0 + alpha) + beta - ref_patch
    w = weight[:, None]
    Jw = jac * w[..., None]
    H = torch.einsum("npi,npj->ij", Jw, jac)
    g = -torch.einsum("npi,np->i", Jw, res)
    chi2 = torch.sum(res * w * res)
    return H, g, chi2, torch.sum(weight)


def fused_evaluate(tiles: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor,
                   weight: torch.Tensor, ref_patch: torch.Tensor,
                   jac: torch.Tensor, ab: torch.Tensor, patch_size: int = 4):
    """One evaluate over all features.

    tiles [N, R, T] f32; ty, tx [N] tile-local coords of patch pixel (0,0);
    weight [N] 0/1; ref_patch [N, P²]; jac [N, P², 8]; ab [2] = (α, β) on
    the tiles' device. Returns (H [8,8], g [8], chi2, n_visible) tensors.
    """
    n, R, T = tiles.shape
    P = patch_size
    area = P * P
    if (ty.shape != (n,) or tx.shape != (n,) or weight.shape != (n,)
            or ref_patch.shape != (n, area) or jac.shape != (n, area, 8)
            or ab.shape != (2,)):
        raise ValueError("fused_evaluate: inconsistent shapes")
    if tiles.device.type == "cpu":
        return fused_evaluate_plain(tiles, ty, tx, weight, ref_patch, jac,
                                    ab, P)
    if tiles.device.type != "cuda":
        raise ValueError(f"fused_evaluate: unsupported device {tiles.device}")
    if area > 64:
        raise ValueError(f"fused_evaluate: patch_size {P} > 8")
    args = [t.to(torch.float32).contiguous()
            for t in (tiles, ty, tx, weight, ref_patch, jac, ab)]
    _cuda.check_cuda("fused_evaluate", *args)
    nblocks = -(-n // _FEAT_PER_BLOCK)
    partials = torch.empty((max(nblocks, 1), _N_OUT), dtype=torch.float32,
                           device=tiles.device)
    out = torch.empty((_N_OUT,), dtype=torch.float32, device=tiles.device)
    Pt = _cuda.ptr
    FUSED_EVALUATE.launch(*[Pt(a) for a in args], Pt(partials), Pt(out),
                          n, R, T, P)
    return out[:64].view(8, 8), out[64:72], out[72], out[73]


# ---------------------------------------------------------------------------
# one pyramid level of the LM keep-best loop
# ---------------------------------------------------------------------------

def patch_origins(lc: LevelCamera, T_icur_iref: SE3, level: int, P: int):
    """(ty, tx, weight) of each feature at the state: the tile-local origin
    of its patch pixel (0, 0), and 1 where the patch lies inside its tile
    and level, the point is in front of the camera and ``ok``, else 0."""
    tb = lc.tb
    f32 = torch.float32
    scale = 1.0 / (1 << level)
    T_cur_ref = (lc.T_cam_body.compose(T_icur_iref)
                 .compose(lc.T_cam_body.inverse()))
    xyz_cur = T_cur_ref.apply(lc.xyz_ref)
    uv_cur, _ = proj.project(lc.cam, xyz_cur)
    cpy = (P - 1) / 2.0
    ys0 = uv_cur[:, 1] * scale - cpy       # patch pixel (0, 0)
    xs0 = uv_cur[:, 0] * scale - cpy
    ty = ys0 - tb.y0.to(f32)
    tx = xs0 - tb.x0.to(f32)
    R, T = tb.shape_rt
    eps = 1e-6
    lh = (tb.lh - 1).to(f32) - eps
    lw = (tb.lw - 1).to(f32) - eps
    vis = ((ty >= 0) & (ty + (P - 1) <= R - 1 + eps)
           & (tx >= 0) & (tx + (P - 1) <= T - 1 + eps)
           & (ys0 >= 0) & (ys0 + (P - 1) <= lh)
           & (xs0 >= 0) & (xs0 + (P - 1) <= lw)
           & (xyz_cur[:, 2] > 0.0))
    return ty, tx, (vis & lc.ok).to(f32)


def state_update(state: AlignState, dx: torch.Tensor) -> AlignState:
    """Reference update rule (sparse_img_align_base.cpp:64-75)."""
    T = state.T_icur_iref.compose(se3_exp(-dx[:6])).normalized()
    denom = 1.0 + dx[6]
    return AlignState(T, (state.alpha - dx[6]) / denom,
                      (state.beta - dx[7]) / denom)


def _select(cond: torch.Tensor, a: AlignState, b: AlignState) -> AlignState:
    return AlignState(a.T_icur_iref.where(cond, b.T_icur_iref),
                      torch.where(cond, a.alpha, b.alpha),
                      torch.where(cond, a.beta, b.beta))


def _uses_prior(opts, T_prior: SE3 | None) -> bool:
    return T_prior is not None and (opts.prior_lambda_rot > 0
                                    or opts.prior_lambda_trans > 0)


def align_level_plain(cams: Sequence[LevelCamera], state: AlignState, opts,
                      level: int, T_prior: SE3 | None = None):
    """The LM keep-best loop of one level in tensor ops: the JAX
    ``lax.while_loop`` run for the fixed ``max_iter`` with a ``done`` mask
    that freezes the state, so it needs no host read per iteration.
    ``opts`` is a ``SparseImgAlignOptions``. Returns (best state, best chi2,
    n_tracked of the initial evaluate, iterations run)."""
    dev = cams[0].xyz_ref.device
    f32 = torch.float32
    P = opts.patch_size
    i8 = torch.arange(8, device=dev)      # built on the device: no copy
    fixed = (((i8 == 6) & (not opts.estimate_alpha))
             | ((i8 == 7) & (not opts.estimate_beta)))
    use_prior = _uses_prior(opts, T_prior)

    def evaluate(st: AlignState):
        H = torch.zeros((8, 8), dtype=f32, device=dev)
        g = torch.zeros((8,), dtype=f32, device=dev)
        c2 = torch.zeros((), dtype=f32, device=dev)
        nm = torch.zeros((), dtype=torch.long, device=dev)
        ab = torch.stack([st.alpha, st.beta]).to(f32)
        for lc in cams:
            ty, tx, w = patch_origins(lc, st.T_icur_iref, level, P)
            Hc, gc, c2c, nmc = fused_evaluate_plain(
                lc.tb.tiles, ty, tx, w, lc.ref_patch, lc.jac, ab, P)
            H = H + Hc
            g = g + gc
            c2 = c2 + c2c
            nm = nm + nmc.long()
        # parameters not estimated: H[i, i] = 1 and g[i] = 0
        H = torch.where(torch.diag(fixed), 1.0, H)
        g = torch.where(fixed, 0.0, g)
        c2 = c2 / torch.clamp(nm, min=1)
        if use_prior:
            e = se3_log(st.T_icur_iref.inverse().compose(T_prior))
            d = torch.diagonal(H)
            h_t = torch.clamp(torch.max(torch.abs(d[:3])), min=1.0)
            h_r = torch.clamp(torch.max(torch.abs(d[3:6])), min=1.0)
            zero3 = torch.zeros(3, dtype=f32, device=dev)
            lam = torch.cat([
                (zero3 + opts.prior_lambda_trans) * h_t,
                (zero3 + opts.prior_lambda_rot) * h_r,
                torch.zeros(2, dtype=f32, device=dev)])
            e8 = torch.cat([e, torch.zeros(2, dtype=f32, device=dev)])
            H = H + torch.diag(lam)
            g = g - lam * e8
            c2 = c2 + torch.sum(lam * e8 * e8)
        return H, g, c2, nm

    # LM-damped GN with keep-best, ONE evaluate per iteration
    H, g, best_chi2, n_tracked = evaluate(state)
    best_st = state
    st = state
    mu = torch.full((), 0.1, dtype=f32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(opts.max_iter):
        active = ~done
        diag = torch.diagonal(H)
        Hd = H + torch.diag(mu * diag + 1e-8)
        dx = tl.solve_psd_small(Hd, g, damping=0.0)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        cand = state_update(st, dx)
        H_new, g_new, c2_new, _ = evaluate(cand)
        improved = c2_new < best_chi2
        take = active & improved
        best_st = _select(take, cand, best_st)
        best_chi2 = torch.where(take, c2_new, best_chi2)
        mu = torch.where(active, torch.where(improved, mu * 0.5,
                                             mu * 4.0), mu)
        st = _select(take, cand, st)
        H = torch.where(take, H_new, H)
        g = torch.where(take, g_new, g)
        iters = iters + active.long()
        done = done | (torch.sum(dx[:6] ** 2) < opts.min_update_squared)
    return best_st, best_chi2, n_tracked, iters


def _cat(xs: list, dtype) -> torch.Tensor:
    xs = [x.to(dtype) for x in xs]
    return (xs[0] if len(xs) == 1 else torch.cat(xs)).contiguous()


def align_level(cams: Sequence[LevelCamera], state: AlignState, opts,
                level: int, T_prior: SE3 | None = None):
    """One pyramid level of sparse alignment over 1..8 cameras (one cluster
    launch on the card). Same arguments and results as
    :func:`align_level_plain`; on the card the results are views of one
    device buffer, with no host read."""
    dev = cams[0].xyz_ref.device
    if dev.type == "cpu":
        return align_level_plain(cams, state, opts, level, T_prior)
    if dev.type != "cuda":
        raise ValueError(f"align_level: unsupported device {dev}")
    C = len(cams)
    P = opts.patch_size
    R, T = cams[0].tb.shape_rt
    if not 1 <= C <= _MAX_CAMS:
        raise ValueError(f"align_level: {C} cameras, 1..{_MAX_CAMS} taken")
    if P * P > 64:
        raise ValueError(f"align_level: patch_size {P} > 8")
    for lc in cams:
        n = lc.xyz_ref.shape[0]
        if (lc.tb.shape_rt != (R, T) or lc.tb.tiles.shape[0] != n
                or lc.ref_patch.shape != (n, P * P)
                or lc.jac.shape != (n, P * P, 8) or lc.ok.shape != (n,)
                or lc.cam.dist_params.shape != (5,)):
            raise ValueError("align_level: inconsistent shapes")
    f32, i64 = torch.float32, torch.int64
    tiles = _cat([lc.tb.tiles for lc in cams], f32)
    jac = _cat([lc.jac for lc in cams], f32)
    ref = _cat([lc.ref_patch for lc in cams], f32)
    xyz = _cat([lc.xyz_ref for lc in cams], f32)
    y0, x0, lh, lw = (_cat([getattr(lc.tb, k) for lc in cams], i64)
                      for k in ("y0", "x0", "lh", "lw"))
    ok = _cat([lc.ok for lc in cams], torch.bool).view(torch.uint8)
    cam_idx = None if C == 1 else torch.cat([
        torch.full((lc.xyz_ref.shape[0],), c, dtype=torch.int32, device=dev)
        for c, lc in enumerate(cams)])
    params = _cat([torch.cat([lc.cam.intrinsics, lc.cam.dist_params,
                              lc.T_cam_body.q, lc.T_cam_body.t])
                   for lc in cams], f32)
    models = sum((int(lc.cam.projection) | int(lc.cam.distortion) << 2)
                 << (4 * c) for c, lc in enumerate(cams))
    st = _cat([state.T_icur_iref.q, state.T_icur_iref.t,
               state.alpha.reshape(1), state.beta.reshape(1)], f32)
    use_prior = _uses_prior(opts, T_prior)
    prior = _cat([T_prior.q, T_prior.t], f32) if use_prior else st
    tensors = [tiles, jac, ref, xyz, y0, x0, lh, lw, ok, params, st, prior]
    if cam_idx is not None:
        tensors.append(cam_idx)
    _cuda.check_cuda("align_level", *tensors)
    out = torch.empty((12,), dtype=f32, device=dev)
    flags = (int(opts.estimate_alpha) | int(opts.estimate_beta) << 1
             | int(use_prior) << 2)
    Pt = _cuda.ptr
    ALIGN_LEVEL.launch(
        Pt(tiles), Pt(jac), Pt(ref), Pt(xyz), Pt(y0), Pt(x0), Pt(lh),
        Pt(lw), Pt(ok), None if cam_idx is None else Pt(cam_idx),
        Pt(params), Pt(st), Pt(prior), Pt(out), xyz.shape[0], R, T, P,
        level, C, models, opts.max_iter, flags, opts.min_update_squared,
        opts.prior_lambda_rot, opts.prior_lambda_trans)
    best = AlignState(SE3(out[0:4], out[4:7]), out[7], out[8])
    return best, out[9], out[10].long(), out[11].long()
