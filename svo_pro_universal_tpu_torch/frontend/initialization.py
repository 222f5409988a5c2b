"""Two-view bootstrap: KLT tracks + batched RANSAC relative pose.

Counterpart of ``svo_pro_universal_tpu/frontend/initialization.py``
(reference src/svo/src/initialization.cpp — FivePointInit::addFrameBundle
:292-347, TwoPointInit :248-290, trackFeaturesAndCheckDisparity :86-120).
OpenGV's sequential RANSAC is a batched hypothesize-and-verify: K hypotheses
of the 8-point essential matrix scored against all correspondences at once,
then an LO-RANSAC polish on the consensus set.

Randomness: the JAX package draws each hypothesis' sample without
replacement with ``jax.random.choice(..., replace=False, p=p)``, which is the
Gumbel top-k trick: the indices of the ``size`` largest ``g + log p`` for
Gumbel noise ``g``. Here the noise is an INPUT ([n_hypotheses, N], from
:func:`gumbel_noise` or from JAX), so the port and the JAX package draw the
same samples from the same noise, on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_pro_universal_tpu_torch.ops.matcher import depth_from_triangulation
from svo_pro_universal_tpu_torch.utils.indexing import take0
from svo_pro_universal_tpu_torch.utils.robust import masked_median
from svo_pro_universal_tpu_torch.utils.transform import SE3, matrix_to_quat


class InitResult(NamedTuple):
    T_cur_ref: SE3               # relative pose, ‖t‖ = 1 (scale-free)
    inliers: torch.Tensor        # [N] bool
    depth_ref: torch.Tensor      # [N] triangulated depth along ref bearing
    n_inliers: torch.Tensor
    success: torch.Tensor        # bool scalar


def gumbel_noise(generator: torch.Generator, shape: tuple, device=None
                 ) -> torch.Tensor:
    """Standard Gumbel noise drawn from a CPU ``generator`` (as
    ``jax.random.gumbel``: −log(−log u), u uniform in [tiny, 1)), then
    moved to ``device``: the card and the CPU draw the same samples."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    g = -torch.log(-torch.log(u * (1.0 - tiny) + tiny))
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        return g.pin_memory().to(dev, non_blocking=True)
    return g.to(dev)


def _top_indices(keys: torch.Tensor, size: int) -> torch.Tensor:
    """Per row, the indices of the ``size`` largest keys, the lower index
    first among equal keys (``lax.top_k``)."""
    return torch.sort(keys, dim=-1, descending=True, stable=True
                      ).indices[..., :size]


def _essential_from_8pt(fr: torch.Tensor, fc: torch.Tensor) -> torch.Tensor:
    """8-point essential matrix per hypothesis. fr, fc: [H, n, 3] unit
    bearings (ref, cur). Returns E [H, 3, 3] with fcᵀ E fr = 0.

    The nullspace and the projection run in float64: at a small baseline
    the two smallest eigenvalues of AᵀA are close, and the float32
    eigenvector is off by up to ~0.6° of pose (the JAX package's float32
    eigh as much, in another direction; ROADMAP Queue 3)."""
    fr, fc = fr.double(), fc.double()
    A = torch.cat([fc[..., 0:1] * fr, fc[..., 1:2] * fr,
                   fc[..., 2:3] * fr], dim=-1)
    AtA = torch.einsum("hni,hnj->hij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    e = vecs[..., :, 0]                      # smallest eigenvalue
    E = e.reshape(e.shape[:-1] + (3, 3))
    # project onto the essential manifold: singular values (1, 1, 0)
    U, _, Vt = torch.linalg.svd(E)
    s = (torch.arange(3, device=E.device) < 2).to(E.dtype)
    return (U * s) @ Vt


def _decompose_essential(E: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """E [H,3,3] → (R [H,4,3,3], t [H,4,3]) float32: the four (R, t)
    candidates (the SVD in E's precision)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.where(torch.linalg.det(U) < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * torch.where(torch.linalg.det(Vt) < 0, -1.0,
                          1.0)[..., None, None]
    # W = [[0,-1,0],[1,0,0],[0,0,1]], built on the device
    e = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([-e[1], e[0], e[2]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    R = torch.stack([R1, R1, R2, R2], dim=-3)
    tt = torch.stack([t, -t, t, -t], dim=-2)
    return R.float(), tt.float()


def _sampson_sq(E: torch.Tensor, fr: torch.Tensor, fc: torch.Tensor
                ) -> torch.Tensor:
    """Squared Sampson distance on the unit plane. E [...,3,3], fr/fc
    [..., N, 3] (z-normalized inside)."""
    xr = fr / torch.where(torch.abs(fr[..., 2:3]) > 1e-8, fr[..., 2:3], 1e-8)
    xc = fc / torch.where(torch.abs(fc[..., 2:3]) > 1e-8, fc[..., 2:3], 1e-8)
    Ex = torch.einsum("...ij,...nj->...ni", E, xr)
    Etxc = torch.einsum("...ji,...nj->...ni", E, xc)
    num = torch.square(torch.sum(xc * Ex, dim=-1))
    den = (torch.square(Ex[..., 0]) + torch.square(Ex[..., 1])
           + torch.square(Etxc[..., 0]) + torch.square(Etxc[..., 1]))
    return num / torch.clamp(den, min=1e-12)


def _skew_stack(t: torch.Tensor) -> torch.Tensor:
    x, y, z = t.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(t.shape[:-1] + (3, 3))


def _score_pose(R: torch.Tensor, t: torch.Tensor, f_ref: torch.Tensor,
                f_cur: torch.Tensor, valid: torch.Tensor, thresh_sq
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inlier count for candidate poses [...,3,3]/[...,3] against all
    correspondences: cheirality (positive depths) + Sampson gate."""
    Rf = torch.einsum("...ij,nj->...ni", R, f_ref)
    a01 = torch.sum(Rf * f_cur, -1)
    a00 = torch.sum(Rf * Rf, -1)
    a11 = torch.sum(f_cur * f_cur, -1)
    det = a00 * a11 - a01 * a01
    b0 = torch.sum(Rf * t[..., None, :], -1)
    b1 = torch.sum(f_cur * t[..., None, :], -1)
    safe = torch.where(torch.abs(det) > 1e-9, det, 1e-9)
    d_ref = -(a11 * b0 - a01 * b1) / safe
    d_cur = -(a01 * b0 - a00 * b1) / safe
    E = _skew_stack(t) @ R
    err = _sampson_sq(E, f_ref, f_cur)
    inl = valid & (d_ref > 0) & (d_cur > 0) & (err < thresh_sq)
    return torch.sum(inl.long(), dim=-1), inl


def _log_p(valid: torch.Tensor) -> torch.Tensor:
    p = valid.to(torch.float32)
    return torch.log(p / torch.clamp(torch.sum(p), min=1.0))


def ransac_relative_pose(
    f_ref: torch.Tensor,         # [N, 3] unit bearings in ref
    f_cur: torch.Tensor,         # [N, 3] unit bearings in cur
    valid: torch.Tensor,         # [N]
    gumbel: torch.Tensor,        # [n_hypotheses, N] Gumbel noise
    focal_length,
    reproj_thresh_px: float = 2.0,
) -> InitResult:
    """Batched 8-point LO-RANSAC (replaces OpenGV CentralRelativePose
    RANSAC, initialization.cpp:292-347). Half the hypotheses draw 8
    correspondences (noise rows [:H/2]), half 16 (rows [H/2:])."""
    thresh_sq = torch.square(reproj_thresh_px / focal_length)
    keys = gumbel + _log_p(valid)
    h8 = gumbel.shape[0] // 2
    idx8 = _top_indices(keys[:h8], 8)
    idx16 = _top_indices(keys[h8:], 16)

    def best_of(idx_bank):
        E = _essential_from_8pt(f_ref[idx_bank], f_cur[idx_bank])
        R, t = _decompose_essential(E)           # [H,4,3,3], [H,4,3]
        counts, _ = _score_pose(R, t, f_ref, f_cur, valid, thresh_sq)
        flat = torch.argmax(counts.reshape(-1))
        return (take0(R.reshape(-1, 3, 3), flat), take0(t.reshape(-1, 3),
                                                        flat),
                take0(counts.reshape(-1), flat))

    R8, t8, c8 = best_of(idx8)
    R16, t16, c16 = best_of(idx16)
    take16 = c16 >= c8
    R_best = torch.where(take16, R16, R8)
    t_best = torch.where(take16, t16, t8)
    n_inl, inl = _score_pose(R_best, t_best, f_ref, f_cur, valid, thresh_sq)

    # LO-RANSAC polish with threshold annealing: re-estimate E on the
    # consensus set (zeroed rows drop out of the 9×9 normal matrix)
    for anneal in (4.0, 2.0, 1.0, 1.0):
        _, inl_gate = _score_pose(R_best, t_best, f_ref, f_cur, valid,
                                  thresh_sq * anneal)
        frz = torch.where(inl_gate[:, None], f_ref, 0.0)[None]
        fcz = torch.where(inl_gate[:, None], f_cur, 0.0)[None]
        R4, t4 = _decompose_essential(_essential_from_8pt(frz, fcz))
        counts4, _ = _score_pose(R4[0], t4[0], f_ref, f_cur, valid,
                                 thresh_sq)
        c4 = torch.argmax(counts4)
        better = take0(counts4, c4) >= n_inl
        R_best = torch.where(better, take0(R4[0], c4), R_best)
        t_best = torch.where(better, take0(t4[0], c4), t_best)
        n_inl, inl = _score_pose(R_best, t_best, f_ref, f_cur, valid,
                                 thresh_sq)

    T_cur_ref = SE3(matrix_to_quat(R_best), t_best)
    depth, tri_ok = depth_from_triangulation(T_cur_ref, f_ref, f_cur)
    return InitResult(T_cur_ref, inl & tri_ok, depth, n_inl, n_inl > 0)


def _homography_dlt(ur: torch.Tensor, uc: torch.Tensor) -> torch.Tensor:
    """DLT homography per hypothesis: ur, uc [H, K, 2] unit-plane points →
    H_cur_ref [H, 3, 3] with uc ≃ H·ur (reference vikit homography.cpp)."""
    x, y = ur[..., 0], ur[..., 1]
    xp, yp = uc[..., 0], uc[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero,
                      x * xp, y * xp, xp], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one,
                      x * yp, y * yp, yp], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                   # [H, 2K, 9]
    AtA = torch.einsum("hni,hnj->hij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    h = vecs[..., :, 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def _decompose_homography(H: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Calibrated homography H = R + t·nᵀ/d → 4 (R, t) candidates
    (Faugeras/Ma decomposition; reference vikit homography.cpp
    computeSE3fromMatches). H [...,3,3] → (R [...,4,3,3], t [...,4,3]).

    The DLT fixes H only up to sign (the eigenvector's sign is the
    solver's choice) and −H decomposes into improper rotations, so H is
    first signed to det(H) > 0, as a camera-facing plane gives; the JAX
    version decomposes whatever sign its eigh returned."""
    H = H * torch.where(torch.linalg.det(H) < 0, -1.0, 1.0)[..., None, None]
    s = torch.linalg.svdvals(H)
    Hn = H / torch.clamp(s[..., 1:2, None], min=1e-9)   # middle sv → 1
    M = Hn.transpose(-1, -2) @ Hn
    w, V = torch.linalg.eigh(M)                          # ascending
    s3, s2, s1 = w[..., 0], w[..., 1], w[..., 2]
    v1, v2, v3 = V[..., :, 2], V[..., :, 1], V[..., :, 0]
    a = torch.sqrt(torch.clamp(1.0 - s3, min=0.0))
    b = torch.sqrt(torch.clamp(s1 - 1.0, min=0.0))
    denom = torch.sqrt(torch.clamp(s1 - s3, min=1e-12))[..., None]
    u1 = (a[..., None] * v1 + b[..., None] * v3) / denom
    u2 = (a[..., None] * v1 - b[..., None] * v3) / denom

    def rt_from(u):
        n = torch.linalg.cross(v2, u, dim=-1)
        U1 = torch.stack([v2, u, n], dim=-1)
        Hv2 = torch.einsum("...ij,...j->...i", Hn, v2)
        Hu = torch.einsum("...ij,...j->...i", Hn, u)
        W1 = torch.stack([Hv2, Hu, torch.linalg.cross(Hv2, Hu, dim=-1)],
                         dim=-1)
        R = W1 @ U1.transpose(-1, -2)
        t = torch.einsum("...ij,...j->...i", Hn - R, n)
        return R, t

    Ra, ta = rt_from(u1)
    Rb, tb = rt_from(u2)
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([ta, -ta, tb, -tb], dim=-2))


def _unit_plane(f: torch.Tensor) -> torch.Tensor:
    return f[:, 0:2] / torch.where(torch.abs(f[:, 2:3]) > 1e-8, f[:, 2:3],
                                   1e-8)


def homography_relative_pose(
    f_ref: torch.Tensor, f_cur: torch.Tensor, valid: torch.Tensor,
    gumbel: torch.Tensor,        # [n_hypotheses, N] Gumbel noise
    focal_length, reproj_thresh_px: float = 2.0,
) -> InitResult:
    """Batched homography RANSAC for (near-)planar scenes, where the
    essential matrix is degenerate (reference HomographyInit +
    vikit homography.cpp); 4 correspondences per hypothesis."""
    thresh_sq = torch.square(reproj_thresh_px / focal_length)
    ur_all, uc_all = _unit_plane(f_ref), _unit_plane(f_cur)
    idx = _top_indices(gumbel + _log_p(valid), 4)
    Hm = _homography_dlt(ur_all[idx], uc_all[idx])       # [H,3,3]
    # score by transfer error on the unit plane
    num = (torch.einsum("hij,nj->hni", Hm[:, :, :2], ur_all)
           + Hm[:, None, :, 2])
    uc_pred = num[..., 0:2] / torch.where(torch.abs(num[..., 2:3]) > 1e-8,
                                          num[..., 2:3], 1e-8)
    terr = torch.sum(torch.square(uc_pred - uc_all[None]), dim=-1)
    inl_h = valid[None] & (terr < thresh_sq)
    hbest = torch.argmax(torch.sum(inl_h.long(), dim=-1))
    # refit on consensus, decompose, pick the candidate by cheirality+Sampson
    inl0 = take0(inl_h, hbest)
    urz = torch.where(inl0[:, None], ur_all, 0.0)[None]
    ucz = torch.where(inl0[:, None], uc_all, 0.0)[None]
    R4, t4 = _decompose_homography(_homography_dlt(urz, ucz)[0])
    t4 = t4 / torch.clamp(torch.linalg.norm(t4, dim=-1, keepdim=True),
                          min=1e-9)
    c4, _ = _score_pose(R4, t4, f_ref, f_cur, valid, thresh_sq)
    cb = torch.argmax(c4)
    R_best, t_best = take0(R4, cb), take0(t4, cb)
    n_inl, inl = _score_pose(R_best, t_best, f_ref, f_cur, valid, thresh_sq)
    T_cur_ref = SE3(matrix_to_quat(R_best), t_best)
    depth, tri_ok = depth_from_triangulation(T_cur_ref, f_ref, f_cur)
    return InitResult(T_cur_ref, inl & tri_ok, depth, n_inl, n_inl > 0)


def two_point_relative_pose(
    f_ref: torch.Tensor, f_cur: torch.Tensor, valid: torch.Tensor,
    R_cur_ref_prior: torch.Tensor,   # [3, 3] rotation prior (IMU gyro)
    gumbel: torch.Tensor,            # [2·n_hypotheses, N] Gumbel noise
    focal_length, reproj_thresh_px: float = 2.0,
) -> InitResult:
    """TwoPoint RANSAC with known rotation (reference TwoPointInit
    initialization.cpp:248-290): each correspondence constrains
    t ⊥ (f_cur × R·f_ref); two give t up to sign. Pairs are drawn WITH
    replacement (``jax.random.categorical``: the argmax of g + log p)."""
    n_hyp = gumbel.shape[0] // 2
    thresh_sq = torch.square(reproj_thresh_px / focal_length)
    p = valid.to(torch.float32)
    p = p / torch.clamp(torch.sum(p), min=1.0)
    logits = torch.log(torch.clamp(p, min=1e-12))
    idx = torch.argmax(gumbel + logits, dim=-1).reshape(n_hyp, 2)
    Rf = torch.einsum("ij,nj->ni", R_cur_ref_prior, f_ref)
    c = torch.linalg.cross(f_cur, Rf, dim=-1)     # [N, 3] constraint normals
    t_hyp = torch.linalg.cross(c[idx[:, 0]], c[idx[:, 1]], dim=-1)
    t_hyp = t_hyp / torch.clamp(torch.linalg.norm(t_hyp, dim=-1,
                                                  keepdim=True), min=1e-12)
    R_hyp = R_cur_ref_prior.expand(n_hyp, 3, 3)
    R2 = torch.stack([R_hyp, R_hyp], dim=1)
    t2 = torch.stack([t_hyp, -t_hyp], dim=1)
    counts, _ = _score_pose(R2, t2, f_ref, f_cur, valid, thresh_sq)
    flat = torch.argmax(counts.reshape(-1))
    R_best = take0(R2.reshape(-1, 3, 3), flat)
    t_best = take0(t2.reshape(-1, 3), flat)
    n_inl, inl = _score_pose(R_best, t_best, f_ref, f_cur, valid, thresh_sq)
    T_cur_ref = SE3(matrix_to_quat(R_best), t_best)
    depth, tri_ok = depth_from_triangulation(T_cur_ref, f_ref, f_cur)
    return InitResult(T_cur_ref, inl & tri_ok, depth, n_inl, n_inl > 0)


def disparity(px_ref: torch.Tensor, px_cur: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Median feature displacement in pixels (reference
    trackFeaturesAndCheckDisparity initialization.cpp:86-120)."""
    return masked_median(torch.linalg.norm(px_cur - px_ref, dim=-1), valid)


def rescale_to_mean_depth(T_cur_ref: SE3, depth_ref: torch.Tensor,
                          inliers: torch.Tensor, target_depth: float
                          ) -> tuple[SE3, torch.Tensor, torch.Tensor]:
    """Fix the monocular scale so the median inlier depth equals
    ``target_depth`` (reference triangulateAndInitializePoints). Returns
    (T_cur_ref scaled, depths scaled, scale)."""
    med = masked_median(depth_ref, inliers)
    scale = target_depth / torch.clamp(med, min=1e-9)
    return SE3(T_cur_ref.q, T_cur_ref.t * scale), depth_ref * scale, scale
