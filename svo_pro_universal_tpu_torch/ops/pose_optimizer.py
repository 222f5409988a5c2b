"""Motion-only pose refinement: robust GN on reprojection errors.

Counterpart of ``svo_pro_universal_tpu/ops/pose_optimizer.py`` (reference
PoseOptimizer, src/svo/src/pose_optimizer.cpp:40-379). The state is the body
pose ``T_body_world``, updated left-multiplicatively ``T ← exp(dx)·T``;
unit-plane errors are whitened by a MAD scale and Tukey-weighted; edgelets
contribute their 1-D along-gradient component with 2× sigma.

- ``optimize_pose_plain`` — the JAX ``lax.while_loop``
  (``svo_pro_universal_tpu/ops/pose_optimizer.py:98-183``) in tensor ops,
  run for the fixed ``max_iter`` with a ``done`` mask that freezes the state
  (no host read per iteration); any number of feature sets and the prior.
- ``pose_gn`` (``csrc/pose.cu``) — the same call in one thread block: the
  MAD scale, the whole keep-best loop and the outlier pass, with no host
  read. It replaces no Pallas kernel (the JAX loop has none); eager, the
  plain loop is ~6,000 small kernels a call. It takes what the port's
  callers pass on the card: one feature set, no engaged prior, N ≤
  ``POSE_GN_MAX_N``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops import _cuda
from svo_pro_universal_tpu_torch.ops.tiles import solve_psd_small
from svo_pro_universal_tpu_torch.utils import robust
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, quat_to_matrix, se3_exp, se3_log, skew)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

POSE_GN = _cuda.register(_cuda.Kernel(
    "pose_gn", "pose.cu", "svo_pose_gn", [_P] * 14 + [_I, _I, _F, _F, _F, _P],
    "svo_pro_universal_tpu/ops/pose_optimizer.py:98-183 (lax.while_loop)"))

# csrc/pose.cu's kMaxN: the shipped configurations hold 256 or 360 feature
# slots a frame, and loop verification passes one keyframe's slots
POSE_GN_MAX_N = 4096


class PoseOptOptions(NamedTuple):
    max_iter: int = 10
    reproj_thresh_px: float = 2.0
    prior_lambda: float = 0.0
    edgelet_sigma_factor: float = 2.0
    min_update_squared: float = 1e-10


class PoseOptFeatures(NamedTuple):
    """Per-camera observations of 3D points (landmarks or seed positions)."""
    xyz_world: torch.Tensor  # [N, 3]
    f: torch.Tensor          # [N, 3] measured unit bearings
    grad: torch.Tensor       # [N, 2] edgelet direction
    level: torch.Tensor      # [N] feature pyramid level
    is_edgelet: torch.Tensor  # [N] bool
    valid: torch.Tensor      # [N] bool
    T_cam_body: SE3
    cam: proj.Camera


class PoseOptResult(NamedTuple):
    T_body_world: SE3
    inlier: Sequence[torch.Tensor]   # per camera [N] bool
    error_before_px: torch.Tensor    # median unwhitened error (pixels)
    error_after_px: torch.Tensor
    n_inliers: torch.Tensor


def _residuals(feats: PoseOptFeatures, T_body_world: SE3):
    """Unit-plane residuals + 2×6 Jacobians w.r.t. the body twist.
    Returns (e [N,2], J [N,2,6], behind [N])."""
    xyz_imu = T_body_world.apply(feats.xyz_world)
    xyz_cam = feats.T_cam_body.apply(xyz_imu)
    z = xyz_cam[:, 2]
    zi = 1.0 / torch.where(torch.abs(z) > 1e-8, z, 1e-8)
    uv_est = xyz_cam[:, 0:2] * zi[:, None]
    uv_meas = feats.f[:, 0:2] / torch.where(
        torch.abs(feats.f[:, 2:3]) > 1e-8, feats.f[:, 2:3], 1e-8)
    e = uv_meas - uv_est
    eye = torch.eye(3, dtype=z.dtype, device=z.device).expand(
        xyz_imu.shape[:-1] + (3, 3))
    G = torch.cat([eye, -skew(xyz_imu)], dim=-1)
    R = quat_to_matrix(feats.T_cam_body.q)
    RG = torch.einsum("ij,njk->nik", R, G)
    one = torch.ones_like(zi)
    zero = torch.zeros_like(zi)
    J_up = torch.stack([
        torch.stack([one, zero, -uv_est[:, 0]], -1),
        torch.stack([zero, one, -uv_est[:, 1]], -1)], dim=-2)
    J = -zi[:, None, None] * torch.einsum("nij,njk->nik", J_up, RG)
    return e, J, z < 1e-6


def _error_norm(feats: PoseOptFeatures, e: torch.Tensor) -> torch.Tensor:
    e_edge = torch.abs(torch.sum(feats.grad * e, dim=-1))
    return torch.where(feats.is_edgelet, e_edge,
                       torch.linalg.norm(e, dim=-1))


def optimize_pose(feature_sets: Sequence[PoseOptFeatures],
                  T_body_world_init: SE3,
                  opts: PoseOptOptions = PoseOptOptions(),
                  T_prior: SE3 | None = None) -> PoseOptResult:
    """Motion-only GN (reference run:40-95): :func:`optimize_pose_plain` on
    the CPU, one ``pose_gn`` launch on the card (module docstring)."""
    dev = T_body_world_init.q.device
    if dev.type == "cpu":
        return optimize_pose_plain(feature_sets, T_body_world_init, opts,
                                   T_prior)
    if dev.type != "cuda":
        raise ValueError(f"optimize_pose: unsupported device {dev}")
    tensors = pose_gn_inputs(feature_sets, T_body_world_init, opts, T_prior)
    n = tensors[0].shape[0]
    out = torch.empty((9,), dtype=torch.float32, device=dev)
    inlier = torch.empty((n,), dtype=torch.bool, device=dev)
    n_in = torch.empty((), dtype=torch.int64, device=dev)
    Pt = _cuda.ptr
    POSE_GN.launch(*[Pt(t) for t in tensors], Pt(out), Pt(inlier), Pt(n_in),
                   n, opts.max_iter, opts.reproj_thresh_px,
                   opts.edgelet_sigma_factor, opts.min_update_squared)
    # views of the buffers the kernel fills: no host read
    return PoseOptResult(SE3(out[0:4], out[4:7]), [inlier], out[7], out[8],
                         n_in)


def pose_gn_inputs(feature_sets: Sequence[PoseOptFeatures],
                   T_body_world_init: SE3, opts: PoseOptOptions,
                   T_prior: SE3 | None = None) -> list[torch.Tensor]:
    """The tensors whose pointers ``pose_gn`` takes, in its order. Raises
    on what the kernel does not take: other than one feature set, an
    engaged prior, N outside 1..``POSE_GN_MAX_N``, another dtype or shape,
    tensors on two devices."""
    if len(feature_sets) != 1:
        raise ValueError(f"optimize_pose: {len(feature_sets)} feature sets; "
                         "the card's kernel takes one")
    if T_prior is not None and opts.prior_lambda > 0:
        raise ValueError("optimize_pose: the card's kernel takes no prior "
                         "(T_prior with prior_lambda > 0)")
    fs = feature_sets[0]
    T = T_body_world_init
    n = fs.xyz_world.shape[0]
    if not 1 <= n <= POSE_GN_MAX_N:
        raise ValueError(f"optimize_pose: {n} features; the card's kernel "
                         f"takes 1..{POSE_GN_MAX_N}")
    f32, i64, b = torch.float32, torch.int64, torch.bool
    args = [("xyz_world", fs.xyz_world, f32, (n, 3)),
            ("f", fs.f, f32, (n, 3)), ("grad", fs.grad, f32, (n, 2)),
            ("level", fs.level, i64, (n,)),
            ("is_edgelet", fs.is_edgelet, b, (n,)),
            ("valid", fs.valid, b, (n,)),
            ("T_cam_body.q", fs.T_cam_body.q, f32, (4,)),
            ("T_cam_body.t", fs.T_cam_body.t, f32, (3,)),
            ("T_body_world_init.q", T.q, f32, (4,)),
            ("T_body_world_init.t", T.t, f32, (3,)),
            ("cam.intrinsics[:2]", fs.cam.intrinsics[:2], f32, (2,))]
    for name, t, dtype, shape in args:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"optimize_pose: {name} is {t.dtype} "
                             f"{tuple(t.shape)}; the card's kernel takes "
                             f"{dtype} {shape}")
    tensors = [t.contiguous() for _, t, _, _ in args]
    _cuda.check_cuda("optimize_pose", *tensors)
    return tensors


def optimize_pose_plain(feature_sets: Sequence[PoseOptFeatures],
                        T_body_world_init: SE3,
                        opts: PoseOptOptions = PoseOptOptions(),
                        T_prior: SE3 | None = None) -> PoseOptResult:
    """Batched motion-only GN in tensor ops (reference run:40-95)."""
    focal = feature_sets[0].cam.focal_length
    dev = T_body_world_init.q.device
    f32 = torch.float32

    errs0, valid0 = [], []
    for fs in feature_sets:
        e, _, behind = _residuals(fs, T_body_world_init)
        scale = (1 << fs.level).to(e.dtype)
        errs0.append(_error_norm(fs, e) / scale)
        valid0.append(fs.valid & ~behind)
    all_err0 = torch.cat(errs0)
    all_valid0 = torch.cat(valid0)
    sigma = torch.clamp(robust.mad_scale(all_err0, all_valid0), min=1e-7)

    def evaluate(T):
        H = torch.zeros((6, 6), dtype=f32, device=dev)
        g = torch.zeros((6,), dtype=f32, device=dev)
        chi2 = torch.zeros((), dtype=f32, device=dev)
        for fs in feature_sets:
            e, J, behind = _residuals(fs, T)
            ok = fs.valid & ~behind
            scale = (1 << fs.level).to(e.dtype)
            ms = sigma * scale * torch.where(
                fs.is_edgelet, opts.edgelet_sigma_factor, 1.0)
            R = 1.0 / ms
            e_edge = torch.sum(fs.grad * e, dim=-1)[:, None]
            J_edge = torch.einsum("ni,nij->nj", fs.grad, J)[:, None, :]
            e2 = torch.where(fs.is_edgelet[:, None],
                             torch.cat([e_edge, torch.zeros_like(e_edge)],
                                       -1), e)
            J2 = torch.where(fs.is_edgelet[:, None, None],
                             torch.cat([J_edge, torch.zeros_like(J_edge)],
                                       1), J)
            ew = e2 * R[:, None]
            Jw = J2 * R[:, None, None]
            ew_norm = torch.linalg.norm(ew, dim=-1)
            w = torch.where(ok, robust.tukey_weight(ew_norm), 0.0)
            H = H + torch.einsum("nij,nik,n->jk", Jw, Jw, w)
            g = g - torch.einsum("nij,ni,n->j", Jw, ew, w)
            chi2 = chi2 + torch.sum(
                torch.where(ok, robust.tukey_rho(ew_norm), 0.0))
        if T_prior is not None and opts.prior_lambda > 0:
            e_p = se3_log(T_prior.compose(T.inverse()))
            h_max = torch.clamp(torch.max(torch.abs(torch.diagonal(H))),
                                min=1.0)
            lam = opts.prior_lambda * h_max
            H = H + lam * torch.eye(6, dtype=f32, device=dev)
            g = g + lam * e_p
            chi2 = chi2 + 0.5 * lam * torch.sum(e_p * e_p)
        return H, g, chi2

    eye6 = torch.eye(6, dtype=f32, device=dev)
    T = T_body_world_init
    best_T = T
    _, _, best_chi2 = evaluate(T)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(opts.max_iter):
        active = ~done
        H, g, _ = evaluate(T)
        dx = solve_psd_small(H + 1e-8 * eye6, g, damping=0.0)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        T_new = se3_exp(dx).compose(T).normalized()
        _, _, chi2_new = evaluate(T_new)
        take = active & (chi2_new < best_chi2)
        best_T = T_new.where(take, best_T)
        best_chi2 = torch.where(take, chi2_new, best_chi2)
        T = T_new.where(take, T)
        done = done | (torch.sum(dx * dx) < opts.min_update_squared)
    T_opt = best_T

    # outlier classification at the level-0 pixel threshold (:196-298)
    inliers, errs_after = [], []
    n_in = torch.zeros((), dtype=torch.long, device=dev)
    for fs, v0 in zip(feature_sets, valid0):
        e, _, _ = _residuals(fs, T_opt)
        err_px = _error_norm(fs, e) / (1 << fs.level).to(e.dtype) * focal
        inl = v0 & (err_px <= opts.reproj_thresh_px)
        inliers.append(inl)
        errs_after.append(err_px)
        n_in = n_in + torch.sum(inl.long())
    med_before = robust.masked_median(all_err0 * focal, all_valid0)
    med_after = robust.masked_median(torch.cat(errs_after),
                                     torch.cat(valid0))
    return PoseOptResult(T_opt, inliers, med_before, med_after, n_in)
