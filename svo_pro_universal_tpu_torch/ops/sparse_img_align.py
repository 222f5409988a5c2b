"""Sparse image alignment: frame-to-frame pose by direct photometric GN.

Counterpart of ``svo_pro_universal_tpu/ops/sparse_img_align.py`` (reference
SparseImgAlign, src/svo_img_align/src/sparse_img_align.cpp:34-545). The
optimized state is the body relative pose ``T_icur_iref`` plus affine
illumination (alpha, beta); the residual per patch pixel is
``I_cur·(1+alpha) + beta − I_ref``; template patches and the 8-dof
inverse-compositional Jacobian are cached once per pyramid level;
coarse-to-fine over levels.

Each evaluate goes through ``cuda_align.fused_evaluate`` (CUDA kernel 3 on
the card, its plain version on the CPU). The LM keep-best loop is the JAX
``lax.while_loop`` run for the fixed ``max_iter`` with a ``done`` mask that
freezes the state, so it needs no host read per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops import cuda_align
from svo_pro_universal_tpu_torch.ops import tiles as tl
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, quat_to_matrix, se3_exp, se3_log, skew)

CUR_TILE = 24     # per-feature current-image tile (patch 4 + ~±9px margin)
REF_TILE = 12     # reference patch-with-border tile


class SparseImgAlignOptions(NamedTuple):
    max_level: int = 4
    min_level: int = 2
    patch_size: int = 4
    max_iter: int = 10
    estimate_alpha: bool = False
    estimate_beta: bool = False
    use_distortion_jacobian: bool = False
    min_update_squared: float = 1e-10
    prior_lambda_rot: float = 0.0
    prior_lambda_trans: float = 0.0


class CameraInput(NamedTuple):
    """Per-camera alignment inputs (mono = a 1-element list of these)."""
    pyr_ref: torch.Tensor     # padded [L, H, W] ref pyramid
    pyr_cur: torch.Tensor     # padded [L, H, W] cur pyramid
    px_ref: torch.Tensor      # [N, 2] feature px (level 0)
    f_ref: torch.Tensor       # [N, 3] unit bearings
    depth_ref: torch.Tensor   # [N] distance along bearing (norm, not z)
    valid: torch.Tensor       # [N] bool
    T_cam_body: SE3
    cam: proj.Camera


class AlignState(NamedTuple):
    T_icur_iref: SE3
    alpha: torch.Tensor
    beta: torch.Tensor


class AlignStats(NamedTuple):
    chi2: torch.Tensor
    n_tracked: torch.Tensor
    n_iter_total: torch.Tensor


def precompute_base(inp: CameraInput, use_distortion_jacobian: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(xyz_ref [N,3], J_proj [N,2,6]): projection Jacobian w.r.t. the body
    twist in the reference frame (reference :265-318)."""
    xyz_ref = inp.f_ref * inp.depth_ref[:, None]
    p_imu = inp.T_cam_body.inverse().apply(xyz_ref)
    eye = torch.eye(3, dtype=xyz_ref.dtype, device=xyz_ref.device).expand(
        p_imu.shape[:-1] + (3, 3))
    G = torch.cat([eye, -skew(p_imu)], dim=-1)              # [N, 3, 6]
    R_cam_imu = quat_to_matrix(inp.T_cam_body.q)
    RG = torch.einsum("ij,njk->nik", R_cam_imu, G)
    if use_distortion_jacobian or \
            inp.cam.projection != proj.ProjectionModel.PINHOLE:
        J_cam = proj.project_jacobian(inp.cam, xyz_ref)
        J = -torch.einsum("nij,njk->nik", J_cam, RG)
    else:
        x, y, z = xyz_ref[:, 0], xyz_ref[:, 1], xyz_ref[:, 2]
        zi = 1.0 / torch.where(torch.abs(z) > 1e-8, z, 1e-8)
        one = torch.ones_like(zi)
        zero = torch.zeros_like(zi)
        J_up = torch.stack([
            torch.stack([one, zero, -x * zi], -1),
            torch.stack([zero, one, -y * zi], -1)], dim=-2)
        J = -(zi * inp.cam.focal_length)[:, None, None] * torch.einsum(
            "nij,njk->nik", J_up, RG)
    return xyz_ref, J


def precompute_level(inp: CameraInput, level: int, patch_size: int,
                     J_proj: torch.Tensor, estimate_alpha: bool,
                     estimate_beta: bool
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Template patches + 8-dof per-pixel Jacobian for one level (reference
    :320-403). Returns (ref_patch [N,P²], jac [N,P²,8], ok_ref [N])."""
    n = inp.px_ref.shape[0]
    dev, dt = inp.px_ref.device, inp.px_ref.dtype
    scale = 1.0 / (1 << level)
    pwb = patch_size + 2
    offs = torch.arange(pwb, dtype=dt, device=dev) - (pwb - 1) / 2.0
    ov, ou = torch.meshgrid(offs, offs, indexing="ij")
    center = inp.px_ref * scale
    uv = center[:, None, None, :] + torch.stack([ou, ov], -1)[None]
    lvl = torch.full((n,), level, dtype=torch.long, device=dev)
    tb = tl.extract_tiles(inp.pyr_ref, lvl,
                          torch.stack([center[:, 1], center[:, 0]], -1),
                          REF_TILE, REF_TILE)
    flat = uv.reshape(n, pwb * pwb, 2)
    vals, inb = tl.tile_bilinear(tb, flat[..., 1], flat[..., 0])
    patch_wb = vals.reshape(n, pwb, pwb)
    ok = torch.all(inb, dim=-1)
    area = patch_size * patch_size
    val = patch_wb[:, 1:-1, 1:-1].reshape(n, area)
    dx = (0.5 * (patch_wb[:, 1:-1, 2:] - patch_wb[:, 1:-1, :-2])).reshape(
        n, area)
    dy = (0.5 * (patch_wb[:, 2:, 1:-1] - patch_wb[:, :-2, 1:-1])).reshape(
        n, area)
    Jp = (dx[..., None] * J_proj[:, None, 0, :]
          + dy[..., None] * J_proj[:, None, 1, :]) * scale
    Ja = (-val if estimate_alpha else torch.zeros_like(val))[..., None]
    Jb = (torch.full_like(val, -1.0) if estimate_beta
          else torch.zeros_like(val))[..., None]
    return val, torch.cat([Jp, Ja, Jb], dim=-1), ok


def extract_cur_tiles(inp: CameraInput, xyz_ref: torch.Tensor,
                      T_cur_ref: SE3, level: int) -> tl.TileBatch:
    """Per-level tile cache around the projected feature positions."""
    n = xyz_ref.shape[0]
    scale = 1.0 / (1 << level)
    uv_cur, _ = proj.project(inp.cam, T_cur_ref.apply(xyz_ref))
    c = uv_cur * scale
    lvl = torch.full((n,), level, dtype=torch.long, device=xyz_ref.device)
    return tl.extract_tiles(inp.pyr_cur, lvl,
                            torch.stack([c[:, 1], c[:, 0]], -1),
                            CUR_TILE, CUR_TILE)


def compute_residuals(inp: CameraInput, tb: tl.TileBatch,
                      xyz_ref: torch.Tensor, ref_patch: torch.Tensor,
                      T_cur_ref: SE3, alpha, beta, level: int,
                      patch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(res [N,P²], visible [N]) sampled inside the level's tile cache
    (reference computeResidualsOfFrame :405-498) — the unfused evaluate,
    kept as the second reference for kernel 3."""
    scale = 1.0 / (1 << level)
    xyz_cur = T_cur_ref.apply(xyz_ref)
    uv_cur, _ = proj.project(inp.cam, xyz_cur)
    offs = (torch.arange(patch_size, dtype=uv_cur.dtype,
                         device=uv_cur.device) - (patch_size - 1) / 2.0)
    ov, ou = torch.meshgrid(offs, offs, indexing="ij")
    pos = (uv_cur[:, None, :] * scale
           + torch.stack([ou.reshape(-1), ov.reshape(-1)], -1)[None])
    cur, inb = tl.tile_bilinear(tb, pos[..., 1], pos[..., 0])
    visible = torch.all(inb, dim=-1) & (xyz_cur[:, 2] > 0.0)
    return cur * (1.0 + alpha) + beta - ref_patch, visible


def _state_update(state: AlignState, dx: torch.Tensor) -> AlignState:
    """Reference update rule (sparse_img_align_base.cpp:64-75)."""
    T = state.T_icur_iref.compose(se3_exp(-dx[:6])).normalized()
    denom = 1.0 + dx[6]
    return AlignState(T, (state.alpha - dx[6]) / denom,
                      (state.beta - dx[7]) / denom)


def _select(cond: torch.Tensor, a: AlignState, b: AlignState) -> AlignState:
    return AlignState(a.T_icur_iref.where(cond, b.T_icur_iref),
                      torch.where(cond, a.alpha, b.alpha),
                      torch.where(cond, a.beta, b.beta))


def evaluate_camera(inp: CameraInput, cache, st: AlignState, level: int,
                    P: int):
    """One camera's normal system at state ``st`` through the fused
    evaluate (CUDA kernel 3 on the card). ``cache`` is (xyz_ref, ref_patch,
    jac, ok, cur TileBatch) of the level. Returns (H, g, chi2, n_visible)
    before the fixed-parameter, normalization and prior terms."""
    xyz_ref, ref_patch, jac, ok, tb = cache
    f32 = torch.float32
    scale = 1.0 / (1 << level)
    T_cur_ref = (inp.T_cam_body.compose(st.T_icur_iref)
                 .compose(inp.T_cam_body.inverse()))
    xyz_cur = T_cur_ref.apply(xyz_ref)
    uv_cur, _ = proj.project(inp.cam, xyz_cur)
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
    ab = torch.stack([st.alpha, st.beta]).to(f32)
    return cuda_align.fused_evaluate(tb.tiles, ty, tx, (vis & ok).to(f32),
                                     ref_patch, jac, ab, P)


def run(inputs: Sequence[CameraInput], state0: AlignState,
        opts: SparseImgAlignOptions, T_prior: SE3 | None = None,
        ) -> tuple[AlignState, AlignStats]:
    """Coarse-to-fine sparse image alignment over all cameras, with the
    optional prior on T_icur_iref weighted by prior_lambda_{rot,trans} × the
    max H diagonal (reference applyPrior :77-110)."""
    dev = inputs[0].px_ref.device
    f32 = torch.float32
    pre = [precompute_base(inp, opts.use_distortion_jacobian)
           for inp in inputs]
    state = state0
    total_iters = torch.zeros((), dtype=torch.long, device=dev)
    chi2 = torch.zeros((), dtype=f32, device=dev)
    n_tracked = torch.zeros((), dtype=torch.long, device=dev)
    P = opts.patch_size
    i8 = torch.arange(8, device=dev)      # built on the device: no copy
    fixed = (((i8 == 6) & (not opts.estimate_alpha))
             | ((i8 == 7) & (not opts.estimate_beta)))
    use_prior = T_prior is not None and (opts.prior_lambda_rot > 0
                                         or opts.prior_lambda_trans > 0)

    for level in range(opts.max_level, opts.min_level - 1, -1):
        caches = []
        for inp, (xyz_ref, J_proj) in zip(inputs, pre):
            ref_patch, jac, ok = precompute_level(
                inp, level, P, J_proj, opts.estimate_alpha,
                opts.estimate_beta)
            T_cur_ref0 = (inp.T_cam_body.compose(state.T_icur_iref)
                          .compose(inp.T_cam_body.inverse()))
            tb = extract_cur_tiles(inp, xyz_ref, T_cur_ref0, level)
            caches.append((xyz_ref, ref_patch, jac, ok & inp.valid, tb))

        def evaluate(st: AlignState):
            H = torch.zeros((8, 8), dtype=f32, device=dev)
            g = torch.zeros((8,), dtype=f32, device=dev)
            c2 = torch.zeros((), dtype=f32, device=dev)
            nm = torch.zeros((), dtype=torch.long, device=dev)
            for inp, cache in zip(inputs, caches):
                Hc, gc, c2c, nmc = evaluate_camera(inp, cache, st, level, P)
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
        for _ in range(opts.max_iter):
            active = ~done
            diag = torch.diagonal(H)
            Hd = H + torch.diag(mu * diag + 1e-8)
            dx = tl.solve_psd_small(Hd, g, damping=0.0)
            dx = torch.where(torch.isfinite(dx), dx, 0.0)
            cand = _state_update(st, dx)
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
            total_iters = total_iters + active.long()
            done = done | (torch.sum(dx[:6] ** 2) < opts.min_update_squared)
        state = best_st
        chi2 = best_chi2
    return state, AlignStats(chi2, n_tracked, total_iters)


def make_state(T_icur_iref: SE3 | None = None, device=None) -> AlignState:
    if T_icur_iref is None:
        T_icur_iref = SE3.identity(device=device)
    z = torch.zeros((), dtype=torch.float32, device=T_icur_iref.q.device)
    return AlignState(T_icur_iref, z, z.clone())
