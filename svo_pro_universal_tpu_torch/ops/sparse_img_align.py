"""Sparse image alignment: frame-to-frame pose by direct photometric GN.

Counterpart of ``svo_pro_universal_tpu/ops/sparse_img_align.py`` (reference
SparseImgAlign, src/svo_img_align/src/sparse_img_align.cpp:34-545). The
optimized state is the body relative pose ``T_icur_iref`` plus affine
illumination (alpha, beta); the residual per patch pixel is
``I_cur·(1+alpha) + beta − I_ref``; template patches and the 8-dof
inverse-compositional Jacobian are cached once per pyramid level;
coarse-to-fine over levels.

Each pyramid level runs through ``cuda_align.align_level``: on the card one
cluster kernel runs the level's whole LM keep-best loop; on the CPU its plain
version is the JAX ``lax.while_loop`` run for the fixed ``max_iter`` with a
``done`` mask that freezes the state. Neither reads the device from the host.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops import cuda_align
from svo_pro_universal_tpu_torch.ops import tiles as tl
from svo_pro_universal_tpu_torch.ops.cuda_align import AlignState
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, quat_to_matrix, skew)

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


def evaluate_camera(inp: CameraInput, cache, st: AlignState, level: int,
                    P: int):
    """One camera's normal system at state ``st`` through the fused
    evaluate (its CUDA kernel on the card). ``cache`` is (xyz_ref,
    ref_patch, jac, ok, cur TileBatch) of the level. Returns (H, g, chi2,
    n_visible) before the fixed-parameter, normalization and prior terms.
    ``run`` evaluates inside ``cuda_align.align_level`` instead; this is
    the standalone evaluate the tests hold against the JAX one."""
    xyz_ref, ref_patch, jac, ok, tb = cache
    lc = cuda_align.LevelCamera(inp.cam, inp.T_cam_body, xyz_ref, ref_patch,
                                jac, ok, tb)
    ty, tx, w = cuda_align.patch_origins(lc, st.T_icur_iref, level, P)
    ab = torch.stack([st.alpha, st.beta]).to(torch.float32)
    return cuda_align.fused_evaluate(tb.tiles, ty, tx, w, ref_patch, jac, ab,
                                     P)


def level_cameras(inputs: Sequence[CameraInput], pre: list,
                  state: AlignState, opts: SparseImgAlignOptions,
                  level: int) -> list[cuda_align.LevelCamera]:
    """One level's inputs to ``align_level``, per camera: the templates and
    Jacobians, and the cur tiles cut around the features projected at
    ``state``. ``pre`` holds each camera's ``precompute_base``."""
    cams = []
    for inp, (xyz_ref, J_proj) in zip(inputs, pre):
        ref_patch, jac, ok = precompute_level(
            inp, level, opts.patch_size, J_proj, opts.estimate_alpha,
            opts.estimate_beta)
        T_cur_ref0 = (inp.T_cam_body.compose(state.T_icur_iref)
                      .compose(inp.T_cam_body.inverse()))
        tb = extract_cur_tiles(inp, xyz_ref, T_cur_ref0, level)
        cams.append(cuda_align.LevelCamera(
            inp.cam, inp.T_cam_body, xyz_ref, ref_patch, jac,
            ok & inp.valid, tb))
    return cams


def run(inputs: Sequence[CameraInput], state0: AlignState,
        opts: SparseImgAlignOptions, T_prior: SE3 | None = None,
        ) -> tuple[AlignState, AlignStats]:
    """Coarse-to-fine sparse image alignment over all cameras, with the
    optional prior on T_icur_iref weighted by prior_lambda_{rot,trans} × the
    max H diagonal (reference applyPrior :77-110). Each level is one
    ``cuda_align.align_level`` call: one kernel launch on the card."""
    dev = inputs[0].px_ref.device
    pre = [precompute_base(inp, opts.use_distortion_jacobian)
           for inp in inputs]
    state = state0
    total_iters = torch.zeros((), dtype=torch.long, device=dev)
    chi2 = torch.zeros((), dtype=torch.float32, device=dev)
    n_tracked = torch.zeros((), dtype=torch.long, device=dev)
    for level in range(opts.max_level, opts.min_level - 1, -1):
        cams = level_cameras(inputs, pre, state, opts, level)
        state, chi2, n_tracked, iters = cuda_align.align_level(
            cams, state, opts, level, T_prior)
        total_iters = total_iters + iters
    return state, AlignStats(chi2, n_tracked, total_iters)


def make_state(T_icur_iref: SE3 | None = None, device=None) -> AlignState:
    if T_icur_iref is None:
        T_icur_iref = SE3.identity(device=device)
    z = torch.zeros((), dtype=torch.float32, device=T_icur_iref.q.device)
    return AlignState(T_icur_iref, z, z.clone())
