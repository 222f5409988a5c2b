"""Direct patch matching: epipolar-line search and landmark re-matching.

Counterpart of ``svo_pro_universal_tpu/ops/matcher.py`` (reference Matcher,
src/svo_direct/src/matcher.cpp — findMatchDirect:31-141,
findEpipolarMatchDirect:157-241, findLocalMatch:262-298,
depthFromTriangulation:492-505). Each feature cuts ONE tile around its
(clamped) epipolar window and scores every integer patch position in it by
ZMSSD at once, masked to a band around the segment; one batched subpixel
alignment refines all winners. The reference side may be a stacked keyframe
ring [K, L, H, W] with a per-feature ``ref_kf`` index (CUDA kernel 2).

The port's tiles are exact windows, so the JAX package's ``crop_tiles`` of
TPU superset tiles has nothing to do here and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops import patch_warp as pw
from svo_pro_universal_tpu_torch.ops import tiles as tl
from svo_pro_universal_tpu_torch.ops.interp import patch_offsets
from svo_pro_universal_tpu_torch.utils.transform import SE3

HALF_PATCH = 4
PATCH = 2 * HALF_PATCH                     # 8, reference kPatchSize
PATCH_AREA = PATCH * PATCH
ZMSSD_THRESHOLD_PER_PX = 2000.0            # reference PatchScore::threshold()

REF_TILE = 24                              # ref-patch warp sampling tile
ALIGN_TILE = 24                            # subpixel-alignment tile
SCAN_TILE = 40                             # epipolar scan tile (window+patch)


class MatcherOptions(NamedTuple):
    max_epi_search_steps: int = 64
    subpix_refinement: bool = True
    epi_search_edgelet_filtering: bool = True
    epi_search_edgelet_max_angle: float = 0.7
    align_max_iter: int = 10
    affine_est_offset: bool = True
    affine_est_gain: bool = False
    max_patch_diff_ratio: float = 2.0
    scan_band_px: float = 0.76


class EpipolarMatch(NamedTuple):
    px_cur: torch.Tensor       # [N, 2] match position (level 0)
    f_cur: torch.Tensor        # [N, 3] bearing of match
    depth: torch.Tensor        # [N] triangulated depth along ref bearing
    search_level: torch.Tensor  # [N]
    success: torch.Tensor      # [N] bool
    rejected: torch.Tensor     # [N] bool: pre-filtered (no Bayes penalty)


class DirectMatch(NamedTuple):
    px_cur: torch.Tensor
    search_level: torch.Tensor
    success: torch.Tensor


def warp_ref_patches_with_border(
    pyr_ref: torch.Tensor,           # [L, H, W] or [K, L, H, W]
    ref_kf: torch.Tensor | None,     # [N] ring slots (None → single frame)
    A_cur_ref: torch.Tensor,         # [N, 2, 2]
    px_ref: torch.Tensor,            # [N, 2] level-0
    level_ref: torch.Tensor,         # [N]
    search_level: torch.Tensor,      # [N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine-warped (P+2)² reference patches at per-feature level
    (matcher.cpp:200-205), sampled inside one 24×24 tile per feature."""
    inv, det = pw.inverse2(A_cur_ref)
    A_ref_cur = inv * (1 << search_level).to(inv.dtype)[:, None, None]
    pwb = PATCH + 2
    dt, dev = px_ref.dtype, px_ref.device
    r = torch.arange(pwb, dtype=dt, device=dev) - (pwb / 2.0)
    ov, ou = torch.meshgrid(r, r, indexing="ij")
    offs = torch.stack([ou.reshape(-1), ov.reshape(-1)], -1)
    center = px_ref / (1 << level_ref).to(dt)[:, None]
    uv = torch.einsum("nij,pj->npi", A_ref_cur, offs) + center[:, None, :]
    cyx = torch.stack([center[:, 1], center[:, 0]], -1)
    if ref_kf is None:
        tb = tl.extract_tiles(pyr_ref, level_ref, cyx, REF_TILE, REF_TILE)
    else:
        tb = tl.extract_tiles_ring(pyr_ref, ref_kf, level_ref, cyx,
                                   REF_TILE, REF_TILE)
    vals, inb = tl.tile_bilinear(tb, uv[..., 1], uv[..., 0])
    return vals, torch.all(inb, dim=-1) & (torch.abs(det) > 1e-8)


def _local_align(pyr_cur: torch.Tensor, search_level: torch.Tensor,
                 border_patch: torch.Tensor, px_init_lvl: torch.Tensor,
                 direction_lvl: torch.Tensor, use_1d: torch.Tensor,
                 opts: MatcherOptions, valid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched align2D/align1D on per-feature pyramid levels (reference
    findLocalMatch :262-298): one 4-parameter GN, 1-D features moving only
    along ``direction_lvl``, all sampling inside one 24×24 tile."""
    n = border_patch.shape[0]
    dt, dev = px_init_lvl.dtype, px_init_lvl.device
    b = border_patch.reshape(n, PATCH + 2, PATCH + 2)
    ref = b[:, 1:-1, 1:-1].reshape(n, PATCH_AREA)
    dx = (0.5 * (b[:, 1:-1, 2:] - b[:, 1:-1, :-2])).reshape(n, PATCH_AREA)
    dy = (0.5 * (b[:, 2:, 1:-1] - b[:, :-2, 1:-1])).reshape(n, PATCH_AREA)
    ex = torch.zeros((n, 2), dtype=dt, device=dev)
    ex[:, 0] = 1.0
    e1 = torch.where(use_1d[:, None], direction_lvl, ex)
    e2 = torch.where(use_1d[:, None], torch.zeros_like(ex),
                     torch.flip(ex, [1]))
    j1 = e1[:, 0:1] * dx + e1[:, 1:2] * dy
    j2 = e2[:, 0:1] * dx + e2[:, 1:2] * dy
    zeros = torch.zeros_like(ref)
    jac = torch.stack([
        j1, j2,
        torch.ones_like(ref) if opts.affine_est_offset else zeros,
        -ref if opts.affine_est_gain else zeros], dim=-1)
    H = torch.einsum("npi,npj->nij", jac, jac)
    # disabled blocks → identity entries so H stays invertible
    H[:, 1, 1] += use_1d.to(dt)
    if not opts.affine_est_offset:
        H[:, 2, 2] += 1.0
    if not opts.affine_est_gain:
        H[:, 3, 3] += 1.0
    offs = patch_offsets(PATCH, dt, dev)
    tb = tl.extract_tiles(
        pyr_cur, search_level,
        torch.stack([px_init_lvl[:, 1], px_init_lvl[:, 0]], -1),
        ALIGN_TILE, ALIGN_TILE)

    uv = px_init_lvl
    mean_diff = torch.zeros((n,), dtype=dt, device=dev)
    alpha = torch.ones((n,), dtype=dt, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(opts.align_max_iter):
        pos = uv[:, None, :] + offs[None]
        cur, inb = tl.tile_bilinear(tb, pos[..., 1], pos[..., 0])
        ok = torch.all(inb, dim=-1) & valid
        res = cur - alpha[:, None] * ref + mean_diff[:, None]
        jres = -torch.einsum("np,npi->ni", res, jac)
        if not opts.affine_est_offset:
            jres[:, 2] = 0.0
        if not opts.affine_est_gain:
            jres[:, 3] = 0.0
        upd = tl.solve_psd_small(H, jres, damping=1e-8)
        apply = (ok & ~done)[:, None]
        duv = upd[:, 0:1] * e1 + upd[:, 1:2] * e2
        uv = uv + torch.where(apply, duv, 0.0)
        mean_diff = mean_diff + torch.where(apply[:, 0], upd[:, 2], 0.0)
        alpha = alpha + torch.where(apply[:, 0], upd[:, 3], 0.0)
        small = torch.sum(duv ** 2, dim=-1) < 0.03 * 0.03
        done = done | (small & ok) | ~ok
    pos = uv[:, None, :] + offs[None]
    _, inb = tl.tile_bilinear(tb, pos[..., 1], pos[..., 0])
    conv = (torch.all(inb, dim=-1) & valid
            & torch.all(torch.isfinite(uv), dim=-1))
    return uv, conv


def depth_from_triangulation(T_cur_ref: SE3, f_ref: torch.Tensor,
                             f_cur: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched two-view depth along the ref bearing (matcher.cpp:492-505).
    Returns (depth [N], ok [N])."""
    Rf = T_cur_ref.rotate(f_ref)
    a00 = torch.sum(Rf * Rf, -1)
    a01 = torch.sum(Rf * f_cur, -1)
    a11 = torch.sum(f_cur * f_cur, -1)
    det = a00 * a11 - a01 * a01
    t = torch.broadcast_to(T_cur_ref.t, f_ref.shape)
    b0 = torch.sum(Rf * t, -1)
    b1 = torch.sum(f_cur * t, -1)
    safe = torch.where(torch.abs(det) > 1e-9, det, 1e-9)
    d0 = -(a11 * b0 - a01 * b1) / safe
    return torch.abs(d0), det >= 1e-6


def find_epipolar_matches(
    pyr_ref: torch.Tensor, pyr_cur: torch.Tensor, cam_ref: proj.Camera,
    cam_cur: proj.Camera, T_cur_ref: SE3, px_ref: torch.Tensor,
    f_ref: torch.Tensor, grad_ref: torch.Tensor, is_edgelet: torch.Tensor,
    level_ref: torch.Tensor, d_estimate_inv: torch.Tensor,
    d_min_inv: torch.Tensor, d_max_inv: torch.Tensor, valid: torch.Tensor,
    max_search_level: int, opts: MatcherOptions = MatcherOptions(),
    ref_kf: torch.Tensor | None = None,
) -> EpipolarMatch:
    """Batched findEpipolarMatchDirect (matcher.cpp:157-241) as a dense
    ZMSSD scan of a fixed tile around the budget-clamped window."""
    n = px_ref.shape[0]
    dt, dev = px_ref.dtype, px_ref.device
    Rf = T_cur_ref.rotate(f_ref)
    t = torch.broadcast_to(T_cur_ref.t, f_ref.shape)
    A_b = Rf + t * d_min_inv[:, None]    # near point (bearing space)
    B_b = Rf + t * d_max_inv[:, None]    # far point
    C_b = Rf + t * d_estimate_inv[:, None]
    px_A, _ = proj.project(cam_cur, A_b)
    px_B, _ = proj.project(cam_cur, B_b)
    epi_image = px_A - px_B
    epi_len0 = torch.linalg.norm(epi_image, dim=-1)

    A_cur_ref = pw.affine_warp_matrix(
        cam_ref, cam_cur, px_ref, f_ref,
        1.0 / torch.clamp(d_estimate_inv, min=1e-6), T_cur_ref, level_ref)
    search_level = pw.best_search_level(A_cur_ref, max_search_level)
    scale = (1 << search_level).to(dt)
    epi_len_pyr = epi_len0 / scale
    epi_dir = epi_image / torch.clamp(epi_len0, min=1e-8)[:, None]

    # edgelet pre-filter (matcher.cpp:183-194)
    grad_cur = torch.einsum("nij,nj->ni", A_cur_ref, grad_ref)
    grad_cur = grad_cur / torch.clamp(
        torch.linalg.norm(grad_cur, dim=-1, keepdim=True), min=1e-8)
    cosangle = torch.abs(torch.sum(grad_cur * epi_dir, dim=-1))
    rejected = is_edgelet & (cosangle < opts.epi_search_edgelet_max_angle)
    if not opts.epi_search_edgelet_filtering:
        rejected = torch.zeros_like(rejected)
    valid = valid & ~rejected

    border_patch, warp_ok = warp_ref_patches_with_border(
        pyr_ref, ref_kf, A_cur_ref, px_ref, level_ref, search_level)
    bp = border_patch.reshape(n, PATCH + 2, PATCH + 2)
    ref_patch = bp[:, 1:-1, 1:-1].reshape(n, PATCH_AREA)
    valid = valid & warp_ok

    # --- window along the unit-plane segment B→A, clamped to the budget ---
    uv_A = A_b[:, 0:2] / A_b[:, 2:3]
    uv_B = B_b[:, 0:2] / B_b[:, 2:3]
    uv_C = C_b[:, 0:2] / C_b[:, 2:3]
    seg = uv_A - uv_B
    seg_len2 = torch.clamp(torch.sum(seg * seg, -1), min=1e-16)
    t_C = torch.clamp(torch.sum((uv_C - uv_B) * seg, -1) / seg_len2,
                      0.0, 1.0)
    budget_px = min(opts.max_epi_search_steps * 0.7, SCAN_TILE - PATCH - 2)
    halfw = torch.clamp(0.5 * budget_px / torch.clamp(epi_len_pyr, min=1.0),
                        max=0.5)
    t_lo = torch.minimum(torch.clamp(t_C - halfw, min=0.0),
                         1.0 - 2.0 * halfw)
    t_hi = t_lo + 2.0 * halfw
    ones1 = torch.ones((n, 1), dtype=dt, device=dev)
    px_W0, _ = proj.project(cam_cur, torch.cat(
        [uv_B + t_lo[:, None] * seg, ones1], -1))
    px_W1, _ = proj.project(cam_cur, torch.cat(
        [uv_B + t_hi[:, None] * seg, ones1], -1))
    w0 = px_W0 / scale[:, None]           # window endpoints, level coords
    w1 = px_W1 / scale[:, None]
    mid = 0.5 * (w0 + w1)

    # --- dense ZMSSD over the scan tile, masked to the epipolar band ------
    tb = tl.extract_tiles(pyr_cur, search_level,
                          torch.stack([mid[:, 1], mid[:, 0]], -1),
                          SCAN_TILE, SCAN_TILE)
    score_map, pos_ok = tl.zmssd_score_map(tb, ref_patch, PATCH)
    tR, tT = tb.shape_rt
    SPy, SPx = tR - PATCH + 1, tT - PATCH + 1
    cyy = (tb.y0[:, None, None].to(dt) + float(HALF_PATCH)
           + torch.arange(SPy, device=dev).to(dt)[None, :, None])
    cxx = (tb.x0[:, None, None].to(dt) + float(HALF_PATCH)
           + torch.arange(SPx, device=dev).to(dt)[None, None, :])
    d01 = w1 - w0
    d01_len2 = torch.clamp(torch.sum(d01 * d01, -1), min=1e-12)[:, None,
                                                                  None]
    rx = cxx - w0[:, 0, None, None]
    ry = cyy - w0[:, 1, None, None]
    t_par = (rx * d01[:, 0, None, None] + ry * d01[:, 1, None, None]) \
        / d01_len2
    t_cl = torch.clamp(t_par, 0.0, 1.0)
    dx_ = rx - t_cl * d01[:, 0, None, None]
    dy_ = ry - t_cl * d01[:, 1, None, None]
    dist2 = dx_ * dx_ + dy_ * dy_
    band = opts.scan_band_px
    on_line = (dist2 <= band * band) & (t_par >= -0.02) & (t_par <= 1.02)
    score = torch.where(pos_ok & on_line, score_map, float("inf"))
    score_flat = score.reshape(n, SPy * SPx)
    best = torch.argmin(score_flat, dim=-1)
    zmssd_best = torch.gather(score_flat, 1, best[:, None])[:, 0]
    by = torch.div(best, SPx, rounding_mode="floor")
    bx = best - by * SPx
    px_best_lvl = torch.stack([
        tb.x0.to(dt) + bx.to(dt) + float(HALF_PATCH),
        tb.y0.to(dt) + by.to(dt) + float(HALF_PATCH)], -1)
    px_best = px_best_lvl * scale[:, None]

    # short line → skip the scan, start the local search at the midpoint
    short = epi_len_pyr < 2.0
    px_init = torch.where(short[:, None], 0.5 * (px_A + px_B), px_best)
    score_ok = short | (zmssd_best < ZMSSD_THRESHOLD_PER_PX * PATCH_AREA)

    if opts.subpix_refinement:
        uv_ref, conv = _local_align(
            pyr_cur, search_level, border_patch, px_init / scale[:, None],
            epi_dir, is_edgelet, opts, valid & score_ok)
        px_cur = uv_ref * scale[:, None]
        align_ok = conv
    else:
        px_cur = px_init
        align_ok = torch.ones((n,), dtype=torch.bool, device=dev)

    f_cur = proj.backproject(cam_cur, px_cur)
    depth, tri_ok = depth_from_triangulation(T_cur_ref, f_ref, f_cur)
    success = valid & score_ok & align_ok & tri_ok
    return EpipolarMatch(px_cur, f_cur, depth, search_level, success,
                         rejected)


def find_matches_direct(
    pyr_ref: torch.Tensor, pyr_cur: torch.Tensor, cam_ref: proj.Camera,
    cam_cur: proj.Camera, T_cur_ref: SE3, px_ref: torch.Tensor,
    f_ref: torch.Tensor, depth_ref: torch.Tensor, grad_ref: torch.Tensor,
    is_edgelet: torch.Tensor, level_ref: torch.Tensor,
    px_cur_init: torch.Tensor, valid: torch.Tensor, max_search_level: int,
    opts: MatcherOptions = MatcherOptions(),
    ref_kf: torch.Tensor | None = None,
) -> DirectMatch:
    """Batched findMatchDirect for landmark reprojection (matcher.cpp:
    31-141): affine warp from the feature's ref keyframe, then subpixel
    alignment around the projected position."""
    A_cur_ref = pw.affine_warp_matrix(
        cam_ref, cam_cur, px_ref, f_ref, depth_ref, T_cur_ref, level_ref)
    search_level = pw.best_search_level(A_cur_ref, max_search_level)
    border_patch, warp_ok = warp_ref_patches_with_border(
        pyr_ref, ref_kf, A_cur_ref, px_ref, level_ref, search_level)
    valid = valid & warp_ok
    grad_cur = torch.einsum("nij,nj->ni", A_cur_ref, grad_ref)
    norm = torch.clamp(torch.linalg.norm(grad_cur, dim=-1, keepdim=True),
                       min=1e-8)
    dir_cur = grad_cur / norm
    # edgelets search along the normal of the warped gradient
    dir_search = torch.stack([dir_cur[:, 1], -dir_cur[:, 0]], -1)
    scale = (1 << search_level).to(px_ref.dtype)
    uv, conv = _local_align(
        pyr_cur, search_level, border_patch, px_cur_init / scale[:, None],
        dir_search, is_edgelet, opts, valid)
    return DirectMatch(uv * scale[:, None], search_level, conv & valid)
