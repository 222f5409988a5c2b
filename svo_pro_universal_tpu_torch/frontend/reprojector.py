"""Reprojector: re-observe map landmarks and seeds in the current frame.

Counterpart of ``svo_pro_universal_tpu/frontend/reprojector.py`` (reference
Reprojector, src/svo/src/reprojector.cpp:28-196):

1. every (keyframe, feature) pair of the ring is a candidate row of one
   flat [K·F] batch (landmark-backed or live-seed-backed),
2. visibility + grid bucketing keep at most one candidate per cell by a
   segment max on a priority key (ties: highest flat index),
3. the winners are compacted (stable top-k) and matched in one batched
   ``find_matches_direct`` (tiles from the ring: CUDA kernel 2),
4. the matches are compacted into the frame's [MAX_FTS] store.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.common import types as ft
from svo_pro_universal_tpu_torch.common.point import LandmarkPool
from svo_pro_universal_tpu_torch.frontend.map import KeyframeRing
from svo_pro_universal_tpu_torch.ops import matcher as matcher_mod
from svo_pro_universal_tpu_torch.utils.indexing import (
    segment_max, set_drop, topk_stable)
from svo_pro_universal_tpu_torch.utils.transform import SE3


class ReprojectorOptions(NamedTuple):
    max_n_kfs: int = 5
    max_n_features_per_frame: int = 160
    cell_size: int = 30
    reproject_unconverged_seeds: bool = True
    seed_sigma2_thresh: float = 200.0
    affine_est_offset: bool = True
    affine_est_gain: bool = False
    max_candidates: int = 384     # compaction bound before patch matching


class ReprojectResult(NamedTuple):
    """Matched features, compacted to [M] slots."""
    px: torch.Tensor
    f: torch.Tensor
    grad: torch.Tensor
    level: torch.Tensor
    ftype: torch.Tensor
    landmark_id: torch.Tensor
    seed_ref_kf: torch.Tensor
    seed_ref_idx: torch.Tensor
    xyz_world: torch.Tensor
    valid: torch.Tensor
    n_matches: torch.Tensor
    n_trials: torch.Tensor


def _type_rank(ftype, has_landmark, is_fixed):
    """Priority: fixed landmarks > landmarks > converged seeds > seeds."""
    rank = torch.where(has_landmark, 3, 0)
    rank = torch.where(is_fixed | (ftype == ft.FeatureType.FIXED_LANDMARK),
                       4, rank)
    rank = torch.where(ft.is_converged_seed(ftype) & ~has_landmark, 2, rank)
    rank = torch.where(ft.is_unconverged_seed(ftype) & ~has_landmark, 1,
                       rank)
    return rank


def reproject(ring: KeyframeRing, pool: LandmarkPool, T_cur_world: SE3,
              pyr_cur: torch.Tensor, cam: proj.Camera, overlap: torch.Tensor,
              grid_occupied: torch.Tensor, n_cols: int, n_rows: int,
              max_search_level: int,
              opts: ReprojectorOptions = ReprojectorOptions(),
              matcher_opts: matcher_mod.MatcherOptions | None = None,
              ) -> ReprojectResult:
    K = ring.capacity
    Fn = ring.frames.px.shape[1]
    NC = K * Fn
    dev = pyr_cur.device

    def flat(x):
        return x.reshape((NC,) + tuple(x.shape[2:]))

    # ---- 1. flat candidate batch over the whole ring -------------------
    kf_idx = torch.arange(K, device=dev).repeat_interleave(Fn)
    ft_idx = torch.arange(Fn, device=dev).repeat(K)
    c_px = flat(ring.frames.px)
    c_f = flat(ring.frames.f)
    c_grad = flat(ring.frames.grad)
    c_level = flat(ring.frames.level)
    c_type = flat(ring.frames.ftype)
    c_lid = flat(ring.frames.landmark_id)
    c_seed = flat(ring.frames.seed_state)

    lidc = torch.clamp(c_lid, 0, pool.capacity - 1)
    kf_ok = (overlap & ring.valid)[kf_idx]
    has_lm = (c_lid >= 0) & pool.valid[lidc]
    # a seed candidate must be OWNED by its keyframe (seed_ref_kf < 0)
    owned = flat(ring.frames.seed_ref_kf) < 0
    seed_ok = ft.is_corner_edgelet_seed(c_type) & owned
    if not opts.reproject_unconverged_seeds:
        seed_ok = seed_ok & ft.is_converged_seed(c_type)
    cand = kf_ok & (has_lm | seed_ok)

    # 3D position: landmark pool, else seed mean depth in its keyframe
    lm_pos = pool.pos[lidc]
    T_world_kf = ring.frames.T_cam_world.index(kf_idx).inverse()
    seed_depth = 1.0 / torch.clamp(c_seed[:, 0], min=1e-12)
    seed_pos_w = T_world_kf.apply(c_f * seed_depth[:, None])
    xyz_w = torch.where(has_lm[:, None], lm_pos, seed_pos_w)

    # ---- 2. visibility + grid bucketing --------------------------------
    p_cur = T_cur_world.apply(xyz_w)
    px_init, vis = proj.project(cam, p_cur)
    margin = 8.0
    vis = vis & (px_init[:, 0] >= margin) & (px_init[:, 1] >= margin) \
        & (px_init[:, 0] < cam.width - margin) \
        & (px_init[:, 1] < cam.height - margin) & (p_cur[:, 2] > 1e-6)
    cand = cand & vis

    n_cells = n_rows * n_cols
    cx = torch.clamp(torch.div(px_init[:, 0], opts.cell_size,
                               rounding_mode="floor").long(), 0, n_cols - 1)
    cy = torch.clamp(torch.div(px_init[:, 1], opts.cell_size,
                               rounding_mode="floor").long(), 0, n_rows - 1)
    cell = cy * n_cols + cx
    cell_c = torch.clamp(cell, 0, n_cells - 1)
    cand = cand & ~grid_occupied[cell_c]

    is_fixed = has_lm & pool.fixed[lidc]
    rank = _type_rank(c_type, has_lm, is_fixed)
    quality = torch.where(has_lm, pool.n_obs[lidc].to(torch.float32),
                          1.0 / (1.0 + c_seed[:, 1]))
    key = rank.to(torch.float32) * 1e6 + torch.clamp(quality, 0.0, 1e5)
    key = torch.where(cand, key, float("-inf"))
    cell_for_seg = torch.where(cand, cell, n_cells)
    best_key = segment_max(key, cell_for_seg, n_cells + 1)[:n_cells]
    # winner per cell: highest flat index among maximizers
    flat_i = torch.arange(NC, device=dev)
    is_winner = cand & (key >= best_key[cell_c])
    win_idx = segment_max(torch.where(is_winner, flat_i, -1), cell_for_seg,
                          n_cells + 1)[:n_cells]
    chosen = set_drop(torch.zeros((NC,), dtype=torch.bool, device=dev),
                      torch.where(win_idx >= 0, win_idx, NC), True)
    cand = cand & chosen

    # ---- 3. COMPACT candidates, then batched direct matching -----------
    MC = min(opts.max_candidates, NC)
    ck, cidx = topk_stable(torch.where(cand, key, float("-inf")), MC)
    c_ok = torch.isfinite(ck)
    kf_c = kf_idx[cidx]
    T_world_kf_c = T_world_kf.index(cidx)
    T_cur_kf = T_cur_world.compose(T_world_kf_c)     # [MC]-batched
    xyz_c = xyz_w[cidx]
    depth_ref = torch.linalg.norm(xyz_c - T_world_kf_c.t, dim=-1)
    mopts = matcher_opts or matcher_mod.MatcherOptions(
        affine_est_offset=opts.affine_est_offset,
        affine_est_gain=opts.affine_est_gain)
    match = matcher_mod.find_matches_direct(
        ring.frames.pyramid, pyr_cur, cam, cam, T_cur_kf,
        c_px[cidx], c_f[cidx], depth_ref, c_grad[cidx],
        ft.is_edgelet(c_type[cidx]), c_level[cidx],
        px_init[cidx], c_ok, max_search_level, mopts, ref_kf=kf_c)
    matched = c_ok & match.success

    # ---- 4. compact to MAX_FTS slots ------------------------------------
    M = opts.max_n_features_per_frame
    top_key, top_i = topk_stable(torch.where(matched, ck, float("-inf")),
                                 min(M, MC))
    sel_ok = torch.isfinite(top_key)
    # globally-optimized landmarks re-enter as FIXED_LANDMARK
    out_type = torch.where(is_fixed[cidx][top_i],
                           int(ft.FeatureType.FIXED_LANDMARK),
                           c_type[cidx][top_i])
    has_lm_c = has_lm[cidx]
    f_new = proj.backproject(cam, match.px_cur)
    seed_row = sel_ok & ~has_lm_c[top_i]
    return ReprojectResult(
        px=match.px_cur[top_i],
        f=f_new[top_i],
        grad=c_grad[cidx][top_i],
        level=match.search_level[top_i],
        ftype=torch.where(sel_ok, out_type, int(ft.FeatureType.INVALID)),
        landmark_id=torch.where(sel_ok, c_lid[cidx][top_i], -1),
        seed_ref_kf=torch.where(seed_row, kf_c[top_i], -1),
        seed_ref_idx=torch.where(seed_row, ft_idx[cidx][top_i], -1),
        xyz_world=xyz_c[top_i],
        valid=sel_ok,
        n_matches=torch.sum(matched.long()),
        n_trials=torch.sum(cand.long()),
    )
