"""Mono frontend stage programs: tracking step and keyframe step.

Counterpart of the stage methods of ``FrameHandlerMono`` in
``svo_pro_universal_tpu/frontend/frame_handler.py`` (reference
frame_handler_base.cpp — sparseImageAlignment:610-644,
projectMapInFrame:646-744, optimizePose:746-777, optimizeStructure:
779-826, upgradeSeedsToFeatures:828-898, needNewKf:1012-1121). Each stage is
a function of tensors on one device; none of them reads the device from the
host, so the pipeline (frontend.pipeline) decides what to run from one small
read per frame.
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.common import seed as seed_mod
from svo_pro_universal_tpu_torch.common import types as ft
from svo_pro_universal_tpu_torch.common.frame import (
    FrameState, scene_depth_stats)
from svo_pro_universal_tpu_torch.common.point import (
    LandmarkPool, add_observations, allocate,
    invalidate_keyframe_observations)
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend import reprojector as repro_mod
from svo_pro_universal_tpu_torch.frontend.map import (
    KeyframeRing, eviction_slot, insert_keyframe, overlap_mask)
from svo_pro_universal_tpu_torch.ops import alignment as align_mod
from svo_pro_universal_tpu_torch.ops import depth_filter as df_mod
from svo_pro_universal_tpu_torch.ops import detector as det_mod
from svo_pro_universal_tpu_torch.ops import matcher as matcher_mod
from svo_pro_universal_tpu_torch.ops import pose_optimizer as po_mod
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia_mod
from svo_pro_universal_tpu_torch.ops import structure_optimizer as so_mod
from svo_pro_universal_tpu_torch.utils.indexing import (
    argsort_stable, set_drop, set_drop_2d, take0, topk_stable)
from svo_pro_universal_tpu_torch.utils.robust import masked_median
from svo_pro_universal_tpu_torch.utils.transform import SE3, se3_log


class Stage(enum.Enum):
    """reference: frame_handler_base.h:214-219."""
    PAUSED = 0
    FIRST_FRAME = 1
    INITIALIZING = 2
    TRACKING = 3
    RELOCALIZING = 4


def _feature_world_points(frame: FrameState, ring: KeyframeRing,
                          pool: LandmarkPool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh 3D point per feature: the landmark pool if linked, else the
    live seed state in its ref keyframe. Returns (xyz_world [N,3], ok)."""
    lid = frame.landmark_id
    lidc = torch.clamp(lid, 0, pool.capacity - 1)
    has_lm = (lid >= 0) & pool.valid[lidc]
    lm_pos = pool.pos[lidc]
    kf = torch.clamp(frame.seed_ref_kf, 0, ring.capacity - 1)
    fidx = torch.clamp(frame.seed_ref_idx, 0, frame.max_fts - 1)
    has_seed = (frame.seed_ref_kf >= 0) & ring.valid[kf]
    seed_state = ring.frames.seed_state[kf, fidx]
    seed_f = ring.frames.f[kf, fidx]
    depth = 1.0 / torch.clamp(seed_state[:, 0], min=1e-12)
    T_world_kf = ring.frames.T_cam_world.index(kf).inverse()
    seed_pos = T_world_kf.apply(seed_f * depth[:, None])
    xyz = torch.where(has_lm[:, None], lm_pos, seed_pos)
    return xyz, has_lm | has_seed


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when CUDA
    is requested and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the card by default and no CUDA device is "
            "present; pass device='cpu' to run on the CPU")
    return dev


class FrameHandlerMono:
    """Mono stage programs on one device (reference FrameHandlerMono); on
    the card unless ``device`` says otherwise."""

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam = cam.to(self.device)
        if T_cam_body is None:
            T_cam_body = SE3.identity(device=self.device)
        self.T_cam_body = SE3(T_cam_body.q.to(self.device),
                              T_cam_body.t.to(self.device))
        self.n_levels = max(cfg.n_pyr_levels, cfg.img_align.max_level + 1)
        self.max_fts = cfg.capacity.max_fts
        cs = cfg.detector.cell_size
        self.n_cols = -(-cam.width // cs)
        self.n_rows = -(-cam.height // cs)
        self.n_cells = self.n_cols * self.n_rows
        # landmarks refined per frame by the structure stage (reference
        # optimizeStructure frame_handler_base.cpp:779); the VIO pipeline
        # sets 0, its window backend owns landmark refinement
        self._structure_max_pts = int(
            cfg.base.structure_optimization_max_pts)

    # ------------------------------------------------------------------
    def _stage_align(self, ring, pool, last_frame, cur_pyramid, T_prior_rel):
        """Stage 1: sparse image alignment vs the last frame. Returns
        (T_cur_world, align_stats)."""
        cfg = self.cfg
        xyz_w, has_pt = _feature_world_points(last_frame, ring, pool)
        last_pos = last_frame.T_world_cam.t
        depth_ref = torch.linalg.norm(xyz_w - last_pos[None], dim=-1)
        inp = sia_mod.CameraInput(
            pyr_ref=last_frame.pyramid, pyr_cur=cur_pyramid,
            px_ref=last_frame.px, f_ref=last_frame.f, depth_ref=depth_ref,
            valid=last_frame.valid_mask() & has_pt,
            T_cam_body=self.T_cam_body, cam=self.cam)
        opts = sia_mod.SparseImgAlignOptions(
            max_level=cfg.img_align.max_level,
            min_level=cfg.img_align.min_level,
            estimate_alpha=cfg.img_align.estimate_illumination_gain,
            estimate_beta=cfg.img_align.estimate_illumination_offset,
            prior_lambda_rot=cfg.base.img_align_prior_lambda_rot,
            prior_lambda_trans=cfg.base.img_align_prior_lambda_trans,
            max_iter=cfg.img_align.max_iter)
        T_body_cam = self.T_cam_body.inverse()
        T_prior_body = (T_body_cam.compose(T_prior_rel)
                        .compose(self.T_cam_body))
        st0 = sia_mod.make_state(T_prior_body)
        align_state, align_stats = sia_mod.run(
            [inp], st0, opts,
            T_prior=(T_prior_body if cfg.base.img_align_prior_lambda_rot > 0
                     else None))
        T_cur_world = (self.T_cam_body.compose(align_state.T_icur_iref)
                       .compose(T_body_cam).compose(last_frame.T_cam_world))
        return T_cur_world, align_stats

    def _stage_reproject(self, ring, pool, cur_frame, T_cur_world, ov):
        """Stage 2: reproject map landmarks/seeds and match their patches.
        Returns (frame, rep)."""
        cfg = self.cfg
        rep = repro_mod.reproject(
            ring, pool, T_cur_world, cur_frame.pyramid, self.cam, ov,
            torch.zeros((self.n_cells,), dtype=torch.bool,
                        device=self.device),
            self.n_cols, self.n_rows,
            max_search_level=cfg.detector.max_level,
            opts=repro_mod.ReprojectorOptions(
                max_n_kfs=cfg.reprojector.max_n_kfs,
                max_n_features_per_frame=min(
                    cfg.reprojector.max_n_features_per_frame, self.max_fts),
                cell_size=cfg.reprojector.cell_size,
                reproject_unconverged_seeds=(
                    cfg.reprojector.reproject_unconverged_seeds),
                affine_est_offset=cfg.reprojector.affine_est_offset,
                affine_est_gain=cfg.reprojector.affine_est_gain))
        m = rep.px.shape[0]

        def head(x, v):
            return torch.cat([v, x[m:]])

        frame = cur_frame._replace(
            T_cam_world=T_cur_world,
            px=head(cur_frame.px, rep.px),
            f=head(cur_frame.f, rep.f),
            grad=head(cur_frame.grad, rep.grad),
            level=head(cur_frame.level, rep.level),
            ftype=head(cur_frame.ftype, rep.ftype),
            landmark_id=head(cur_frame.landmark_id, rep.landmark_id),
            seed_ref_kf=head(cur_frame.seed_ref_kf, rep.seed_ref_kf),
            seed_ref_idx=head(cur_frame.seed_ref_idx, rep.seed_ref_idx))
        return frame, rep

    def _stage_pose(self, ring, pool, frame):
        """Stage 3: motion-only pose refinement. Returns
        (frame, po_res, xyz_cur, has_cur)."""
        cfg = self.cfg
        xyz_cur, has_cur = _feature_world_points(frame, ring, pool)
        fs = po_mod.PoseOptFeatures(
            xyz_world=xyz_cur, f=frame.f, grad=frame.grad,
            level=frame.level, is_edgelet=ft.is_edgelet(frame.ftype),
            valid=frame.valid_mask() & has_cur,
            T_cam_body=self.T_cam_body, cam=self.cam)
        T_body_world = self.T_cam_body.inverse().compose(frame.T_cam_world)
        po_res = po_mod.optimize_pose(
            [fs], T_body_world,
            po_mod.PoseOptOptions(
                reproj_thresh_px=cfg.base.poseoptim_thresh,
                prior_lambda=cfg.base.poseoptim_prior_lambda))
        T_cur_world = self.T_cam_body.compose(po_res.T_body_world)
        outlier = frame.valid_mask() & has_cur & ~po_res.inlier[0]
        frame = frame._replace(
            T_cam_world=T_cur_world,
            ftype=torch.where(outlier, int(ft.FeatureType.OUTLIER),
                              frame.ftype))
        return frame, po_res, xyz_cur, has_cur

    def _stage_structure(self, ring, pool, frame):
        """Stage 4: per-point structure GN on the longest-unoptimized
        landmarks with enough parallax. Returns pool (unchanged, and nothing
        launched, when the point budget is 0, as with a window backend)."""
        max_pts = self._structure_max_pts
        if max_pts <= 0:
            return pool
        lid = frame.landmark_id
        has_lm = (lid >= 0) & frame.valid_mask()
        lidc = torch.clamp(lid, 0, pool.capacity - 1)
        obs_kf = pool.obs_kf[lidc]                     # [N, O]
        obs_idx = pool.obs_idx[lidc]
        okf = torch.clamp(obs_kf, 0, ring.capacity - 1)
        oidx = torch.clamp(obs_idx, 0, self.max_fts - 1)
        f_obs = ring.frames.f[okf, oidx]               # [N, O, 3]
        T_obs = ring.frames.T_cam_world.index(okf)
        obs_ok = (obs_kf >= 0) & ring.valid[okf]
        enough = torch.sum(obs_ok.long(), dim=-1) >= 2
        # parallax gate: only points whose observations span ≥ 8%
        # baseline-to-depth are re-triangulated
        cam_pos = T_obs.inverse().t                    # [N, O, 3]
        X = pool.pos[lidc]
        depth_o = torch.clamp(torch.linalg.norm(X[:, None, :] - cam_pos,
                                                dim=-1), min=1e-6)
        pdist = torch.linalg.norm(cam_pos[:, :, None, :]
                                  - cam_pos[:, None, :, :], dim=-1)
        pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
        max_base = torch.amax(torch.where(pair_ok, pdist, 0.0), dim=(1, 2))
        parallax_ok = max_base > 0.08 * torch.amin(
            torch.where(obs_ok, depth_o, float("inf")), dim=-1)
        cand = has_lm & enough & parallax_ok & ~pool.fixed[lidc]
        n = lidc.shape[0]
        if max_pts < n:
            age = pool.last_structure_optim[lidc].to(torch.float32)
            _, sel_rows = topk_stable(torch.where(cand, -age,
                                                  float("-inf")), max_pts)
            chosen = set_drop(torch.zeros((n,), dtype=torch.bool,
                                          device=self.device),
                              sel_rows, True) & cand
        else:
            chosen = cand
        so_res = so_mod.optimize_points(
            pool.pos[lidc], f_obs, T_obs, obs_ok, chosen, n_iter=5)
        widx = torch.where(chosen, lidc, pool.capacity)
        now_i = (frame.timestamp * 1000.0).to(torch.int32).long()
        return pool._replace(
            pos=set_drop(pool.pos, widx, so_res.xyz),
            last_structure_optim=set_drop(pool.last_structure_optim, widx,
                                          now_i))

    def _stage_seeds(self, ring, cur_pyramid, T_cur_world, depth_scalars,
                     ov):
        """Stage 5: depth-filter update of the ring's seeds, compacted to
        the ``max_seed_updates`` most uncertain. Returns (ring, upd)."""
        cfg = self.cfg
        K, Fn = ring.capacity, self.max_fts
        NC = K * Fn
        MS = min(cfg.capacity.max_seed_updates, NC)

        def rflat(x):
            return x.reshape((NC,) + tuple(x.shape[2:]))

        kf_idx = torch.arange(K, device=self.device).repeat_interleave(Fn)
        owned = rflat(ring.frames.seed_ref_kf) < 0
        r_ftype = rflat(ring.frames.ftype)
        r_seed = rflat(ring.frames.seed_state)
        active = ((ov & ring.valid)[kf_idx] & owned
                  & ft.is_unconverged_seed(r_ftype))
        score = torch.where(active,
                            1.0 + torch.clamp(r_seed[:, 1], 0.0, 1e3),
                            float("-inf"))
        _, sidx = topk_stable(score, MS)
        s_ok = active[sidx]
        kf_s = kf_idx[sidx]
        T_cur_kf = T_cur_world.compose(
            ring.frames.T_cam_world.index(kf_s).inverse())
        upd = df_mod.update_seeds(
            ring.frames.pyramid, cur_pyramid, self.cam, self.cam, T_cur_kf,
            rflat(ring.frames.px)[sidx], rflat(ring.frames.f)[sidx],
            rflat(ring.frames.grad)[sidx], rflat(ring.frames.level)[sidx],
            torch.where(s_ok, r_ftype[sidx], int(ft.FeatureType.INVALID)),
            r_seed[sidx], 1.0 / depth_scalars[1],
            max_search_level=cfg.depth_filter.max_search_level,
            sigma2_convergence_threshold=(
                cfg.depth_filter.seed_convergence_sigma2_thresh),
            matcher_opts=matcher_mod.MatcherOptions(
                max_epi_search_steps=cfg.capacity.epi_samples),
            ref_kf=kf_s)
        widx = torch.where(s_ok, sidx, NC)
        frames = ring.frames._replace(
            seed_state=set_drop(r_seed, widx, upd.seed_state).reshape(
                K, Fn, 4),
            ftype=set_drop(r_ftype, widx, upd.ftype).reshape(K, Fn))
        return ring._replace(frames=frames), upd

    def _stage_kf_policy(self, ring, pool, frame, ov):
        """Keyframe-policy signals (reference needNewKf :1012-1121).
        Returns dict(med_disparity, kf_too_close)."""
        cfgb = self.cfg.base
        last_kf = torch.clamp(ring.last_added, 0, ring.capacity - 1)
        kf_lid = take0(ring.frames.landmark_id, last_kf)
        kf_px = take0(ring.frames.px, last_kf)
        P = pool.capacity
        lid2idx = set_drop(
            torch.full((P + 1,), -1, dtype=torch.long, device=self.device),
            torch.where(kf_lid >= 0, kf_lid, P),
            torch.arange(self.max_fts, device=self.device))
        cur_lid = torch.clamp(frame.landmark_id, 0, P - 1)
        co = lid2idx[torch.where(frame.landmark_id >= 0, cur_lid, P)]
        co_ok = (co >= 0) & frame.valid_mask()
        disp = torch.linalg.norm(
            frame.px - kf_px[torch.clamp(co, 0, self.max_fts - 1)], dim=-1)
        med_disparity = masked_median(disp, co_ok)
        kf_rel_t = torch.linalg.norm(
            frame.T_world_cam.t[None] - ring.frames.T_cam_world.inverse().t,
            dim=-1)
        kq = ring.frames.T_cam_world.q
        zero_t = torch.zeros(kq.shape[:-1] + (3,), dtype=kq.dtype,
                             device=kq.device)
        dq = se3_log(SE3(kq, zero_t).inverse().compose(
            SE3(frame.T_cam_world.q.expand(kq.shape), zero_t)))
        kf_ang = torch.linalg.norm(dq[:, 3:], dim=-1)
        close = (ov & ring.valid
                 & (kf_ang < math.radians(cfgb.kfselect_min_angle))
                 & (kf_rel_t < cfgb.kfselect_min_dist_metric))
        return dict(med_disparity=med_disparity,
                    kf_too_close=torch.any(close))

    def _tracking_step(self, ring, pool, last_frame, cur_frame, T_prior_rel,
                       depth_scalars):
        """Sparse align → reproject → pose opt → structure opt → seed
        update. Returns (ring, pool, frame, stats) with device scalars."""
        cfg = self.cfg
        T_cur_world, align_stats = self._stage_align(
            ring, pool, last_frame, cur_frame.pyramid, T_prior_rel)
        ov = overlap_mask(ring, T_cur_world, cfg.reprojector.max_n_kfs)
        frame, rep = self._stage_reproject(ring, pool, cur_frame,
                                           T_cur_world, ov)
        frame, po_res, xyz_cur, has_cur = self._stage_pose(ring, pool, frame)
        T_cur_world = frame.T_cam_world
        pool = self._stage_structure(ring, pool, frame)
        ring, upd = self._stage_seeds(ring, cur_frame.pyramid, T_cur_world,
                                      depth_scalars, ov)
        valid = frame.valid_mask()
        n_tracked = torch.sum((valid & (frame.landmark_id >= 0)).long())
        z_med, z_min, _ = scene_depth_stats(frame, xyz_cur, valid & has_cur)
        policy = self._stage_kf_policy(ring, pool, frame, ov)
        stats = dict(
            med_disparity=policy["med_disparity"],
            kf_too_close=policy["kf_too_close"],
            n_tracked=n_tracked, n_total=frame.num_valid(),
            align_chi2=align_stats.chi2, align_fts=align_stats.n_tracked,
            reproj_matches=rep.n_matches, reproj_trials=rep.n_trials,
            pose_err_before=po_res.error_before_px,
            pose_err_after=po_res.error_after_px,
            n_inliers=po_res.n_inliers,
            seeds_updated=upd.n_updated, seeds_converged=upd.n_converged,
            depth_median=z_med, depth_min=z_min)
        return ring, pool, frame, stats

    def _keyframe_step(self, ring, pool, frame, depth_scalars):
        """Upgrade converged seeds to landmarks, detect new seeds, insert
        the keyframe (reference upgradeSeedsToFeatures :828-898 +
        makeKeyframe frame_handler_mono.cpp:186-250). The ring is updated
        in place (map.insert_keyframe)."""
        dev = self.device
        idx = torch.arange(self.max_fts, device=dev)
        kf = torch.clamp(frame.seed_ref_kf, 0, ring.capacity - 1)
        fidx = torch.clamp(frame.seed_ref_idx, 0, self.max_fts - 1)
        has_seed = ((frame.seed_ref_kf >= 0) & ring.valid[kf]
                    & frame.valid_mask() & (frame.landmark_id < 0))
        seed_type = ring.frames.ftype[kf, fidx]
        seed_state = ring.frames.seed_state[kf, fidx]
        converged = (ft.is_converged_seed(seed_type) & has_seed
                     & (seed_state[:, 0] > 1e-6) & (seed_state[:, 1] > 0.0))
        seed_f = ring.frames.f[kf, fidx]
        depth = 1.0 / torch.clamp(seed_state[:, 0], min=1e-12)
        T_world_kf = ring.frames.T_cam_world.index(kf).inverse()
        xyz_w = T_world_kf.apply(seed_f * depth[:, None])

        pool, slots = allocate(pool, xyz_w, converged)
        new_slot = eviction_slot(ring, frame.T_world_cam.t)
        # evicting a ring slot invalidates every pool observation of it
        pool = invalidate_keyframe_observations(pool, new_slot,
                                                take0(ring.valid, new_slot))
        # re-observed landmarks register this keyframe too
        reobs = frame.valid_mask() & (frame.landmark_id >= 0)
        new_slots = new_slot.expand(self.max_fts)
        pool = add_observations(
            pool, torch.clamp(frame.landmark_id, 0, pool.capacity - 1),
            new_slots, idx, reobs, protect_first=2)
        pool = add_observations(pool, slots, frame.seed_ref_kf, fidx,
                                converged)
        pool = add_observations(pool, slots, new_slots, idx, converged)

        frame = frame._replace(
            landmark_id=torch.where(converged, slots, frame.landmark_id),
            ftype=torch.where(converged,
                              ft.seed_to_landmark_type(frame.ftype),
                              frame.ftype))
        # anchor keyframe entries flip to landmark too (stops re-seeding)
        ai = torch.where(converged, kf, ring.capacity)
        aj = torch.where(converged, fidx, 0)
        ring = ring._replace(frames=ring.frames._replace(
            landmark_id=set_drop_2d(ring.frames.landmark_id, ai, aj, slots),
            ftype=set_drop_2d(ring.frames.ftype, ai, aj,
                              ft.seed_to_landmark_type(seed_type))))

        frame, n_new = self._detect_into_frame(frame, depth_scalars)
        frame = frame._replace(
            is_keyframe=torch.ones((), dtype=torch.bool, device=dev))
        ring = insert_keyframe(ring, frame, new_slot)
        return ring, pool, frame, torch.sum(converged.long()), n_new

    def _klt_track(self, ref_frame, cur_pyramid, px_ref, valid,
                   px_init=None):
        """Pyramidal KLT with a bidirectional consistency check: a track
        must map back to its ref position within 1 px (JAX
        frame_handler.py:664-690). ``px_init`` is the previous frame's
        track positions during initialization (the reference's
        FeatureTracker is incremental, feature_tracker.cpp:52-84)."""
        tr = self.cfg.tracker
        max_level = min(tr.klt_max_level, self.n_levels - 1)
        sizes = [tr.klt_patch_size] * (max_level + 1)
        fwd = align_mod.align_pyr_2d(
            ref_frame.pyramid, cur_pyramid, px_ref,
            px_ref if px_init is None else px_init,
            max_level=max_level, min_level=tr.klt_min_level,
            patch_sizes=sizes, n_iter=tr.klt_max_iter, valid=valid)
        bwd = align_mod.align_pyr_2d(
            cur_pyramid, ref_frame.pyramid, fwd.px, fwd.px,
            max_level=max_level, min_level=tr.klt_min_level,
            patch_sizes=sizes, n_iter=tr.klt_max_iter,
            valid=valid & fwd.converged)
        roundtrip = torch.linalg.norm(bwd.px - px_ref, dim=-1)
        ok = valid & fwd.converged & bwd.converged & (roundtrip < 1.0)
        return fwd.px, ok

    def _detect_into_frame(self, frame: FrameState, depth_scalars):
        """Fill free feature slots with fresh detections and seed states
        (reference DepthFilter::addKeyframe → initializeSeeds)."""
        cfg = self.cfg
        dev = self.device
        cs = cfg.detector.cell_size
        px = frame.px
        cx = torch.clamp(torch.div(px[:, 0], cs, rounding_mode="floor")
                         .long(), 0, self.n_cols - 1)
        cy = torch.clamp(torch.div(px[:, 1], cs, rounding_mode="floor")
                         .long(), 0, self.n_rows - 1)
        cell = cy * self.n_cols + cx
        valid = frame.valid_mask()
        occupied = set_drop(
            torch.zeros((self.n_cells,), dtype=torch.bool, device=dev),
            torch.where(valid, cell, self.n_cells), True)
        det = det_mod.detect_features(
            frame.pyramid, occupied, cs, self.n_cols, self.n_rows,
            max_features=self.max_fts,
            threshold_primary=cfg.detector.threshold_primary,
            threshold_secondary=cfg.detector.threshold_secondary,
            min_level=0, max_level=cfg.detector.max_level,
            detector_type=cfg.detector.detector_type)
        free = ~valid
        det_slot = argsort_stable(~free)      # free slots first, stable
        n_det = det.px.shape[0]
        can_place = det.valid & (torch.arange(n_det, device=dev)
                                 < torch.sum(free.long()))
        widx = torch.where(can_place, det_slot[:n_det], frame.max_fts)
        f_new = proj.backproject(self.cam, det.px)
        ones = torch.ones((n_det,), dtype=torch.float32, device=dev)
        seeds = seed_mod.make(ones * depth_scalars[0],
                              ones * depth_scalars[1])
        frame = frame._replace(
            px=set_drop(frame.px, widx, det.px),
            f=set_drop(frame.f, widx, f_new),
            grad=set_drop(frame.grad, widx, det.grad),
            score=set_drop(frame.score, widx, det.score),
            level=set_drop(frame.level, widx, det.level),
            ftype=set_drop(frame.ftype, widx, det.ftype),
            landmark_id=set_drop(frame.landmark_id, widx, -1),
            seed_ref_kf=set_drop(frame.seed_ref_kf, widx, -1),
            seed_ref_idx=set_drop(frame.seed_ref_idx, widx, -1),
            seed_state=set_drop(frame.seed_state, widx, seeds),
            seed_mu_range=1.0 / depth_scalars[1])
        return frame, torch.sum(can_place.long())
