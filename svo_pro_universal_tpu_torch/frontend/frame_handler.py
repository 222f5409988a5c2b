"""Mono frontend: the stage programs and the host frame handlers.

Counterpart of ``svo_pro_universal_tpu/frontend/frame_handler.py``
(reference frame_handler_base.cpp — sparseImageAlignment:610-644,
projectMapInFrame:646-744, optimizePose:746-777, optimizeStructure:
779-826, upgradeSeedsToFeatures:828-898, needNewKf:1012-1121;
frame_handler_mono.cpp — processFrame:120-253, processFirstFrame:64-117,
relocalizeFrame:254-279).

``StagePrograms`` holds the stages: each is a function of tensors on one
device, and none of them reads the device from the host. The device
pipelines (frontend.pipeline*) and the host handlers below share them.

The host handlers (``FrameHandlerMono``, ``FrameHandlerVIO``,
``FrameHandlerStereo``, ``FrameHandlerArray``) are the system's documented
entry point: ``add_image`` returns a ``FrameResult``. Their state lives in
attributes with the JAX handler's names, and each frame makes ONE
device→host read of what its branch decides on (``_read``): on a tracked
frame the stats vector and the pose, in the bootstrap n_new, or n_ok and the
disparity, plus n_inliers on a frame that tries RANSAC. The JAX package runs
the keyframe step inside its frame program under ``lax.cond``; here it runs
when the host has read the keyframe decision's inputs, with the same
decision function as ``DevicePipelineMono`` (``is_keyframe``).
"""

from __future__ import annotations

import enum
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.common import seed as seed_mod
from svo_pro_universal_tpu_torch.common import types as ft
from svo_pro_universal_tpu_torch.common.frame import (
    FrameState, frame_map, make_empty_frame, scene_depth_stats)
from svo_pro_universal_tpu_torch.common.point import (
    LandmarkPool, add_observations, allocate,
    invalidate_keyframe_observations, make_pool)
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend import initialization as init_mod
from svo_pro_universal_tpu_torch.frontend import reprojector as repro_mod
from svo_pro_universal_tpu_torch.frontend.map import (
    KeyframeRing, closest_keyframe_slot, eviction_slot, insert_keyframe,
    make_ring, overlap_mask, ring_frame)
from svo_pro_universal_tpu_torch.ops import alignment as align_mod
from svo_pro_universal_tpu_torch.ops import depth_filter as df_mod
from svo_pro_universal_tpu_torch.ops import detector as det_mod
from svo_pro_universal_tpu_torch.ops.detector import DETECTOR_TYPES
from svo_pro_universal_tpu_torch.ops.pyramid import (
    build_pyramid, image_to_float)
from svo_pro_universal_tpu_torch.ops import matcher as matcher_mod
from svo_pro_universal_tpu_torch.ops import pose_optimizer as po_mod
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia_mod
from svo_pro_universal_tpu_torch.ops import structure_optimizer as so_mod
from svo_pro_universal_tpu_torch.utils.indexing import (
    argsort_stable, set_drop, set_drop_2d, take0, topk_stable)
from svo_pro_universal_tpu_torch.utils.perf import Tracer, traced
from svo_pro_universal_tpu_torch.utils.robust import masked_median
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, matrix_to_quat_np, quat_to_matrix, se3_log)

N_HYPOTHESES = 128     # RANSAC hypotheses of the FivePoint bootstrap


class Stage(enum.Enum):
    """reference: frame_handler_base.h:214-219."""
    PAUSED = 0
    FIRST_FRAME = 1
    INITIALIZING = 2
    TRACKING = 3
    RELOCALIZING = 4


class TrackingQuality(enum.Enum):
    INSUFFICIENT = 0
    BAD = 1
    GOOD = 2


class FrameResult(NamedTuple):
    """Host-visible per-frame output."""
    T_world_cam: np.ndarray      # 4×4
    stage: Stage
    n_tracked: int
    quality: TrackingQuality
    is_keyframe: bool


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


def zeroed_ring(ring: KeyframeRing) -> KeyframeRing:
    """A new all-zero ring of ``ring``'s shapes (the input is untouched)."""
    zeros = torch.zeros_like
    return KeyframeRing(frame_map(zeros, ring.frames), zeros(ring.valid),
                        zeros(ring.last_added))


def is_keyframe(b, frames_since_kf: int, n_tracked: int, med_disp: float,
                too_close: bool) -> bool:
    """Keyframe decision (reference needNewKf :1012-1121) on host values;
    ``b`` is ``cfg.base``. The disparity gate compares in float32, as the
    JAX package's device decision does."""
    is_kf = n_tracked <= b.kfselect_numkfs_upper_thresh
    is_kf &= frames_since_kf >= b.kfselect_min_num_frames_between_kfs
    need_more = n_tracked < b.kfselect_numkfs_lower_thresh
    gates = True
    if b.kfselect_min_disparity > 0:
        gates &= not (np.isfinite(med_disp)
                      and med_disp < np.float32(b.kfselect_min_disparity))
    gates &= not too_close
    is_kf &= need_more or gates
    return bool(is_kf and n_tracked >= b.quality_min_fts)


def secondary_align_inputs(ring, pool, last_frame: FrameState,
                           cam_body: SE3, cams: Sequence[proj.Camera],
                           T_c_c0: Sequence[SE3], pyr_last, pyr_cur
                           ) -> list:
    """One sparse-alignment ``CameraInput`` per secondary camera: cam0's
    feature points projected into it at the last frame's pose, those in
    front of it (z > 0.1) and inside its image valid, against its previous
    (``pyr_last``) and current (``pyr_cur``) pyramids (JAX
    frame_handler.py:1063-1086, 1184-1206). ``cam_body`` is cam0's
    T_cam_body."""
    xyz_w, has_pt = _feature_world_points(last_frame, ring, pool)
    out = []
    for cam, T, pl, pc in zip(cams, T_c_c0, pyr_last, pyr_cur):
        p_c = T.compose(last_frame.T_cam_world).apply(xyz_w)
        px, ok = proj.project(cam, p_c)
        depth = torch.linalg.norm(p_c, dim=-1)
        f = p_c / torch.clamp(depth[:, None], min=1e-9)
        valid = last_frame.valid_mask() & has_pt & ok & (p_c[:, 2] > 0.1)
        out.append(sia_mod.CameraInput(
            pyr_ref=pl, pyr_cur=pc, px_ref=px, f_ref=f, depth_ref=depth,
            valid=valid, T_cam_body=T.compose(cam_body), cam=cam))
    return out


class StagePrograms:
    """Mono stage programs on one device (reference FrameHandlerMono's
    stages); on the card unless ``device`` says otherwise."""

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None,
                 device: torch.device | str | None = None):
        if cfg.detector.detector_type not in DETECTOR_TYPES:
            raise ValueError(
                f"unknown detector_type {cfg.detector.detector_type!r}; "
                f"one of {DETECTOR_TYPES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        # the spans and counters of this object's frames (off until a
        # caller starts it; utils.perf)
        self.tracer = Tracer()
        if self.device.type == "cuda":
            # the dense ZMSSD scan is a cuDNN depthwise conv; TF32 there
            # (cuDNN's default) flips argmin near-ties, so keep full f32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
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
        # for the host-side gyro rotation prior of the motion model
        self._R_cam_body_np = quat_to_matrix(
            self.T_cam_body.q.detach().cpu()).numpy().astype(np.float64)

    def _template(self) -> FrameState:
        """An empty frame of the camera's size on the device."""
        pyr = build_pyramid(torch.zeros((self.cam.height, self.cam.width),
                                        device=self.device), self.n_levels)
        return make_empty_frame(pyr, self.max_fts, T_cam_body=self.T_cam_body)

    def _upload(self, img, aux: np.ndarray
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The frame's one host→device copy: ``aux`` (float32) then the
        image bytes (uint8 or float32; one image, or the rig's stacked) in
        one buffer, pinned and copied asynchronously on the card. Returns
        (image, aux) views on the device."""
        arr = np.ascontiguousarray(np.asarray(img))
        if arr.dtype not in (np.uint8, np.float32):
            arr = arr.astype(np.float32)
        buf = np.concatenate([aux.view(np.uint8), arr.reshape(-1).view(
            np.uint8)])
        host = torch.from_numpy(buf)
        if self.device.type == "cuda":
            dev = host.pin_memory().to(self.device, non_blocking=True)
        else:
            dev = host
        n = aux.nbytes
        aux_d = dev[:n].view(torch.float32)
        img_d = dev[n:].view(torch.uint8 if arr.dtype == np.uint8
                             else torch.float32).reshape(arr.shape)
        return img_d, aux_d

    @traced("pyramid_creation")
    def _pyramid(self, img) -> torch.Tensor:
        """The pyramid of one image (host array, uploaded as it is, or a
        device tensor)."""
        if not torch.is_tensor(img):
            img, _ = self._upload(img, np.zeros(0, np.float32))
        return build_pyramid(image_to_float(img, self.device), self.n_levels)

    # ------------------------------------------------------------------
    # the two bootstraps (shared by the host handlers and the pipelines)
    # ------------------------------------------------------------------
    def _oneshot_keyframe(self, ring, pool, frame):
        """OneShot (reference OneShotInit): every feature of the first
        keyframe becomes a landmark at ``cfg.init.expected_avg_depth``;
        the frame goes to ring slot 0 (in place). Returns (ring, pool,
        frame)."""
        valid = frame.valid_mask()
        pts_w = frame.T_world_cam.apply(frame.f
                                        * self.cfg.init.expected_avg_depth)
        pool, slots = allocate(pool, pts_w, valid)
        pool = add_observations(
            pool, slots, torch.zeros_like(slots),
            torch.arange(self.max_fts, device=self.device), valid)
        frame = frame._replace(
            landmark_id=torch.where(valid, slots, -1),
            ftype=torch.where(valid, int(ft.FeatureType.CORNER),
                              frame.ftype))
        ring = insert_keyframe(ring, frame, torch.zeros(
            (), dtype=torch.long, device=self.device))
        return ring, pool, frame

    def _two_view_keyframes(self, ring, pool, ref, frame, px_cur, f_cur,
                            inliers, T_cur_ref, depths, depth_scalars):
        """The second keyframe with triangulated landmarks (reference
        processSecondFrame frame_handler_mono.cpp:82-117; JAX
        frame_handler.py:828-870): inliers within 0.1–5× the expected depth
        become landmarks seen by ring slots 0 (``ref``) and 1 (the new
        keyframe, its free slots seeded at ``depth_scalars``). Both
        keyframes are written in place. Returns (ring, pool, frame)."""
        dev = self.device
        med = self.cfg.init.expected_avg_depth
        inl = inliers & (depths > 0.1 * med) & (depths < 5.0 * med)
        pts_w = ref.f * depths[:, None]
        pool, slots = allocate(pool, pts_w, inl)
        idx = torch.arange(self.max_fts, device=dev)
        pool = add_observations(pool, slots, torch.zeros_like(idx), idx, inl)
        pool = add_observations(pool, slots, torch.ones_like(idx), idx, inl)
        corner = int(ft.FeatureType.CORNER)
        ref_upd = ref._replace(
            landmark_id=torch.where(inl, slots, -1),
            ftype=torch.where(inl, corner, ref.ftype))
        ring = insert_keyframe(ring, ref_upd,
                               torch.zeros((), dtype=torch.long, device=dev))
        fr = frame._replace(
            T_cam_world=T_cur_ref.compose(ref.T_cam_world),
            px=px_cur, f=f_cur, grad=ref.grad, level=ref.level,
            ftype=torch.where(inl, corner, int(ft.FeatureType.INVALID)),
            landmark_id=torch.where(inl, slots, -1),
            is_keyframe=torch.ones((), dtype=torch.bool, device=dev))
        fr, _ = self._detect_into_frame(fr, depth_scalars)
        ring = insert_keyframe(ring, fr,
                               torch.ones((), dtype=torch.long, device=dev))
        return ring, pool, fr

    # ------------------------------------------------------------------
    def _extra_align_inputs(self, ring, pool, last_frame, extra):
        """Secondary-camera ``CameraInput``s for joint multi-camera
        alignment (JAX frame_handler.py:153-160). Mono: none; the stereo and
        array pipelines build them from ``extra`` when joint alignment is
        on."""
        return []

    @traced("sparse_img_align")
    def _stage_align(self, ring, pool, last_frame, cur_pyramid, T_prior_rel,
                     extra=None):
        """Stage 1: sparse image alignment vs the last frame, jointly over
        the rig's cameras when ``_extra_align_inputs`` gives more. Returns
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
        inputs = [inp] + self._extra_align_inputs(ring, pool, last_frame,
                                                  extra)
        align_state, align_stats = sia_mod.run(
            inputs, st0, opts,
            T_prior=(T_prior_body if cfg.base.img_align_prior_lambda_rot > 0
                     else None))
        T_cur_world = (self.T_cam_body.compose(align_state.T_icur_iref)
                       .compose(T_body_cam).compose(last_frame.T_cam_world))
        return T_cur_world, align_stats

    @traced("reproject")
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

    @traced("pose_optimizer")
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
        if xyz_cur.is_cuda:
            self.tracer.count("pose_kernel_calls")
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
        with self.tracer.span("point_optimizer"):
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
            # the frame's ms stamp as XLA converts it: to int32, saturating (at
            # EuRoC's epoch, 1.4e12 ms, torch's CPU cast would wrap to -2³¹
            # and rank the points just optimized first)
            now_i = torch.clamp((frame.timestamp * 1000.0).to(torch.float64),
                                -2.0 ** 31, 2.0 ** 31 - 1).long()
            return pool._replace(
                pos=set_drop(pool.pos, widx, so_res.xyz),
                last_structure_optim=set_drop(pool.last_structure_optim, widx,
                                              now_i))

    @traced("depth_filter")
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

    @traced("kf_policy")
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

    @traced("tracking_step")
    def _tracking_step(self, ring, pool, last_frame, cur_frame, T_prior_rel,
                       depth_scalars, extra=None):
        """Sparse align → reproject → pose opt → structure opt → seed
        update. ``extra`` carries the secondary cameras' pyramids for joint
        alignment. Returns (ring, pool, frame, stats) with device
        scalars."""
        cfg = self.cfg
        T_cur_world, align_stats = self._stage_align(
            ring, pool, last_frame, cur_frame.pyramid, T_prior_rel, extra)
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

    @traced("keyframe_step")
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
        self.tracer.count("keyframes")
        return ring, pool, frame, torch.sum(converged.long()), n_new

    @traced("klt")
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
            threshold_shitomasi=cfg.detector.threshold_shitomasi,
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


# ---------------------------------------------------------------------------
# the host handlers
# ---------------------------------------------------------------------------

class FrameHandlerMono(StagePrograms):
    """Host state machine of the mono frontend (reference
    svo::FrameHandlerMono and the Odometry facade, svo_factory.h:83-129):
    ``add_image`` runs one frame through the stage of ``self.stage`` and
    returns a ``FrameResult``. On the card unless ``device`` says otherwise. The
    RANSAC noise of the FivePoint bootstrap comes from a CPU
    ``torch.Generator`` seeded by ``seed`` (``_init_noise``)."""

    # order of the stats vector a tracked frame reads (JAX STATS_KEYS)
    STATS_KEYS = (
        "n_tracked", "n_total", "align_chi2", "align_fts",
        "reproj_matches", "reproj_trials", "pose_err_before",
        "pose_err_after", "n_inliers", "seeds_updated", "seeds_converged",
        "depth_median", "depth_min", "med_disparity", "kf_too_close",
        "is_kf", "kf_upgraded", "kf_new_seeds")

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None, seed: int = 0,
                 imu_handler=None, device=None):
        super().__init__(cfg, cam, T_cam_body=T_cam_body, device=device)
        self.stage = Stage.FIRST_FRAME
        self.seed = seed
        self.rng = torch.Generator().manual_seed(seed)
        # optional IMU: the gyro rotation prior of the motion model
        self.imu = imu_handler
        self._last_ts: Optional[float] = None
        cap = cfg.capacity
        self.ring = make_ring(self._template(), cap.max_kfs)
        self.pool = make_pool(cap.max_points, cap.max_obs_per_point,
                              self.device)
        self.last_frame: Optional[FrameState] = None
        self.T_rel_prev = SE3.identity(device=self.device)
        self.frames_since_kf = 0
        self.frame_count = 0
        self.reloc_trials = 0
        self.depth_median = float(cfg.init.expected_avg_depth)
        self.depth_min = self.depth_median * 0.1
        # the first keyframe and its KLT tracks during initialization
        self._init_ref_frame: Optional[FrameState] = None
        self._init_ref_px = None
        self._init_ref_valid = None
        self._init_px_guess = None
        self._prev_n_tracked: Optional[int] = None
        self.stats: dict = {}
        self._depth_state = self._depth_scalars()
        # device→host reads made (one per frame; VIO and SLAM add theirs)
        self.host_reads = 0

    # ------------------------------------------------------------------
    def _read(self, values: Sequence[torch.Tensor],
              poses: Sequence[SE3] = ()) -> tuple[list, list]:
        """ONE device→host transfer of 0-dim ``values`` and of the 4×4
        T_world_cam of each T_cam_world in ``poses`` (float32, as the JAX
        package's ``as_matrix``). Returns (floats, matrices)."""
        parts = [torch.stack([v.to(torch.float64) for v in values])]
        parts += [T.inverse().as_matrix().reshape(-1).to(torch.float64)
                  for T in poses]
        out = np.asarray(self.tracer.read(torch.cat(parts)), np.float64)
        self.host_reads += 1
        n = len(values)
        mats = [out[n + 16 * i:n + 16 * (i + 1)].reshape(4, 4).astype(
            np.float32) for i in range(len(poses))]
        return out[:n].tolist(), mats

    def _init_noise(self, n_hyp: int, n: int) -> torch.Tensor:
        """Gumbel noise [n_hyp, n] of one RANSAC call."""
        return init_mod.gumbel_noise(self.rng, (n_hyp, n), self.device)

    def _depth_scalars(self) -> torch.Tensor:
        return torch.tensor([self.depth_median, self.depth_min],
                            dtype=torch.float32).to(self.device)

    def _make_frame(self, img, timestamp: float,
                    frame_id: Optional[int] = None) -> FrameState:
        return make_empty_frame(
            self._pyramid(img), self.max_fts, T_cam_body=self.T_cam_body,
            frame_id=-1 if frame_id is None else frame_id,
            timestamp=timestamp)

    def add_imu_measurement(self, t: float, gyro, acc) -> None:
        """reference: Odometry::addImuMeasurement svo_factory.cpp:401-414."""
        if self.imu is not None:
            self.imu.add_measurement(t, gyro, acc)

    def _motion_prior(self, timestamp: float) -> SE3:
        """Constant-velocity translation + (with an IMU) the gyro rotation
        prior, integrated on the host (reference getMotionPrior
        frame_handler_base.cpp:313-360)."""
        if self.imu is None or self._last_ts is None:
            return self.T_rel_prev
        R = self.imu.relative_rotation_prior_np(
            self._last_ts, timestamp, self._R_cam_body_np)
        q = torch.from_numpy(matrix_to_quat_np(R)).to(self.device)
        return SE3(q, self.T_rel_prev.t)

    def add_image(self, img, timestamp: float) -> FrameResult:
        """Feed one image (uint8 [H, W], uploaded as uint8)."""
        self.frame_count += 1
        with self.tracer.frame(self.frame_count):
            if self.stage == Stage.TRACKING:
                out = self._process_tracking(img, timestamp)
            else:
                frame = self._make_frame(img, timestamp, self.frame_count)
                if self.stage == Stage.FIRST_FRAME:
                    out = self._process_first_frame(frame)
                elif self.stage == Stage.INITIALIZING:
                    out = self._process_init(frame)
                else:
                    out = self._process_reloc(frame)
        self._last_ts = timestamp
        return out

    def _process_first_frame(self, frame: FrameState) -> FrameResult:
        frame, n_new_t = self._detect_into_frame(frame, self._depth_scalars())
        (n_new,), (T,) = self._read([n_new_t], [frame.T_cam_world])
        n_new = int(n_new)
        if n_new < self.cfg.init.init_min_features:
            return FrameResult(T, self.stage, 0,
                               TrackingQuality.INSUFFICIENT, False)
        frame = frame._replace(
            is_keyframe=torch.ones((), dtype=torch.bool, device=self.device))
        if self.cfg.init.init_method == "OneShot":
            self.ring, self.pool, frame = self._oneshot_keyframe(
                self.ring, self.pool, frame)
            self.last_frame = frame
            self.T_rel_prev = SE3.identity(device=self.device)
            self.frames_since_kf = 0
            self.stage = Stage.TRACKING
            return FrameResult(T, self.stage, n_new, TrackingQuality.GOOD,
                               True)
        self.ring = insert_keyframe(self.ring, frame, torch.zeros(
            (), dtype=torch.long, device=self.device))
        self.last_frame = frame
        self._init_ref_frame = frame
        self._init_ref_px = frame.px
        self._init_ref_valid = frame.valid_mask()
        self._init_px_guess = frame.px       # incremental KLT guesses
        self.stage = Stage.INITIALIZING
        return FrameResult(T, self.stage, n_new, TrackingQuality.GOOD, True)

    @traced("init_step")
    def _process_init(self, frame: FrameState) -> FrameResult:
        """KLT tracks from the first keyframe + RANSAC relative pose
        (reference FivePointInit initialization.cpp:292-347)."""
        cfg = self.cfg
        ref = self._init_ref_frame
        px_cur, ok = self._klt_track(ref, frame.pyramid, self._init_ref_px,
                                     self._init_ref_valid,
                                     self._init_px_guess)
        # failed tracks keep their last good guess
        self._init_px_guess = torch.where(ok[:, None], px_cur,
                                          self._init_px_guess)
        (n_ok, disp), (T,) = self._read(
            [torch.sum(ok.long()),
             init_mod.disparity(self._init_ref_px, px_cur, ok)],
            [frame.T_cam_world])
        n_ok = int(n_ok)
        if n_ok < cfg.init.init_min_tracked:
            # lost too many tracks → restart initialization
            self.stage = Stage.FIRST_FRAME
            self.ring = zeroed_ring(self.ring)
            return FrameResult(T, self.stage, n_ok,
                               TrackingQuality.INSUFFICIENT, False)
        if disp < cfg.init.init_min_disparity:
            self.last_frame = frame
            return FrameResult(T, self.stage, n_ok, TrackingQuality.GOOD,
                               False)
        f_cur = proj.backproject(self.cam, px_cur)
        with self.tracer.span("ransac"):
            res = init_mod.ransac_relative_pose(
                ref.f, f_cur, ok,
                self._init_noise(N_HYPOTHESES, self.max_fts),
                self.cam.focal_length,
                reproj_thresh_px=cfg.init.reproj_error_thresh)
        T_cur_ref, depths, _ = init_mod.rescale_to_mean_depth(
            res.T_cur_ref, res.depth_ref, res.inliers,
            cfg.init.expected_avg_depth)
        (n_inl,), (T_kf,) = self._read(
            [res.n_inliers], [T_cur_ref.compose(ref.T_cam_world)])
        n_inl = int(n_inl)
        if n_inl < cfg.init.init_min_inliers:
            self.last_frame = frame
            return FrameResult(T, self.stage, n_ok,
                               TrackingQuality.INSUFFICIENT, False)
        self._finish_init(frame, px_cur, f_cur, ok & res.inliers,
                          T_cur_ref, depths)
        return FrameResult(T_kf, self.stage, n_inl, TrackingQuality.GOOD,
                           True)

    def _finish_init(self, frame, px_cur, f_cur, inliers, T_cur_ref, depths):
        """The second keyframe (reference processSecondFrame
        frame_handler_mono.cpp:82-117)."""
        self.depth_median = float(self.cfg.init.expected_avg_depth)
        self.depth_min = self.depth_median * 0.1
        self.ring, self.pool, frame = self._two_view_keyframes(
            self.ring, self.pool, self._init_ref_frame, frame, px_cur, f_cur,
            inliers, T_cur_ref, depths, self._depth_scalars())
        self.last_frame = frame
        self.T_rel_prev = SE3.identity(device=self.device)
        self.frames_since_kf = 0
        self.stage = Stage.TRACKING

    def _align_extra(self):
        """Secondary-camera pyramids for joint alignment (stereo/array)."""
        return None

    def _process_tracking(self, img, timestamp: float) -> FrameResult:
        """The tracking step, one read of its stats vector and the pose,
        the keyframe step when the decision fires."""
        cur = self._make_frame(img, timestamp)
        ring, pool, frame, stats = self._tracking_step(
            self.ring, self.pool, self.last_frame, cur,
            self._motion_prior(timestamp), self._depth_state,
            self._align_extra())
        keys = self.STATS_KEYS[:15]
        sv, (T,) = self._read([stats[k] for k in keys],
                              [frame.T_cam_world])      # the frame's read
        st = dict(zip(keys, sv))
        n_tracked = int(st["n_tracked"])
        is_kf = is_keyframe(self.cfg.base, self.frames_since_kf, n_tracked,
                            st["med_disparity"], bool(st["kf_too_close"]))
        n_up = n_new = 0.0
        if is_kf:
            # the keyframe's counts stay on the device (read on demand)
            ring, pool, frame, n_up, n_new = self._keyframe_step(
                ring, pool, frame, self._depth_state)
        self.stats = st | {"is_kf": float(is_kf), "kf_upgraded": n_up,
                           "kf_new_seeds": n_new}

        quality = self._check_quality(n_tracked)
        if quality == TrackingQuality.INSUFFICIENT:
            # keep the last good frame as the relocalization anchor
            self.ring, self.pool = ring, pool
            self.stage = Stage.RELOCALIZING
            self.reloc_trials = 0
            return FrameResult(T, self.stage, n_tracked, quality, False)

        T_rel = frame.T_cam_world.compose(self.last_frame.T_cam_world
                                          .inverse())
        dm, dmin = stats["depth_median"], stats["depth_min"]
        dm_ok = torch.isfinite(dm) & (dm > 1e-3) & (dm < 1e6)
        self._depth_state = torch.where(
            dm_ok, torch.stack([dm, torch.clamp(0.5 * dmin, min=1e-3)]),
            self._depth_state)
        self.ring, self.pool, self.last_frame = ring, pool, frame
        self.T_rel_prev = T_rel
        if 1e-3 < st["depth_median"] < 1e6:
            self.depth_median = st["depth_median"]
        if 1e-3 < st["depth_min"] < 1e6:
            self.depth_min = max(0.5 * st["depth_min"], 1e-3)
        self.frames_since_kf = 0 if is_kf else self.frames_since_kf + 1
        return FrameResult(T, self.stage, n_tracked, quality, is_kf)

    def _check_quality(self, n_tracked: int) -> TrackingQuality:
        """reference: setTrackingQuality frame_handler_base.cpp:991-1009."""
        if n_tracked < self.cfg.base.quality_min_fts:
            return TrackingQuality.INSUFFICIENT
        prev = (n_tracked if self._prev_n_tracked is None
                else self._prev_n_tracked)
        self._prev_n_tracked = n_tracked
        if prev - n_tracked > self.cfg.base.quality_max_fts_drop:
            return TrackingQuality.BAD
        return TrackingQuality.GOOD

    @traced("reloc_step")
    def _process_reloc(self, frame: FrameState) -> FrameResult:
        """Relocalize against the closest keyframe by re-running tracking
        with it as the reference (reference relocalizeFrame
        frame_handler_mono.cpp:254-279). A failed trial leaves ring and
        pool as they were: the tracking step writes new tensors."""
        self.reloc_trials += 1
        kf = ring_frame(self.ring, closest_keyframe_slot(
            self.ring, self.last_frame.T_cam_world))
        ring, pool, tracked, stats = self._tracking_step(
            self.ring, self.pool, kf, frame,
            SE3.identity(device=self.device), self._depth_scalars())
        (n_tracked,), (T_tr, T) = self._read(
            [stats["n_tracked"]], [tracked.T_cam_world, frame.T_cam_world])
        n_tracked = int(n_tracked)
        if n_tracked >= self.cfg.base.quality_min_fts:
            self.ring, self.pool = ring, pool
            self.last_frame = tracked
            self.T_rel_prev = SE3.identity(device=self.device)
            self.stage = Stage.TRACKING
            return FrameResult(T_tr, self.stage, n_tracked,
                               TrackingQuality.GOOD, False)
        if self.reloc_trials >= self.cfg.base.relocalization_max_trials:
            # hard reset (reference resetVisionFrontendCommon)
            self.stage = Stage.FIRST_FRAME
            self.ring = zeroed_ring(self.ring)
            self.pool = make_pool(self.cfg.capacity.max_points,
                                  self.cfg.capacity.max_obs_per_point,
                                  self.device)
        return FrameResult(T, self.stage, n_tracked,
                           TrackingQuality.INSUFFICIENT, False)


class FrameHandlerVIO(FrameHandlerMono):
    """Mono VIO: gyro priors in the frontend + the sliding-window VI bundle
    adjustment on every keyframe (reference kMonoIMU with the ceres backend
    attached, frame_handler_base.cpp:263-311). The backend is the device
    backend's host API (``DeviceBackend.add_keyframe_device``); each
    backend call reads its applied scale and chi2 once. The per-frame
    structure stage keeps its budget (``structure_optimization_max_pts``),
    as the JAX host handler does."""

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None, seed: int = 0,
                 imu_handler=None, imu_params=None, gravity=None,
                 device=None):
        super().__init__(cfg, cam, T_cam_body=T_cam_body, seed=seed,
                         imu_handler=imu_handler, device=device)
        from svo_pro_universal_tpu_torch.backend import window_ba as wba_mod
        from svo_pro_universal_tpu_torch.backend.device_interface import (
            DeviceBackend)
        opts = wba_mod.BAOptions(
            max_iter=cfg.backend.max_iterations,
            gravity=tuple(gravity) if gravity is not None
            else (0.0, 0.0, -9.81))
        self.backend = DeviceBackend(
            self.cam.focal_length, self.T_cam_body,
            num_keyframes=cfg.backend.num_keyframes,
            imu_params=imu_params, opts=opts, backend_cfg=cfg.backend,
            device=self.device, tracer=self.tracer)
        self._last_backend_chi2: Optional[float] = None

    def _process_tracking(self, img, timestamp: float) -> FrameResult:
        res = super()._process_tracking(img, timestamp)
        # the latest backend result stays visible in every frame's stats
        if self._last_backend_chi2 is not None:
            self.stats["backend_chi2"] = self._last_backend_chi2
        if res.is_keyframe:
            with self.tracer.span("backend_step"):
                T_new, chi2 = self.backend.add_keyframe_device(
                    timestamp, self.last_frame, self.pool,
                    imu_handler=self.imu)
                with self.tracer.span("backend_apply"):
                    ring, pool, frame, s, _ = self.backend._apply_program(
                        self.backend.state, self.ring, self.pool,
                        self.last_frame, T_new, chi2)
                self.ring, self.pool, self.last_frame = ring, pool, frame
                (sf, c2), _ = self._read([s, chi2])  # the backend's read
            # the common-mode scale rescales the host's scene-depth scalars
            # and the constant-velocity model
            self.depth_median *= sf
            self.depth_min *= sf
            self.T_rel_prev = SE3(self.T_rel_prev.q, self.T_rel_prev.t * sf)
            self.stats["backend_chi2"] = c2
            self._last_backend_chi2 = c2
        return res


def copied_ring(ring: KeyframeRing) -> KeyframeRing:
    """A copy of ``ring`` that an in-place insert may write without
    touching ``ring``."""
    return KeyframeRing(frame_map(torch.clone, ring.frames),
                        ring.valid.clone(), ring.last_added.clone())


class RigHandlerBase(FrameHandlerMono):
    """What the stereo and array handlers share (JAX
    frame_handler.py:1008-1247): cam0 tracks and aligns jointly with the
    secondary cameras (their previous and current pyramids), the first
    frame with enough triangulated landmarks bootstraps with metric scale,
    and every keyframe's fresh seeds are triangulated. A subclass names the
    triangulation (``_triangulate_keyframe``) and whether a failed
    bootstrap keeps its frame as ``last_frame`` (the array does, as JAX's
    does)."""

    _failed_bootstrap_keeps_frame = False

    def __init__(self, cfg: Config, cams, T_body_cams, seed: int,
                 device):
        super().__init__(cfg, cams[0], T_cam_body=T_body_cams[0].inverse(),
                         seed=seed, device=device)
        from svo_pro_universal_tpu_torch.frontend import (
            stereo_triangulation as st)
        self._st = st
        dev = self.device
        self._sec_cams = [c.to(dev) for c in cams[1:]]
        self._sec_T = []                                      # T_ci_c0
        for Tb in T_body_cams[1:]:
            T = Tb.inverse().compose(T_body_cams[0])
            self._sec_T.append(SE3(T.q.to(dev), T.t.to(dev)))
        self._st_opts = st.options_from_config(cfg)
        self._pyrs_cur: Optional[list] = None
        self._pyrs_last: Optional[list] = None

    def _triangulate_keyframe(self, ring, pool, frame):
        """(ring, pool, frame, n promoted) of the keyframe ``frame``'s
        fresh seeds against the current secondary pyramids."""
        raise NotImplementedError

    def _add_views(self, images, timestamp: float) -> FrameResult:
        if len(images) != 1 + len(self._sec_cams):
            raise ValueError(f"{len(images)} images for "
                             f"{1 + len(self._sec_cams)} cameras")
        self._pyrs_last = self._pyrs_cur
        self._pyrs_cur = [self._pyramid(im) for im in images[1:]]
        return self.add_image(images[0], timestamp)

    def _align_extra(self):
        if self._pyrs_last is None:
            return None
        return dict(pyr_last=list(self._pyrs_last),
                    pyr_cur=list(self._pyrs_cur))

    def _extra_align_inputs(self, ring, pool, last_frame, extra):
        """Joint alignment on every camera of the rig (JAX
        frame_handler.py:1063-1086, 1184-1206)."""
        if extra is None:
            return []
        return secondary_align_inputs(
            ring, pool, last_frame, self.T_cam_body, self._sec_cams,
            self._sec_T, extra["pyr_last"], extra["pyr_cur"])

    def _process_first_frame(self, frame: FrameState) -> FrameResult:
        """Detect, write ring slot 0, triangulate; TRACKING with metric
        scale when enough landmarks stick (reference
        frame_handler_stereo.cpp processFirstFrame). The triangulation runs
        on a copy of the ring, so a frame with too few detections leaves
        ring and pool as they were; too few landmarks empty the map."""
        cfg = self.cfg
        frame, n_new_t = self._detect_into_frame(frame, self._depth_scalars())
        frame = frame._replace(
            is_keyframe=torch.ones((), dtype=torch.bool, device=self.device))
        ring = insert_keyframe(copied_ring(self.ring), frame, torch.zeros(
            (), dtype=torch.long, device=self.device))
        ring, pool, fr, n_lm_t = self._triangulate_keyframe(ring, self.pool,
                                                            frame)
        (n_new, n_lm), (T,) = self._read([n_new_t, n_lm_t],
                                         [frame.T_cam_world])
        if n_new < cfg.init.init_min_features:
            return FrameResult(T, self.stage, 0,
                               TrackingQuality.INSUFFICIENT, False)
        n_lm = int(n_lm)
        if n_lm < cfg.init.init_min_inliers:
            # not enough metric landmarks → empty map, retry next frame
            self.ring = zeroed_ring(self.ring)
            self.pool = make_pool(cfg.capacity.max_points,
                                  cfg.capacity.max_obs_per_point,
                                  self.device)
            if self._failed_bootstrap_keeps_frame:
                self.last_frame = fr
            return FrameResult(T, self.stage, n_lm,
                               TrackingQuality.INSUFFICIENT, False)
        self.ring, self.pool, self.last_frame = ring, pool, fr
        self.T_rel_prev = SE3.identity(device=self.device)
        self.frames_since_kf = 0
        self.stage = Stage.TRACKING
        return FrameResult(T, self.stage, n_lm, TrackingQuality.GOOD, True)

    def _process_init(self, frame: FrameState) -> FrameResult:
        # a calibrated rig never needs the monocular two-view bootstrap
        return self._process_first_frame(frame)

    def _process_tracking(self, img, timestamp: float) -> FrameResult:
        res = super()._process_tracking(img, timestamp)
        if res.is_keyframe:
            self.ring, self.pool, self.last_frame, _ = \
                self._triangulate_keyframe(self.ring, self.pool,
                                           self.last_frame)
        return res


class FrameHandlerStereo(RigHandlerBase):
    """Stereo (reference FrameHandlerStereo frame_handler_stereo.cpp:66-213
    + StereoTriangulation stereo_triangulation.cpp:23-141): metric
    bootstrap from one pair, cam0 tracking aligned jointly on both cameras,
    stereo re-triangulation at every keyframe."""

    def __init__(self, cfg: Config, cam0: proj.Camera, cam1: proj.Camera,
                 T_body_cam0: SE3, T_body_cam1: SE3, seed: int = 0,
                 device=None):
        super().__init__(cfg, [cam0, cam1], [T_body_cam0, T_body_cam1],
                         seed, device)

    @property
    def cam1(self) -> proj.Camera:
        return self._sec_cams[0]

    @property
    def T_c1_c0(self) -> SE3:
        return self._sec_T[0]

    def _triangulate_keyframe(self, ring, pool, frame):
        """Promote the keyframe's fresh seeds matched in cam1 straight to
        metric landmarks (JAX ``_stereo_landmarks``)."""
        out = self._st.promote_seeds(ring, pool, frame, self._pyrs_cur,
                                     self.cam, self._sec_cams, self._sec_T,
                                     self._st_opts)
        self.stats["kf_stereo_landmarks"] = out[3]       # read on demand
        return out

    def _process_first_frame(self, frame: FrameState) -> FrameResult:
        res = super()._process_first_frame(frame)
        if res.stage == Stage.TRACKING:
            self.stats = {}
        return res

    def add_image_pair(self, img0, img1, timestamp: float) -> FrameResult:
        """Feed one stereo pair (uint8 [H, W] each)."""
        return self._add_views((img0, img1), timestamp)


class FrameHandlerArray(RigHandlerBase):
    """N-camera rig (reference FrameHandlerArray
    frame_handler_array.cpp:38-204): at each keyframe the fresh seeds are
    triangulated against each secondary camera in turn, N−1 pair
    triangulations each promoting its matches (JAX
    frame_handler.py:1063-1131)."""

    _failed_bootstrap_keeps_frame = True

    def __init__(self, cfg: Config, cams, T_body_cams, seed: int = 0,
                 device=None):
        if len(cams) < 2 or len(cams) != len(T_body_cams):
            raise ValueError("an array needs ≥ 2 cameras, each with its "
                             "T_body_cam")
        super().__init__(cfg, cams, T_body_cams, seed, device)

    @property
    def cams(self) -> list:
        return [self.cam] + self._sec_cams

    def _triangulate_keyframe(self, ring, pool, frame):
        """Each secondary camera's pair triangulation in turn (JAX
        ``_triangulate_all_pairs``)."""
        n_total = torch.zeros((), dtype=torch.long, device=self.device)
        for pyr, cam, T in zip(self._pyrs_cur, self._sec_cams, self._sec_T):
            ring, pool, frame, n = self._st.promote_seeds(
                ring, pool, frame, [pyr], self.cam, [cam], [T],
                self._st_opts)
            n_total = n_total + n
        self.stats["kf_array_landmarks"] = n_total       # read on demand
        return ring, pool, frame, n_total

    def add_image_bundle(self, images, timestamp: float) -> FrameResult:
        """images: one per camera (uint8 [H, W]), cam0 first."""
        return self._add_views(images, timestamp)
