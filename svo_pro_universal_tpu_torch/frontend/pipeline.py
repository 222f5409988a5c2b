"""Mono VO pipeline on one device: ``DevicePipelineMono``.

Counterpart of ``svo_pro_universal_tpu/frontend/pipeline.py``. The JAX
package runs the whole state machine in one jitted program and branches with
``lax.switch`` / ``lax.cond``. PyTorch runs eagerly, so here the stage
(first frame, tracking, relocalization) is a host integer, and each frame
makes ONE small device→host read of the values the branch needs
(n_tracked, median disparity, keyframe-too-close): the keyframe step runs
only when the host decides it, instead of being computed every frame and
selected. That read, and the upload of the uint8 image, are the frame's two
synchronizations with the card; everything else is queued asynchronously.
The pose trace stays on the device until ``drain()``.

Initialization is OneShot (every first-frame feature becomes a landmark at
``cfg.init.expected_avg_depth``); FivePoint (KLT + RANSAC) is a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.common import types as ft
from svo_pro_universal_tpu_torch.common.frame import (
    FrameState, frame_map, make_empty_frame)
from svo_pro_universal_tpu_torch.common.point import (
    LandmarkPool, add_observations, allocate, make_pool)
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono, Stage, resolve_device)
from svo_pro_universal_tpu_torch.frontend.map import (
    KeyframeRing, closest_keyframe_slot, insert_keyframe, make_ring,
    ring_frame)
from svo_pro_universal_tpu_torch.ops.detector import SUPPORTED_DETECTORS
from svo_pro_universal_tpu_torch.ops.pyramid import (
    build_pyramid, image_to_float)
from svo_pro_universal_tpu_torch.utils.transform import SE3, quat_normalize


class WorldState(NamedTuple):
    """The pipeline state: device tensors plus the host-side counters the
    branches are decided on."""
    stage: int                  # Stage code (host)
    ring: KeyframeRing
    pool: LandmarkPool
    last_frame: FrameState
    T_rel_prev: SE3             # constant-velocity model
    depth_state: torch.Tensor   # [2] = (depth_median, depth_min)
    frames_since_kf: int
    prev_n_tracked: int
    reloc_trials: int
    trace_q: torch.Tensor       # [CAP, 4] T_world_cam quaternion (device)
    trace_t: torch.Tensor       # [CAP, 3] T_world_cam translation (device)
    trace_meta: np.ndarray      # [CAP, 4] (stage, n_tracked, is_kf, ts)
    trace_ptr: int


class DevicePipelineMono(FrameHandlerMono):
    """Mono VO with OneShot initialization: one tracking step per frame,
    a keyframe step when the keyframe policy fires."""

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None,
                 trace_capacity: int = 8192, device=None):
        if cfg.init.init_method != "OneShot":
            raise NotImplementedError(
                f"init_method {cfg.init.init_method!r}: the port runs "
                "OneShot; FivePoint (KLT + RANSAC) is a later slice")
        if cfg.detector.detector_type not in SUPPORTED_DETECTORS:
            raise NotImplementedError(
                f"detector_type {cfg.detector.detector_type!r}: the port "
                "runs 'fast_grad'; the other detectors are a later slice")
        dev = resolve_device(device)
        if dev.type == "cuda":
            # the dense ZMSSD scan is a cuDNN depthwise conv; TF32 there
            # (cuDNN's default) flips argmin near-ties, so keep full f32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        super().__init__(cfg, cam, T_cam_body=T_cam_body, device=dev)
        self.trace_capacity = trace_capacity
        self._t_epoch: Optional[float] = None
        self.world = self._make_world()

    def _rel_ts(self, timestamp: float) -> float:
        """Session-relative timestamp (absolute stamps do not fit f32)."""
        if self._t_epoch is None:
            self._t_epoch = float(timestamp)
        return float(timestamp) - self._t_epoch

    def _template(self) -> FrameState:
        pyr = build_pyramid(torch.zeros((self.cam.height, self.cam.width),
                                        device=self.device), self.n_levels)
        return make_empty_frame(pyr, self.max_fts, T_cam_body=self.T_cam_body)

    def _make_world(self) -> WorldState:
        cap = self.cfg.capacity
        dev = self.device
        template = self._template()
        C = self.trace_capacity
        d0 = float(self.cfg.init.expected_avg_depth)
        trace_q = torch.zeros((C, 4), dtype=torch.float32, device=dev)
        trace_q[:, 0] = 1.0
        return WorldState(
            stage=Stage.FIRST_FRAME.value,
            ring=make_ring(template, cap.max_kfs),
            pool=make_pool(cap.max_points, cap.max_obs_per_point, dev),
            last_frame=template,
            T_rel_prev=SE3.identity(device=dev),
            depth_state=torch.tensor([d0, 0.1 * d0], dtype=torch.float32,
                                     device=dev),
            frames_since_kf=0, prev_n_tracked=0, reloc_trials=0,
            trace_q=trace_q,
            trace_t=torch.zeros((C, 3), dtype=torch.float32, device=dev),
            trace_meta=np.zeros((C, 4), np.float32),
            trace_ptr=0)

    # ------------------------------------------------------------------
    # stage branches: (world, frame) → (world', n_tracked, is_kf)
    # ------------------------------------------------------------------
    def _branch_first_frame(self, world: WorldState, frame: FrameState):
        cfg = self.cfg
        frame, n_new_t = self._detect_into_frame(frame, world.depth_state)
        n_new = int(n_new_t)                      # the frame's one read
        enough = n_new >= cfg.init.init_min_features
        frame = frame._replace(is_keyframe=torch.full(
            (), enough, dtype=torch.bool, device=self.device))
        if not enough:
            return world._replace(last_frame=frame), n_new, False
        # constant-depth bootstrap (reference: OneShotInit)
        valid = frame.valid_mask()
        pts_w = frame.T_world_cam.apply(frame.f
                                        * cfg.init.expected_avg_depth)
        pool, slots = allocate(world.pool, pts_w, valid)
        pool = add_observations(
            pool, slots, torch.zeros_like(slots),
            torch.arange(self.max_fts, device=self.device), valid)
        fr = frame._replace(
            landmark_id=torch.where(valid, slots, -1),
            ftype=torch.where(valid, int(ft.FeatureType.CORNER),
                              frame.ftype))
        zero = torch.zeros((), dtype=torch.long, device=self.device)
        world = world._replace(
            stage=Stage.TRACKING.value,
            ring=insert_keyframe(world.ring, fr, zero), pool=pool,
            last_frame=fr, T_rel_prev=SE3.identity(device=self.device),
            frames_since_kf=0)
        return world, n_new, True

    def _is_keyframe(self, world: WorldState, n_tracked: int,
                     med_disp: float, too_close: bool) -> bool:
        """Keyframe decision (reference needNewKf :1012-1121) on host
        values."""
        b = self.cfg.base
        is_kf = n_tracked <= b.kfselect_numkfs_upper_thresh
        is_kf &= world.frames_since_kf >= b.kfselect_min_num_frames_between_kfs
        need_more = n_tracked < b.kfselect_numkfs_lower_thresh
        gates = True
        if b.kfselect_min_disparity > 0:
            gates &= not (np.isfinite(med_disp)
                          and med_disp < np.float32(b.kfselect_min_disparity))
        gates &= not too_close
        is_kf &= need_more or gates
        return is_kf and n_tracked >= b.quality_min_fts

    def _branch_tracking(self, world: WorldState, frame: FrameState):
        cfg = self.cfg
        ring, pool, tracked, stats = self._tracking_step(
            world.ring, world.pool, world.last_frame, frame,
            world.T_rel_prev, world.depth_state)
        n_tracked, med_disp, too_close = torch.stack([
            stats["n_tracked"].float(), stats["med_disparity"],
            stats["kf_too_close"].float()]).tolist()   # the frame's one read
        n_tracked = int(n_tracked)
        is_kf = self._is_keyframe(world, n_tracked, med_disp,
                                  bool(too_close))
        if is_kf:
            ring, pool, tracked, _, _ = self._keyframe_step(
                ring, pool, tracked, world.depth_state)
        if n_tracked < cfg.base.quality_min_fts:
            # keep the last good frame as the relocalization anchor
            world = world._replace(
                stage=Stage.RELOCALIZING.value, ring=ring, pool=pool,
                reloc_trials=0, prev_n_tracked=n_tracked)
            return world, n_tracked, False
        T_rel = tracked.T_cam_world.compose(
            world.last_frame.T_cam_world.inverse())
        dm, dmin = stats["depth_median"], stats["depth_min"]
        dm_ok = torch.isfinite(dm) & (dm > 1e-3) & (dm < 1e6)
        new_depth = torch.where(
            dm_ok, torch.stack([dm, torch.clamp(0.5 * dmin, min=1e-3)]),
            world.depth_state)
        world = world._replace(
            ring=ring, pool=pool, last_frame=tracked, T_rel_prev=T_rel,
            depth_state=new_depth,
            frames_since_kf=0 if is_kf else world.frames_since_kf + 1,
            prev_n_tracked=n_tracked)
        return world, n_tracked, is_kf

    def _branch_reloc(self, world: WorldState, frame: FrameState):
        """Relocalize against the closest keyframe (reference
        relocalizeFrame frame_handler_mono.cpp:254-279)."""
        cfg = self.cfg
        slot = closest_keyframe_slot(world.ring, world.last_frame.T_cam_world)
        kf = ring_frame(world.ring, slot)
        ring, pool, tracked, stats = self._tracking_step(
            world.ring, world.pool, kf, frame,
            SE3.identity(device=self.device), world.depth_state)
        n_tracked = int(stats["n_tracked"])             # the frame's one read
        if n_tracked >= cfg.base.quality_min_fts:
            world = world._replace(
                stage=Stage.TRACKING.value, ring=ring, pool=pool,
                last_frame=tracked,
                T_rel_prev=SE3.identity(device=self.device),
                prev_n_tracked=n_tracked)
            return world, n_tracked, False
        trials = world.reloc_trials + 1
        if trials >= cfg.base.relocalization_max_trials:
            # hard reset (reference resetVisionFrontendCommon)
            zeros = lambda x: torch.zeros_like(x)  # noqa: E731
            world = world._replace(
                stage=Stage.FIRST_FRAME.value,
                ring=KeyframeRing(frame_map(zeros, world.ring.frames),
                                  zeros(world.ring.valid),
                                  zeros(world.ring.last_added)),
                pool=LandmarkPool(*[zeros(x) for x in world.pool]),
                reloc_trials=0)
        else:
            world = world._replace(reloc_trials=trials)
        return world, n_tracked, False

    # ------------------------------------------------------------------
    def step(self, world: WorldState, img, ts: float
             ) -> tuple[WorldState, int, bool]:
        """One frame through the stage machine, trace appended."""
        pyr = build_pyramid(image_to_float(img, self.device), self.n_levels)
        frame = make_empty_frame(pyr, self.max_fts,
                                 T_cam_body=self.T_cam_body, timestamp=ts)
        if world.stage == Stage.FIRST_FRAME.value:
            world, n_tracked, is_kf = self._branch_first_frame(world, frame)
        elif world.stage == Stage.TRACKING.value:
            world, n_tracked, is_kf = self._branch_tracking(world, frame)
        elif world.stage == Stage.RELOCALIZING.value:
            world, n_tracked, is_kf = self._branch_reloc(world, frame)
        else:
            raise NotImplementedError(
                f"stage {Stage(world.stage).name}: only OneShot "
                "initialization is ported")
        T_wc = world.last_frame.T_world_cam
        p = min(world.trace_ptr, self.trace_capacity - 1)
        world.trace_q[p] = quat_normalize(T_wc.q)
        world.trace_t[p] = T_wc.t
        world.trace_meta[p] = (world.stage, n_tracked, float(is_kf), ts)
        return world._replace(trace_ptr=world.trace_ptr + 1), n_tracked, is_kf

    def add_image(self, img, timestamp: float) -> None:
        """Feed one image (uint8 [H, W], uploaded as uint8)."""
        self.world, _, _ = self.step(self.world, img,
                                     self._rel_ts(timestamp))

    @property
    def stage(self) -> Stage:
        return Stage(self.world.stage)

    def drain(self) -> tuple[np.ndarray, np.ndarray]:
        """Fetch the whole pose/meta trace: (T_world_cam [N,4,4], meta
        [N,4] = (stage, n_tracked, is_kf, ts)) as numpy."""
        n = min(self.world.trace_ptr, self.trace_capacity)
        T = SE3(self.world.trace_q[:n], self.world.trace_t[:n])
        mats = T.as_matrix().cpu().numpy()
        return mats, self.world.trace_meta[:n].copy()
