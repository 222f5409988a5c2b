"""Mono VO pipeline on one device: ``DevicePipelineMono``.

Counterpart of ``svo_pro_universal_tpu/frontend/pipeline.py``. The JAX
package runs the whole state machine in one jitted program and branches with
``lax.switch`` / ``lax.cond``. PyTorch runs eagerly, so here the stage
(first frame, initializing, tracking, relocalization) is a host integer, and
each frame makes ONE small device→host read of the values the branch needs
(tracking: n_tracked, median disparity, keyframe-too-close; initializing:
n_tracked and disparity, plus n_inliers on a frame that tries RANSAC): the
keyframe step and the two-view bootstrap run only when the host decides it,
instead of being computed every frame and selected. That read, and the
upload of the uint8 image, are the frame's synchronizations with the card
(the RANSAC's eigh/SVD add their own on the few frames that run it);
everything else is queued asynchronously. The pose trace stays on the
device until ``drain()``; ``block()`` waits for the queued work and reads
nothing back, and ``sync=True`` makes ``add_image`` return the frame's
``FrameResult`` (one more read; JAX pipeline.py:77-87, 442-452).

Initialization: OneShot (every first-frame feature becomes a landmark at
``cfg.init.expected_avg_depth``) or, for every other ``init_method`` as in
the JAX package, FivePoint: KLT tracks from the first keyframe plus the
batched 8-point LO-RANSAC (frontend.initialization), whose Gumbel noise is
drawn from a CPU ``torch.Generator`` seeded by ``seed``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.common.frame import (
    FrameState, make_empty_frame)
from svo_pro_universal_tpu_torch.common.point import (
    LandmarkPool, make_pool)
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend import initialization as init_mod
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    N_HYPOTHESES, FrameResult, Stage, StagePrograms, TrackingQuality,
    is_keyframe)
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    zeroed_ring as _zeroed)
from svo_pro_universal_tpu_torch.frontend.map import (
    KeyframeRing, closest_keyframe_slot, insert_keyframe, make_ring,
    ring_frame)
from svo_pro_universal_tpu_torch.ops.pyramid import (
    build_pyramid, image_to_float)
from svo_pro_universal_tpu_torch.utils.perf import traced
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, matrix_to_quat_np, quat_normalize)


class WorldState(NamedTuple):
    """The pipeline state: device tensors plus the host-side counters the
    branches are decided on."""
    stage: int                  # Stage code (host)
    ring: KeyframeRing
    pool: LandmarkPool
    last_frame: FrameState
    init_ref: FrameState        # first keyframe during initialization
    init_px: torch.Tensor       # [N, 2] incremental KLT guesses (init)
    T_rel_prev: SE3             # constant-velocity model
    depth_state: torch.Tensor   # [2] = (depth_median, depth_min)
    frames_since_kf: int
    prev_n_tracked: int
    reloc_trials: int
    rng: torch.Generator        # CPU generator of the RANSAC noise
    trace_q: torch.Tensor       # [CAP, 4] T_world_cam quaternion (device)
    trace_t: torch.Tensor       # [CAP, 3] T_world_cam translation (device)
    trace_meta: np.ndarray      # [CAP, 4] (stage, n_tracked, is_kf, ts)
    trace_ptr: int


class DevicePipelineMono(StagePrograms):
    """Mono VO: one tracking step per frame, a keyframe step when the
    keyframe policy fires, OneShot or FivePoint initialization.

    ``sync=True`` makes ``add_image`` return the frame's ``FrameResult``
    (tests, debugging); the default returns None."""

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None, seed: int = 0,
                 imu_handler=None, trace_capacity: int = 8192,
                 sync: bool = False, device=None):
        super().__init__(cfg, cam, T_cam_body=T_cam_body, device=device)
        self.sync = sync
        self.frame_count = 0
        self.seed = seed
        self.imu = imu_handler
        self._last_ts: Optional[float] = None
        self.trace_capacity = trace_capacity
        self._t_epoch: Optional[float] = None
        self.world = self._make_world()

    def _rel_ts(self, timestamp: float) -> float:
        """Session-relative timestamp (absolute stamps do not fit f32)."""
        if self._t_epoch is None:
            self._t_epoch = float(timestamp)
        return float(timestamp) - self._t_epoch

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
            last_frame=template, init_ref=template,
            init_px=torch.zeros((self.max_fts, 2), dtype=torch.float32,
                                device=dev),
            T_rel_prev=SE3.identity(device=dev),
            depth_state=torch.tensor([d0, 0.1 * d0], dtype=torch.float32,
                                     device=dev),
            frames_since_kf=0, prev_n_tracked=0, reloc_trials=0,
            rng=torch.Generator().manual_seed(self.seed),
            trace_q=trace_q,
            trace_t=torch.zeros((C, 3), dtype=torch.float32, device=dev),
            trace_meta=np.zeros((C, 4), np.float32),
            trace_ptr=0)

    def _init_noise(self, world: WorldState, n_hyp: int, n: int
                    ) -> torch.Tensor:
        """Gumbel noise [n_hyp, n] of one RANSAC call, from the world's
        CPU generator."""
        return init_mod.gumbel_noise(world.rng, (n_hyp, n), self.device)

    def _device_align_extra(self, world: WorldState):
        """The secondary cameras' pyramids for joint alignment, read from
        the world (JAX pipeline.py:266-269); the stereo and array pipelines
        override it. Mono: none."""
        return None

    def _reset_world_extras(self, world):
        """Hook for subclasses to clear their extra world fields on a full
        restart (initialization lost, relocalization given up); the VIO
        pipeline empties its backend window here."""
        return world

    # ------------------------------------------------------------------
    # stage branches: (world, frame, ts, T_prior_rel) → (world', n_tracked,
    # is_kf)
    # ------------------------------------------------------------------
    def _branch_first_frame(self, world: WorldState, frame: FrameState,
                            ts: float, T_prior_rel: SE3):
        cfg = self.cfg
        frame, n_new_t = self._detect_into_frame(frame, world.depth_state)
        n_new = self.tracer.read(n_new_t)          # the frame's one read
        enough = n_new >= cfg.init.init_min_features
        frame = frame._replace(is_keyframe=torch.full(
            (), enough, dtype=torch.bool, device=self.device))
        if not enough:
            return world._replace(last_frame=frame), n_new, False
        if cfg.init.init_method != "OneShot":
            # FivePoint: the first keyframe; KLT tracks from it until the
            # two-view bootstrap succeeds
            zero = torch.zeros((), dtype=torch.long, device=self.device)
            world = world._replace(
                stage=Stage.INITIALIZING.value,
                ring=insert_keyframe(world.ring, frame, zero),
                last_frame=frame, init_ref=frame, init_px=frame.px)
            return world, n_new, True
        ring, pool, fr = self._oneshot_keyframe(world.ring, world.pool, frame)
        world = world._replace(
            stage=Stage.TRACKING.value, ring=ring, pool=pool,
            last_frame=fr, T_rel_prev=SE3.identity(device=self.device),
            frames_since_kf=0)
        return world, n_new, True

    @traced("init_step")
    def _branch_init(self, world: WorldState, frame: FrameState,
                     ts: float, T_prior_rel: SE3):
        """Second-keyframe search: KLT tracks + RANSAC relative pose
        (reference processSecondFrame frame_handler_mono.cpp:82-117,
        FivePointInit initialization.cpp:292-347; JAX pipeline.py:176-264).
        The KLT of each frame starts from the previous frame's tracks."""
        cfg = self.cfg
        dev = self.device
        ref = world.init_ref
        px_cur, ok = self._klt_track(ref, frame.pyramid, ref.px,
                                     ref.valid_mask(), world.init_px)
        world = world._replace(
            init_px=torch.where(ok[:, None], px_cur, world.init_px))
        n_ok_t = torch.sum(ok.long())
        disp_t = init_mod.disparity(ref.px, px_cur, ok)
        n_ok, disp = self.tracer.read(torch.stack([n_ok_t.float(), disp_t]))
        n_ok = int(n_ok)                           # the frame's one read
        if n_ok < cfg.init.init_min_tracked:
            # lost too many tracks → restart initialization from scratch
            world = self._reset_world_extras(world._replace(
                stage=Stage.FIRST_FRAME.value, ring=_zeroed(world.ring),
                last_frame=frame))
            return world, n_ok, False
        if not disp >= np.float32(cfg.init.init_min_disparity):
            return world._replace(last_frame=frame), n_ok, False

        f_cur = proj.backproject(self.cam, px_cur)
        with self.tracer.span("ransac"):
            res = init_mod.ransac_relative_pose(
                ref.f, f_cur, ok, self._init_noise(world, N_HYPOTHESES,
                                                   self.max_fts),
                self.cam.focal_length,
                reproj_thresh_px=cfg.init.reproj_error_thresh)
        T_cur_ref, depths, _ = init_mod.rescale_to_mean_depth(
            res.T_cur_ref, res.depth_ref, res.inliers,
            cfg.init.expected_avg_depth)
        n_inliers = int(self.tracer.read(res.n_inliers))    # second read
        if n_inliers < cfg.init.init_min_inliers:
            return world._replace(last_frame=frame), n_ok, False

        med = cfg.init.expected_avg_depth
        d0 = torch.tensor([med, 0.1 * med], dtype=torch.float32, device=dev)
        ring, pool, fr = self._two_view_keyframes(
            world.ring, world.pool, ref, frame, px_cur, f_cur,
            ok & res.inliers, T_cur_ref, depths, d0)
        world = world._replace(
            stage=Stage.TRACKING.value, ring=ring, pool=pool, last_frame=fr,
            init_ref=fr,        # drop the stale reference
            T_rel_prev=SE3.identity(device=dev), depth_state=d0,
            frames_since_kf=0)
        return world, n_ok, True

    def _branch_tracking(self, world: WorldState, frame: FrameState,
                         ts: float, T_prior_rel: SE3):
        cfg = self.cfg
        ring, pool, tracked, stats = self._tracking_step(
            world.ring, world.pool, world.last_frame, frame, T_prior_rel,
            world.depth_state, self._device_align_extra(world))
        n_tracked, med_disp, too_close = self.tracer.read(torch.stack([
            stats["n_tracked"].float(), stats["med_disparity"],
            stats["kf_too_close"].float()]))           # the frame's one read
        n_tracked = int(n_tracked)
        is_kf = is_keyframe(cfg.base, world.frames_since_kf, n_tracked,
                            med_disp, bool(too_close))
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

    @traced("reloc_step")
    def _branch_reloc(self, world: WorldState, frame: FrameState,
                      ts: float, T_prior_rel: SE3):
        """Relocalize against the closest keyframe (reference
        relocalizeFrame frame_handler_mono.cpp:254-279)."""
        cfg = self.cfg
        slot = closest_keyframe_slot(world.ring, world.last_frame.T_cam_world)
        kf = ring_frame(world.ring, slot)
        ring, pool, tracked, stats = self._tracking_step(
            world.ring, world.pool, kf, frame,
            SE3.identity(device=self.device), world.depth_state)
        n_tracked = int(self.tracer.read(stats["n_tracked"]))  # one read
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
            world = self._reset_world_extras(world._replace(
                stage=Stage.FIRST_FRAME.value, ring=_zeroed(world.ring),
                pool=LandmarkPool(*[torch.zeros_like(x)
                                    for x in world.pool]),
                reloc_trials=0))
        else:
            world = world._replace(reloc_trials=trials)
        return world, n_tracked, False

    # ------------------------------------------------------------------
    def _run_state_machine(self, world: WorldState, frame: FrameState,
                           ts: float, T_prior_rel: SE3
                           ) -> tuple[WorldState, int, bool]:
        """One frame through the stage branch of ``world.stage``, trace
        appended."""
        branch = {Stage.FIRST_FRAME.value: self._branch_first_frame,
                  Stage.INITIALIZING.value: self._branch_init,
                  Stage.TRACKING.value: self._branch_tracking,
                  Stage.RELOCALIZING.value: self._branch_reloc}[world.stage]
        world, n_tracked, is_kf = branch(world, frame, ts, T_prior_rel)
        T_wc = world.last_frame.T_world_cam
        p = min(world.trace_ptr, self.trace_capacity - 1)
        world.trace_q[p] = quat_normalize(T_wc.q)
        world.trace_t[p] = T_wc.t
        world.trace_meta[p] = (world.stage, n_tracked, float(is_kf), ts)
        return world._replace(trace_ptr=world.trace_ptr + 1), n_tracked, is_kf

    def step(self, world: WorldState, img, ts: float,
             T_prior_rel: Optional[SE3] = None
             ) -> tuple[WorldState, int, bool]:
        """One frame (uint8 [H, W]) through the stage machine, trace
        appended. ``T_prior_rel`` (default: the constant-velocity model)
        seeds the tracking step's alignment."""
        with self.tracer.span("pyramid_creation"):
            pyr = build_pyramid(image_to_float(img, self.device),
                                self.n_levels)
        frame = make_empty_frame(pyr, self.max_fts,
                                 T_cam_body=self.T_cam_body, timestamp=ts)
        if T_prior_rel is None:
            T_prior_rel = world.T_rel_prev
        return self._run_state_machine(world, frame, ts, T_prior_rel)

    def _motion_prior(self, timestamp: float) -> SE3:
        """Constant-velocity translation with, given an IMU, the gyro
        rotation prior integrated on the host (JAX pipeline.py:430-440)."""
        if self.imu is None or self._last_ts is None:
            return self.world.T_rel_prev
        R = self.imu.relative_rotation_prior_np(
            self._last_ts, timestamp, self._R_cam_body_np)
        q = torch.from_numpy(matrix_to_quat_np(R))
        if self.device.type == "cuda":
            q = q.pin_memory().to(self.device, non_blocking=True)
        return SE3(q.to(self.device), self.world.T_rel_prev.t)

    def add_image(self, img, timestamp: float) -> Optional[FrameResult]:
        """Feed one image (uint8 [H, W], uploaded as uint8). Returns the
        frame's ``FrameResult`` with ``sync=True``, else None."""
        self.frame_count += 1
        with self.tracer.frame(self.frame_count):
            with self.tracer.span("upload"):
                prior = self._motion_prior(timestamp)
            self.world, _, _ = self.step(self.world, img,
                                         self._rel_ts(timestamp), prior)
        self._last_ts = timestamp
        if self.sync:
            return self._sync_result()
        return None

    def _sync_result(self) -> FrameResult:
        """The newest trace entry as a ``FrameResult`` (JAX
        pipeline.py:442-452): its pose read back, its stage, tracked count
        and keyframe flag."""
        p = min(self.world.trace_ptr, self.trace_capacity) - 1
        T = SE3(self.world.trace_q[p], self.world.trace_t[p])
        stage, n_tracked, is_kf, _ = self.world.trace_meta[p]
        return FrameResult(T.as_matrix().cpu().numpy(), Stage(int(stage)),
                           int(n_tracked), TrackingQuality.GOOD,
                           bool(is_kf))

    def block(self) -> None:
        """Wait for the work queued on the pipeline's device; nothing is
        read back (on the CPU there is nothing to wait for)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
