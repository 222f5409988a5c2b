"""Mono VIO on one device: ``DevicePipelineVIO``, the mono pipeline plus the
sliding-window VI backend.

Counterpart of ``svo_pro_universal_tpu/frontend/pipeline_vio.py``. On a
keyframe, or when the newest window state is older than the temporal-state
interval, the tracking branch runs the device backend
(backend.device_interface): slot assignment, IMU preintegration over the
frame's measurement window masked to (last window state, now], window LM
optimization, the marginalization slide when the window is full, and the
correction merged back into ring and pool.

Each frame makes ONE upload: the image, the packed IMU window
(``ImuHandler.window_packed``: times relative to the frame), the gyro
rotation prior and the session timestamp, in one pinned buffer copied
asynchronously. The host keeps its copy of the window and the keyframe
clock (float32, as the device values of the JAX package), so which window
samples a factor integrates is decided on the host, and the device gets
that host mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import device_interface as dbe
from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
from svo_pro_universal_tpu_torch.frontend.pipeline import DevicePipelineMono
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, matrix_to_quat_np)

F32 = np.float32


class WorldStateVIO(NamedTuple):
    """WorldState + backend + IMU-streaming fields (the same leading
    fields, so the parent's branches work through ``_replace``)."""
    stage: int
    ring: object
    pool: object
    last_frame: object
    init_ref: object
    init_px: torch.Tensor
    T_rel_prev: SE3
    depth_state: torch.Tensor
    frames_since_kf: int
    prev_n_tracked: int
    reloc_trials: int
    rng: torch.Generator
    trace_q: torch.Tensor
    trace_t: torch.Tensor
    trace_meta: np.ndarray
    trace_ptr: int
    # --- VIO extras ---
    backend: dbe.DeviceBackendState
    backend_k: int              # host: states in the window
    last_kf_ts: np.float32      # host: session ts of the newest state (-1)
    imu_packed: torch.Tensor    # [M, 8] (t − ts, gyro, acc, valid)
    backend_chi2: torch.Tensor  # latest visual solve cost


class DevicePipelineVIO(DevicePipelineMono):
    """Mono VIO: frontend + window BA, on the card unless ``device`` says
    otherwise."""

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None, seed: int = 0,
                 imu_handler=None, trace_capacity: int = 8192,
                 imu_params=None, gravity=None, device=None):
        self._imu_m = (imu_handler.window_size
                       if imu_handler is not None else 16)
        self._imu_params = imu_params
        self._gravity = gravity
        super().__init__(cfg, cam, T_cam_body=T_cam_body, seed=seed,
                         imu_handler=imu_handler,
                         trace_capacity=trace_capacity, device=device)
        # with a window backend, landmark refinement is the BACKEND's job
        # (JAX pipeline_vio.py:99-106): no per-frame structure GN
        self._structure_max_pts = 0
        self._packed_host = np.zeros((self._imu_m, 8), np.float32)

    @property
    def backend(self) -> dbe.DeviceBackend:
        if not hasattr(self, "_backend"):
            self._backend = dbe.DeviceBackend(
                self.cam.focal_length, self.T_cam_body,
                num_keyframes=self.cfg.backend.num_keyframes,
                imu_params=self._imu_params,
                opts=wba.BAOptions(
                    max_iter=self.cfg.backend.max_iterations,
                    # scale is owned by the long-horizon alignment buffer
                    # (JAX pipeline_vio.py:85-93)
                    vi_alignment=False,
                    gravity=(tuple(self._gravity) if self._gravity
                             is not None else (0.0, 0.0, -9.81))),
                backend_cfg=self.cfg.backend, device=self.device)
        return self._backend

    def _make_world(self) -> WorldStateVIO:
        base = super()._make_world()
        return WorldStateVIO(
            *base, backend=self.backend._fresh_state(), backend_k=0,
            last_kf_ts=F32(-1.0),
            imu_packed=torch.zeros((self._imu_m, 8), device=self.device),
            backend_chi2=torch.zeros((), device=self.device))

    def _reset_world_extras(self, world):
        """Full restart: the new map lives in an unrelated world frame, so
        the backend window, slot tables and keyframe clock start over."""
        world = super()._reset_world_extras(world)
        return world._replace(
            backend=self.backend._fresh_state(), backend_k=0,
            last_kf_ts=F32(-1.0),
            backend_chi2=torch.zeros((), device=self.device))

    # ------------------------------------------------------------------
    def _branch_tracking(self, world, frame, ts, T_prior_rel):
        world, n_tracked, is_kf = super()._branch_tracking(
            world, frame, ts, T_prior_rel)
        return (self._vio_backend_step(world, F32(ts), is_kf), n_tracked,
                is_kf)

    def _vio_backend_step(self, world: WorldStateVIO, ts: np.float32,
                          is_kf: bool) -> WorldStateVIO:
        """Run the backend on a keyframe, or as a TEMPORAL state when the
        newest window state is older than ``temporal_dt`` (reference
        num_imu_frames, ceres_backend_interface.hpp:21-58)."""
        be = self.backend
        temporal = (world.last_kf_ts >= 0
                    and ts - world.last_kf_ts >= F32(be.temporal_dt))
        if not ((is_kf or temporal) and world.stage == Stage.TRACKING.value):
            return world
        st, k = world.backend, world.backend_k
        if k >= be.S:
            st = be._marginalize_program(st)
            k -= 1
        # the factor integrates the IMU window over (last_kf_ts, ts];
        # packed times are relative to the frame (cam-IMU delay applied by
        # window_packed)
        dt_prev = max(ts - world.last_kf_ts, F32(1e-3))
        # no IMU factor across a tracking outage (stale velocities)
        have_prev = bool(world.last_kf_ts >= 0
                         and dt_prev < F32(be.max_imu_gap))
        fr = world.last_frame
        st, T_new, chi2 = be._step_program(
            st, k, dt_prev, ts, fr.T_cam_world, fr.landmark_id, fr.f,
            fr.valid_mask(), world.pool.pos, world.imu_packed,
            self._packed_host, world.last_kf_ts - ts, have_prev, is_kf)
        ring, pool, fr, s, c = be._apply_program(st, world.ring, world.pool,
                                                 fr, T_new, chi2)
        # a scale correction rewrites the recorded trajectory too
        written = (torch.arange(world.trace_t.shape[0], device=self.device)
                   < world.trace_ptr)[:, None]
        trace_t = torch.where(written, c[None] + s * (world.trace_t
                                                      - c[None]),
                              world.trace_t)
        return world._replace(
            backend=st, backend_k=k + 1, last_kf_ts=F32(ts), ring=ring,
            pool=pool, last_frame=fr, trace_t=trace_t,
            # common-mode scale: depth scalars + motion model follow
            depth_state=world.depth_state * s,
            T_rel_prev=SE3(world.T_rel_prev.q, world.T_rel_prev.t * s),
            backend_chi2=chi2)

    # ------------------------------------------------------------------
    def _aux(self, timestamp: float) -> np.ndarray:
        """(packed IMU window [M·8], gyro-prior quaternion [4], session ts)
        as one float32 vector; host numpy only."""
        m = self._imu_m
        if self.imu is not None:
            horizon = m / max(self.imu.params.imu_rate, 1.0)
            packed = self.imu.window_packed(timestamp - horizon, timestamp)
        else:
            packed = np.zeros((m, 8), np.float32)
        if self.imu is not None and self._last_ts is not None:
            q = matrix_to_quat_np(self.imu.relative_rotation_prior_np(
                self._last_ts, timestamp, self._R_cam_body_np))
        else:
            q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        return np.concatenate([packed.ravel(), q, np.array(
            [self._rel_ts(timestamp)], np.float32)]).astype(np.float32)

    def add_image(self, img, timestamp: float) -> None:
        """One upload, one pass through the state machine."""
        m = self._imu_m
        aux = self._aux(timestamp)
        img_d, aux_d = self._upload(img, aux)
        self._packed_host = aux[:m * 8].reshape(m, 8)
        world = self.world._replace(imu_packed=aux_d[:m * 8].reshape(m, 8))
        prior = SE3(aux_d[m * 8:m * 8 + 4], world.T_rel_prev.t)
        self.world, _, _ = self.step(world, img_d, float(aux[m * 8 + 4]),
                                     prior)
        self._last_ts = timestamp

    def add_images_batched(self, imgs, timestamps) -> None:
        """The JAX package's throughput API (one scanned program per batch
        there); here a loop of :meth:`add_image`. All IMU measurements up
        to ``timestamps[-1]`` must already be in the handler."""
        for img, ts in zip(imgs, timestamps):
            self.add_image(img, float(ts))
