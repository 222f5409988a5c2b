"""Stereo VIO on one device: ``DevicePipelineStereoVIO``, the stereo pipeline
plus the sliding-window VI backend.

Counterpart of ``svo_pro_universal_tpu/frontend/pipeline_stereo_vio.py``
(the reference's stereo handler shares the mono one's backend hooks,
frame_handler_stereo.cpp:66-213, frame_handler_base.cpp:366-455). The
tracking branch triangulates a new keyframe against cam1 first and then runs
the window backend as ``DevicePipelineVIO`` does, whose pieces it reuses:
the backend step, the aux vector (packed IMU window, gyro-prior quaternion,
session timestamp) and the backend's construction.

As in the JAX package:

- the backend runs with ``vi_alignment`` off and ``scale_correction`` off:
  the stereo map is metric from triangulation (JAX :76-90);
- the per-frame structure stage keeps ``cfg.base.structure_optimization
  _max_pts``: only the mono ``DevicePipelineVIO`` zeroes it;
- the prior is the gyro rotation with the constant-velocity translation.

Each frame makes ONE upload: the aux vector, then both images (uint8).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import device_interface as dbe
from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.pipeline_stereo import (
    DevicePipelineStereo)
from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
    F32, DevicePipelineVIO)
from svo_pro_universal_tpu_torch.utils.transform import SE3


class WorldStateStereoVIO(NamedTuple):
    """WorldState + stereo pyramids + VIO backend fields."""
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
    # --- stereo extras (names match WorldStateStereo) ---
    pyr1_cur: torch.Tensor
    pyr1_prev: torch.Tensor
    # --- VIO extras (names match WorldStateVIO) ---
    backend: dbe.DeviceBackendState
    backend_k: int
    last_kf_ts: np.float32
    imu_packed: torch.Tensor
    backend_chi2: torch.Tensor


class DevicePipelineStereoVIO(DevicePipelineStereo):
    """Stereo VIO with metric scale from the first frame, on the card unless
    ``device`` says otherwise."""

    def __init__(self, cfg: Config, cam0: proj.Camera, cam1: proj.Camera,
                 T_body_cam0: SE3, T_body_cam1: SE3, seed: int = 0,
                 imu_handler=None, trace_capacity: int = 8192,
                 imu_params=None, gravity=None, joint_alignment: bool = False,
                 device=None):
        self._imu_m = (imu_handler.window_size
                       if imu_handler is not None else 16)
        self._imu_params = imu_params
        self._gravity = gravity
        super().__init__(cfg, cam0, cam1, T_body_cam0, T_body_cam1,
                         seed=seed, trace_capacity=trace_capacity,
                         joint_alignment=joint_alignment, device=device)
        self.imu = imu_handler
        self._packed_host = np.zeros((self._imu_m, 8), np.float32)

    @property
    def backend(self) -> dbe.DeviceBackend:
        if not hasattr(self, "_backend"):
            be = DevicePipelineVIO.backend.fget(self)
            # stereo scale is metric from triangulation: no rescaling
            be.scale_correction = False
        return self._backend

    # the VIO pieces, reused as they are (they reach the world by field
    # name and call no zero-argument super())
    _vio_backend_step = DevicePipelineVIO._vio_backend_step
    _aux = DevicePipelineVIO._aux

    def _make_world(self) -> WorldStateStereoVIO:
        base = super()._make_world()
        return WorldStateStereoVIO(
            *base, backend=self.backend._fresh_state(), backend_k=0,
            last_kf_ts=F32(-1.0),
            imu_packed=torch.zeros((self._imu_m, 8), device=self.device),
            backend_chi2=torch.zeros((), device=self.device))

    def _reset_world_extras(self, world):
        """Full restart: the backend window and keyframe clock start over
        (as ``DevicePipelineVIO._reset_world_extras``)."""
        world = super()._reset_world_extras(world)
        return world._replace(
            backend=self.backend._fresh_state(), backend_k=0,
            last_kf_ts=F32(-1.0),
            backend_chi2=torch.zeros((), device=self.device))

    def _branch_tracking(self, world, frame, ts, T_prior_rel):
        world, n_tracked, is_kf = super()._branch_tracking(
            world, frame, ts, T_prior_rel)
        return (self._vio_backend_step(world, F32(ts), is_kf), n_tracked,
                is_kf)

    def add_image_pair(self, img0, img1, timestamp: float) -> None:
        """Feed one stereo pair (uint8 [H, W] each); the IMU must hold the
        measurements up to ``timestamp``."""
        m = self._imu_m
        aux = self._aux(timestamp)
        imgs, aux_d = self._upload(
            np.stack([np.asarray(img0), np.asarray(img1)]), aux)
        self._packed_host = aux[:m * 8].reshape(m, 8)
        ts = float(aux[m * 8 + 4])
        world = self.world._replace(imu_packed=aux_d[:m * 8].reshape(m, 8))
        world, frame = self._new_frame(world, imgs, ts)
        prior = SE3(aux_d[m * 8:m * 8 + 4], world.T_rel_prev.t)
        self.world, _, _ = self._run_state_machine(world, frame, ts, prior)
        self._last_ts = timestamp
