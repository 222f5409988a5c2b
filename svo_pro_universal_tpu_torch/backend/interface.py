"""Backend interface: feeds keyframes to the sliding-window VI-BA and returns
corrected poses and landmarks to the frontend.

Counterpart of ``svo_pro_universal_tpu/backend/interface.py`` (reference
extra/svo_ceres_backend/src/ceres_backend_interface.cpp — addKeyframe /
bundleAdjustment handshake :200-360, optimizationLoop :597-732). The
bookkeeping is the JAX package's, on the host: a landmark-id → window-slot
dict with a wrapping slot cursor, a wrapping observation cursor, one
keyframe time per state. Each call is synchronous: marginalize when the
window is full, insert the state, add the IMU factor from the previous
keyframe, add the keyframe's observations, optimize (backend.window_ba), and
return the corrections. The window lives on the card unless ``device`` says
otherwise; the caller's landmark arrays are host numpy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import imu_factor as imf
from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.backend.device_interface import imu_steps
from svo_pro_universal_tpu_torch.frontend.frame_handler import resolve_device
from svo_pro_universal_tpu_torch.frontend.imu_handler import (
    ImuHandler, ImuWindow)
from svo_pro_universal_tpu_torch.utils.transform import SE3


class BackendResult(NamedTuple):
    T_cam_world: SE3           # corrected pose of the newest keyframe
    lm_slots_pool: np.ndarray  # pool ids of the window's landmarks
    lm_pos: torch.Tensor       # their optimized positions (device)
    chi2: float


def put_rows(x: torch.Tensor, idx, v) -> torch.Tensor:
    """``x.at[idx].set(v)`` for host indices ``idx`` (a copy)."""
    x = x.clone()
    x[torch.as_tensor(idx, device=x.device)] = torch.as_tensor(
        v, dtype=x.dtype).to(x.device)
    return x


class BackendInterface:
    def __init__(self, cam_focal, T_cam_body: SE3,
                 num_keyframes: int = 5, max_landmarks: int = 256,
                 max_obs: int = 1024, max_obs_per_kf: int = 120,
                 imu_params=None, opts: Optional[wba.BAOptions] = None,
                 device=None):
        self.device = resolve_device(device)
        self.S = num_keyframes
        self.L = max_landmarks
        self.No = max_obs
        self.max_obs_per_kf = max_obs_per_kf
        self.T_cam_body = SE3(T_cam_body.q.to(self.device),
                              T_cam_body.t.to(self.device))
        self.focal = torch.as_tensor(cam_focal, dtype=torch.float32).to(
            self.device)
        self.opts = opts or wba.BAOptions(max_iter=3)
        self.imu_params = imu_params
        self.window = wba.make_window(self.S, self.L, self.No, self.device)
        self.n_states = 0
        self.kf_ts: list[float] = []
        self.lid2slot: dict[int, int] = {}
        self.slot2lid: dict[int, int] = {}
        self._lm_cursor = 0
        self._obs_cursor = 0

    # ------------------------------------------------------------------
    def _assign_lm_slot(self, lid: int) -> int:
        if lid in self.lid2slot:
            return self.lid2slot[lid]
        slot = self._lm_cursor % self.L
        self._lm_cursor += 1
        old = self.slot2lid.pop(slot, None)
        if old is not None:
            self.lid2slot.pop(old, None)
        self.lid2slot[lid] = slot
        self.slot2lid[slot] = lid
        return slot

    def _imu_factor(self, imu_handler: ImuHandler, k: int,
                    timestamp: float, w: wba.Window) -> wba.Window:
        """The preintegrated factor between states k−1 and k."""
        win = imu_handler.window_between(self.kf_ts[-1], timestamp)
        steps = imu_steps(win.t.numpy(), win.valid.numpy())
        win = ImuWindow(*(x.to(self.device) for x in win))
        ip = self.imu_params
        factor = imf.preintegrate_with_cov(
            win, w.bg[k - 1], w.ba[k - 1], ip.sigma_omega_c, ip.sigma_acc_c,
            steps)
        info = imf.imu_information(factor, ip.sigma_omega_bias_c,
                                   ip.sigma_acc_bias_c)
        return w._replace(
            imu=wba.tree_map(lambda a, f: put_rows(a, [k - 1], f[None]),
                             w.imu, factor),
            imu_info=put_rows(w.imu_info, [k - 1], info[None]),
            imu_valid=put_rows(w.imu_valid, [k - 1], True))

    def add_keyframe(self, timestamp: float, T_cam_world: SE3,
                     landmark_ids: np.ndarray, bearings: np.ndarray,
                     lm_positions: np.ndarray,
                     imu_handler: Optional[ImuHandler] = None
                     ) -> Optional[BackendResult]:
        """Insert a keyframe (+ the IMU factor since the previous one), run
        the window optimization, return the corrections.
        ``landmark_ids`` / ``bearings`` / ``lm_positions``: per-feature host
        arrays of the keyframe (−1 ids are skipped)."""
        w = self.window
        if self.n_states == self.S:
            w = wba.marginalize_oldest(w, self.T_cam_body, self.focal,
                                       self.opts)
            self.n_states -= 1
            self.kf_ts.pop(0)
        k = self.n_states

        # state initialization from the frontend pose
        T_cam_world = SE3(T_cam_world.q.to(self.device),
                          T_cam_world.t.to(self.device))
        T_w_b = T_cam_world.inverse().compose(self.T_cam_body)
        v0 = torch.zeros(3, device=self.device)
        if k > 0:
            dt = max(timestamp - self.kf_ts[-1], 1e-3)
            v0 = (T_w_b.t - w.p[k - 1]) / dt
        prev = max(k - 1, 0)
        w = w._replace(
            q=put_rows(w.q, [k], T_w_b.q[None]),
            p=put_rows(w.p, [k], T_w_b.t[None]),
            v=put_rows(w.v, [k], v0[None]),
            bg=put_rows(w.bg, [k], w.bg[prev][None]),
            ba=put_rows(w.ba, [k], w.ba[prev][None]),
            state_valid=put_rows(w.state_valid, [k], True))

        if k > 0 and imu_handler is not None and self.imu_params is not None:
            w = self._imu_factor(imu_handler, k, timestamp, w)

        # observations (bounded per keyframe)
        landmark_ids = np.asarray(landmark_ids)
        sel = np.nonzero(landmark_ids >= 0)[0][: self.max_obs_per_kf]
        obs_l, obs_f, init_slots, init_pos = [], [], [], []
        for i in sel:
            lid = int(landmark_ids[i])
            new = lid not in self.lid2slot
            slot = self._assign_lm_slot(lid)
            if new:
                init_slots.append(slot)
                init_pos.append(lm_positions[i])
            obs_l.append(slot)
            obs_f.append(bearings[i])
        if obs_l:
            n = len(obs_l)
            idx = ((self._obs_cursor + np.arange(n)) % self.No).tolist()
            self._obs_cursor += n
            w = w._replace(
                obs_state=put_rows(w.obs_state, idx, [k] * n),
                obs_lm=put_rows(w.obs_lm, idx, obs_l),
                obs_f=put_rows(w.obs_f, idx,
                               np.stack(obs_f).astype(np.float32)),
                obs_valid=put_rows(w.obs_valid, idx, True))
        if init_slots:
            w = w._replace(
                lm_pos=put_rows(w.lm_pos, init_slots,
                                np.stack(init_pos).astype(np.float32)),
                lm_valid=put_rows(w.lm_valid, init_slots, True))

        self.n_states = k + 1
        self.kf_ts.append(timestamp)
        w, chi2, _ = wba.optimize(w, self.T_cam_body, self.focal, self.opts)
        self.window = w

        # corrections back to the frontend
        T_cam_world_new = self.T_cam_body.compose(
            SE3(w.q[k], w.p[k]).inverse())
        slots = sorted(self.slot2lid.keys())
        pool_ids = np.asarray([self.slot2lid[s] for s in slots], np.int32)
        lm_pos = w.lm_pos[torch.as_tensor(slots, dtype=torch.long,
                                          device=self.device)]
        return BackendResult(T_cam_world_new, pool_ids, lm_pos, float(chi2))
