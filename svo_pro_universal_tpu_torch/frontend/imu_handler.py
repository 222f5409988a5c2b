"""IMU handling: measurement buffer, rotation priors, gravity init,
frontend preintegration.

Counterpart of ``svo_pro_universal_tpu/frontend/imu_handler.py`` (reference
src/svo/src/imu_handler.cpp — PreintegratedImuMeasurement :51-68,
getRelativeRotationPrior :270-297, getInitialAttitude :458-489,
getMeasurementsContainingEdges, the temporal stationarity check). The buffer,
the windows and the per-frame rotation prior are host numpy (as in the JAX
package); the integrations over a window are functions of tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras.rig import (
    ImuInitialization, ImuParams)
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, matrix_to_quat, quat_multiply, quat_normalize, quat_rotate, so3_exp)


class ImuWindow(NamedTuple):
    """Fixed-capacity measurement window."""
    t: torch.Tensor        # [M] seconds
    gyro: torch.Tensor     # [M, 3]
    acc: torch.Tensor      # [M, 3]
    valid: torch.Tensor    # [M] bool


class Preintegrated(NamedTuple):
    """Frontend preintegration Δ(R, v, p) over a window (biases fixed, no
    covariance; the backend's factor carries it)."""
    delta_q: torch.Tensor   # [4] wxyz, R_i←j
    delta_v: torch.Tensor   # [3]
    delta_p: torch.Tensor   # [3]
    dt: torch.Tensor        # scalar


def step_dts(window: ImuWindow) -> torch.Tensor:
    """[M-1] integration step lengths: 0 where a sample pair is not both
    valid or time runs backwards."""
    dts = torch.diff(window.t)
    pair_ok = window.valid[:-1] & window.valid[1:]
    return torch.where(pair_ok, torch.clamp(dts, min=0.0), 0.0)


def _identity_q(ref: torch.Tensor) -> torch.Tensor:
    return (torch.arange(4, device=ref.device) == 0).to(ref.dtype)


def preintegrate(window: ImuWindow, gyro_bias: torch.Tensor,
                 acc_bias: torch.Tensor) -> Preintegrated:
    """Second-order preintegration over the masked window (the JAX
    ``lax.scan`` as a loop over its M-1 steps)."""
    dts = step_dts(window)
    gyro = window.gyro[:-1] - gyro_bias
    acc = window.acc[:-1] - acc_bias
    q = _identity_q(window.t)
    v = torch.zeros(3, dtype=window.t.dtype, device=window.t.device)
    p = torch.zeros_like(v)
    dt_sum = torch.zeros((), dtype=window.t.dtype, device=window.t.device)
    for k in range(dts.shape[0]):
        dt = dts[k]
        a_r = quat_rotate(q, acc[k])
        p = p + v * dt + 0.5 * a_r * dt * dt
        v = v + a_r * dt
        q = quat_normalize(quat_multiply(q, so3_exp(gyro[k] * dt)))
        dt_sum = dt_sum + dt
    return Preintegrated(q, v, p, dt_sum)


def gyro_rotation_prior(window: ImuWindow, gyro_bias: torch.Tensor
                        ) -> torch.Tensor:
    """Relative body rotation q_i←j over the window from gyro only
    (reference getRelativeRotationPrior imu_handler.cpp:270-297)."""
    dts = step_dts(window)
    w = (window.gyro[:-1] - gyro_bias) * dts[:, None]
    dq = so3_exp(w)
    q = _identity_q(window.t)
    for k in range(dts.shape[0]):
        q = quat_normalize(quat_multiply(q, dq[k]))
    return q


def initial_attitude_from_gravity(acc: torch.Tensor) -> torch.Tensor:
    """q_body_world aligning measured specific force with +z gravity
    (reference getInitialAttitude imu_handler.cpp:458-489)."""
    z = acc / torch.clamp(torch.linalg.norm(acc), min=1e-9)
    e = torch.eye(3, dtype=acc.dtype, device=acc.device)
    p = torch.where(torch.abs(z @ e[0]) > torch.abs(z @ e[1]), e[1], e[0])
    y = torch.linalg.cross(z, p, dim=-1)
    y = y / torch.clamp(torch.linalg.norm(y), min=1e-9)
    x = torch.linalg.cross(y, z, dim=-1)
    C = torch.stack([x, y, z], dim=1)   # world axes in body coords
    return matrix_to_quat(C)


def _searchsorted_range(ts: np.ndarray, t0: float, t1: float, m: int
                        ) -> slice:
    i0 = max(int(np.searchsorted(ts, t0, "right")) - 1, 0)
    i1 = min(int(np.searchsorted(ts, t1, "left")) + 1, len(ts))
    return slice(i0, min(i1, i0 + m))


class ImuHandler:
    """Host-side measurement buffer (replaces the mutex-guarded deque,
    imu_handler.h:166-189); biases are host numpy."""

    def __init__(self, params: Optional[ImuParams] = None,
                 init: Optional[ImuInitialization] = None,
                 window_size: int = 256):
        self.params = params or ImuParams()
        self.init = init or ImuInitialization()
        self.window_size = window_size
        self._t: list[float] = []
        self._gyro: list[np.ndarray] = []
        self._acc: list[np.ndarray] = []
        self.gyro_bias = np.asarray(self.init.omega_bias, np.float32)
        self.acc_bias = np.asarray(self.init.acc_bias, np.float32)

    def add_measurement(self, t: float, gyro, acc) -> None:
        self._t.append(float(t))
        self._gyro.append(np.asarray(gyro, np.float32))
        self._acc.append(np.asarray(acc, np.float32))
        # bound host memory: drop very old entries
        if len(self._t) > 20000:
            self._t = self._t[-10000:]
            self._gyro = self._gyro[-10000:]
            self._acc = self._acc[-10000:]

    def window_between(self, t0: float, t1: float, device=None
                       ) -> ImuWindow:
        """Fixed-size padded window covering [t0, t1] with edge samples
        (reference getMeasurementsContainingEdges), times relative to the
        window's first sample and shifted by the cam-IMU delay."""
        d = self.params.delay_imu_cam
        ts = np.asarray(self._t, np.float64)
        m = self.window_size
        g = np.zeros((m, 3), np.float32)
        a = np.zeros((m, 3), np.float32)
        v = np.zeros((m,), bool)
        t_rel = np.zeros((m,), np.float32)
        if len(ts):
            sel = _searchsorted_range(ts, t0 - d, t1 - d, m)
            tt = ts[sel]
            n = len(tt)
            t_pad = np.full((m,), tt[-1] if n else 0.0, np.float64)
            t_pad[:n] = tt
            if n:
                g[:n] = np.stack(self._gyro[sel])
                a[:n] = np.stack(self._acc[sel])
            v[:n] = True
            t_rel = (t_pad - t_pad[0]).astype(np.float32)
        return ImuWindow(*(torch.from_numpy(x).to(device)
                           for x in (t_rel, g, a, v)))

    def window_packed(self, t0: float, t1: float) -> np.ndarray:
        """Like :meth:`window_between` but ONE packed numpy [M, 8] array
        (t_rel, gyro×3, acc×3, valid) with times relative to the
        delay-shifted ``t1``: a frame uploads it with its image."""
        d = self.params.delay_imu_cam
        t0s, t1s = t0 - d, t1 - d
        m = self.window_size
        out = np.zeros((m, 8), np.float32)
        ts = np.asarray(self._t, np.float64)
        if len(ts) == 0:
            return out
        sel = _searchsorted_range(ts, t0s, t1s, m)
        tt = ts[sel]
        n = len(tt)
        if n == 0:
            return out
        out[:n, 0] = (tt - t1s).astype(np.float32)
        out[n:, 0] = out[n - 1, 0]
        out[:n, 1:4] = np.stack(self._gyro[sel])
        out[:n, 4:7] = np.stack(self._acc[sel])
        out[:n, 7] = 1.0
        return out

    def relative_rotation_prior(self, t0: float, t1: float,
                                T_cam_body: SE3, device=None) -> SE3:
        """Camera-frame rotation prior R_cam1_cam0 from gyro integration
        (reference getRelativeRotationPrior + frame_handler usage)."""
        w = self.window_between(t0, t1, device)
        q_b0_b1 = gyro_rotation_prior(
            w, torch.from_numpy(self.gyro_bias).to(device))
        conj = torch.tensor([1.0, -1.0, -1.0, -1.0], device=device)
        q_cb = T_cam_body.q.to(device)
        q = quat_multiply(q_cb, quat_multiply(conj * q_b0_b1, conj * q_cb))
        return SE3(quat_normalize(q), torch.zeros(3, device=device))

    def relative_rotation_prior_np(self, t0: float, t1: float,
                                   R_cam_body: np.ndarray) -> np.ndarray:
        """Host-side gyro integration → R_c1_c0 rotation matrix: the
        per-frame motion prior, computed on the CPU as the reference does
        (imu_handler.cpp:270-297)."""
        d = self.params.delay_imu_cam
        ts = np.asarray(self._t, np.float64)
        if len(ts) < 2:
            return np.eye(3)
        i0 = max(int(np.searchsorted(ts, t0 - d, "right")) - 1, 0)
        i1 = min(int(np.searchsorted(ts, t1 - d, "left")) + 1, len(ts))
        R = np.eye(3)
        bg = self.gyro_bias
        for k in range(i0, i1 - 1):
            dt = ts[k + 1] - ts[k]
            if dt <= 0:
                continue
            w = (np.asarray(self._gyro[k]) - bg) * dt
            th = np.linalg.norm(w)
            if th < 1e-12:
                continue
            a = w / th
            K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                          [-a[1], a[0], 0]])
            R = R @ (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K)
        # R is R_b0_b1; camera-frame relative: R_c1_c0 = R_cb·R_b0_b1ᵀ·R_cbᵀ
        return R_cam_body @ R.T @ R_cam_body.T

    def initial_attitude(self, t: float, device=None
                         ) -> Optional[torch.Tensor]:
        """q_body_world from the accelerometer nearest to t."""
        if not self._t:
            return None
        i = int(np.argmin(np.abs(np.asarray(self._t) - t)))
        return initial_attitude_from_gravity(
            torch.from_numpy(self._acc[i]).to(device))

    def is_stationary(self, t: float, window_sec: float = 0.5,
                      acc_sigma_thresh: float = 0.1,
                      gyr_sigma_thresh: float = 0.06) -> Optional[bool]:
        """Temporal stationarity check (reference checkTemporalStatus:
        std-dev of acc/gyro over a trailing window)."""
        ts = np.asarray(self._t)
        sel = (ts >= t - window_sec) & (ts <= t)
        if sel.sum() < 5:
            return None
        acc = np.stack(self._acc)[sel]
        gyr = np.stack(self._gyro)[sel]
        return bool(np.all(acc.std(axis=0) < acc_sigma_thresh)
                    and np.all(gyr.std(axis=0) < gyr_sigma_thresh))
