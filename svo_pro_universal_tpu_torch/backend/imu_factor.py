"""IMU preintegration factor: covariance propagation, bias Jacobians and the
residual of the sliding-window VI bundle adjustment.

Counterpart of ``svo_pro_universal_tpu/backend/imu_factor.py`` (reference
OKVIS-style ImuError, extra/svo_ceres_backend/src/imu_error.cpp — propagation
:292-547, Evaluate :549-750). Residual convention (Forster et al. / OKVIS):

  r_R = log( (Δq · Exp(J_q_bg · δbg))⁻¹ · q_i⁻¹ · q_j )
  r_v = R_i⁻¹ (v_j − v_i − g Δt) − (Δv + J_v_bg δbg + J_v_ba δba)
  r_p = R_i⁻¹ (p_j − p_i − v_i Δt − ½ g Δt²) − (Δp + J_p_bg δbg + J_p_ba δba)
  r_bg = bg_j − bg_i ;  r_ba = ba_j − ba_i

The JAX package integrates with one ``lax.scan`` over all M−1 steps of the
window, a step of length 0 leaving the carry as it was. Eagerly every step is
a few dozen kernel launches, so here everything that does not depend on the
carry (rotation increments, the state-transition and noise blocks) is
computed for the whole window at once, and the sequential part runs only over
the steps the caller lists (``steps``, host indices of the steps with
dt > 0, which the host knows from the window's mask). Skipping a
zero-length step is exact: the JAX scan's masked update returns the carry
bit for bit, which ``tests/test_torch_backend.py`` checks against a masked
loop over every step.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from svo_pro_universal_tpu_torch.frontend.imu_handler import (
    ImuWindow, step_dts)
from svo_pro_universal_tpu_torch.utils.transform import (
    quat_conjugate, quat_multiply, quat_normalize, quat_to_matrix, skew,
    so3_exp, so3_log)

GRAVITY = (0.0, 0.0, -9.81)


class PreintFactor(NamedTuple):
    """Preintegrated IMU measurement between states i and j."""
    delta_q: torch.Tensor      # [4]
    delta_v: torch.Tensor      # [3]
    delta_p: torch.Tensor      # [3]
    dt: torch.Tensor           # scalar
    # first-order bias sensitivity (at the linearization bias)
    J_q_bg: torch.Tensor       # [3, 3] d(log Δq)/d(bg)
    J_v_bg: torch.Tensor       # [3, 3]
    J_v_ba: torch.Tensor       # [3, 3]
    J_p_bg: torch.Tensor       # [3, 3]
    J_p_ba: torch.Tensor       # [3, 3]
    bias_gyr: torch.Tensor     # [3] linearization gyro bias
    bias_acc: torch.Tensor     # [3]
    cov: torch.Tensor          # [9, 9] covariance of (r_R, r_v, r_p)


def _matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched M @ x as an elementwise product and a sum over 3 (the same
    arithmetic whatever the batch size)."""
    return torch.sum(M * x[..., None, :], dim=-1)


def _matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _step_blocks(dts, dR, R, Sa, sigma_gyr_c, sigma_acc_c):
    """Per-step transition A [K,9,9] and discrete noise B·Q·Bᵀ [K,9,9] of
    the error state (δθ, δv, δp), δθ the body-frame right perturbation of
    Δq (Forster supplementary): functions of the step and of the carry's
    rotation R only."""
    K = dts.shape[0]
    dt = dts[:, None, None]
    eye = torch.eye(3, dtype=dts.dtype, device=dts.device).expand(K, 3, 3)
    zero = torch.zeros_like(eye)
    RSa = _matmul(R, Sa)
    A = torch.cat([
        torch.cat([dR.transpose(-1, -2), zero, zero], -1),
        torch.cat([-RSa * dt, eye, zero], -1),
        torch.cat([-0.5 * RSa * dt * dt, eye * dt, eye], -1)], -2)
    B = torch.cat([
        torch.cat([eye * dt, zero], -1),
        torch.cat([zero, R * dt], -1),
        torch.cat([zero, 0.5 * R * dt * dt], -1)], -2)
    q = torch.cat([torch.full((K, 3), sigma_gyr_c ** 2, dtype=dts.dtype,
                              device=dts.device),
                   torch.full((K, 3), sigma_acc_c ** 2, dtype=dts.dtype,
                              device=dts.device)], -1)
    q = q / torch.clamp(dts, min=1e-6)[:, None]       # continuous → discrete
    BQBt = torch.sum((B * q[:, None, :])[:, :, None, :] * B[:, None, :, :],
                     dim=-1)
    return A, BQBt, RSa


def preintegrate_with_cov(window: ImuWindow, bias_gyr: torch.Tensor,
                          bias_acc: torch.Tensor, sigma_gyr_c: float,
                          sigma_acc_c: float, steps: Sequence[int]
                          ) -> PreintFactor:
    """Preintegration with covariance and bias Jacobians (reference
    imu_error.cpp propagation :292-547). ``steps`` (host indices into the
    M−1 steps, ascending) are the steps the sequential part runs; they
    must hold every step with dt > 0 (``device_interface.imu_steps``)."""
    dts_all = step_dts(window)
    dev, f32 = dts_all.device, dts_all.dtype
    steps = list(steps)
    n = len(steps)
    w = window.gyro[:-1] - bias_gyr
    a = window.acc[:-1] - bias_acc
    dq_all = so3_exp(w * dts_all[:, None])
    dR_all = quat_to_matrix(dq_all)
    Sa_all = skew(a)
    start = steps[0] if n else 0
    if steps == list(range(start, start + n)):
        # a contiguous run (a window masked to a time interval): views
        dts, dq, dR, Sa, acc = (x[start:start + n] for x in
                                (dts_all, dq_all, dR_all, Sa_all, a))
    else:
        idx = torch.tensor(steps, dtype=torch.long)
        if dev.type == "cuda":
            idx = idx.pin_memory().to(dev, non_blocking=True)
        dts, dq, dR, Sa, acc = (x.index_select(0, idx) for x in
                                (dts_all, dq_all, dR_all, Sa_all, a))

    # rotation chain: q_k, and R_k = R(q before step k)
    q = (torch.arange(4, device=dev) == 0).to(f32)
    qs = [q]
    for k in range(n):
        q = quat_normalize(quat_multiply(q, dq[k]))
        qs.append(q)
    R = quat_to_matrix(torch.stack(qs[:-1])) if n else dR
    A, BQBt, RSa = _step_blocks(dts, dR, R, Sa, sigma_gyr_c, sigma_acc_c)
    ar_dt = _matvec(R, acc) * dts[:, None]
    half_ar_dt2 = 0.5 * _matvec(R, acc) * dts[:, None] * dts[:, None]
    R_dt = R * dts[:, None, None]
    half_R_dt2 = 0.5 * R * dts[:, None, None] * dts[:, None, None]
    dRT = dR.transpose(-1, -2)
    eye_dt = (torch.eye(3, dtype=f32, device=dev)
              * dts[:, None, None])

    v = torch.zeros(3, dtype=f32, device=dev)
    p = torch.zeros_like(v)
    P = torch.zeros((9, 9), dtype=f32, device=dev)
    Jq = torch.zeros((3, 3), dtype=f32, device=dev)
    Jvg, Jva, Jpg, Jpa = Jq, Jq, Jq, Jq
    for k in range(n):
        dt = dts[k]
        p, v = p + v * dt + half_ar_dt2[k], v + ar_dt[k]
        P = A[k] @ P @ A[k].T + BQBt[k]
        RSaJq = RSa[k] @ Jq
        Jpg, Jpa = (Jpg + Jvg * dt - 0.5 * RSaJq * dt * dt,
                    Jpa + Jva * dt - half_R_dt2[k])
        Jq = dRT[k] @ Jq - eye_dt[k]
        Jvg = Jvg - RSaJq * dt
        Jva = Jva - R_dt[k]
    dt_sum = torch.sum(dts_all)
    # regularize: keep invertible even for empty windows
    P = P + torch.eye(9, dtype=f32, device=dev) * 1e-10
    return PreintFactor(q, v, p, dt_sum, Jq, Jvg, Jva, Jpg, Jpa,
                        bias_gyr, bias_acc, P)


def imu_residual(factor: PreintFactor,
                 q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, bg_j, ba_j,
                 gravity: torch.Tensor) -> torch.Tensor:
    """15-dim residual (r_R, r_v, r_p, r_bg, r_ba); states are
    T_world_body poses (q, p) + velocity + biases. Batches over leading
    dims."""
    dbg = bg_i - factor.bias_gyr
    dba = ba_i - factor.bias_acc
    dt = factor.dt[..., None]
    R_i_T = quat_to_matrix(q_i).transpose(-1, -2)

    def mv(M, x):
        return torch.einsum("...ij,...j->...i", M, x)

    dq_corr = quat_multiply(factor.delta_q, so3_exp(mv(factor.J_q_bg, dbg)))
    q_err = quat_multiply(quat_conjugate(dq_corr),
                          quat_multiply(quat_conjugate(q_i), q_j))
    r_R = so3_log(q_err)
    dv_corr = (factor.delta_v + mv(factor.J_v_bg, dbg)
               + mv(factor.J_v_ba, dba))
    r_v = mv(R_i_T, v_j - v_i - gravity * dt) - dv_corr
    dp_corr = (factor.delta_p + mv(factor.J_p_bg, dbg)
               + mv(factor.J_p_ba, dba))
    r_p = mv(R_i_T, p_j - p_i - v_i * dt - 0.5 * gravity * dt * dt) - dp_corr
    return torch.cat([r_R, r_v, r_p, bg_j - bg_i, ba_j - ba_i], dim=-1)


def imu_information(factor: PreintFactor, sigma_gyr_bias_c: float,
                    sigma_acc_bias_c: float) -> torch.Tensor:
    """[..., 15, 15] information: inverse preintegration covariance for
    (r_R, r_v, r_p) + random-walk information for the bias residuals. The
    inverse is ``inv_ex`` (no host check of the LAPACK/cuSOLVER info)."""
    info9 = torch.linalg.inv_ex(factor.cov)[0]
    info9 = 0.5 * (info9 + info9.transpose(-1, -2))
    dt = torch.clamp(factor.dt, min=1e-3)[..., None, None]
    eye = torch.eye(3, dtype=info9.dtype, device=info9.device)
    out = torch.zeros(info9.shape[:-2] + (15, 15), dtype=info9.dtype,
                      device=info9.device)
    out[..., :9, :9] = info9
    out[..., 9:12, 9:12] = eye / (sigma_gyr_bias_c ** 2 * dt)
    out[..., 12:, 12:] = eye / (sigma_acc_bias_c ** 2 * dt)
    return out
