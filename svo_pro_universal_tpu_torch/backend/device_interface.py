"""Device-resident sliding-window backend: keyframe absorption, landmark slot
assignment, IMU preintegration, LM optimization and frontend correction.

Counterpart of ``svo_pro_universal_tpu/backend/device_interface.py``
(reference extra/svo_ceres_backend/src/ceres_backend_interface.cpp —
addKeyframe/bundleAdjustment:200-360, optimizationLoop:597-732; the
correction feedback loadMapFromBundleAdjustment, frame_handler_base.cpp:
256-310; marginalization estimator.cpp:632).

- landmark-id → window-slot resolution is an [mok, L] equality match plus an
  LRU allocation (a stable argsort over slot ages);
- observations live in per-state segments (state k owns rows
  [k·mok, (k+1)·mok)); evicting a slot invalidates the rows that still
  reference it; the marginalization slide shifts states and segments by one;
- a long-horizon alignment buffer of keyframe-rate states estimates the
  metric scale in closed form and stages it for the frontend.

The JAX package keeps every counter on the device and branches with
``lax.cond``. Here what the host already knows stays on the host — the
window count, the buffer count and clock (``abuf_n``, ``abuf_last_ts``, as
float32 like the device values they mirror), the slot-age counter — and is
branched on in Python, so a skipped branch launches nothing. Decisions that
depend on data (the buffer alignment firing, the solve-health and pose-jump
gates of the correction) are selected on the device with ``torch.where``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import imu_factor as imf
from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.frontend.frame_handler import resolve_device
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuWindow
from svo_pro_universal_tpu_torch.frontend.map import insert_keyframe
from svo_pro_universal_tpu_torch.utils.indexing import (
    argsort_stable, segment_sum, set_drop, topk_stable)
from svo_pro_universal_tpu_torch.utils.robust import masked_median
from svo_pro_universal_tpu_torch.utils.transform import SE3, quat_rotate

F32 = np.float32


class DeviceBackendState(NamedTuple):
    window: wba.Window
    slot_lid: torch.Tensor     # [L] pool landmark id per slot (-1 free)
    slot_age: torch.Tensor     # [L] last-touched counter (LRU eviction)
    next_age: int              # host counter
    # --- long-horizon VI-initialization buffer (JAX
    # device_interface.py:50-66): keyframe-rate states over seconds, whose
    # long IMU factors make the metric scale observable
    abuf_q: torch.Tensor       # [A, 4] body orientation at insertion
    abuf_p: torch.Tensor       # [A, 3] body position (frontend map units)
    abuf_imu: imf.PreintFactor  # [A-1] between consecutive slots
    abuf_fvalid: torch.Tensor  # [A-1]
    abuf_n: int                # host: slots filled
    abuf_last_ts: np.float32   # host: session ts of the newest slot (-1)
    abuf_rel: torch.Tensor     # latest buffer-alignment rel_std (inf)
    # similarity the next _apply_program must apply to the frontend (1.0 =
    # none); set when the buffer alignment fires
    pending_scale: torch.Tensor


def imu_steps(t: np.ndarray, mask: np.ndarray) -> list[int]:
    """Host indices of the integration steps of a window with dt > 0 (the
    only steps that change a preintegration; ``imu_factor``): both samples
    in ``mask`` and time moving forward, in float32 as on the device."""
    t = np.asarray(t, np.float32)
    ok = mask[:-1] & mask[1:] & ((t[1:] - t[:-1]) > F32(0.0))
    return np.flatnonzero(ok).tolist()


def packed_raw_mask(packed_host: np.ndarray) -> np.ndarray:
    """[M] host mask of the usable samples of a packed window
    (``ImuHandler.window_packed``): flagged valid and not after the
    frame."""
    return (packed_host[:, 7] > 0.5) & (packed_host[:, 0] <= F32(1e-6))


def masked_window(packed: torch.Tensor, packed_host: np.ndarray,
                  mask: np.ndarray) -> tuple[ImuWindow, list[int]]:
    """The window of the packed [M, 8] device tensor (t_rel, gyro, acc,
    valid) under the host ``mask``, and its steps with dt > 0. The host
    mask is the one source of both: the device gets a copy of it (pinned,
    asynchronous) and the steps are read from it."""
    m = torch.from_numpy(np.ascontiguousarray(mask))
    if packed.device.type == "cuda":
        m = m.pin_memory().to(packed.device, non_blocking=True)
    win = ImuWindow(packed[:, 0], packed[:, 1:4], packed[:, 4:7], m)
    return win, imu_steps(packed_host[:, 0], mask)


def _put(x: torch.Tensor, k: int, v) -> torch.Tensor:
    """``x.at[k].set(v)`` for a host index ``k``."""
    x = x.clone()
    x[k] = v
    return x


class DeviceBackend:
    """Sliding-window VI-BA with device-resident bookkeeping."""

    def __init__(self, cam_focal, T_cam_body: SE3, num_keyframes: int = 5,
                 max_landmarks: int = 256, max_obs_per_kf: int = 120,
                 imu_params=None, opts: Optional[wba.BAOptions] = None,
                 backend_cfg=None, device=None):
        """``backend_cfg`` (a :class:`config.BackendOptions`) supplies every
        tunable below when given, as in the JAX package."""
        bc = backend_cfg
        self.device = resolve_device(device)
        self.S = num_keyframes
        self.L = getattr(bc, "max_landmarks", max_landmarks)
        self.mok = getattr(bc, "max_obs_per_kf", max_obs_per_kf)
        self.T_cam_body = SE3(T_cam_body.q.to(self.device),
                              T_cam_body.t.to(self.device))
        self.focal = torch.as_tensor(cam_focal, dtype=torch.float32).to(
            self.device)
        self.opts = opts or wba.BAOptions(max_iter=3)
        self.imu_params = imu_params
        self.ingest_gate_px = getattr(bc, "ingest_gate_px", 5.0)
        self.max_pose_correction = getattr(bc, "max_pose_correction", 0.5)
        self.use_zupt = getattr(bc, "use_zero_motion_detection", True)
        self.zupt_gyro_thresh = getattr(bc, "zupt_gyro_thresh", 0.015)
        self.zupt_acc_thresh = getattr(bc, "zupt_acc_thresh", 0.12)
        self.zupt_sigma_v = getattr(bc, "zupt_sigma_v", 0.02)
        self.zupt_require_rest = getattr(bc, "zupt_require_rest", False)
        self.scale_correction = getattr(bc, "scale_correction", True)
        self.max_scale_step = getattr(bc, "max_scale_step", 1.15)
        self.min_scale_support = getattr(bc, "min_scale_support", 12)
        self.scale_deadband = getattr(bc, "scale_deadband", 0.003)
        self.scale_damping = getattr(bc, "scale_damping", 0.5)
        self.scale_obs_max_rel_std = getattr(bc, "scale_obs_max_rel_std",
                                             0.15)
        self.max_chi2_per_obs = getattr(bc, "max_chi2_per_obs", 200.0)
        self.max_imu_gap = getattr(bc, "max_imu_dt_between_kfs", 0.6)
        self.temporal_dt = getattr(bc, "temporal_state_max_dt", 0.3)
        self.align_buffer_len = getattr(bc, "align_buffer_len", 12)
        self.align_min_factors = getattr(bc, "align_min_factors", 4)
        self.align_deadband = getattr(bc, "align_deadband", 0.02)
        self.align_max_gap = getattr(bc, "align_max_gap", 1.2)
        self.align_max_rel_std = getattr(bc, "align_max_rel_std", 0.13)
        self.align_damping = getattr(bc, "align_damping", 0.5)
        self.align_min_dt = getattr(bc, "align_min_dt", 0.2)
        # diagnostics over the backend's life: LM iterations run (host) and
        # those whose state step ``solve_schur`` voided (device, no read)
        self.lm_iterations = 0
        self.lm_voided = torch.zeros((), dtype=torch.long, device=self.device)
        # the host API's window count and keyframe times
        # (add_keyframe_device)
        self.n_states = 0
        self._ts: list[float] = []
        self.state = self._fresh_state()

    def _fresh_state(self) -> DeviceBackendState:
        A, dev = self.align_buffer_len, self.device
        return DeviceBackendState(
            window=wba.make_window(self.S, self.L, self.S * self.mok, dev),
            slot_lid=torch.full((self.L,), -1, dtype=torch.long, device=dev),
            slot_age=torch.zeros((self.L,), dtype=torch.long, device=dev),
            next_age=1,
            abuf_q=wba._unit_q(A, dev),
            abuf_p=torch.zeros((A, 3), device=dev),
            abuf_imu=wba.empty_factors(A - 1, dev),
            abuf_fvalid=torch.zeros((A - 1,), dtype=torch.bool, device=dev),
            abuf_n=0, abuf_last_ts=F32(-1.0),
            abuf_rel=torch.full((), float("inf"), device=dev),
            pending_scale=torch.ones((), device=dev))

    # ------------------------------------------------------------------
    def _add_keyframe(self, st: DeviceBackendState, k: int, dt_prev: float,
                      T_cam_world: SE3, lids, bearings, valid, pool_pos,
                      imu_win: ImuWindow, use_imu: bool,
                      steps: Sequence[int]) -> DeviceBackendState:
        """Window state ``k`` from the frontend pose, the IMU factor from
        state k−1 (preintegrated over ``steps`` of ``imu_win``), and the
        keyframe's observations in segment k."""
        w = st.window
        S, L, mok = self.S, self.L, self.mok
        dev = pool_pos.device

        # ---- state init from the frontend pose ------------------------
        T_w_b = T_cam_world.inverse().compose(self.T_cam_body)
        prev = min(max(k - 1, 0), S - 1)
        if k > 0:
            v0 = (T_w_b.t - w.p[prev]) / max(float(dt_prev), 1e-3)
        else:
            v0 = torch.zeros(3, device=dev)
        w = w._replace(
            q=_put(w.q, k, T_w_b.q), p=_put(w.p, k, T_w_b.t),
            v=_put(w.v, k, v0), bg=_put(w.bg, k, w.bg[prev]),
            ba=_put(w.ba, k, w.ba[prev]),
            state_valid=w.state_valid | (torch.arange(S, device=dev) == k))

        # ---- IMU factor from the previous keyframe --------------------
        if self.imu_params is not None:
            ip = self.imu_params
            zupt_k = torch.zeros((), device=dev)
            if use_imu and self.use_zupt:
                # stationarity → zero-velocity prior on this state
                # (reference motion_detector.hpp zero-motion priors)
                m = imu_win.valid.to(torch.float32)[:, None]
                nm = torch.clamp(torch.sum(m), min=1.0)
                g_mean = torch.sum(imu_win.gyro * m, 0) / nm
                a_mean = torch.sum(imu_win.acc * m, 0) / nm
                g_dev = torch.sqrt(torch.sum(torch.sum(
                    (imu_win.gyro - g_mean) ** 2 * m, 0)) / nm
                    + torch.sum(g_mean ** 2))
                a_dev = torch.sqrt(torch.sum(torch.sum(
                    (imu_win.acc - a_mean) ** 2 * m, 0)) / nm)
                stationary = ((nm >= 10) & (g_dev < self.zupt_gyro_thresh)
                              & (a_dev < self.zupt_acc_thresh))
                if self.zupt_require_rest:
                    # the frontend's velocity v0 at rest too (within 3 σ of
                    # the prior): the IMU alone cannot tell rest from
                    # constant velocity (opt-in; ROADMAP, deliberate
                    # divergences)
                    stationary = stationary & (torch.linalg.norm(v0)
                                               < 3.0 * self.zupt_sigma_v)
                zupt_k = torch.where(stationary,
                                     1.0 / self.zupt_sigma_v ** 2, 0.0)
            w = w._replace(zupt=_put(w.zupt, k, zupt_k))
            if use_imu and k > 0:
                factor = imf.preintegrate_with_cov(
                    imu_win, w.bg[prev], w.ba[prev], ip.sigma_omega_c,
                    ip.sigma_acc_c, steps)
                info = imf.imu_information(factor, ip.sigma_omega_bias_c,
                                           ip.sigma_acc_bias_c)
                ki = min(max(k - 1, 0), S - 2)
                w = w._replace(
                    imu=wba.tree_map(lambda a, b: _put(a, ki, b), w.imu,
                                     factor),
                    imu_info=_put(w.imu_info, ki, info),
                    imu_valid=w.imu_valid | (torch.arange(S - 1, device=dev)
                                             == ki))

        # ---- feature compaction: first `mok` landmark-backed features --
        # ingestion gate: a tracked feature must reproject its pool
        # landmark within ingest_gate_px at the fed pose
        P = pool_pos.shape[0]
        Xw = pool_pos[torch.clamp(lids, 0, P - 1)]
        p_c = T_cam_world.apply(Xw)
        zi = 1.0 / torch.where(torch.abs(p_c[:, 2:3]) > 1e-8, p_c[:, 2:3],
                               1e-8)
        uv_lm = p_c[:, 0:2] * zi
        uv_ft = bearings[:, 0:2] / torch.where(
            torch.abs(bearings[:, 2:3]) > 1e-8, bearings[:, 2:3], 1e-8)
        e_px = torch.linalg.norm(uv_lm - uv_ft, dim=-1) * self.focal
        n = lids.shape[0]
        ok = (valid & (lids >= 0) & (p_c[:, 2] > 1e-3)
              & (e_px < self.ingest_gate_px))
        score = torch.where(ok, -torch.arange(n, dtype=torch.float32,
                                              device=dev), float("-inf"))
        _, sel = topk_stable(score, min(mok, n))
        if sel.shape[0] < mok:
            sel = torch.cat([sel, torch.zeros((mok - sel.shape[0],),
                                              dtype=torch.long, device=dev)])
        sel_ok = ok[sel]
        lid_s = torch.where(sel_ok, lids[sel], -1)
        f_s = bearings[sel]

        # ---- slot resolution: existing match or LRU allocation --------
        eq = (lid_s[:, None] == st.slot_lid[None, :]) & (lid_s >= 0)[:, None]
        found = torch.any(eq, dim=-1)
        slot_found = torch.argmax(eq.to(torch.uint8), dim=-1)
        is_new = sel_ok & ~found
        prio = torch.where(st.slot_lid < 0, -1, st.slot_age)
        order = argsort_stable(prio)                    # free, then oldest
        rank = torch.cumsum(is_new.long(), 0) - 1
        slot_alloc = order[torch.clamp(rank, 0, L - 1)]
        slot = torch.where(is_new, slot_alloc, slot_found)
        slot_ok = sel_ok

        # ---- eviction: stale obs rows must not alias the reused slot --
        evict_idx = torch.where(is_new & (st.slot_lid[slot_alloc] >= 0),
                                slot_alloc, L)
        evicted = set_drop(torch.zeros((L + 1,), dtype=torch.bool,
                                       device=dev), evict_idx, True)[:L]
        obs_lm_c = torch.clamp(w.obs_lm, 0, L - 1)
        w = w._replace(obs_valid=w.obs_valid & ~evicted[obs_lm_c])
        slot_lid = set_drop(st.slot_lid, torch.where(is_new, slot_alloc, L),
                            lid_s)
        slot_age = set_drop(st.slot_age, torch.where(slot_ok, slot, L),
                            st.next_age)

        # ---- landmark init for fresh slots ----------------------------
        lm0 = pool_pos[torch.clamp(lid_s, 0, P - 1)]
        w = w._replace(
            lm_pos=set_drop(w.lm_pos, torch.where(is_new, slot, L), lm0),
            lm_valid=set_drop(w.lm_valid, torch.where(slot_ok, slot, L),
                              True))

        # ---- observation segment k ------------------------------------
        seg = slice(k * mok, (k + 1) * mok)

        def put_seg(x, v):
            x = x.clone()
            x[seg] = v
            return x

        w = w._replace(
            obs_state=put_seg(w.obs_state, torch.full(
                (mok,), k, dtype=torch.long, device=dev)),
            obs_lm=put_seg(w.obs_lm, slot), obs_f=put_seg(w.obs_f, f_s),
            obs_valid=put_seg(w.obs_valid, slot_ok))
        return st._replace(window=w, slot_lid=slot_lid, slot_age=slot_age,
                           next_age=st.next_age + 1)

    # ------------------------------------------------------------------
    def _step_program(self, st: DeviceBackendState, k: int, dt_prev, ts,
                      T_cam_world: SE3, lids, bearings, valid, pool_pos,
                      packed: torch.Tensor, packed_host: np.ndarray,
                      rel_kf: np.float32, use_imu: bool, is_kf: bool):
        """Absorb state k + optimize + the alignment buffer; returns (st,
        T_cam_world of state k, visual chi2). ``packed`` is the frame's
        packed IMU window on the device and ``packed_host`` its host copy;
        the keyframe factor integrates its samples after ``rel_kf`` (the
        previous state's time relative to the frame), the buffer's those
        after the buffer's newest slot. Adds the LM iterations run and
        those whose state step was voided to ``lm_iterations`` /
        ``lm_voided``."""
        raw = packed_raw_mask(packed_host)
        iw, steps = masked_window(packed, packed_host,
                                  raw & (packed_host[:, 0] > F32(rel_kf)))
        return self._solve_step(st, k, dt_prev, ts, T_cam_world, lids,
                                bearings, valid, pool_pos, iw, steps,
                                packed, packed_host, use_imu, is_kf)

    def _solve_step(self, st: DeviceBackendState, k: int, dt_prev, ts,
                    T_cam_world: SE3, lids, bearings, valid, pool_pos,
                    iw: ImuWindow, steps: Sequence[int],
                    packed: torch.Tensor, packed_host: np.ndarray,
                    use_imu: bool, is_kf: bool):
        """``_step_program`` past the choice of the keyframe factor's
        samples (``iw``, its ``steps``); the buffer reads ``packed``."""
        st = self._add_keyframe(st, k, dt_prev, T_cam_world, lids, bearings,
                                valid, pool_pos, iw, use_imu, steps)
        w, _, n_void = wba.optimize(st.window, self.T_cam_body, self.focal,
                                    self.opts)
        self.lm_iterations += self.opts.max_iter
        self.lm_voided = self.lm_voided + n_void
        st = st._replace(window=w)
        st = self._align_buffer_step(st, k, F32(ts), packed, packed_host,
                                     is_kf)
        w = st.window
        e, _, _, wgt, _ = wba._reproj_terms(w, self.T_cam_body, self.focal,
                                            self.opts)
        chi2_vis = torch.sum(torch.sum(e * e, -1) * wgt)
        T_new = self.T_cam_body.compose(SE3(w.q[k], w.p[k]).inverse())
        return st, T_new, chi2_vis

    def _align_buffer_step(self, st: DeviceBackendState, k: int,
                           ts: np.float32, packed: torch.Tensor,
                           packed_host: np.ndarray,
                           is_kf: bool) -> DeviceBackendState:
        """Insert a keyframe-rate state into the long-horizon buffer,
        solve the closed-form alignment over it, and when the scale is
        observable rescale window + buffer about the current body position
        and stage the similarity for the frontend (JAX
        device_interface.py:337-461)."""
        A = self.align_buffer_len
        dev = st.abuf_p.device
        do_insert = (is_kf or st.abuf_last_ts < 0
                     or ts - st.abuf_last_ts >= F32(self.align_min_dt))
        if not do_insert:
            return st._replace(pending_scale=torch.ones((), device=dev))
        w = st.window
        dt_buf = ts - st.abuf_last_ts
        have_prev = bool(st.abuf_last_ts >= 0 and st.abuf_n > 0
                         and dt_buf < F32(self.align_max_gap))
        # preintegrate over (abuf_last_ts, ts]; window times are relative
        # to the current frame
        rel0 = st.abuf_last_ts - ts
        iw, steps = masked_window(packed, packed_host,
                                  packed_raw_mask(packed_host)
                                  & (packed_host[:, 0] > rel0))
        ip = self.imu_params
        factor = imf.preintegrate_with_cov(
            iw, w.bg[k], w.ba[k], ip.sigma_omega_c if ip else 1e-3,
            ip.sigma_acc_c if ip else 1e-2, steps)

        def shift(x):
            return torch.cat([x[1:], x[-1:]], dim=0)

        full = st.abuf_n >= A
        q_b, p_b, fv = st.abuf_q, st.abuf_p, st.abuf_fvalid
        imu_b = st.abuf_imu
        if full:
            q_b, p_b, fv = shift(q_b), shift(p_b), shift(fv)
            imu_b = wba.tree_map(shift, imu_b)
        slot = min(st.abuf_n, A - 1)
        q_b = _put(q_b, slot, w.q[k])
        p_b = _put(p_b, slot, w.p[k])
        if slot > 0:
            fslot = min(max(slot - 1, 0), A - 2)
            imu_b = wba.tree_map(lambda a, b: _put(a, fslot, b), imu_b,
                                 factor)
            fv = fv & (torch.arange(A - 1, device=dev) != fslot)
            if have_prev:
                fv = fv | (torch.arange(A - 1, device=dev) == fslot)
        n_new = min(st.abuf_n + 1, A)
        st = st._replace(abuf_q=q_b, abuf_p=p_b, abuf_imu=imu_b,
                         abuf_fvalid=fv, abuf_n=n_new, abuf_last_ts=F32(ts))

        # ---- closed-form alignment over the buffer ----------------------
        filled = torch.arange(A, device=dev) < n_new
        fvalid = (st.abuf_fvalid & filled[:-1] & filled[1:]
                  & (st.abuf_imu.dt > 1e-4))
        gates = self.opts._replace(
            vi_align_min_factors=self.align_min_factors,
            vi_align_max_sigma=self.align_max_rel_std)
        alpha, _, _, ok, rel = wba.alignment_solve(
            st.abuf_q, st.abuf_p, st.abuf_imu.delta_p, st.abuf_imu.delta_v,
            st.abuf_imu.dt, fvalid, gates)
        log_a = torch.log(torch.clamp(alpha, min=1e-6))
        fire = ok & (torch.abs(log_a) > self.align_deadband)
        a_damp = torch.exp(self.align_damping * log_a)
        a_app = torch.where(fire, torch.clamp(a_damp, 0.5, 2.0), 1.0)

        w_diag = w._replace(align_min_rel=torch.minimum(w.align_min_rel,
                                                        rel))
        # rescale about the current body position; selected by `fire` on
        # the device (drops the marginalization prior like a loop fix)
        c = w_diag.p[k]
        sv = w_diag.state_valid[:, None]
        p_new = c[None] + a_app * (w_diag.p - c[None])
        v_new = torch.where(sv, a_app * w_diag.v, w_diag.v)
        rescaled = w_diag._replace(
            p=p_new, v=v_new,
            lm_pos=c[None] + a_app * (w_diag.lm_pos - c[None]),
            q0=w_diag.q, p0=p_new, v0=v_new, bg0=w_diag.bg, ba0=w_diag.ba,
            H_prior=torch.zeros_like(w_diag.H_prior),
            b_prior=torch.zeros_like(w_diag.b_prior),
            has_prior=torch.zeros_like(w_diag.has_prior),
            align_n=w_diag.align_n + 1,
            align_log=w_diag.align_log + torch.log(a_app))
        abuf_p = torch.where(fire, c[None] + a_app * (st.abuf_p - c[None]),
                             st.abuf_p)
        return st._replace(window=wba.tree_where(fire, rescaled, w_diag),
                           abuf_p=abuf_p, pending_scale=a_app, abuf_rel=rel)

    def _marginalize_program(self, st: DeviceBackendState
                             ) -> DeviceBackendState:
        """Slide the window AND the per-state obs segments by one."""
        mok = self.mok
        w = wba.marginalize_oldest(st.window, self.T_cam_body, self.focal,
                                   self.opts)

        def roll_seg(x):
            return torch.cat([x[mok:], torch.zeros_like(x[:mok])], dim=0)

        w = w._replace(obs_state=roll_seg(w.obs_state),
                       obs_lm=roll_seg(w.obs_lm), obs_f=roll_seg(w.obs_f),
                       obs_valid=roll_seg(w.obs_valid))
        return st._replace(window=w)

    def _apply_program(self, st: DeviceBackendState, ring, pool, frame,
                       T_new: SE3, chi2):
        """Merge the correction into the frontend (reference
        loadMapFromBundleAdjustment frame_handler_base.cpp:263-311), gated
        like its scale-stability check (JAX device_interface.py:479-635):
        pose jump and solve health, a damped common-mode scale (or the
        buffer's staged one) applied to the whole frontend map as a
        similarity, and landmark feedback for well-observed slots. Returns
        (ring, pool, frame, s, c): the applied scale and its centre. The
        frame is written into the ring's newest slot (in place), as the
        JAX program does."""
        w = st.window
        L = self.L
        P = pool.capacity

        dt_jump = torch.linalg.norm(T_new.t - frame.T_cam_world.t)
        n_live = torch.clamp(torch.sum(w.obs_valid.long()), min=1)
        healthy = chi2 / n_live.to(torch.float32) < self.max_chi2_per_obs
        pose_ok = (dt_jump < self.max_pose_correction) & healthy
        c_opt = T_new.inverse().t              # optimized camera center
        c_old = frame.T_cam_world.inverse().t  # pre-correction center

        n_obs = segment_sum(
            w.obs_valid.long(),
            torch.where(w.obs_valid, torch.clamp(w.obs_lm, 0, L - 1), L), L)
        old_pos = pool.pos[torch.clamp(st.slot_lid, 0, P - 1)]
        well = (st.slot_lid >= 0) & w.lm_valid & (n_obs >= 2)
        observable = st.abuf_rel < self.scale_obs_max_rel_std

        if self.scale_correction:
            d_new = torch.linalg.norm(w.lm_pos - c_opt[None], dim=-1)
            d_old = torch.clamp(torch.linalg.norm(old_pos - c_old[None],
                                                  dim=-1), min=1e-6)
            ratio = d_new / d_old
            sup = well & torch.isfinite(ratio) & (ratio > 0.1) & (ratio < 10.)
            s_raw = masked_median(ratio, sup)
            log_raw = torch.log(torch.clamp(s_raw, min=1e-6))
            trust = (healthy & observable
                     & (torch.sum(sup.long()) >= self.min_scale_support)
                     & torch.isfinite(s_raw)
                     & (torch.abs(log_raw) > self.scale_deadband))
            s_damped = torch.exp(self.scale_damping * log_raw)
            s = torch.where(trust, torch.clamp(
                s_damped, 1.0 / self.max_scale_step, self.max_scale_step),
                1.0)
            clip_binds = trust & (torch.abs(
                torch.log(torch.clamp(s_damped, min=1e-6))
                - torch.log(s)) > 0.02)
        else:
            s = torch.ones((), device=w.q.device)
            clip_binds = torch.zeros((), dtype=torch.bool, device=w.q.device)

        # the buffer's staged similarity overrides the per-solve transfer
        pend = (torch.abs(torch.log(torch.clamp(st.pending_scale,
                                                min=1e-6))) > 1e-6)
        s = torch.where(pend, st.pending_scale, s)
        clip_binds = clip_binds & ~pend

        pose_ok = pose_ok & ~clip_binds
        T_use = T_new.where(pose_ok, frame.T_cam_world)
        c = torch.where(pose_ok, c_opt, c_old)

        # similarity about c over the whole frontend map: x' = c + s(x−c)
        pool_scaled = c[None] + s * (pool.pos - c[None])
        old_scaled = c[None] + s * (old_pos - c[None])
        disp = torch.linalg.norm(w.lm_pos - old_scaled, dim=-1)
        depth = torch.clamp(torch.linalg.norm(w.lm_pos - c[None], dim=-1),
                            min=1e-3)
        lm_ok = well & (disp < 0.2 * depth) & pose_ok & observable
        tgt = torch.where(lm_ok, st.slot_lid, P)
        pool = pool._replace(pos=set_drop(pool_scaled, tgt, w.lm_pos))

        # ring keyframe centres rescaled about c (rotations unchanged)
        Tcw_ring = ring.frames.T_cam_world
        ci = Tcw_ring.inverse().t
        ci2 = c[None] + s * (ci - c[None])
        t_ring = -quat_rotate(Tcw_ring.q, ci2)
        # seeds store INVERSE depth in their keyframe: a similarity about c
        # multiplies every depth by s
        def scale_seeds(x):
            return torch.cat([x[..., 0:1] / s, x[..., 1:2] / (s * s),
                              x[..., 2:4]], dim=-1)

        frames = ring.frames._replace(
            T_cam_world=SE3(Tcw_ring.q, t_ring),
            seed_state=scale_seeds(ring.frames.seed_state),
            seed_mu_range=ring.frames.seed_mu_range / s)
        frame = frame._replace(T_cam_world=T_use,
                               seed_state=scale_seeds(frame.seed_state),
                               seed_mu_range=frame.seed_mu_range / s)
        ring = insert_keyframe(ring._replace(frames=frames), frame,
                               ring.last_added)
        return ring, pool, frame, s, c

    # ------------------------------------------------------------------
    # host API (JAX device_interface.py:640-677)
    # ------------------------------------------------------------------
    def add_keyframe_device(self, timestamp: float, frame, pool,
                            imu_handler=None):
        """One keyframe step of the host handlers: marginalize when the
        window is full, absorb ``frame`` (its pose, landmark ids, bearings
        and ``pool``'s positions) with the IMU factor over
        ``imu_handler.window_between`` since the previous keyframe,
        optimize. Returns (T_cam_world_new, visual chi2), both on the
        device; nothing is read back.

        As in the JAX package, the window's times are relative to its first
        sample (not to the frame), so the long-horizon alignment buffer
        preintegrates nothing here and never fires (ROADMAP Queue 3: scale
        transfer is disabled on the host path)."""
        if self.n_states == self.S:
            self.state = self._marginalize_program(self.state)
            self.n_states -= 1
            self._ts.pop(0)
        k = self.n_states
        dt_prev = (timestamp - self._ts[-1]) if self.n_states else 0.0
        if imu_handler is not None and self.n_states:
            w = imu_handler.window_between(self._ts[-1], timestamp)
            packed_host = np.concatenate(
                [w.t.numpy()[:, None], w.gyro.numpy(), w.acc.numpy(),
                 w.valid.numpy()[:, None]], axis=1).astype(np.float32)
            # no factor across a tracking outage (stale velocities)
            use_imu = dt_prev < self.max_imu_gap
        else:
            m = getattr(imu_handler, "window_size", 16)
            packed_host = np.zeros((m, 8), np.float32)
            use_imu = False
        packed = torch.from_numpy(packed_host)
        if self.device.type == "cuda":
            packed = packed.pin_memory().to(self.device, non_blocking=True)
        iw, steps = masked_window(packed, packed_host,
                                  packed_host[:, 7] > 0.5)
        self.state, T_new, chi2 = self._solve_step(
            self.state, k, F32(dt_prev), F32(timestamp), frame.T_cam_world,
            frame.landmark_id, frame.f, frame.valid_mask(), pool.pos, iw,
            steps, packed, packed_host, use_imu, False)
        self.n_states += 1
        self._ts.append(timestamp)
        return T_new, chi2

    def reset(self) -> None:
        self.n_states = 0
        self._ts = []
        self.state = self._fresh_state()
