"""Global map: absorbs keyframes as they leave the sliding window, runs a
large-window bundle adjustment, and feeds its optimized landmarks back to
the frontend as fixed landmarks.

Counterpart of ``svo_pro_universal_tpu/backend/global_map.py`` (reference
extra/svo_global_map/src/global_map.cpp — GlobalMap::addKeyframe
global_map.h:228, graph_manager.cpp smart factors :271-330; fixed-landmark
feedback reprojector.h:64-69 + frame_handler_base.cpp:662-676). As in the
JAX package the global problem is a larger fixed-shape window solved with
the sliding window's Schur machinery (backend.window_ba):

- a weak pose anchor per state holds the vision-only gauge, scale
  included;
- observations live in per-state segments (state k owns rows
  [k·mok, (k+1)·mok)), cleared before they are filled;
- a landmark slot reused by a new id invalidates the rows that still name
  it;
- when the state ring is full the oldest state is evicted: states and
  segments shift down one, and the new oldest state gets a tight anchor at
  its current estimate (``_evict_program``);
- an optional IMU factor links consecutive states.

The window lives on the card unless ``device`` says otherwise.

With ``mesh`` / ``mesh_axes`` (``parallel.mesh``) every solve is
map-block-partitioned (JAX global_map.py:78-115): it runs on a partitioned
copy (``sharded_ba.partition_observations``, then ``distributed_optimize``)
and copies the states and landmarks back, so the stored observation rows
keep their insertion order; dropped rows are counted in
``last_dropped_obs`` and warned about. Every rank makes the same calls
(SPMD). The JAX package hands out landmark slots in cursor order, so the
first L/n landmarks all fall in shard 0 and its slice overflows as soon as
they are seen more than No/n times; here the cursor is dealt round-robin
over the shards (slot = (c mod n)·L/n + c div n), which leaves a one-shard
map as it was and spreads a partitioned one evenly.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.backend.interface import put_rows
from svo_pro_universal_tpu_torch.frontend.frame_handler import resolve_device
from svo_pro_universal_tpu_torch.parallel import sharded_ba as sba
from svo_pro_universal_tpu_torch.parallel.mesh import FEATURE_AXIS
from svo_pro_universal_tpu_torch.utils.transform import SE3


class GlobalMapOptions(NamedTuple):
    max_keyframes: int = 32
    max_landmarks: int = 1024
    max_obs: int = 4096
    max_obs_per_kf: int = 100
    optimize_every: int = 4        # run BA every N added keyframes
    ba_iters: int = 4
    # weak anchor toward the fed poses: holds the 7-dof vision-only gauge,
    # scale included
    pose_anchor_sigma_t: float = 0.2
    pose_anchor_sigma_r: float = 0.1
    # the tighter anchor an evicted state's successor gets at its current
    # estimate
    evict_anchor_sigma_t: float = 0.02
    evict_anchor_sigma_r: float = 0.01


def _anchor(sigma_t: float, sigma_r: float, device) -> torch.Tensor:
    """[15, 15] diagonal pose anchor: translation, rotation, nothing on
    velocity and biases."""
    wt = 1.0 / sigma_t ** 2
    wr = 1.0 / sigma_r ** 2
    return torch.diag(torch.tensor([wt] * 3 + [wr] * 3 + [0.0] * 9,
                                   dtype=torch.float32, device=device))


class GlobalMap:
    def __init__(self, cam_focal, T_cam_body: SE3,
                 opts: GlobalMapOptions = GlobalMapOptions(),
                 mesh=None, mesh_axes: tuple | None = None, device=None):
        if mesh is None and mesh_axes is not None:
            raise ValueError("GlobalMap: mesh_axes without a mesh")
        self.mesh = mesh
        self.mesh_axes = (tuple(mesh_axes or (FEATURE_AXIS,))
                          if mesh is not None else None)
        self._n_shards = 1 if mesh is None else mesh.size(self.mesh_axes)
        if opts.max_landmarks % self._n_shards or \
                opts.max_obs % self._n_shards:
            raise ValueError(f"max_landmarks {opts.max_landmarks} and "
                             f"max_obs {opts.max_obs} must split over "
                             f"{self._n_shards} shards")
        self.last_dropped_obs = 0
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        self.opts = opts
        self.T_cam_body = SE3(T_cam_body.q.to(self.device),
                              T_cam_body.t.to(self.device))
        self.focal = torch.as_tensor(cam_focal, dtype=torch.float32).to(
            self.device)
        if opts.max_obs < opts.max_keyframes * opts.max_obs_per_kf:
            raise ValueError("the segmented observation store needs "
                             "max_obs >= max_keyframes * max_obs_per_kf")
        self.window = wba.make_window(opts.max_keyframes, opts.max_landmarks,
                                      opts.max_obs, self.device)
        self.n_states = 0
        self.kf_ids: list[int] = []
        self.lid2slot: dict[int, int] = {}
        self.slot2lid: dict[int, int] = {}
        self._lm_cursor = 0
        self._obs_cursor = 0
        self._since_opt = 0
        self._reused_slots: list[int] = []
        self.ba_opts = wba.BAOptions(max_iter=opts.ba_iters)

    def _optimize(self, w: wba.Window) -> tuple[wba.Window, torch.Tensor]:
        if self.mesh is None:
            w, chi2, _ = wba.optimize(w, self.T_cam_body, self.focal,
                                      self.ba_opts)
            return w, chi2
        part, n_dropped = sba.partition_observations(w, self._n_shards)
        self.last_dropped_obs = n_dropped
        if n_dropped:
            warnings.warn(
                f"global-map distributed solve dropped {n_dropped} "
                f"observation rows (a shard's slice overflowed); increase "
                f"max_obs or the shard count")
        wp, chi2, _ = sba.distributed_optimize(
            part, self.T_cam_body, self.focal, self.mesh, self.ba_opts,
            self.mesh_axes)
        return w._replace(q=wp.q, p=wp.p, v=wp.v, bg=wp.bg, ba=wp.ba,
                          lm_pos=wp.lm_pos, lm_valid=wp.lm_valid), chi2

    def _evict_program(self, w: wba.Window) -> wba.Window:
        """Slide the ring: drop state 0, shift everything down one slot,
        and re-anchor the new oldest state at its current (optimized)
        estimate with a tight prior (JAX global_map.py:119-165)."""
        D = w.S * wba.DOF
        DOF = wba.DOF
        mok = self.opts.max_obs_per_kf

        def shift(x):
            return torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)

        def roll_seg(x):
            return torch.cat([x[mok:], torch.zeros_like(x[:mok])], dim=0)

        Hp = torch.zeros_like(w.H_prior)
        Hp[: D - DOF, : D - DOF] = w.H_prior[DOF:, DOF:]
        Hp[:DOF, :DOF] += _anchor(self.opts.evict_anchor_sigma_t,
                                  self.opts.evict_anchor_sigma_r,
                                  Hp.device)
        bp = torch.zeros_like(w.b_prior)
        bp[: D - DOF] = w.b_prior[DOF:]
        return w._replace(
            q=shift(w.q), p=shift(w.p), v=shift(w.v), bg=shift(w.bg),
            ba=shift(w.ba), state_valid=shift(w.state_valid),
            obs_state=roll_seg(w.obs_state - 1),
            obs_lm=roll_seg(w.obs_lm), obs_f=roll_seg(w.obs_f),
            obs_valid=roll_seg(w.obs_valid & (w.obs_state >= 1)),
            imu=wba.tree_map(shift, w.imu), imu_info=shift(w.imu_info),
            imu_valid=shift(w.imu_valid), zupt=shift(w.zupt),
            H_prior=Hp, b_prior=bp,
            # the anchors are absolute pulls toward q0/p0: re-linearize at
            # the shifted current estimates
            q0=shift(w.q), p0=shift(w.p), v0=shift(w.v), bg0=shift(w.bg),
            ba0=shift(w.ba))

    def __len__(self):
        return self.n_states

    def _lm_slot(self, lid: int) -> int:
        if lid in self.lid2slot:
            return self.lid2slot[lid]
        c = self._lm_cursor % self.opts.max_landmarks
        n = self._n_shards
        slot = (c % n) * (self.opts.max_landmarks // n) + c // n
        self._lm_cursor += 1
        old = self.slot2lid.pop(slot, None)
        if old is not None:
            self.lid2slot.pop(old, None)
            # stale observation rows must not alias the slot's new owner
            self._reused_slots.append(slot)
        self.lid2slot[lid] = slot
        self.slot2lid[slot] = lid
        return slot

    def add_keyframe(self, kf_id: int, T_cam_world: SE3,
                     landmark_ids: np.ndarray, bearings: np.ndarray,
                     lm_positions: np.ndarray, imu_factor=None,
                     imu_info=None) -> Optional[float]:
        """Absorb a keyframe (reference doc/global_map.md:5-13 handoff).
        Returns the BA chi2 when a solve ran. When the state ring is full
        the oldest state is evicted first. ``imu_factor`` / ``imu_info``:
        an optional preintegrated factor from the previous added keyframe
        to this one (reference CombinedImuFactor,
        graph_manager.cpp:331-360)."""
        if self.n_states >= self.opts.max_keyframes:
            self.window = self._evict_program(self.window)
            self.n_states -= 1
            self.kf_ids.pop(0)
        k = self.n_states
        w = self.window
        T_cam_world = SE3(T_cam_world.q.to(self.device),
                          T_cam_world.t.to(self.device))
        T_w_b = T_cam_world.inverse().compose(self.T_cam_body)
        # anchor prior block on this state's pose (gauge incl. scale)
        d0 = k * wba.DOF
        Hp = w.H_prior.clone()
        Hp[d0:d0 + wba.DOF, d0:d0 + wba.DOF] = _anchor(
            self.opts.pose_anchor_sigma_t, self.opts.pose_anchor_sigma_r,
            self.device)
        w = w._replace(
            q=put_rows(w.q, [k], T_w_b.q[None]),
            p=put_rows(w.p, [k], T_w_b.t[None]),
            q0=put_rows(w.q0, [k], T_w_b.q[None]),
            p0=put_rows(w.p0, [k], T_w_b.t[None]),
            H_prior=Hp, has_prior=torch.ones_like(w.has_prior),
            state_valid=put_rows(w.state_valid, [k], True))

        landmark_ids = np.asarray(landmark_ids)
        sel = np.nonzero(landmark_ids >= 0)[0][: self.opts.max_obs_per_kf]
        self._reused_slots = []
        obs_l, obs_f, new_slots, new_pos = [], [], [], []
        for i in sel:
            lid = int(landmark_ids[i])
            fresh = lid not in self.lid2slot
            slot = self._lm_slot(lid)
            if fresh:
                new_slots.append(slot)
                new_pos.append(lm_positions[i])
            obs_l.append(slot)
            obs_f.append(bearings[i])
        if self._reused_slots:
            reused = torch.as_tensor(sorted(set(self._reused_slots)),
                                     dtype=torch.long, device=self.device)
            stale = torch.any(w.obs_lm[None, :] == reused[:, None], dim=0)
            w = w._replace(obs_valid=w.obs_valid & ~stale)
        # segmented observation store: clear state k's segment, then fill
        mok = self.opts.max_obs_per_kf
        seg = (k * mok + np.arange(mok)).tolist()
        w = w._replace(obs_valid=put_rows(w.obs_valid, seg, False))
        if obs_l:
            n = len(obs_l)
            idx = seg[:n]
            w = w._replace(
                obs_state=put_rows(w.obs_state, idx, [k] * n),
                obs_lm=put_rows(w.obs_lm, idx, obs_l),
                obs_f=put_rows(w.obs_f, idx,
                               np.stack(obs_f).astype(np.float32)),
                obs_valid=put_rows(w.obs_valid, idx, True))
        if new_slots:
            w = w._replace(
                lm_pos=put_rows(w.lm_pos, new_slots,
                                np.stack(new_pos).astype(np.float32)),
                lm_valid=put_rows(w.lm_valid, new_slots, True))

        # IMU factor linking the previous global state to this one
        if imu_factor is not None and imu_info is not None and k > 0:
            w = w._replace(
                imu=wba.tree_map(lambda a, f: put_rows(
                    a, [k - 1], torch.as_tensor(f)[None]), w.imu,
                    imu_factor),
                imu_info=put_rows(w.imu_info, [k - 1],
                                  torch.as_tensor(imu_info)[None]),
                imu_valid=put_rows(w.imu_valid, [k - 1], True))

        self.window = w
        self.n_states = k + 1
        self.kf_ids.append(kf_id)
        self._since_opt += 1
        if self._since_opt >= self.opts.optimize_every and k >= 2:
            self._since_opt = 0
            self.window, chi2 = self._optimize(self.window)
            return float(chi2)
        return None

    def force_optimize(self) -> float:
        self._since_opt = 0
        self.window, chi2 = self._optimize(self.window)
        return float(chi2)

    def keyframe_poses(self) -> tuple[np.ndarray, list[int]]:
        """(T_world_body positions [n, 3], keyframe ids) for viz / PGO."""
        n = self.n_states
        return self.window.p[:n].cpu().numpy(), list(self.kf_ids)

    def optimized_landmarks(self) -> tuple[np.ndarray, np.ndarray]:
        """Every globally-optimized landmark as (landmark ids [n],
        positions [n, 3]), for re-injection into the frontend pool
        (reference frame_handler_base.cpp:662-676). One read."""
        w = self.window
        packed = torch.cat([w.lm_valid[:, None].to(torch.float32),
                            w.lm_pos], dim=1).cpu().numpy()
        slots = np.nonzero(packed[:, 0] > 0.5)[0]
        ids = np.asarray([self.slot2lid.get(int(s), -1) for s in slots],
                         np.int32)
        keep = ids >= 0
        return ids[keep], packed[slots, 1:][keep]

    def fixed_landmarks(self, T_cam_world: SE3, max_out: int = 50
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Globally-optimized landmarks in front of a pose, for the
        frontend's FIXED_LANDMARK reprojection (reference
        reprojector.h:64-69). Returns (ids, positions). One read."""
        w = self.window
        T = SE3(T_cam_world.q.to(self.device), T_cam_world.t.to(self.device))
        vis = w.lm_valid & (T.apply(w.lm_pos)[:, 2] > 0.1)
        packed = torch.cat([vis[:, None].to(torch.float32), w.lm_pos],
                           dim=1).cpu().numpy()
        slots = np.nonzero(packed[:, 0] > 0.5)[0][:max_out]
        ids = np.asarray([self.slot2lid.get(int(s), -1) for s in slots],
                         np.int32)
        return ids, packed[slots, 1:]
