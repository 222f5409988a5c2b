"""SLAM host handler: the mono frontend + loop closing + pose-graph
correction + global map.

Counterpart of ``svo_pro_universal_tpu/frontend/slam.py`` (reference
wiring: keyframe handoff to loop closing frame_handler_base.cpp:447-453
addFrameToPR, correction consumption :368-455, PGO feed
loop_closing.cpp:677-720, global-map absorption doc/global_map.md:5-13).
Each keyframe, synchronously: a loop-closing snapshot, a pose-graph node
and odometry constraint, a database query and verification; on a verified
loop the graph is optimized (15 LM iterations) and the correction applied
to the whole map as one rigid world transform; then the keyframe is
absorbed by the global map (keyed by the pool's unique landmark ids), and
after each global solve its landmarks go back into the pool as FIXED.

Host reads per keyframe: one transfer of the keyframe's pose, landmark ids,
validity, bearings and pool positions and unique ids (``_keyframe_rows``),
plus the loop closer's own (a query, a verification) and the global map's
after a solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import pgo as pgo_mod
from svo_pro_universal_tpu_torch.backend.global_map import GlobalMap
from svo_pro_universal_tpu_torch.backend.loop_closing import (
    LoopClosing, LoopClosingOptions, snapshot_keyframe)
from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono, FrameResult, _feature_world_points)
from svo_pro_universal_tpu_torch.utils.indexing import set_drop
from svo_pro_universal_tpu_torch.utils.transform import SE3


class FrameHandlerSLAM(FrameHandlerMono):
    """Mono VO with loop closing, a pose graph and a global map; on the card
    unless ``device`` says otherwise."""

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None, seed: int = 0,
                 lc_opts: LoopClosingOptions = LoopClosingOptions(),
                 max_pgo_nodes: int = 256, use_global_map: bool = True,
                 global_map_mesh=None,
                 global_map_mesh_axes: tuple | None = None, device=None):
        super().__init__(cfg, cam, T_cam_body=T_cam_body, seed=seed,
                         device=device)
        self.loop_closer = LoopClosing(lc_opts, device=self.device)
        self.graph = pgo_mod.make_graph(max_pgo_nodes, 2 * max_pgo_nodes,
                                        self.device)
        self._pgo_n = 0
        self._pgo_c = 0
        self._kf_poses: list[SE3] = []       # T_world_cam per pgo node
        self.global_map = (GlobalMap(self.cam.focal_length, self.T_cam_body,
                                     mesh=global_map_mesh,
                                     mesh_axes=global_map_mesh_axes,
                                     device=self.device)
                           if use_global_map else None)
        self.n_loops_closed = 0
        self._uid2slot: dict[int, int] = {}  # unique landmark id → slot

    # ------------------------------------------------------------------
    def _snapshot_data(self, ring, pool, frame):
        """Feature depths and validity for the loop-closing snapshot."""
        xyz_w, has = _feature_world_points(frame, ring, pool)
        p_cam = frame.T_cam_world.apply(xyz_w)
        depth = torch.linalg.norm(p_cam, dim=-1)
        valid = frame.valid_mask() & has & (p_cam[:, 2] > 1e-6)
        return depth, valid

    def _apply_correction(self, ring, pool, frame, delta: SE3):
        """Rigid world-frame correction ``delta`` (world_new ← world_old)
        applied to every pose and landmark (reference
        setCorrectionInWorld / transformMap)."""
        inv = delta.inverse()
        frames = ring.frames._replace(
            T_cam_world=ring.frames.T_cam_world.compose(inv))
        pool = pool._replace(pos=delta.apply(pool.pos))
        frame = frame._replace(T_cam_world=frame.T_cam_world.compose(inv))
        return ring._replace(frames=frames), pool, frame

    def _keyframe_rows(self, kf, valid) -> tuple:
        """ONE read of the keyframe's rows for the global map: landmark ids
        (−1 where not valid), pool unique ids, bearings and pool
        positions."""
        P = self.pool.capacity
        slots = torch.where(valid, kf.landmark_id, -1)
        slotc = torch.clamp(slots, 0, P - 1)
        rows = torch.cat([slots[:, None].to(torch.float64),
                          self.pool.ids[slotc][:, None].to(torch.float64),
                          kf.f.to(torch.float64),
                          self.pool.pos[slotc].to(torch.float64)], dim=1)
        out = rows.cpu().numpy()
        self.host_reads += 1
        slots = out[:, 0].astype(np.int64)
        uids = np.where(slots >= 0, out[:, 1].astype(np.int64), -1)
        return (slots, uids, out[:, 2:5].astype(np.float32),
                out[:, 5:8].astype(np.float32))

    def _process_tracking(self, img, timestamp: float) -> FrameResult:
        res = super()._process_tracking(img, timestamp)
        if not res.is_keyframe:
            return res
        kf = self.last_frame
        depth, valid = self._snapshot_data(self.ring, self.pool, kf)
        snap = snapshot_keyframe(
            kf.image, kf.px, kf.f, torch.where(valid, depth, 0.0), valid,
            self.loop_closer.opts)
        node = self._pgo_n
        # pose-graph nodes store T_world_cam, so relative constraints are
        # world-free: T_i⁻¹·T_j = T_cami_camj
        T_cw = kf.T_cam_world
        T_wc = T_cw.inverse()
        g = self.graph
        if node < g.N:
            g = g._replace(q=pgo_mod.put(g.q, node, T_wc.q),
                           t=pgo_mod.put(g.t, node, T_wc.t),
                           node_valid=pgo_mod.put(g.node_valid, node, True))
            if node > 0 and self._pgo_c < g.C:
                T_ij = self._kf_poses[-1].inverse().compose(T_wc)
                g = pgo_mod.add_constraint(g, self._pgo_c, node - 1, node,
                                           T_ij)
                self._pgo_c += 1
            self._kf_poses.append(T_wc)
            self._pgo_n += 1
        self.graph = g

        constraint = self.loop_closer.add_keyframe(
            node, snap, self.cam.focal_length)
        if constraint is not None and self._pgo_c < self.graph.C:
            # verified T_cur_old maps old-cam → cur-cam: with i = cur and
            # j = old the measurement is T_camcur_camold
            self.graph = pgo_mod.add_constraint(
                self.graph, self._pgo_c, constraint.kf_id_from,
                constraint.kf_id_to, constraint.T_cur_old,
                weight_rot=50.0, weight_trans=50.0)
            self._pgo_c += 1
            self.graph, _ = pgo_mod.optimize(self.graph, max_iter=15)
            self.n_loops_closed += 1
            # the latest pose's correction as a rigid map update:
            # x_new = delta·x_old, delta = T_opt_wc · T_cam_world_old
            delta = SE3(self.graph.q[node], self.graph.t[node]).compose(T_cw)
            self.ring, self.pool, self.last_frame = self._apply_correction(
                self.ring, self.pool, self.last_frame, delta)
            self._kf_poses = [SE3(self.graph.q[i], self.graph.t[i])
                              for i in range(len(self._kf_poses))]
            self.stats["loop_closed_to"] = constraint.kf_id_to

        if self.global_map is not None:
            slots, uids, f, lm_pos = self._keyframe_rows(kf, valid)
            # key the global map by the pool's unique landmark id, so slot
            # reuse in the frontend pool cannot alias global states
            for s, u in zip(slots.tolist(), uids.tolist()):
                if s >= 0 and u >= 0:
                    self._uid2slot[u] = s
            chi2 = self.global_map.add_keyframe(node, T_cw, uids, f, lm_pos)
            if chi2 is not None:
                self._reinject_fixed_landmarks()
        return res

    def _reinject_fixed_landmarks(self) -> None:
        """Write the globally-optimized landmark positions back into the
        pool and mark them FIXED (reference frame_handler_base.cpp:662-676
        + reprojector.h:64-69): fixed points win reprojection-grid priority
        and leave the frontend's structure GN."""
        uids, pos = self.global_map.optimized_landmarks()
        if uids.size == 0:
            return
        slots = np.asarray([self._uid2slot.get(int(u), -1) for u in uids],
                           np.int64)
        keep = slots >= 0
        if not keep.any():
            return
        dev = self.device
        s = torch.from_numpy(slots[keep]).to(dev)
        p = torch.from_numpy(np.ascontiguousarray(pos[keep],
                                                  np.float32)).to(dev)
        u = torch.from_numpy(uids[keep].astype(np.int64)).to(dev)
        pool = self.pool
        ok = pool.valid[s] & (pool.ids[s] == u)
        widx = torch.where(ok, s, pool.capacity)
        self.pool = pool._replace(pos=set_drop(pool.pos, widx, p),
                                  fixed=set_drop(pool.fixed, widx, True))
        self.stats["n_fixed_landmarks"] = torch.sum(ok.long())  # on demand

    def _process_reloc(self, frame) -> FrameResult:
        """Relocalize against the whole keyframe database by place
        recognition and 3D-2D verification before the closest-keyframe
        retry (JAX slam.py:181-209)."""
        if len(self.loop_closer) >= 1:
            det_frame, _ = self._detect_into_frame(frame,
                                                   self._depth_scalars())
            snap = snapshot_keyframe(
                det_frame.image, det_frame.px, det_frame.f,
                torch.zeros((self.max_fts,), device=self.device),
                det_frame.valid_mask(), self.loop_closer.opts)
            cand = self.loop_closer._query(snap, include_recent=True)
            if cand is not None:
                out = self.loop_closer._verify(-1, snap, cand,
                                               self.cam.focal_length)
                if out is not None:
                    # cand.kf_id is a database row: map it through kf_ids
                    node_id = int(self.loop_closer.kf_ids[cand.kf_id])
                    T_old_wc = self._kf_poses[node_id]
                    self.last_frame = self.last_frame._replace(
                        T_cam_world=out.T_cur_old.compose(
                            T_old_wc.inverse()))
                    self.stats["reloc_pr_node"] = node_id
        return super()._process_reloc(frame)

    def pgo_trajectory(self) -> np.ndarray:
        """Optimized keyframe camera positions [n, 3] (nodes are
        T_world_cam, so translations are camera centres)."""
        return self.graph.t[:self._pgo_n].cpu().numpy()
