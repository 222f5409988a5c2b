"""Mono SLAM on one device: ``DevicePipelineSLAM``, the VIO pipeline plus
loop closing, pose-graph optimization and a global landmark map.

Counterpart of ``svo_pro_universal_tpu/frontend/pipeline_slam.py``. On every
keyframe the tracking branch, after the VIO backend, runs the SLAM step:

- a snapshot of the keyframe (place descriptor, its best-scored features
  with depths, bearings and level-0 patches) goes into a device ring, the
  loop-closure database, after a place query against the rows at least
  ``min_temporal_gap`` pose-graph nodes older;
- the keyframe becomes a pose-graph node with a sequential constraint;
- the most similar eligible row, at or above ``min_similarity``, is
  verified (``loop_closing.verify_candidate``: mutual-NN patch matching,
  the Sim3 seed, the two-stage pose GN); a verified loop adds its
  constraint, optimizes the graph, and
  applies the rigid correction of the newest node to the frontend (ring,
  pool, frame) and to the backend window (states, landmarks,
  linearization points; the marginalization prior and the alignment
  buffer are dropped);
- the global landmark store absorbs the snapshot's new landmarks, is
  refined by batched structure-only GN against the graph's node poses,
  and every ``gm_feedback_every`` nodes feeds back into the pool as fixed
  landmarks.

The JAX package selects these branches with ``lax.cond`` inside one jitted
step. Here the keyframe decision and the stage are host values already, the
node, constraint and database counters are host integers, and the
data-dependent gates are read from the device: one read a keyframe (the
candidate's similarity against the gate) and one a verification (verified
or not), so a keyframe without a candidate launches no verification and one
without a loop no graph optimization. The Sim3 seed's 3×3 SVDs add their
own synchronizations on candidate keyframes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import loop_closing as lc_mod
from svo_pro_universal_tpu_torch.backend import pgo as pgo_mod
from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    Stage, _feature_world_points)
from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
    DevicePipelineVIO)
from svo_pro_universal_tpu_torch.ops.interp import extract_patches
from svo_pro_universal_tpu_torch.utils.indexing import (
    segment_sum, set_drop, topk_stable)
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, quat_multiply, quat_normalize, quat_to_matrix)


class SlamOptions(NamedTuple):
    """Capacities and gates of the SLAM stack."""
    # loop-closure database (device ring; evicts the oldest past capacity)
    max_db_keyframes: int = 256
    snap_features: int = 96          # features stored per snapshot
    patch_size: int = 16
    descriptor_cells: tuple = (4, 5)
    descriptor_bins: int = 8
    min_similarity: float = 0.8
    min_temporal_gap: int = 8        # in pose-graph node ids
    ratio_test: float = 0.8
    # per-px gate in unit-variance patch units (2(1−NCC))
    max_match_zmssd_per_px: float = 1.6
    min_inliers: int = 20
    verify_iters: int = 15
    ransac_thresh_px: float = 2.0
    # pose graph
    max_nodes: int = 256
    pgo_iters: int = 12
    loop_weight: float = 50.0
    # global map
    gm_landmarks: int = 512
    gm_refine_iters: int = 2
    gm_min_obs: int = 3              # observations before a point is fixed
    gm_feedback_every: int = 4       # fixed-landmark feedback cadence


class WorldStateSLAM(NamedTuple):
    """WorldStateVIO + the loop-closure database, the pose graph and the
    global map (the VIO fields first, so the parents' branches work through
    ``_replace``)."""
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
    backend: object
    backend_k: int
    last_kf_ts: np.float32
    imu_packed: torch.Tensor
    backend_chi2: torch.Tensor
    # --- loop-closure keyframe database (ring) ---
    lc_desc: torch.Tensor    # [K, D] place descriptors
    lc_f: torch.Tensor       # [K, N2, 3] feature bearings
    lc_depth: torch.Tensor   # [K, N2] feature depths (0 = unknown)
    lc_patch: torch.Tensor   # [K, N2, P²]
    lc_px: torch.Tensor      # [K, N2, 2]
    lc_fvalid: torch.Tensor  # [K, N2]
    lc_node: torch.Tensor    # [K] pose-graph node of the row (-1 empty)
    lc_uid: torch.Tensor     # [K, N2] pool landmark uid per feature (-1)
    lc_n: int                # host: total adds (write row = lc_n % K)
    # --- pose graph ---
    pgo: pgo_mod.PoseGraph
    pgo_n: int               # host: nodes added
    pgo_c: int               # host: constraints
    n_loops: int             # host: verified loop closures
    last_loop_to: torch.Tensor  # node of the last loop target (-1)
    # --- global landmark store ---
    gm_uid: torch.Tensor     # [G] pool uid per slot (-1 free)
    gm_pos: torch.Tensor     # [G, 3]
    gm_n: torch.Tensor       # ring allocation counter
    lc_best_sim: torch.Tensor  # best eligible query similarity seen
    # verification chain: [candidates checked, last NN matches, last with
    # depth, last GN inliers, max NN, max with depth, max inliers, spare]
    lc_diag: torch.Tensor    # [8]


class DevicePipelineSLAM(DevicePipelineVIO):
    """Mono SLAM: VIO + loop closing + pose graph + global map, on the card
    unless ``device`` says otherwise."""

    def __init__(self, cfg: Config, cam: proj.Camera,
                 T_cam_body: Optional[SE3] = None, seed: int = 0,
                 imu_handler=None, trace_capacity: int = 8192,
                 imu_params=None, gravity=None,
                 slam_opts: SlamOptions = SlamOptions(), device=None):
        self.slam = slam_opts
        super().__init__(cfg, cam, T_cam_body=T_cam_body, seed=seed,
                         imu_handler=imu_handler,
                         trace_capacity=trace_capacity,
                         imu_params=imu_params, gravity=gravity,
                         device=device)

    def _slam_fields(self) -> dict:
        so, dev = self.slam, self.device
        K, N2, G = so.max_db_keyframes, so.snap_features, so.gm_landmarks
        D = (so.descriptor_cells[0] * so.descriptor_cells[1]
             * so.descriptor_bins)
        PP = so.patch_size * so.patch_size

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def full(shape, v, dtype=torch.long):
            return torch.full(shape, v, dtype=dtype, device=dev)

        return dict(
            lc_desc=z(K, D), lc_f=z(K, N2, 3), lc_depth=z(K, N2),
            lc_patch=z(K, N2, PP), lc_px=z(K, N2, 2),
            lc_fvalid=z(K, N2, dtype=torch.bool), lc_node=full((K,), -1),
            lc_uid=full((K, N2), -1), lc_n=0,
            pgo=pgo_mod.make_graph(so.max_nodes, 2 * so.max_nodes, dev),
            pgo_n=0, pgo_c=0, n_loops=0, last_loop_to=full((), -1),
            gm_uid=full((G,), -1), gm_pos=z(G, 3), gm_n=full((), 0),
            lc_best_sim=full((), -1.0, torch.float32),
            lc_diag=full((8,), 0))

    def _make_world(self) -> WorldStateSLAM:
        return WorldStateSLAM(*super()._make_world(), **self._slam_fields())

    def _reset_world_extras(self, world):
        """Full restart: the SLAM stores describe a dead world frame, and
        its counters start again at zero."""
        return super()._reset_world_extras(world)._replace(
            **self._slam_fields())

    # ------------------------------------------------------------------
    # rigid world correction
    # ------------------------------------------------------------------
    def _apply_rigid(self, ring, pool, frame, delta: SE3):
        """x_new = delta · x_old on every frontend pose and landmark
        (reference setCorrectionInWorld / transformMap)."""
        inv = delta.inverse()
        frames = ring.frames._replace(
            T_cam_world=ring.frames.T_cam_world.compose(inv))
        pool = pool._replace(pos=delta.apply(pool.pos))
        frame = frame._replace(T_cam_world=frame.T_cam_world.compose(inv))
        return ring._replace(frames=frames), pool, frame

    def _transform_backend(self, st, delta: SE3):
        """The loop correction reaching the window backend (JAX
        pipeline_slam.py:219-248; reference
        ``remove_marginalization_term_after_correction``,
        ceres_backend_factory.cpp:58): window states, landmarks and
        linearization points move rigidly, the marginalization prior is
        dropped (its information is in pre-correction coordinates), and so
        is the alignment buffer (its poses are pre-correction states)."""
        w = st.window
        q_n = quat_normalize(quat_multiply(delta.q[None], w.q))
        w = w._replace(
            q=q_n, p=delta.apply(w.p), v=delta.rotate(w.v),
            lm_pos=delta.apply(w.lm_pos),
            q0=q_n, p0=delta.apply(w.p0), v0=delta.rotate(w.v0),
            bg0=w.bg, ba0=w.ba,
            H_prior=torch.zeros_like(w.H_prior),
            b_prior=torch.zeros_like(w.b_prior),
            has_prior=torch.zeros_like(w.has_prior))
        return st._replace(window=w,
                           abuf_fvalid=torch.zeros_like(st.abuf_fvalid),
                           abuf_n=0, abuf_last_ts=np.float32(-1.0))

    # ------------------------------------------------------------------
    # global map
    # ------------------------------------------------------------------
    def _gm_slots(self, w: WorldStateSLAM):
        """(eq [K·N2, G]: each stored observation's uid against each global
        slot's, the slot each observation resolves to [K·N2])."""
        uid = w.lc_uid.reshape(-1)
        eq = ((uid[:, None] == w.gm_uid[None, :]) & (uid >= 0)[:, None]
              & (w.gm_uid >= 0)[None, :])
        return eq, torch.argmax(eq.to(torch.uint8), dim=-1)

    def _gm_refine(self, w: WorldStateSLAM) -> torch.Tensor:
        """Batched structure-only GN over the global store: every stored
        observation (a snapshot feature with a uid) constrains its landmark
        against the optimized node poses. One segment sum builds all [G]
        3×3 systems; one batched damped solve updates every point.
        Returns the refined gm_pos."""
        so = self.slam
        G, NN, N2 = so.gm_landmarks, so.max_nodes, so.snap_features
        nodes = torch.clamp(w.lc_node, 0, NN - 1)
        T_cw = SE3(w.pgo.q[nodes], w.pgo.t[nodes]).inverse()     # [K]
        row_ok = (w.lc_node >= 0) & w.pgo.node_valid[nodes]
        eq, slot = self._gm_slots(w)
        f = w.lc_f.reshape(-1, 3)
        ok = (w.lc_fvalid.reshape(-1) & torch.any(eq, dim=-1)
              & torch.repeat_interleave(row_ok, N2))
        T_r = SE3(torch.repeat_interleave(T_cw.q, N2, dim=0),
                  torch.repeat_interleave(T_cw.t, N2, dim=0))
        R_cw = quat_to_matrix(T_r.q)
        uv_m = f[:, 0:2] / torch.where(torch.abs(f[:, 2:3]) > 1e-8,
                                       f[:, 2:3], 1e-8)
        eye3 = torch.eye(3, device=self.device)
        gm = w.gm_pos
        for _ in range(so.gm_refine_iters):
            p_c = T_r.apply(gm[slot])
            z = p_c[:, 2]
            zi = 1.0 / torch.where(torch.abs(z) > 1e-8, z, 1e-8)
            uv = p_c[:, 0:2] * zi[:, None]
            e = uv_m - uv
            zero = torch.zeros_like(zi)
            J_uv = torch.stack([
                torch.stack([zi, zero, -uv[:, 0] * zi], -1),
                torch.stack([zero, zi, -uv[:, 1] * zi], -1)], -2)
            J = -torch.einsum("nij,njk->nik", J_uv, R_cw)      # d e / d X
            # robust gate: within 4× the verification threshold
            e_px = torch.linalg.norm(e, dim=-1) * self.cam.focal_length
            wgt = (ok & (z > 1e-3)
                   & (e_px < 4.0 * so.ransac_thresh_px)).to(torch.float32)
            seg = torch.where(wgt > 0, slot, G)
            sums = segment_sum(torch.cat([
                torch.einsum("nri,nrj,n->nij", J, J, wgt).reshape(-1, 9),
                -torch.einsum("nri,nr,n->ni", J, e, wgt), wgt[:, None]],
                dim=-1), seg, G)
            H, b, n_o = sums[:, :9].reshape(G, 3, 3), sums[:, 9:12], \
                sums[:, 12]
            Hd = H + eye3[None] * (1e-4 + (n_o < so.gm_min_obs).to(
                torch.float32))[:, None, None]
            dx = torch.linalg.solve_ex(Hd, b[..., None])[0][..., 0]
            dx = torch.where(torch.isfinite(dx), dx, 0.0)
            upd = (w.gm_uid >= 0) & (n_o >= so.gm_min_obs)
            gm = gm + dx * upd[:, None]
        return gm

    def _gm_feedback(self, w: WorldStateSLAM):
        """Refined global positions back into the pool as FIXED landmarks
        (reference frame_handler_base.cpp:662-676) once a point's global
        estimate has ``gm_min_obs`` stored observations."""
        so = self.slam
        pool = w.pool
        eq, _ = self._gm_slots(w)
        n_o = torch.sum((eq & w.lc_fvalid.reshape(-1)[:, None]).long(),
                        dim=0)
        stable = (w.gm_uid >= 0) & (n_o >= so.gm_min_obs)
        eq_p = ((w.gm_uid[:, None] == pool.ids[None, :]) & stable[:, None]
                & pool.valid[None, :])
        in_pool = torch.any(eq_p, dim=-1)
        pslot = torch.argmax(eq_p.to(torch.uint8), dim=-1)
        tgt = torch.where(in_pool, pslot, pool.capacity)
        return pool._replace(pos=set_drop(pool.pos, tgt, w.gm_pos),
                             fixed=set_drop(pool.fixed, tgt, True))

    # ------------------------------------------------------------------
    # the per-keyframe SLAM step
    # ------------------------------------------------------------------
    def _snapshot(self, w: WorldStateSLAM):
        """The keyframe's snapshot (its ``snap_features`` features with a
        3D point, by detector score) and each feature's pool uid (-1 for
        none)."""
        so = self.slam
        frame = w.last_frame
        T_cw = frame.T_cam_world
        desc = lc_mod.global_descriptor(frame.image, so.descriptor_cells,
                                        so.descriptor_bins)
        xyz_w, has_pt = _feature_world_points(frame, w.ring, w.pool)
        p_cam = T_cw.apply(xyz_w)
        has_depth = frame.valid_mask() & has_pt & (p_cam[:, 2] > 1e-6)
        _, sel = topk_stable(torch.where(has_depth, frame.score,
                                         float("-inf")), so.snap_features)
        sel_ok = has_depth[sel]
        depth = torch.where(sel_ok, torch.linalg.norm(p_cam[sel], dim=-1),
                            0.0)
        patches, pok = extract_patches(frame.image, frame.px[sel],
                                       so.patch_size)
        snap = lc_mod.KeyframeSnapshot(desc, frame.px[sel], frame.f[sel],
                                       depth, patches, sel_ok & pok)
        Pc = w.pool.capacity
        lid_s = frame.landmark_id[sel]
        uid_s = torch.where(sel_ok & (lid_s >= 0),
                            w.pool.ids[torch.clamp(lid_s, 0, Pc - 1)], -1)
        return snap, lid_s, uid_s

    def _lc_options(self) -> lc_mod.LoopClosingOptions:
        so = self.slam
        return lc_mod.LoopClosingOptions(
            patch_size=so.patch_size,
            max_match_zmssd_per_px=so.max_match_zmssd_per_px,
            ratio_test=so.ratio_test, min_inliers=so.min_inliers,
            ransac_thresh_px=so.ransac_thresh_px)

    def _close_loop(self, w: WorldStateSLAM, node: int,
                    old_node: torch.Tensor, T_cur_old: SE3,
                    T_cw: SE3) -> WorldStateSLAM:
        """Add the loop constraint node → old_node, optimize the graph, and
        move the frontend, the backend window and the global map by the
        newest node's correction delta = T_opt_wc · T_cam_world."""
        so = self.slam
        NN = so.max_nodes
        g = w.pgo
        old_node = torch.clamp(old_node, 0, NN - 1)
        can_add = w.pgo_c < 2 * NN
        if can_add:
            g = pgo_mod.add_constraint(g, w.pgo_c, node, old_node, T_cur_old,
                                       so.loop_weight, so.loop_weight)
        g, _ = pgo_mod.optimize(g, max_iter=so.pgo_iters)
        delta = SE3(g.q[node], g.t[node]).compose(T_cw)
        ring, pool, fr = self._apply_rigid(w.ring, w.pool, w.last_frame,
                                           delta)
        return w._replace(
            pgo=g, pgo_c=w.pgo_c + int(can_add), ring=ring, pool=pool,
            last_frame=fr,
            backend=self._transform_backend(w.backend, delta),
            gm_pos=delta.apply(w.gm_pos),
            T_rel_prev=SE3.identity(device=self.device),
            n_loops=w.n_loops + 1, last_loop_to=old_node)

    def _run_slam_kf(self, w: WorldStateSLAM) -> WorldStateSLAM:
        so = self.slam
        K, NN, G = so.max_db_keyframes, so.max_nodes, so.gm_landmarks
        T_cw = w.last_frame.T_cam_world
        T_wc = T_cw.inverse()
        node = min(w.pgo_n, NN - 1)
        snap, lid_s, uid_s = self._snapshot(w)

        # ---- pose-graph node + sequential constraint ------------------
        g = w.pgo
        g = g._replace(q=pgo_mod.put(g.q, node, T_wc.q),
                       t=pgo_mod.put(g.t, node, T_wc.t),
                       node_valid=pgo_mod.put(g.node_valid, node, True))
        prev = min(max(node - 1, 0), NN - 1)
        T_ij = SE3(g.q[prev], g.t[prev]).inverse().compose(T_wc)
        # no constraints once the node ring saturates: new keyframes all
        # share node NN-1
        add_seq = node > 0 and w.pgo_c < 2 * NN and w.pgo_n < NN
        if add_seq:
            c = w.pgo_c
            g = g._replace(c_i=pgo_mod.put(g.c_i, c, prev),
                           c_j=pgo_mod.put(g.c_j, c, node),
                           c_q=pgo_mod.put(g.c_q, c, T_ij.q),
                           c_t=pgo_mod.put(g.c_t, c, T_ij.t),
                           c_valid=pgo_mod.put(g.c_valid, c, True))
        w = w._replace(pgo=g, pgo_n=w.pgo_n + 1,
                       pgo_c=w.pgo_c + int(add_seq))

        # ---- place query (before inserting itself) --------------------
        sims = lc_mod.rolled_similarities(w.lc_desc, snap.descriptor,
                                          so.descriptor_cells,
                                          so.descriptor_bins)
        elig = (w.lc_node >= 0) & (w.lc_node <= node - so.min_temporal_gap)
        sims = torch.where(elig, sims, float("-inf"))
        best = torch.argmax(sims)
        best_sim = sims[best]
        w = w._replace(lc_best_sim=torch.maximum(
            w.lc_best_sim, torch.where(torch.isfinite(best_sim), best_sim,
                                       -1.0)))
        # a saturated graph closes no loops: new keyframes share node NN-1
        cand = None
        if w.pgo_n < NN:
            ok, row_b = torch.stack([
                (best_sim >= so.min_similarity).to(torch.float32),
                best.to(torch.float32)]).tolist()            # one read
            if ok:
                # the candidate row before the insert below (once the ring
                # wraps, the write row can be the candidate's)
                r = int(row_b)
                cand = (lc_mod.KeyframeSnapshot(*(
                    x[r].clone() for x in (w.lc_desc, w.lc_px, w.lc_f,
                                           w.lc_depth, w.lc_patch,
                                           w.lc_fvalid))),
                    w.lc_node[r].clone())

        # ---- insert the snapshot (ring) -------------------------------
        row = w.lc_n % K
        for name, v in (("lc_desc", snap.descriptor), ("lc_f", snap.f),
                        ("lc_depth", snap.depth), ("lc_patch", snap.patches),
                        ("lc_px", snap.px), ("lc_fvalid", snap.valid),
                        ("lc_uid", uid_s)):
            getattr(w, name)[row] = v
        w.lc_node[row].fill_(node)
        w = w._replace(lc_n=w.lc_n + 1)

        # ---- global landmark absorption (uid-keyed ring store) --------
        found = torch.any((uid_s[:, None] == w.gm_uid[None, :])
                          & (uid_s >= 0)[:, None], dim=-1)
        is_new = (uid_s >= 0) & ~found & snap.valid
        rank = torch.cumsum(is_new.long(), 0) - 1
        tgt = torch.where(is_new, torch.remainder(w.gm_n + rank, G), G)
        lm_pos0 = w.pool.pos[torch.clamp(lid_s, 0, w.pool.capacity - 1)]
        w = w._replace(gm_uid=set_drop(w.gm_uid, tgt, uid_s),
                       gm_pos=set_drop(w.gm_pos, tgt, lm_pos0),
                       gm_n=w.gm_n + torch.sum(is_new.long()))

        # ---- verification + loop closure -----------------------------
        if cand is not None:
            old, old_node = cand
            v = lc_mod.verify_candidate(snap, old, self.cam.focal_length,
                                        self._lc_options(), so.verify_iters)
            last = torch.stack([v.n_nn, v.n_matches, v.n_inliers])
            d = w.lc_diag
            w = w._replace(lc_diag=torch.cat([
                d[:1] + 1, last, torch.maximum(d[4:7], last), d[7:]]))
            if bool(v.verified):                       # a read a candidate
                w = self._close_loop(w, node, old_node, v.T_cur_old, T_cw)

        # ---- global-map refinement + fixed feedback -------------------
        w = w._replace(gm_pos=self._gm_refine(w))
        if w.pgo_n % so.gm_feedback_every == 0:
            w = w._replace(pool=self._gm_feedback(w))
        return w

    # ------------------------------------------------------------------
    def _branch_tracking(self, world, frame, ts, T_prior_rel):
        world, n_tracked, is_kf = super()._branch_tracking(
            world, frame, ts, T_prior_rel)
        if is_kf and world.stage == Stage.TRACKING.value:
            world = self._run_slam_kf(world)
        return world, n_tracked, is_kf

    # ------------------------------------------------------------------
    # end-of-run reads
    # ------------------------------------------------------------------
    def pgo_trajectory(self) -> np.ndarray:
        """Optimized keyframe camera centres [n, 3]."""
        n = min(self.world.pgo_n, self.slam.max_nodes)
        return self.world.pgo.t[:n].cpu().numpy()

    def slam_stats(self) -> dict:
        """End-of-run SLAM counters."""
        w = self.world
        diag = w.lc_diag.cpu().numpy()
        return {
            "n_keyframes": w.pgo_n,
            "n_loops_closed": w.n_loops,
            "last_loop_to": int(w.last_loop_to),
            "lc_db_size": min(w.lc_n, self.slam.max_db_keyframes),
            "gm_landmarks": int(torch.sum((w.gm_uid >= 0).long())),
            "lc_best_sim": round(float(w.lc_best_sim), 3),
            "pgo_saturated": w.pgo_n >= self.slam.max_nodes,
            "lc_diag": dict(zip(
                ["n_cand", "nn_last", "depth_last", "inl_last",
                 "nn_max", "depth_max", "inl_max"],
                [int(x) for x in diag[:7]])),
        }
