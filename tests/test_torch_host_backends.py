"""The port's host backends, ``BackendInterface`` and ``GlobalMap``, against
the JAX package's on the CPU, on the inputs of tests/test_backend_interface
.py and tests/test_global_map.py (the same draws from the seeded ``rng``).

``BackendInterface`` (8 keyframes through a 5-state window: three
marginalizations; IMU factors from ``ImuHandler.window_between``): the
JAX test's gates (corrected poses beat the fed noise by 2×, 5 states, a
prior), the same landmark ids returned every call, and from the second
keyframe on the corrected pose within 2 mm and the landmarks within 3 cm
(the second call) and 1 cm (after) of JAX's. The first call holds one
state and once-seen landmarks: JAX's float32 solve zeroes their
non-finite steps and keeps its cost, the port's float64 solve moves them
onto their bearings, so there the port's cost is held at or below JAX's.

``GlobalMap``:
- absorption and BA of 10 keyframes (16-state ring, a solve every 3):
  every solve's cost within 1e-4 relative, the states and landmarks within
  1e-4 of JAX's (no step is voided there), then the JAX test's gates;
- ``optimized_landmarks`` and the pool re-injection semantics, as the JAX
  test;
- eviction and slot reuse, the JAX test's 200-keyframe run cut to 40
  keyframes through an 8-state ring and 128 landmark slots: after every
  keyframe the observation store (states, slots, validity), the landmark
  and state masks, the id↔slot dicts, cursors and keyframe ids equal JAX's;
  the ring keeps optimizing and holds the newest 8 keyframes, its states
  within 3 cm of JAX's after every solve (JAX's float32 solve stops at
  costs up to 0.29 where the port's float64 one reaches 0.18; the states
  differ by 4–17 mm); ``_evict_program`` alone, from the same window,
  equals JAX's within 1e-6;
- IMU factors between global states: a blind state pulled back by the IMU
  chain (the JAX test's gate) and the optimized positions within 1e-3 of
  JAX's.
- Mesh axes without a mesh, or a mesh the capacities do not split over,
  raise (``tests/test_torch_global_map_mesh.py`` runs a mesh); the default
  device is the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.backend import imu_factor as jimf
from svo_pro_universal_tpu.backend import window_ba as jwba
from svo_pro_universal_tpu.backend.global_map import (
    GlobalMap as JaxGlobalMap, GlobalMapOptions as JaxGMOptions)
from svo_pro_universal_tpu.backend.interface import (
    BackendInterface as JaxBackendInterface)
from svo_pro_universal_tpu.cameras.rig import ImuParams as JImuParams
from svo_pro_universal_tpu.frontend.imu_handler import ImuHandler as JImu
from svo_pro_universal_tpu.frontend.imu_handler import ImuWindow as JWindow
from svo_pro_universal_tpu.utils.transform import (
    SE3 as JSE3, quat_conjugate, quat_multiply, quat_normalize, quat_rotate,
    so3_exp)
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.backend import window_ba as twba
from svo_pro_universal_tpu_torch.backend.global_map import (
    GlobalMap, GlobalMapOptions)
from svo_pro_universal_tpu_torch.backend.interface import BackendInterface
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.common.point import allocate, make_pool
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
from svo_pro_universal_tpu_torch.utils.indexing import set_drop

from test_window_ba import simulate_vi
from torch_parity_utils import jax_map_state, to_dict


def tse3(T):
    return convert.se3(to_dict(T))


# ---------------------------------------------------------------------------
# BackendInterface
# ---------------------------------------------------------------------------

def test_backend_interface_matches_jax(rng):
    n_states = 8
    states, segs = simulate_vi(n_states=n_states, state_dt=0.25)
    lm = rng.uniform([-2, -2, 1.5], [2, 2, 6], (60, 3)).astype(np.float32)
    jimu, timu = JImu(JImuParams()), ImuHandler(ImuParams())
    for k, seg in enumerate(segs):
        tt = np.asarray(seg.t) + states["t"][k]
        for i in range(len(tt) - (1 if k < len(segs) - 1 else 0)):
            for imu in (jimu, timu):
                imu.add_measurement(tt[i], np.asarray(seg.gyro[i]),
                                    np.asarray(seg.acc[i]))
    jb = JaxBackendInterface(
        cam_focal=300.0, T_cam_body=JSE3.identity(), num_keyframes=5,
        imu_params=JImuParams(),
        opts=jwba.BAOptions(max_iter=6, gravity=(0.0, 0.0, -9.81)))
    tb = BackendInterface(
        300.0, tse3(JSE3.identity()), num_keyframes=5,
        imu_params=ImuParams(),
        opts=twba.BAOptions(max_iter=6, gravity=(0.0, 0.0, -9.81)),
        device="cpu")
    errs_in, errs_out = [], []
    for k in range(n_states):
        q, p = states["q"][k], states["p"][k]
        if k == 0:
            dq, dp = jnp.array([1.0, 0, 0, 0]), jnp.zeros(3)
        else:
            dq = so3_exp(jnp.asarray(
                rng.normal(0, 0.01, 3).astype(np.float32)))
            dp = jnp.asarray(rng.normal(0, 0.03, 3).astype(np.float32))
        T_cam_world = JSE3(quat_normalize(quat_multiply(q, dq)),
                           p + dp).inverse()
        pb = quat_rotate(quat_conjugate(q), jnp.asarray(lm) - p[None])
        vis = np.asarray(pb[:, 2] > 0.3)
        f = np.asarray(pb / jnp.linalg.norm(pb, axis=-1, keepdims=True))
        lids = np.where(vis, np.arange(60), -1)
        lm_noisy = lm + rng.normal(0, 0.02, lm.shape).astype(np.float32)
        ts = float(states["t"][k])
        jout = jb.add_keyframe(ts, T_cam_world, lids, f, lm_noisy,
                               imu_handler=jimu)
        out = tb.add_keyframe(ts, tse3(T_cam_world), lids, f, lm_noisy,
                              imu_handler=timu)
        np.testing.assert_array_equal(out.lm_slots_pool, jout.lm_slots_pool)
        T_corr = out.T_cam_world.inverse()
        errs_in.append(float(jnp.linalg.norm(dp)))
        errs_out.append(float(np.linalg.norm(T_corr.t.numpy()
                                             - np.asarray(p))))
        if k == 0:
            assert out.chi2 <= jout.chi2 + 1e-6, (out.chi2, jout.chi2)
            continue
        t_gap = np.abs(out.T_cam_world.t.numpy()
                       - np.asarray(jout.T_cam_world.t)).max()
        lm_gap = np.abs(out.lm_pos.numpy() - np.asarray(jout.lm_pos)).max()
        assert t_gap <= 2e-3, (k, t_gap)
        assert lm_gap <= (3e-2 if k == 1 else 1e-2), (k, lm_gap)
    assert np.mean(errs_out[1:]) < 0.5 * np.mean(errs_in[1:]), (
        errs_in, errs_out)
    assert tb.n_states == 5 and bool(tb.window.has_prior)
    assert tb.kf_ts == jb.kf_ts and tb._obs_cursor == jb._obs_cursor


# ---------------------------------------------------------------------------
# GlobalMap
# ---------------------------------------------------------------------------

def _arc_pose(k):
    tw = jnp.asarray([0.15 * k, 0.05 * np.sin(k), 0.02 * k,
                      0.0, 0.02 * k, 0.01 * k], jnp.float32)
    return JSE3(so3_exp(tw[3:]), tw[:3])


def test_global_map_refines_like_jax(rng):
    lm = rng.uniform([-2, -2, 2], [2, 2, 6], (80, 3)).astype(np.float32)
    kw = dict(max_keyframes=16, optimize_every=3, ba_iters=6)
    jg = JaxGlobalMap(300.0, JSE3.identity(), JaxGMOptions(**kw))
    gm = GlobalMap(300.0, tse3(JSE3.identity()), GlobalMapOptions(**kw),
                   device="cpu")
    true_p, chi2 = [], None
    for k in range(10):
        T_w_b = _arc_pose(k)
        true_p.append(np.asarray(T_w_b.t))
        dp = (rng.normal(0, 0.03, 3).astype(np.float32)
              if k > 0 else np.zeros(3, np.float32))
        T_cam_world = JSE3(T_w_b.q, T_w_b.t + dp).inverse()
        pb = quat_rotate(quat_conjugate(T_w_b.q),
                         jnp.asarray(lm) - T_w_b.t[None])
        vis = np.asarray(pb[:, 2] > 0.3)
        f = np.asarray(pb / jnp.linalg.norm(pb, axis=-1, keepdims=True))
        lids = np.where(vis, np.arange(80), -1)
        lm_noisy = lm + rng.normal(0, 0.02, lm.shape).astype(np.float32)
        jout = jg.add_keyframe(k, T_cam_world, lids, f, lm_noisy)
        out = gm.add_keyframe(k, tse3(T_cam_world), lids, f, lm_noisy)
        assert (out is None) == (jout is None), k
        if out is not None:
            chi2 = out
            assert abs(out - jout) <= 1e-4 * abs(jout), (k, out, jout)
            jw, tw = to_dict(jg.window), convert.to_numpy(gm.window)
            for fld in ("q", "p", "lm_pos"):
                np.testing.assert_allclose(tw[fld], jw[fld], atol=1e-4,
                                           err_msg=f"{k} {fld}")
    assert len(gm) == 10 and chi2 is not None
    gm.force_optimize()
    p_opt, ids = gm.keyframe_poses()
    errs = np.linalg.norm(p_opt - np.stack(true_p), axis=-1)
    assert errs[1:].mean() < 0.03, errs
    lids_out, pos = gm.fixed_landmarks(tse3(JSE3.identity()), max_out=20)
    jlids, jpos = jg.fixed_landmarks(JSE3.identity(), max_out=20)
    np.testing.assert_array_equal(lids_out, jlids)
    assert len(lids_out) > 0 and (lids_out >= 0).all()


def test_optimized_landmarks_and_pool_reinjection(rng):
    lm = rng.uniform([-2, -2, 2], [2, 2, 6], (40, 3)).astype(np.float32)
    gm = GlobalMap(300.0, tse3(JSE3.identity()),
                   GlobalMapOptions(max_keyframes=8, optimize_every=100),
                   device="cpu")
    jg = JaxGlobalMap(300.0, JSE3.identity(),
                      JaxGMOptions(max_keyframes=8, optimize_every=100))
    for k in range(3):
        T_w_b = JSE3.identity()._replace(
            t=jnp.asarray([0.2 * k, 0.0, 0.0], jnp.float32))
        pb = jnp.asarray(lm) - T_w_b.t[None]
        f = np.asarray(pb / jnp.linalg.norm(pb, axis=-1, keepdims=True))
        uids = np.arange(40, dtype=np.int32) + 100
        gm.add_keyframe(k, tse3(T_w_b.inverse()), uids, f, lm)
        jg.add_keyframe(k, T_w_b.inverse(), uids, f, lm)
    uids_out, pos_out = gm.optimized_landmarks()
    juids, jpos = jg.optimized_landmarks()
    np.testing.assert_array_equal(uids_out, juids)
    np.testing.assert_allclose(pos_out, jpos, atol=1e-6)
    assert set(uids_out.tolist()) == set(range(100, 140))
    # the SLAM handler's re-injection: uid must still match the slot's id
    pool = make_pool(64, 4)
    pool, slots = allocate(pool, torch.from_numpy(lm),
                           torch.ones((40,), dtype=torch.bool))
    pool = pool._replace(ids=set_drop(pool.ids, slots,
                                      torch.from_numpy(uids_out).long()))
    u = torch.from_numpy(uids_out).long()
    ok = pool.valid[slots] & (pool.ids[slots] == u)
    widx = torch.where(ok, slots, pool.capacity)
    pool = pool._replace(pos=set_drop(pool.pos, widx,
                                      torch.from_numpy(pos_out)),
                         fixed=set_drop(pool.fixed, widx, True))
    assert bool(pool.fixed[slots].all())
    ids2 = pool.ids.clone()
    ids2[slots[0]] = -7                       # a reused slot
    ok2 = pool.valid[slots] & (ids2[slots] == u)
    assert not bool(ok2[0]) and bool(ok2[1:].all())


def _structure(g) -> dict:
    w = (convert.to_numpy(g.window) if isinstance(g, GlobalMap)
         else to_dict(g.window))
    d = {k: np.asarray(w[k]) for k in ("obs_state", "obs_lm", "obs_valid",
                                       "lm_valid", "state_valid")}
    d["obs_state"] = np.where(d["obs_valid"], d["obs_state"], -1)
    d["obs_lm"] = np.where(d["obs_valid"], d["obs_lm"], -1)
    return d


def test_global_map_evicts_and_reuses_slots_like_jax(rng):
    lm = rng.uniform([-3, -3, 2], [9, 3, 8], (160, 3)).astype(np.float32)
    kw = dict(max_keyframes=8, max_landmarks=128, max_obs=800,
              optimize_every=4, ba_iters=4)
    jg = JaxGlobalMap(300.0, JSE3.identity(), JaxGMOptions(**kw))
    gm = GlobalMap(300.0, tse3(JSE3.identity()), GlobalMapOptions(**kw),
                   device="cpu")
    n_kf, ran, evict_checked = 40, 0, False
    for k in range(n_kf):
        tw = jnp.asarray([0.04 * k, 0.05 * np.sin(0.2 * k), 0.01 * k,
                          0.0, 0.005 * np.sin(0.1 * k), 0.0], jnp.float32)
        T_w_b = JSE3(so3_exp(tw[3:]), tw[:3])
        dp = (rng.normal(0, 0.02, 3).astype(np.float32)
              if k > 0 else np.zeros(3, np.float32))
        T_cam_world = JSE3(T_w_b.q, T_w_b.t + dp).inverse()
        pb = quat_rotate(quat_conjugate(T_w_b.q),
                         jnp.asarray(lm) - T_w_b.t[None])
        vis = np.asarray((pb[:, 2] > 0.5) & (pb[:, 2] < 8.0))
        f = np.asarray(pb / jnp.linalg.norm(pb, axis=-1, keepdims=True))
        lids = np.where(vis, np.arange(len(lm)), -1)
        lm_noisy = lm + rng.normal(0, 0.01, lm.shape).astype(np.float32)
        if len(jg) == kw["max_keyframes"] and not evict_checked:
            # _evict_program alone, from JAX's window
            w = convert.window(to_dict(jg.window), "cpu")
            got = convert.to_numpy(gm._evict_program(w))
            want = to_dict(jg._evict_program(jg.window))
            for fld in want:
                if fld != "imu":
                    np.testing.assert_allclose(got[fld], want[fld],
                                               atol=1e-6, err_msg=fld)
            evict_checked = True
        jout = jg.add_keyframe(k, T_cam_world, lids, f, lm_noisy)
        out = gm.add_keyframe(k, tse3(T_cam_world), lids, f, lm_noisy)
        assert (out is None) == (jout is None), k
        ran += out is not None
        if out is not None:
            np.testing.assert_allclose(convert.to_numpy(gm.window)["p"],
                                       to_dict(jg.window)["p"], atol=3e-2,
                                       err_msg=str(k))
        js, ts_ = _structure(jg), _structure(gm)
        for fld in js:
            np.testing.assert_array_equal(ts_[fld], js[fld],
                                          err_msg=f"{k} {fld}")
        jm, tm = jax_map_state(jg), jax_map_state(gm)
        for fld in ("lid2slot", "slot2lid", "kf_ids", "_lm_cursor",
                    "_obs_cursor", "_since_opt", "n_states"):
            assert tm[fld] == jm[fld], (k, fld)
    assert evict_checked and ran >= 8
    assert len(gm) == kw["max_keyframes"]
    assert gm.kf_ids == list(range(n_kf - kw["max_keyframes"], n_kf))
    assert np.isfinite(gm.force_optimize())
    p_opt, _ = gm.keyframe_poses()
    assert np.isfinite(p_opt).all()


def test_global_map_imu_factors_like_jax():
    opts = dict(max_keyframes=8, max_landmarks=128, max_obs=800,
                optimize_every=100, ba_iters=6, pose_anchor_sigma_t=5.0,
                pose_anchor_sigma_r=5.0)
    jg = JaxGlobalMap(300.0, JSE3.identity(), JaxGMOptions(**opts))
    gm = GlobalMap(300.0, tse3(JSE3.identity()), GlobalMapOptions(**opts),
                   device="cpu")
    rng = np.random.default_rng(42)
    lm = rng.uniform([-2, -2, 2], [3, 2, 6], (60, 3)).astype(np.float32)
    dt_kf = 0.25
    vel = np.array([0.4, 0.0, 0.0], np.float32)
    n_s = 51
    t_seg = jnp.linspace(0.0, dt_kf, n_s)
    win = JWindow(t_seg, jnp.zeros((n_s, 3)),
                  jnp.tile(jnp.asarray([0.0, 0.0, 9.81]), (n_s, 1)),
                  jnp.ones((n_s,), bool))
    factor = jimf.preintegrate_with_cov(win, jnp.zeros(3), jnp.zeros(3),
                                        1e-3, 1e-2)
    info = jimf.imu_information(factor, 1e-4, 1e-3)
    tfactor = convert.preint_factor(to_dict(factor))
    tinfo = torch.from_numpy(np.array(info))
    for k in range(6):
        p_k = vel * dt_kf * k
        T_w_b = JSE3(jnp.asarray([1.0, 0, 0, 0]), jnp.asarray(p_k))
        pb = jnp.asarray(lm) - T_w_b.t[None]
        f = np.asarray(pb / jnp.linalg.norm(pb, axis=-1, keepdims=True))
        lids = (np.full(len(lm), -1) if k == 3
                else np.where(np.asarray(pb[:, 2] > 0.3),
                              np.arange(len(lm)), -1))
        dp = np.array([0.3, -0.2, 0.15], np.float32) if k == 3 else 0.0
        T_feed = JSE3(T_w_b.q, T_w_b.t + dp).inverse()
        jg.add_keyframe(k, T_feed, lids, f, lm, imu_factor=factor,
                        imu_info=info)
        gm.add_keyframe(k, tse3(T_feed), lids, f, lm, imu_factor=tfactor,
                        imu_info=tinfo)
    assert bool(gm.window.imu_valid[:5].all())
    jg.force_optimize()
    gm.force_optimize()
    p_opt, _ = gm.keyframe_poses()
    jp, _ = jg.keyframe_poses()
    np.testing.assert_allclose(p_opt, jp, atol=1e-3)
    assert np.linalg.norm(p_opt[3] - vel * dt_kf * 3) < 0.08, p_opt


def test_backends_default_to_the_card_and_refuse_a_mesh(monkeypatch):
    T = tse3(JSE3.identity())

    class ThreeShards:                 # a mesh 1024 slots do not split over
        device = torch.device("cpu")

        def size(self, axes):
            return 3
    with pytest.raises(ValueError, match="mesh"):
        GlobalMap(300.0, T, mesh_axes=("h",), device="cpu")
    with pytest.raises(ValueError, match="split over 3 shards"):
        GlobalMap(300.0, T, mesh=ThreeShards(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: GlobalMap(300.0, T),
                 lambda: BackendInterface(300.0, T)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
