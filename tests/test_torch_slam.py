"""The port's mono SLAM pipeline (DevicePipelineSLAM: VIO, loop closing,
pose graph, global map) against the JAX package's, on the CPU, at 160×120
on the closed loop of tests/test_device_pipeline_slam.py (``simulate_loop``,
10 Hz camera, 200 Hz IMU; its configuration and SlamOptions) cut to the
32 frames that reach its first verified loop (frame 31). The JAX run is made
once per module.

Stepwise: the JAX world before frame k is converted into the port (the
JAX step's RANSAC noise injected on init frames; the window solve with
``void_on_single_view``) and both take one step on the same frame and IMU
stream. Every frame: the same stage, keyframe decision, pose-graph node
and constraint counts, database size and loop count, n_tracked within ±2,
the backend's window count equal; position ≤ 1 mm and rotation ≤ 0.05°,
with two exceptions. The bootstrap frame, a float32 eigh near a degenerate
baseline in JAX, is held to 1 cm and 0.2°, as tests/test_torch_vio.py
shows. And JAX's float32 window solve voids its state step whenever
float32 rounding makes a once-seen landmark's block non-finite, which the
port cannot reproduce: where JAX's call took a step (an old window state
rotated on a frame without a loop; 2 of the 12 calls here) the port's
voided step is held to 2 cm and 0.5°, and at most two such frames are
allowed. On the loop frame the optimized pose-graph nodes are within 1 mm
of JAX's, and the global map holds the same landmarks.
"""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.cameras.rig import ImuParams as JImuParams
from svo_pro_universal_tpu.frontend.frame_handler import Stage
from svo_pro_universal_tpu.frontend.imu_handler import ImuHandler as JImu
from svo_pro_universal_tpu.frontend.pipeline_slam import (
    DevicePipelineSLAM as JaxSLAM, SlamOptions as JSlamOptions)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
from svo_pro_universal_tpu_torch.frontend.pipeline_slam import (
    DevicePipelineSLAM)

from synthetic_utils import render_sphere_view
from test_device_pipeline_slam import simulate_loop
from test_pipeline_mono import make_config
from test_pipeline_vio import G_W
from test_torch_init import init_noise_of, _JaxNoise
from torch_parity_utils import (camera_dict, port_config, rotation_angle_deg,
                                to_dict)

DURATION = 3.15       # s: 32 frames; the first loop closes at frame 31


def slam_config():
    """tests/test_device_pipeline_slam.py's config."""
    cfg = make_config()
    cfg.backend.num_keyframes = 5
    cfg.backend.max_iterations = 3
    cfg.base.kfselect_min_num_frames_between_kfs = 1
    cfg.base.kfselect_min_disparity = 8.0
    return cfg


SLAM_OPTS = dict(max_db_keyframes=48, snap_features=48, max_nodes=48,
                 pgo_iters=10, gm_landmarks=192, min_temporal_gap=6,
                 min_inliers=12, min_similarity=0.75)


@pytest.fixture(scope="module")
def slam_run():
    imu_stream, cam_poses, cam_ts = simulate_loop(duration=DURATION)
    frames = [np.clip(np.rint(np.asarray(render_sphere_view(T))), 0,
                      255).astype(np.uint8) for T in cam_poses]
    cfg = slam_config()
    imu = JImu(JImuParams())
    h = JaxSLAM(cfg, CAM, imu_handler=imu, imu_params=JImuParams(),
                trace_capacity=64, gravity=tuple(G_W),
                slam_opts=JSlamOptions(**SLAM_OPTS))
    worlds = []
    i_imu = 0
    for img, ts in zip(frames, cam_ts):
        while i_imu < len(imu_stream) and imu_stream[i_imu][0] <= ts:
            imu.add_measurement(*imu_stream[i_imu])
            i_imu += 1
        worlds.append(to_dict(h.world))
        h.add_image(img, ts)
    worlds.append(to_dict(h.world))
    mats, meta = h.drain()
    return dict(imu_stream=imu_stream, frames=frames, cam_ts=cam_ts,
                cfg=cfg, worlds=worlds, mats=mats, meta=meta,
                stats=h.slam_stats())


def _port(cfg, device="cpu"):
    imu = ImuHandler(ImuParams())
    pipe = DevicePipelineSLAM(
        port_config(cfg), convert.camera(camera_dict(CAM)),
        imu_handler=imu, imu_params=ImuParams(), trace_capacity=64,
        gravity=tuple(G_W),
        slam_opts=convert.slam_options(JSlamOptions(**SLAM_OPTS)._asdict()),
        device=device)
    pipe.backend.opts = pipe.backend.opts._replace(void_on_single_view=True)
    return pipe, imu


def test_slam_run_closes_a_loop(slam_run):
    """The JAX reference run initializes, tracks, and verifies its first
    loop on the last frame."""
    stages = slam_run["meta"][:, 0].astype(int)
    first = int(np.argmax(stages == Stage.TRACKING.value))
    assert 0 < first < 10 and (stages[first:] == Stage.TRACKING.value).all()
    w = slam_run["worlds"]
    assert int(w[-1]["n_loops"]) >= 1 and int(w[-2]["n_loops"]) == 0
    assert slam_run["stats"]["gm_landmarks"] >= 20


def _jax_pose(worlds, k):
    jw = worlds[k + 1]
    return convert.SE3(*(torch.from_numpy(np.array(jw[f][k]))
                         for f in ("trace_q", "trace_t"))).as_matrix().numpy()


def _jax_window_stepped(worlds, k) -> bool:
    """Whether JAX's backend call on frame k (no loop on it) took an LM
    state step: some window state that survives the call rotated. A voided
    step leaves every state's rotation as it was (the marginalization
    shifts the states; the alignment buffer rescales positions only)."""
    a, b = worlds[k], worlds[k + 1]
    if (float(a["last_kf_ts"]) == float(b["last_kf_ts"])
            or int(b["n_loops"]) > int(a["n_loops"])):
        return False
    qa = np.asarray(a["backend"]["window"]["q"])
    qb = np.asarray(b["backend"]["window"]["q"])
    shift = int(int(a["backend_k"]) >= qa.shape[0])
    n = int(a["backend_k"]) - shift
    return n > 0 and not np.array_equal(qb[:n], qa[shift:shift + n])


def test_slam_stepwise_matches_jax(slam_run):
    r = slam_run
    worlds, meta = r["worlds"], r["meta"]
    k_boot = int(np.argmax(meta[:, 0].astype(int) == Stage.TRACKING.value))
    pipe, imu = _port(r["cfg"])
    noise = _JaxNoise(pipe, lambda k: init_noise_of(worlds[k],
                                                    pipe.max_fts))
    checked, loops, stepped = [], [], []
    i_imu = 0
    for k, (img, ts) in enumerate(zip(r["frames"], r["cam_ts"])):
        while (i_imu < len(r["imu_stream"])
               and r["imu_stream"][i_imu][0] <= ts):
            imu.add_measurement(*r["imu_stream"][i_imu])
            i_imu += 1
        noise.frame = k
        pipe.world = convert.world_slam(worlds[k], "cpu")
        pipe.add_image(img, ts)
        w, jw = pipe.world, worlds[k + 1]
        m = w.trace_meta[w.trace_ptr - 1]
        assert w.stage == int(meta[k, 0]), k
        assert bool(m[2]) == bool(meta[k, 2]), k
        assert abs(int(m[1]) - int(meta[k, 1])) <= 2, (k, m[1], meta[k, 1])
        assert w.backend_k == int(jw["backend_k"]), k
        for key in ("pgo_n", "pgo_c", "lc_n", "n_loops"):
            assert getattr(w, key) == int(jw[key]), (k, key)
        T = w.last_frame.T_world_cam.as_matrix().numpy()
        Tj = _jax_pose(worlds, k)
        gap = float(np.linalg.norm(T[:3, 3] - Tj[:3, 3]))
        ang = rotation_angle_deg(T[:3, :3], Tj[:3, :3])
        tol = (1e-2, 0.2) if k == k_boot else (1e-3, 0.05)
        if _jax_window_stepped(worlds, k):
            stepped.append(k)
            tol = (2e-2, 0.5)
        checked.append((k, gap, ang))
        assert gap <= tol[0] and ang <= tol[1], checked[-1]
        if w.n_loops > int(worlds[k]["n_loops"]):
            loops.append(k)
            n = w.pgo_n
            np.testing.assert_allclose(w.pgo.t[:n].numpy(),
                                       np.asarray(jw["pgo"]["t"])[:n],
                                       atol=1e-3)
            assert int(w.last_loop_to) == int(jw["last_loop_to"])
            np.testing.assert_array_equal(
                np.sort(w.gm_uid.numpy()), np.sort(jw["gm_uid"]))
            np.testing.assert_array_equal(w.lc_diag.numpy()[0],
                                          np.asarray(jw["lc_diag"])[0])
    assert loops == [len(r["frames"]) - 1]
    assert len(stepped) <= 2, stepped
    traj = pipe.pgo_trajectory()
    assert traj.shape == (pipe.world.pgo_n, 3)
    np.testing.assert_array_equal(traj, pipe.world.pgo.t[:traj.shape[0]])


def test_convert_round_trip_slam(slam_run):
    """JAX WorldStateSLAM → port → numpy gives back the JAX arrays
    (integers as int32); host counters as scalars of the same value; and
    SlamOptions both ways."""
    jw = slam_run["worlds"][-1]
    back = convert.to_numpy(convert.world_slam(jw, "cpu"))

    def check(a, b):
        if isinstance(b, dict):
            for k in b:
                check(a[k], b[k])
            return
        b = np.asarray(b)
        a = np.asarray(a)
        if b.ndim == 0:
            assert a == b
            return
        assert a.dtype == b.dtype and np.array_equal(a, b)

    for key in ("lc_desc", "lc_f", "lc_depth", "lc_patch", "lc_px",
                "lc_fvalid", "lc_node", "lc_uid", "pgo", "last_loop_to",
                "gm_uid", "gm_pos", "gm_n", "lc_best_sim", "lc_diag",
                "backend", "ring", "pool"):
        check(back[key], jw[key])
    for key in ("lc_n", "pgo_n", "pgo_c", "n_loops"):
        assert back[key] == int(jw[key])
    so = JSlamOptions(**SLAM_OPTS)
    back = convert.to_numpy(convert.slam_options(so._asdict()))
    assert back == so._asdict()


def test_slam_pipeline_defaults_to_the_card(monkeypatch):
    """Like the VIO pipeline, DevicePipelineSLAM runs on the card unless
    it is given a device: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(slam_config())
    cam = convert.camera(camera_dict(CAM))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePipelineSLAM(cfg, cam, imu_handler=ImuHandler())
    pipe = DevicePipelineSLAM(cfg, cam, imu_handler=ImuHandler(),
                              device="cpu")
    assert pipe.world.lc_desc.device.type == "cpu"
    assert pipe.world.pgo.q.device.type == "cpu"
    assert pipe.slam_stats()["n_loops_closed"] == 0
