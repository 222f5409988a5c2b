"""The port's stereo VIO (DevicePipelineStereoVIO: stereo frontend, IMU,
window backend) against the JAX package's, on the CPU, at 160×120 on
tests/test_device_pipeline_stereo_vio.py's inputs: the 0.11 m rig over the
sphere scene along ``simulate_fast`` (10 Hz camera, 200 Hz IMU), a 5-state
window and 3 LM iterations. The JAX run is made once per module.

- Stepwise: the JAX world before frame k converted into the port, both take
  one step on the same frames and IMU stream: the same stage and keyframe
  decision, n_tracked within ±2, the stereo landmarks of a keyframe within
  ±2, the backend's window count and keyframe clock equal, position ≤ 1 mm
  and rotation ≤ 0.05° on every frame. The port's window solve runs with
  ``void_on_single_view``, as in the other parity tests: JAX's float32
  solve voids or keeps a state step by float32 rounding of once-seen
  landmarks' blocks, which the port's float64 solve does not reproduce.
- Free run of the port from the first frame: the JAX test's gates
  (TRACKING by frame 1 and on, ≥ 2 keyframes, backend ≥ 2 states with a
  finite chi2 > 0, metric unaligned ATE < 0.15 × path).
- The stereo VIO keeps the per-frame structure stage and builds its backend
  without scale correction, as the JAX package does.
- The pipeline runs on the card by default; ``convert`` round trip.
"""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.cameras.rig import ImuParams as JImuParams
from svo_pro_universal_tpu.frontend.frame_handler import Stage
from svo_pro_universal_tpu.frontend.imu_handler import ImuHandler as JImu
from svo_pro_universal_tpu.frontend.pipeline_stereo_vio import (
    DevicePipelineStereoVIO as JaxStereoVIO)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
from svo_pro_universal_tpu_torch.frontend.pipeline_stereo_vio import (
    DevicePipelineStereoVIO)

from test_device_pipeline_stereo_vio import stereo_pair
from test_device_pipeline_vio import simulate_fast
from test_pipeline_stereo import T_BODY_CAM0, T_BODY_CAM1
from test_pipeline_vio import G_W
from torch_parity_utils import (assert_tree_equal, camera_dict,
                                new_own_landmarks, port_config, pose_gap,
                                rig_config, to_dict, uint8_views,
                                unaligned_ate)

DURATION = 2.4          # s: tests/test_device_pipeline_stereo_vio.py


def stereo_vio_config():
    cfg = rig_config()
    cfg.backend.num_keyframes = 5
    cfg.backend.max_iterations = 3
    return cfg


def _feed(add, imu, imu_stream, pairs, cam_ts, before=None, after=None):
    """The IMU up to each frame's time, then the pair; ``before(k)`` and
    ``after(k)`` run around frame k."""
    i_imu = 0
    for k, ((a, b), ts) in enumerate(zip(pairs, cam_ts)):
        while i_imu < len(imu_stream) and imu_stream[i_imu][0] <= ts:
            imu.add_measurement(*imu_stream[i_imu])
            i_imu += 1
        if before is not None:
            before(k)
        add(a, b, ts)
        if after is not None:
            after(k)


@pytest.fixture(scope="module")
def svio_run():
    imu_stream, cam_poses, cam_ts = simulate_fast(duration=DURATION)
    pairs = [tuple(uint8_views(stereo_pair(T))) for T in cam_poses]
    cfg = stereo_vio_config()
    imu = JImu(JImuParams())
    h = JaxStereoVIO(cfg, CAM, CAM, T_BODY_CAM0, T_BODY_CAM1,
                     imu_handler=imu, imu_params=JImuParams(),
                     trace_capacity=64, gravity=tuple(G_W))
    worlds = []
    _feed(h.add_image_pair, imu, imu_stream, pairs, cam_ts,
          before=lambda k: worlds.append(to_dict(h.world)))
    worlds.append(to_dict(h.world))
    mats, meta = h.drain()
    return dict(imu_stream=imu_stream, cam_poses=cam_poses, cam_ts=cam_ts,
                pairs=pairs, cfg=cfg, worlds=worlds, mats=mats, meta=meta)


def _port(cfg, device="cpu"):
    cam = convert.camera(camera_dict(CAM))
    imu = ImuHandler(ImuParams())
    pipe = DevicePipelineStereoVIO(
        port_config(cfg), cam, cam, convert.se3(to_dict(T_BODY_CAM0)),
        convert.se3(to_dict(T_BODY_CAM1)), imu_handler=imu,
        imu_params=ImuParams(), trace_capacity=64, gravity=tuple(G_W),
        device=device)
    pipe.backend.opts = pipe.backend.opts._replace(void_on_single_view=True)
    return pipe, imu


def test_stereo_vio_run_covers_the_path(svio_run):
    """The JAX run tracks from frame 0, selects keyframes and fills its
    window."""
    meta, worlds = svio_run["meta"], svio_run["worlds"]
    assert (meta[:, 0] == Stage.TRACKING.value).all()
    assert meta[1:, 2].sum() >= 2
    assert max(int(w["backend_k"]) for w in worlds) >= 3


def test_stereo_vio_stepwise_matches_jax(svio_run):
    r = svio_run
    worlds, meta, cam_ts = r["worlds"], r["meta"], r["cam_ts"]
    pipe, imu = _port(r["cfg"])
    checked = []

    def before(k):
        pipe.world = convert.world_stereo_vio(worlds[k])
        pipe._t_epoch = cam_ts[0]
        pipe._last_ts = cam_ts[k - 1] if k else None

    def after(k):
        w, jw = pipe.world, worlds[k + 1]
        m = w.trace_meta[w.trace_ptr - 1]
        assert w.stage == int(meta[k, 0]), k
        assert bool(m[2]) == bool(meta[k, 2]), k
        assert abs(int(m[1]) - int(meta[k, 1])) <= 2, (k, m[1], meta[k, 1])
        assert w.backend_k == int(jw["backend_k"]), k
        assert w.last_kf_ts == np.float32(jw["last_kf_ts"]), k
        if meta[k, 2]:
            nid = int(worlds[k]["pool"]["next_id"])
            n_port = new_own_landmarks(convert.to_numpy(w.last_frame),
                                       convert.to_numpy(w.pool), nid)
            n_jax = new_own_landmarks(jw["last_frame"], jw["pool"], nid)
            assert n_jax >= 20 and abs(n_port - n_jax) <= 2, (k, n_port,
                                                              n_jax)
        gap, ang = pose_gap(pipe, worlds, k)
        checked.append((k, gap, ang))
        assert gap <= 1e-3 and ang <= 0.05, checked[-1]

    _feed(pipe.add_image_pair, imu, r["imu_stream"], r["pairs"], cam_ts,
          before, after)
    backend_calls = sum(float(b["last_kf_ts"]) != float(a["last_kf_ts"])
                        for a, b in zip(worlds, worlds[1:]))
    assert len(checked) == len(r["pairs"]) and backend_calls >= 4


def test_stereo_vio_free_run(svio_run):
    """The port alone over the whole sequence: the JAX test's gates."""
    r = svio_run
    pipe, imu = _port(r["cfg"])
    _feed(pipe.add_image_pair, imu, r["imu_stream"], r["pairs"], r["cam_ts"])
    mats, meta = pipe.drain()
    stages = meta[:, 0].astype(int)
    start = int(np.argmax(stages == Stage.TRACKING.value))
    assert start <= 1 and (stages[start:] == Stage.TRACKING.value).all()
    assert meta[start:, 2].sum() >= 2
    chi2 = float(pipe.world.backend_chi2)
    assert pipe.world.backend_k >= 2 and np.isfinite(chi2) and chi2 > 0.0
    gt_pos = np.stack([np.asarray(T.inverse().t)
                       for T in r["cam_poses"][start:]])
    ate, path = unaligned_ate(mats[start:], gt_pos)
    assert ate < 0.15 * max(path, 0.1), (ate, path)


def test_stereo_vio_keeps_structure_stage_and_metric_scale(svio_run):
    """Unlike the mono VIO, the stereo VIO keeps the per-frame structure
    stage (the JAX stereo VIO never runs DevicePipelineVIO.__init__), and
    its backend never rescales the map (JAX pipeline_stereo_vio.py:76-90)."""
    cfg = svio_run["cfg"]
    pipe, _ = _port(cfg)
    assert pipe._structure_max_pts == cfg.base.structure_optimization_max_pts
    assert pipe._structure_max_pts > 0
    assert pipe.backend.scale_correction is False
    assert pipe.backend.opts.vi_alignment is False


def test_stereo_vio_pipeline_defaults_to_the_card(monkeypatch, svio_run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(svio_run["cfg"], device=None)
    pipe, _ = _port(svio_run["cfg"])
    assert pipe.backend.device.type == "cpu"
    assert pipe.world.backend.window.q.device.type == "cpu"


def test_convert_round_trip_stereo_vio(svio_run):
    jw = svio_run["worlds"][-1]
    back = convert.to_numpy(convert.world_stereo_vio(jw))
    for key in ("ring", "pool", "last_frame", "pyr1_cur", "pyr1_prev",
                "backend", "imu_packed", "backend_chi2", "T_rel_prev"):
        assert_tree_equal(back[key], jw[key])
    assert back["backend_k"] == int(jw["backend_k"])
    assert back["last_kf_ts"] == np.float32(jw["last_kf_ts"])
