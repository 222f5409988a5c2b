"""The port's mono tracking slice (DevicePipelineMono, OneShot) against the
JAX package's DevicePipelineMono, on the CPU, at the 160×120 test config.

Stepwise: the JAX world before frame k is converted into the port, both
take one step on the same uint8 image, and the outcomes are compared:
same stage and keyframe decision, n_tracked within ±2 (a near-tie in the
detector or the ZMSSD argmin may move a feature or two, since sums run in
another order), position ≤ 1 mm and rotation ≤ 0.05° (float32 GN solves
started from the same state).
Free run: 8 frames on each side from scratch; same stage sequence and
positions within 5 mm of each other (plane at 2 m), the drift two float32
implementations may accumulate over 8 frames. The JAX run is made with
``sync=True``, and the port's ``sync=True`` results are held to its
``FrameResult``s at the free run's tolerances (stage, keyframe flag,
n_tracked ±2, position ≤ 5 mm), with the same ``frame_count``.
"""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.frontend.pipeline import (
    DevicePipelineMono as JaxPipeline)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.cameras.projections import Camera
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono, Stage)
from svo_pro_universal_tpu_torch.frontend.pipeline import DevicePipelineMono

from torch_parity_utils import (camera_dict, port_config, rotation_angle_deg,
                                sequence, slice_config, to_dict)

N_FRAMES = 8


def _jax_run(imgs, sync=False):
    """The JAX world before each frame, and the JAX trace (with ``sync``
    also each frame's FrameResult and the final frame_count)."""
    cfg = slice_config()
    h = JaxPipeline(cfg, CAM, trace_capacity=64, sync=sync)
    worlds, results = [], []
    for t, img in enumerate(imgs):
        worlds.append(to_dict(h.world))
        results.append(h.add_image(img, t * 0.05))
    mats, meta = h.drain()
    if sync:
        return imgs, cfg, worlds, mats, meta, results, h.frame_count
    return imgs, cfg, worlds, mats, meta


@pytest.fixture(scope="module")
def jax_synced():
    return _jax_run(sequence(N_FRAMES), sync=True)


@pytest.fixture(scope="module")
def jax_run(jax_synced):
    return jax_synced[:5]


def _port(cfg):
    cam = convert.camera(camera_dict(CAM))
    return DevicePipelineMono(port_config(cfg), cam, trace_capacity=64,
                              device="cpu")


def _assert_stepwise(run):
    imgs, cfg, worlds, mats, meta = run
    port = _port(cfg)
    for k in range(len(imgs)):
        world = convert.world(worlds[k], "cpu")
        world, n_tracked, is_kf = port.step(world, imgs[k], k * 0.05)
        assert world.stage == int(meta[k, 0]), k
        assert is_kf == bool(meta[k, 2]), k
        assert abs(n_tracked - int(meta[k, 1])) <= 2, (k, n_tracked,
                                                       meta[k, 1])
        T = world.last_frame.T_world_cam.as_matrix().numpy()
        assert np.linalg.norm(T[:3, 3] - mats[k, :3, 3]) <= 1e-3, k
        assert rotation_angle_deg(T[:3, :3], mats[k, :3, :3]) <= 0.05, k


def test_slice_stepwise_matches_jax(jax_run):
    _assert_stepwise(jax_run)
    assert (jax_run[4][:, 0] == Stage.TRACKING.value).all()


def test_slice_relocalization_matches_jax():
    """A blank frame loses track (RELOCALIZING); the next frame
    relocalizes against the closest keyframe (TRACKING again)."""
    imgs = sequence(6)
    imgs[3] = np.zeros_like(imgs[3])
    run = _jax_run(imgs)
    assert run[4][:, 0].tolist() == [Stage.TRACKING.value] * 3 + [
        Stage.RELOCALIZING.value] + [Stage.TRACKING.value] * 2
    _assert_stepwise(run)


def test_slice_free_run_matches_jax(jax_run):
    imgs, cfg, _, mats, meta = jax_run
    port = _port(cfg)
    for t, img in enumerate(imgs):
        port.add_image(img, t * 0.05)
    pmats, pmeta = port.drain()
    assert pmats.shape == mats.shape
    np.testing.assert_array_equal(pmeta[:, 0], meta[:, 0])
    assert (pmeta[:, 0] == Stage.TRACKING.value).all()
    gap = np.linalg.norm(pmats[:, :3, 3] - mats[:, :3, 3], axis=-1)
    assert gap.max() <= 5e-3, gap


def test_sync_results_match_jax(jax_synced):
    imgs, cfg, _, _, _, results, frame_count = jax_synced
    port = DevicePipelineMono(port_config(cfg),
                              convert.camera(camera_dict(CAM)),
                              trace_capacity=64, sync=True, device="cpu")
    got = [port.add_image(img, t * 0.05) for t, img in enumerate(imgs)]
    assert port.frame_count == frame_count == len(imgs)
    for k, (g, j) in enumerate(zip(got, results)):
        assert g.stage.value == j.stage.value == Stage.TRACKING.value, k
        assert g.is_keyframe == j.is_keyframe, k
        assert abs(g.n_tracked - j.n_tracked) <= 2, (k, g.n_tracked,
                                                     j.n_tracked)
        assert g.quality.name == j.quality.name == "GOOD"
        assert np.linalg.norm(g.T_world_cam[:3, 3]
                              - np.asarray(j.T_world_cam)[:3, 3]) <= 5e-3, k
    # the synced results are the trace's entries
    mats, meta = port.drain()
    assert [r.stage.value for r in got] == meta[:, 0].astype(int).tolist()
    np.testing.assert_array_equal(np.stack([r.T_world_cam for r in got]),
                                  mats)
    # unsynced, add_image returns nothing
    quiet = DevicePipelineMono(port_config(cfg),
                               convert.camera(camera_dict(CAM)),
                               trace_capacity=64, device="cpu")
    assert quiet.add_image(imgs[0], 0.0) is None
    assert quiet.frame_count == 1
    quiet.block()


def test_convert_round_trip(jax_run):
    """JAX world → port → numpy gives back the JAX arrays, dtypes
    included (integers as int32)."""
    _, _, worlds, _, _ = jax_run
    jw = worlds[-1]
    back = convert.to_numpy(convert.world(jw, "cpu"))

    def check(a, b):
        if isinstance(a, dict):
            for k in b:
                check(a[k], b[k])
            return
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)

    for key in ("ring", "pool", "last_frame", "T_rel_prev", "depth_state",
                "trace_q", "trace_t"):
        check(jw[key], back[key])
    assert back["stage"] == int(jw["stage"])


def test_pipeline_defaults_to_the_card(monkeypatch):
    """Without a card, the default device raises: no silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = Camera.pinhole(150.0, 150.0, 80.0, 60.0, 160, 120)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePipelineMono(port_config(slice_config()), cam)


def test_frame_handler_defaults_to_the_card(monkeypatch):
    """FrameHandlerMono, like the pipeline, runs on the card unless it is
    given a device: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = Camera.pinhole(150.0, 150.0, 80.0, 60.0, 160, 120)
    cfg = port_config(slice_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FrameHandlerMono(cfg, cam)
    assert FrameHandlerMono(cfg, cam, device="cpu").device.type == "cpu"


def test_unported_options_raise():
    """FivePoint initialization is ported (it constructs and starts in
    FIRST_FRAME), and so is every detector of the JAX package; only a
    detector name the JAX package does not know raises."""
    cam = Camera.pinhole(150.0, 150.0, 80.0, 60.0, 160, 120)
    cfg = port_config(slice_config())
    cfg.init.init_method = "FivePoint"
    pipe = DevicePipelineMono(cfg, cam, device="cpu")
    assert pipe.stage == Stage.FIRST_FRAME
    assert pipe.world.init_px.shape == (cfg.capacity.max_fts, 2)
    for kind in ("fast", "grad", "shitomasi", "shitomasi_grad", "sobel",
                 "canny", "gradhm", "allpixels"):
        cfg = port_config(slice_config())
        cfg.detector.detector_type = kind
        DevicePipelineMono(cfg, cam, device="cpu")
    cfg.detector.detector_type = "harris"
    with pytest.raises(ValueError, match="unknown detector_type"):
        DevicePipelineMono(cfg, cam, device="cpu")
