"""Checkpoints, the tracefile monitor and the map exports of the port,
against the JAX package on the CPU at 160×120 (the OneShot textured plane
of tests/test_torch_host_mono.py).

- Round trip: 7 frames, ``save_state``, a new handler, ``load_state``, 7
  more frames: every result equal to the uninterrupted run's to the bit.
- Across packages: a JAX ``save_state`` restores into the port and a port
  checkpoint into the JAX package; the next 7 frames of the port and of
  the JAX package, both resumed from the same file, have the same stage,
  quality, keyframe decision and tracked count, positions within 1 mm and
  rotations within 0.05° (tests/test_torch_host_mono.py's free-run bounds).
  The files hold the same keys; leaves have the JAX package's dtypes.
- ``PerformanceMonitor``: the same CSV text as JAX's for the same calls
  (timers stubbed to a fixed clock).
- ``export_ply``'s text equals JAX's; ``export_map_yaml`` of the same map
  loads equal to JAX's document (1e-7); ``dump_map`` writes its files.
"""

import json

import numpy as np
import pytest
import yaml

from svo_pro_universal_tpu import io as jio
from svo_pro_universal_tpu import viz as jviz
from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerMono as JaxHandler)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu.utils import perf as jperf
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch import io as tio
from svo_pro_universal_tpu_torch import viz as tviz
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono)
from svo_pro_universal_tpu_torch.utils import perf as tperf

from test_torch_host_mono import gap, same_decisions
from torch_parity_utils import (camera_dict, jax_host_state, port_config,
                                sequence, slice_config)

N_HALF = 7
DT = 0.05


def _port():
    return FrameHandlerMono(port_config(slice_config()),
                            convert.camera(camera_dict(CAM)), device="cpu")


def _feed(h, imgs, k0):
    return [h.add_image(img, (k0 + k) * DT) for k, img in enumerate(imgs)]


@pytest.fixture(scope="module")
def imgs():
    return sequence(2 * N_HALF)


def test_checkpoint_round_trip_resumes_exactly(imgs, tmp_path):
    whole = _feed(_port(), imgs, 0)
    h = _port()
    _feed(h, imgs[:N_HALF], 0)
    path = str(tmp_path / "state.npz")
    tio.save_state(path, h)
    h2 = _port()
    tio.load_state(path, h2)
    rest = _feed(h2, imgs[N_HALF:], N_HALF)
    assert sum(r.is_keyframe for r in whole[N_HALF:]) >= 1
    for a, b in zip(rest, whole[N_HALF:], strict=True):
        assert np.array_equal(a.T_world_cam, b.T_world_cam)
        assert (a.stage, a.n_tracked, a.quality, a.is_keyframe) == (
            b.stage, b.n_tracked, b.quality, b.is_keyframe)
    for x, y in zip(tio.leaves(h2.pool), tio.leaves(h.pool)):
        assert x.dtype == y.dtype and x.shape == y.shape


def _continue_both(path, imgs):
    """The port and the JAX package, each resumed from ``path``."""
    th, jh = _port(), JaxHandler(slice_config(), CAM)
    tio.load_state(path, th)
    jio.load_state(path, jh)
    tres = _feed(th, imgs[N_HALF:], N_HALF)
    jres = [jh.add_image(img, (N_HALF + k) * DT)
            for k, img in enumerate(imgs[N_HALF:])]
    for k, (r, jr) in enumerate(zip(tres, jres)):
        assert same_decisions(r, jr), (k, r, jr)
        dp, da = gap(r, jr)
        assert dp <= 1e-3 and da <= 0.05, (k, dp, da)
    return th, jh


def test_jax_checkpoint_restores_into_the_port_and_back(imgs, tmp_path):
    jh = JaxHandler(slice_config(), CAM)
    for k, img in enumerate(imgs[:N_HALF]):
        jh.add_image(img, k * DT)
    jpath = str(tmp_path / "jax.npz")
    jio.save_state(jpath, jh)
    th, _ = _continue_both(jpath, imgs)
    # the restored port state equals JAX's at the checkpoint
    th2 = _port()
    tio.load_state(jpath, th2)
    state = jax_host_state(jh)
    assert np.array_equal(th2.pool.pos.numpy(), state["pool"]["pos"])
    assert np.array_equal(th2.ring.frames.px.numpy(),
                          state["ring"]["frames"]["px"])

    # the reverse: the port's checkpoint into the JAX package
    h = _port()
    _feed(h, imgs[:N_HALF], 0)
    tpath = str(tmp_path / "port.npz")
    tio.save_state(tpath, h)
    _continue_both(tpath, imgs)
    jd, td = np.load(jpath), np.load(tpath)
    extra = {"T_rel_prev.0", "T_rel_prev.1", "_rng_state"}
    assert set(td.files) - extra == set(jd.files)
    for key in jd.files:
        if key != "__meta__":
            assert td[key].dtype == jd[key].dtype, key
            assert td[key].shape == jd[key].shape, key
    jm, tm = (json.loads(str(d["__meta__"])) for d in (jd, td))
    assert set(jm) <= set(tm)


def test_perf_monitor_writes_the_jax_tracefile(tmp_path, monkeypatch):
    texts = []
    for mod, sub in ((jperf, "j"), (tperf, "t")):
        clock = iter(np.arange(100) * 0.25)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        pm = mod.make_frontend_monitor(str(tmp_path / sub))
        for frame in range(3):
            with pm.timer("frontend_time"):
                with pm.timer("sparse_img_align"):
                    pass
            pm.log("timestamp", 1403636579.7635558 + frame * 0.05)
            pm.log("repr_n_matches", 42 + frame)
            pm.log("extra_log", frame)
            pm.write_to_file()
        pm.close()
        texts.append((tmp_path / sub / "trace.csv").read_text())
    assert texts[0] == texts[1]
    assert texts[1].splitlines()[0].startswith("timer_pyramid_creation,")


def test_map_exports_match_jax(imgs, tmp_path):
    pts = np.random.default_rng(0).uniform(-1, 1, (50, 3))
    cols = np.random.default_rng(1).integers(0, 255, (50, 3))
    for c in (None, cols):
        jviz.export_ply(str(tmp_path / "j.ply"), pts, c)
        tviz.export_ply(str(tmp_path / "t.ply"), pts, c)
        assert ((tmp_path / "j.ply").read_text()
                == (tmp_path / "t.ply").read_text())
    jh = JaxHandler(slice_config(), CAM)
    for k, img in enumerate(imgs[:N_HALF]):
        jh.add_image(img, k * DT)
    path = str(tmp_path / "state.npz")
    jio.save_state(path, jh)
    th = _port()
    tio.load_state(path, th)
    jio.export_map_yaml(str(tmp_path / "j.yaml"), jh)
    tio.export_map_yaml(str(tmp_path / "t.yaml"), th)
    jd = yaml.safe_load((tmp_path / "j.yaml").read_text())
    td = yaml.safe_load((tmp_path / "t.yaml").read_text())
    assert len(td["keyframes"]) >= 1 and len(td["points"]) > 10
    for part in ("keyframes", "points"):
        assert len(td[part]) == len(jd[part])
        for a, b in zip(td[part], jd[part]):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_allclose(a[key], b[key], atol=1e-7)
    tviz.dump_map(th, str(tmp_path / "map"))
    assert (tmp_path / "map_landmarks.ply").read_text().startswith("ply")
    assert (tmp_path / "map_trajectory.png").stat().st_size > 1000
