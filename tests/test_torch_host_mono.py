"""The port's host ``FrameHandlerMono`` (``add_image`` → ``FrameResult``)
against the JAX package's, on the CPU at 160×120.

- OneShot on the textured plane of tests/test_torch_slice.py (14 frames,
  two keyframes): stepwise from JAX's state before each frame
  (``convert.host_mono``) and free from scratch, every frame with the same
  stage, quality, keyframe decision and tracked count; position within
  1 mm and rotation within 0.05° (stepwise), 1 mm (free).
- Two-view (FivePoint) on the sphere+plane scene of tests/test_torch_init.py
  (10 frames: first frame, initializing, TRACKING), JAX's RANSAC noise
  injected: the same stages and keyframes, tracked counts within ±2 (the
  device pipeline's bound, test_torch_init.py), positions within 5 mm.
- ``host_reads``: one device→host read per frame.

Relocalization and the host/device agreement are in
tests/test_torch_host_reloc.py.
"""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerMono as JaxHandler)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono, Stage)

from test_pipeline_mono import make_config
from test_torch_init import init_noise_of, sphere_sequence
from torch_parity_utils import (camera_dict, jax_host_state, port_config,
                                rotation_angle_deg, sequence, slice_config)

N_ONESHOT = 14
N_FIVEPOINT = 10


def jax_run(cfg, imgs, dt=0.05):
    """The JAX host handler over ``imgs``: (states before each frame,
    results)."""
    h = JaxHandler(cfg, CAM)
    states, results = [], []
    for t, img in enumerate(imgs):
        states.append(jax_host_state(h))
        results.append(h.add_image(img, t * dt))
    return states, results


def port_handler(cfg):
    return FrameHandlerMono(port_config(cfg),
                            convert.camera(camera_dict(CAM)), device="cpu")


def inject_noise(h, states):
    """The port handler's RANSAC draws JAX's noise of frame ``h.k``."""
    h.k = 0
    h._init_noise = lambda n_hyp, n: torch.from_numpy(np.array(
        init_noise_of(states[h.k], n)))


def gap(res, jres) -> tuple[float, float]:
    T, Tj = res.T_world_cam, np.asarray(jres.T_world_cam)
    return (float(np.linalg.norm(T[:3, 3] - Tj[:3, 3])),
            rotation_angle_deg(T[:3, :3], Tj[:3, :3]))


def same_decisions(res, jres, n_tol=0) -> bool:
    return (res.stage.value == jres.stage.value
            and res.quality.value == jres.quality.value
            and res.is_keyframe == bool(jres.is_keyframe)
            and abs(res.n_tracked - int(jres.n_tracked)) <= n_tol)


@pytest.fixture(scope="module")
def oneshot_run():
    cfg = slice_config()
    imgs = sequence(N_ONESHOT)
    states, results = jax_run(cfg, imgs)
    return cfg, imgs, states, results


@pytest.fixture(scope="module")
def fivepoint_run():
    cfg = make_config()
    imgs = sphere_sequence(N_FIVEPOINT)
    states, results = jax_run(cfg, imgs)
    return cfg, imgs, states, results


def test_oneshot_run_covers_the_path(oneshot_run):
    _, _, _, results = oneshot_run
    assert all(r.stage.value == Stage.TRACKING.value for r in results)
    assert sum(bool(r.is_keyframe) for r in results[1:]) >= 1


def test_oneshot_stepwise_matches_jax(oneshot_run):
    cfg, imgs, states, results = oneshot_run
    h = port_handler(cfg)
    for t, img in enumerate(imgs):
        convert.host_mono(h, states[t])
        res = h.add_image(img, t * 0.05)
        assert same_decisions(res, results[t]), (t, res, results[t])
        dp, da = gap(res, results[t])
        assert dp <= 1e-3 and da <= 0.05, (t, dp, da)


def test_oneshot_free_run_matches_jax(oneshot_run):
    cfg, imgs, _, results = oneshot_run
    h = port_handler(cfg)
    for t, img in enumerate(imgs):
        res = h.add_image(img, t * 0.05)
        assert same_decisions(res, results[t]), (t, res, results[t])
        assert gap(res, results[t])[0] <= 1e-3, t
    assert h.host_reads == len(imgs)          # one read a frame


def test_fivepoint_stepwise_matches_jax(fivepoint_run):
    cfg, imgs, states, results = fivepoint_run
    stages = [r.stage.value for r in results]
    assert Stage.INITIALIZING.value in stages
    assert stages[-1] == Stage.TRACKING.value
    h = port_handler(cfg)
    inject_noise(h, states)
    for t, img in enumerate(imgs):
        h.k = t
        convert.host_mono(h, states[t])
        res = h.add_image(img, t * 0.05)
        assert same_decisions(res, results[t], n_tol=2), (t, res,
                                                          results[t])
        dp, da = gap(res, results[t])
        assert dp <= 5e-3 and da <= 0.2, (t, dp, da)


def test_fivepoint_free_run_matches_jax(fivepoint_run):
    """From scratch: the bootstrap pose is a float32 eigh in JAX and a
    float64 one in the port (test_torch_init.py), so the two maps differ
    by a fraction of a millimetre from there on. Every frame has the same
    stage and a position within 5 mm; the keyframe decisions and counts
    are equal through the bootstrap and the two frames after it (the
    first flip, a keyframe decision at the disparity gate, comes at frame
    9)."""
    cfg, imgs, states, results = fivepoint_run
    h = port_handler(cfg)
    inject_noise(h, states)
    boot = next(t for t, r in enumerate(results)
                if r.stage.value == Stage.TRACKING.value)
    first_flip = None
    for t, img in enumerate(imgs):
        h.k = t
        res = h.add_image(img, t * 0.05)
        assert res.stage.value == results[t].stage.value, t
        assert gap(res, results[t])[0] <= 5e-3, t
        if first_flip is None and not same_decisions(res, results[t],
                                                     n_tol=2):
            first_flip = t
    assert first_flip is None or first_flip > boot + 2, (boot, first_flip)
