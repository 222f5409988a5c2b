"""The port's host ``FrameHandlerVIO`` against the JAX package's, on the CPU
at 160×120, on the sphere+plane scene of tests/test_device_pipeline_vio.py
(``simulate_fast``, 2.4 s: 10 Hz camera, 200 Hz IMU fed through
``add_imu_measurement``), config of tests/test_torch_vio.py.

Stepwise: JAX's handler state before frame k (``convert.host_vio``: the
frontend, the backend's state, window count and keyframe times) goes into
the port, JAX's RANSAC noise is injected, and both take frame k. The run
covers a failed bootstrap (tracks lost, back to FIRST_FRAME), the two-view
bootstrap and five backend calls, the last with a full window.

- Every frame: the same stage, quality and keyframe decision, n_tracked
  within ±2 (the device VIO test's bound); position within 1 mm and
  rotation within 0.05°, the bootstrap frame within 1 cm and 0.2° (JAX's
  float32 eigh there, tests/test_torch_vio.py).
- The backend: the same window count and keyframe times; after each call
  the window's states (q, p, v, bg, ba) within 1e-3 of JAX's. The port's
  solve runs with ``void_on_single_view``: its float64 solve would move
  every once-seen landmark along its bearing, where JAX's float32 solve
  voids the state step. The chi2 is held finite and positive, not to JAX's
  value: the once-seen landmarks' updates in JAX come from float32 inverses
  of near-singular blocks.
- Reads: one a tracked frame, one more per backend call (its scale and
  chi2); at most two on a bootstrap frame (n_ok and the disparity, then
  n_inliers when it tries RANSAC).
"""

import numpy as np
import pytest

from svo_pro_universal_tpu.cameras.rig import ImuParams as JImuParams
from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerVIO as JaxVIO)
from svo_pro_universal_tpu.frontend.imu_handler import ImuHandler as JImu
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerVIO, Stage)
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler

from synthetic_utils import render_sphere_view
from test_device_pipeline_vio import simulate_fast
from test_pipeline_vio import G_W
from test_torch_host_mono import gap, inject_noise, same_decisions
from test_torch_vio import vio_config
from torch_parity_utils import camera_dict, jax_host_state, port_config

DURATION = 2.4


def feed_imu(h, stream, i, ts) -> int:
    while i < len(stream) and stream[i][0] <= ts:
        h.add_imu_measurement(*stream[i])
        i += 1
    return i


@pytest.fixture(scope="module")
def vio_run():
    imu_stream, cam_poses, cam_ts = simulate_fast(duration=DURATION)
    frames = [np.clip(np.rint(np.asarray(render_sphere_view(T))), 0,
                      255).astype(np.uint8) for T in cam_poses]
    cfg = vio_config()
    h = JaxVIO(cfg, CAM, imu_handler=JImu(JImuParams()),
               imu_params=JImuParams(), gravity=tuple(G_W))
    states, results, i = [], [], 0
    for img, ts in zip(frames, cam_ts):
        i = feed_imu(h, imu_stream, i, ts)
        states.append(jax_host_state(h))
        results.append(h.add_image(img, ts))
    states.append(jax_host_state(h))
    return dict(cfg=cfg, frames=frames, cam_ts=cam_ts,
                imu_stream=imu_stream, states=states, results=results)


def test_vio_run_covers_the_path(vio_run):
    stages = [r.stage.value for r in vio_run["results"]]
    assert Stage.FIRST_FRAME.value in stages[1:]       # a failed bootstrap
    assert stages[-1] == Stage.TRACKING.value
    n_states = [s["backend"]["n_states"] for s in vio_run["states"]]
    assert n_states[-1] == 5                           # the window filled
    assert sum(b > a for a, b in zip(n_states, n_states[1:])) >= 4


def test_vio_stepwise_matches_jax(vio_run):
    r = vio_run
    states, results = r["states"], r["results"]
    cfg = r["cfg"]
    h = FrameHandlerVIO(port_config(cfg), convert.camera(camera_dict(CAM)),
                        imu_handler=ImuHandler(ImuParams()),
                        imu_params=ImuParams(), gravity=tuple(G_W),
                        device="cpu")
    h.backend.opts = h.backend.opts._replace(void_on_single_view=True)
    inject_noise(h, states)
    boot = next(k for k, res in enumerate(results)
                if res.stage.value == Stage.TRACKING.value)
    i, calls = 0, 0
    for k, (img, ts) in enumerate(zip(r["frames"], r["cam_ts"])):
        i = feed_imu(h, r["imu_stream"], i, ts)
        h.k = k
        convert.host_vio(h, states[k])
        reads = h.host_reads
        res = h.add_image(img, ts)
        jres, jb = results[k], states[k + 1]["backend"]
        assert same_decisions(res, jres, n_tol=2), (k, res, jres)
        dp, da = gap(res, jres)
        tol = (1e-2, 0.2) if k == boot else (1e-3, 0.05)
        assert dp <= tol[0] and da <= tol[1], (k, dp, da)
        assert h.backend.n_states == jb["n_states"], k
        assert h.backend._ts == [float(t) for t in jb["_ts"]], k
        ran = jb["_ts"] != states[k]["backend"]["_ts"]
        if states[k]["stage"] == Stage.TRACKING.value:
            assert h.host_reads - reads == 1 + ran, k
        else:                          # plus n_inliers on a RANSAC frame
            assert h.host_reads - reads <= 2, k
        if ran:
            calls += 1
            pw = convert.to_numpy(h.backend.state.window)
            for f in ("q", "p", "v", "bg", "ba"):
                np.testing.assert_allclose(pw[f], jb["state"]["window"][f],
                                           atol=1e-3, err_msg=f"{k} {f}")
            chi2 = h.stats["backend_chi2"]
            assert np.isfinite(chi2) and chi2 > 0, (k, chi2)
    assert calls >= 4
