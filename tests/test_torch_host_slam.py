"""The port's host ``FrameHandlerSLAM`` (mono frontend + loop closing + pose
graph + global map) against the JAX package's, on the CPU at 160×120 on
tests/test_slam.py's loop (``loop_trajectory``: 1.4 laps of the sphere
scene, its config and loop-closing options), 28 frames. The JAX run closes
a verified loop (frame 27), absorbs every keyframe into the
global map and re-injects its landmarks as FIXED after each solve.

- Stepwise: JAX's state before frame k (``convert.host_slam``: the
  frontend, pose graph, node poses, uid→slot map, loop count, the loop
  closer's database and the global map) into the port, JAX's RANSAC noise
  injected, one frame each: the same stage, quality and keyframe decision,
  n_tracked within ±2; the same pose-graph node and loop counts, global-map
  length and FIXED landmark count; position within 1 mm and rotation
  within 0.05°. Not the bootstrap frame's pose: a two-view bootstrap at a
  two-frame baseline, where JAX's float32 eigh and the port's float64 one
  land 0.17 m / 4° apart (tests/test_torch_vio.py has the same fork).
- Free run in segments from JAX's state after the bootstrap to the end:
  the port runs on its own, restarted from JAX's state only after each
  global-map solve (frames 10, 18, 26), with the same counts on every
  frame (the loop closed at the same frame), positions within 5 mm and
  at the end the pose-graph trajectory within 5 mm of JAX's.
  The restarts: the global map keeps once-seen landmarks (60 of its 107
  at frame 10) and re-injects them as FIXED, at a depth along their
  bearing that no observation fixes; JAX's float32 solve, the same solve
  in float64 and the port's place them metres apart, and the next frame
  tracks 3 cm apart (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.backend.loop_closing import (
    LoopClosingOptions as JaxLCOptions)
from svo_pro_universal_tpu.frontend.slam import FrameHandlerSLAM as JaxSLAM
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.backend.loop_closing import (
    LoopClosingOptions)
from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
from svo_pro_universal_tpu_torch.frontend.slam import FrameHandlerSLAM

from synthetic_utils import render_sphere_view
from test_pipeline_mono import make_config
from test_slam import loop_trajectory
from test_torch_host_mono import gap, inject_noise, same_decisions
from torch_parity_utils import (camera_dict, jax_host_state, port_config,
                                uint8_views)

N_FRAMES = 28
LC = dict(min_temporal_gap=6, min_similarity=0.8, min_inliers=12)


def slam_config():
    cfg = make_config()
    cfg.base.kfselect_min_num_frames_between_kfs = 1
    cfg.base.kfselect_min_disparity = 8.0
    return cfg


def counts(h) -> tuple:
    fixed = h.pool.fixed
    n_fixed = int(fixed.sum()) if torch.is_tensor(fixed) else int(
        np.asarray(fixed).sum())
    return h._pgo_n, h.n_loops_closed, len(h.global_map), n_fixed


@pytest.fixture(scope="module")
def slam_run():
    cfg = slam_config()
    imgs = uint8_views([render_sphere_view(T)
                        for T in loop_trajectory(N_FRAMES)])
    h = JaxSLAM(cfg, CAM, lc_opts=JaxLCOptions(**LC), use_global_map=True)
    states, results, cnt = [], [], []
    for t, img in enumerate(imgs):
        states.append(jax_host_state(h))
        results.append(h.add_image(img, t * 0.1))
        cnt.append(counts(h))
    states.append(jax_host_state(h))
    return dict(cfg=cfg, imgs=imgs, states=states, results=results,
                counts=cnt, pgo=np.asarray(h.pgo_trajectory()))


def _port(cfg, states):
    h = FrameHandlerSLAM(port_config(cfg), convert.camera(camera_dict(CAM)),
                         lc_opts=LoopClosingOptions(**LC), device="cpu")
    inject_noise(h, states)
    return h


def test_slam_run_covers_the_path(slam_run):
    c = slam_run["counts"]
    assert slam_run["results"][-1].stage.value == Stage.TRACKING.value
    assert c[-1][0] >= 6 and c[-1][1] >= 1 and c[-1][2] >= 6
    assert c[-1][3] > 0                       # FIXED landmarks re-injected


def test_slam_stepwise_matches_jax(slam_run):
    r = slam_run
    states, results = r["states"], r["results"]
    h = _port(r["cfg"], states)
    boot = next(t for t, res in enumerate(results)
                if res.stage.value == Stage.TRACKING.value)
    for t, img in enumerate(r["imgs"]):
        h.k = t
        convert.host_slam(h, states[t])
        res = h.add_image(img, t * 0.1)
        assert same_decisions(res, results[t], n_tol=2), (t, res,
                                                          results[t])
        assert counts(h) == r["counts"][t], (t, counts(h), r["counts"][t])
        if t != boot:
            dp, da = gap(res, results[t])
            assert dp <= 1e-3 and da <= 0.05, (t, dp, da)


def test_slam_free_run_in_segments_matches_jax(slam_run):
    r = slam_run
    states, results, cnt = r["states"], r["results"], r["counts"]
    k0 = next(t for t, res in enumerate(results)
              if res.stage.value == Stage.TRACKING.value) + 1
    h = _port(r["cfg"], states)
    restarts = []
    for t in range(k0, N_FRAMES):
        if t == k0 or cnt[t - 1][3] != cnt[t - 2][3]:
            convert.host_slam(h, states[t])     # after a global solve
            restarts.append(t)
        res = h.add_image(r["imgs"][t], t * 0.1)
        assert res.stage.value == results[t].stage.value, t
        assert counts(h) == cnt[t], (t, counts(h), cnt[t])
        assert gap(res, results[t])[0] <= 5e-3, t
    assert len(restarts) <= 4, restarts
    assert cnt[-1][1] >= 1 and h.n_loops_closed == cnt[-1][1]
    np.testing.assert_allclose(h.pgo_trajectory(), r["pgo"], atol=5e-3)
