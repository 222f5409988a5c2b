"""The port's host ``FrameHandlerStereo`` (``add_image_pair``) against the
JAX package's, on the CPU at 160×120 on tests/test_pipeline_stereo.py's rig
(two copies of the test camera, 0.11 m apart) and tests/test_pipeline_
mono.py's sphere trajectory, 20 frames. Unlike the device pipelines, both
host handlers align on both cameras.

- Stepwise: JAX's handler state before frame k (``convert.host_stereo``:
  the frontend and cam1's two pyramids) into the port, one frame each: the
  same stage, quality and keyframe decision, n_tracked within ±2, the
  landmarks a keyframe's stereo re-triangulation promotes within ±2,
  position within 1 mm and rotation within 0.05°.
- Free run from the first pair: JAX's gates (TRACKING by frame 1 and at
  the end, metric unaligned ATE < 0.15 × path, the scale of the path
  within 0.85–1.18) and every frame's stage equal to JAX's, position
  within 5 mm.
- Reads: one a frame.
"""

import numpy as np
import pytest

from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerStereo as JaxStereo)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerStereo, Stage)

from test_pipeline_mono import trajectory
from test_pipeline_stereo import T_BODY_CAM0, T_BODY_CAM1, stereo_pair
from test_torch_host_mono import gap, same_decisions
from torch_parity_utils import (camera_dict, jax_host_state, port_config,
                                rig_config, to_dict, uint8_views,
                                unaligned_ate)

N_FRAMES = 20


def rig_run(h, feed, inputs):
    """Feed ``inputs`` to the JAX handler ``h``: (states before each frame
    and after the last, results, the keyframe landmark counts)."""
    states, results, n_lm = [], [], []
    for t, x in enumerate(inputs):
        states.append(jax_host_state(h))
        results.append(feed(h, x, t * 0.05))
        n_lm.append(h.stats.get(LM_KEY[type(h).__name__]))
    states.append(jax_host_state(h))
    return states, results, n_lm


LM_KEY = {"FrameHandlerStereo": "kf_stereo_landmarks",
          "FrameHandlerArray": "kf_array_landmarks"}


def check_stepwise(h, feed, inputs, states, results, n_lm, to_port):
    for t, x in enumerate(inputs):
        to_port(h, states[t])
        h.stats = {}
        reads = h.host_reads
        res = feed(h, x, t * 0.05)
        assert h.host_reads - reads == 1, t
        assert same_decisions(res, results[t], n_tol=2), (t, res,
                                                          results[t])
        dp, da = gap(res, results[t])
        assert dp <= 1e-3 and da <= 0.05, (t, dp, da)
        mine = h.stats.get(LM_KEY[type(h).__name__])
        if res.is_keyframe and t > 0:
            assert abs(int(mine) - int(n_lm[t])) <= 2, (t, mine, n_lm[t])


def check_free_run(h, feed, inputs, results, gt):
    est, start = [], None
    for t, x in enumerate(inputs):
        res = feed(h, x, t * 0.05)
        assert res.stage.value == results[t].stage.value, t
        assert gap(res, results[t])[0] <= 5e-3, t
        est.append(res.T_world_cam)
        if res.stage == Stage.TRACKING and start is None:
            start = t
    assert start is not None and start <= 1
    assert h.stage == Stage.TRACKING
    gt_pos = np.stack([np.asarray(p.inverse().t) for p in gt[start:]])
    est_pos = np.stack([m[:3, 3] for m in est[start:]])
    ate, path = unaligned_ate(np.stack(est[start:]), gt_pos)
    assert ate < 0.15 * max(path, 0.1), (ate, path)
    return gt_pos, est_pos


def _feed(h, pair, ts):
    return h.add_image_pair(pair[0], pair[1], ts)


def _port_se3(T):
    return convert.se3(to_dict(T))


@pytest.fixture(scope="module")
def stereo_run():
    cfg = rig_config()
    gt = trajectory(N_FRAMES)
    pairs = [tuple(uint8_views(stereo_pair(T))) for T in gt]
    h = JaxStereo(cfg, CAM, CAM, T_BODY_CAM0, T_BODY_CAM1)
    states, results, n_lm = rig_run(h, _feed, pairs)
    return dict(cfg=cfg, gt=gt, pairs=pairs, states=states,
                results=results, n_lm=n_lm)


def _port(cfg):
    cam = convert.camera(camera_dict(CAM))
    return FrameHandlerStereo(port_config(cfg), cam, cam,
                              _port_se3(T_BODY_CAM0),
                              _port_se3(T_BODY_CAM1), device="cpu")


def test_stereo_run_covers_the_path(stereo_run):
    res = stereo_run["results"]
    assert res[0].stage.value == Stage.TRACKING.value
    assert sum(bool(r.is_keyframe) for r in res[1:]) >= 2


def test_stereo_stepwise_matches_jax(stereo_run):
    r = stereo_run
    check_stepwise(_port(r["cfg"]), _feed, r["pairs"], r["states"],
                   r["results"], r["n_lm"], convert.host_stereo)


def test_stereo_free_run_matches_jax(stereo_run):
    r = stereo_run
    h = _port(r["cfg"])
    gt_pos, est_pos = check_free_run(h, _feed, r["pairs"], r["results"],
                                     r["gt"])
    gt_rel, est_rel = gt_pos - gt_pos[0], est_pos - est_pos[0]
    s = np.sum(gt_rel * est_rel) / max(np.sum(est_rel * est_rel), 1e-12)
    assert 0.85 < s < 1.18, s
    assert h.host_reads == N_FRAMES
