"""The port's host ``FrameHandlerArray`` (``add_image_bundle``) against the
JAX package's, on the CPU at 160×120 on tests/test_pipeline_array.py's
three-camera rig (cam1 0.11 m along x, cam2 0.09 m along y) and
tests/test_pipeline_mono.py's sphere trajectory, 18 frames. Both host
handlers align jointly on the three cameras and triangulate every
keyframe's seeds pair by pair (N−1 pair triangulations).

- Stepwise: JAX's handler state before frame k (``convert.host_array``)
  into the port, one frame each: the same stage, quality and keyframe
  decision, n_tracked within ±2, the landmarks a keyframe's pair
  triangulations promote within ±2, position within 1 mm and rotation
  within 0.05°; one read a frame.
- Free run from the first bundle: JAX's gates (TRACKING by frame 1 and at
  the end, metric unaligned ATE < 0.15 × path) and every frame's stage
  equal to JAX's, position within 5 mm.
"""

import pytest

from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerArray as JaxArray)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerArray, Stage)

from test_pipeline_array import T_BODY_CAMS, bundle
from test_pipeline_mono import trajectory
from test_torch_array import array_config
from test_torch_host_stereo import check_free_run, check_stepwise, rig_run
from torch_parity_utils import camera_dict, port_config, to_dict, uint8_views

N_FRAMES = 18


def _feed(h, imgs, ts):
    return h.add_image_bundle(imgs, ts)


@pytest.fixture(scope="module")
def array_run():
    cfg = array_config()
    gt = trajectory(N_FRAMES)
    bundles = [uint8_views(bundle(T)) for T in gt]
    h = JaxArray(cfg, [CAM] * 3, T_BODY_CAMS)
    states, results, n_lm = rig_run(h, _feed, bundles)
    return dict(cfg=cfg, gt=gt, bundles=bundles, states=states,
                results=results, n_lm=n_lm)


def _port(cfg):
    cam = convert.camera(camera_dict(CAM))
    return FrameHandlerArray(port_config(cfg), [cam] * 3,
                             [convert.se3(to_dict(T)) for T in T_BODY_CAMS],
                             device="cpu")


def test_array_run_covers_the_path(array_run):
    res = array_run["results"]
    assert res[0].stage.value == Stage.TRACKING.value
    assert sum(bool(r.is_keyframe) for r in res[1:]) >= 1


def test_array_stepwise_matches_jax(array_run):
    r = array_run
    check_stepwise(_port(r["cfg"]), _feed, r["bundles"], r["states"],
                   r["results"], r["n_lm"], convert.host_array)


def test_array_free_run_matches_jax(array_run):
    r = array_run
    check_free_run(_port(r["cfg"]), _feed, r["bundles"], r["results"],
                   r["gt"])
