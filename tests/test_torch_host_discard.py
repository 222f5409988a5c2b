"""Branches of the port's host handlers whose map the JAX package throws
away (JAX frame_handler.py:800-804, 930-946, 1113-1117, 1222-1228). The
port's keyframe ring is written in place (frontend.map.insert_keyframe),
so each such branch is checked for traces: the ring and pool the handler
held before the frame, compared leaf by leaf with a copy taken before it,
and what the handler holds after it, as the JAX package's branch leaves it.

- A failed relocalization trial: ring and pool as they were (the same
  objects, the same values).
- A failed two-view bootstrap (tracks lost): back to FIRST_FRAME with an
  all-zero ring, the pool as it was; the old ring's buffers untouched.
- A stereo or array bootstrap with too few detections: ring and pool as
  they were; with too few triangulated landmarks (the bar raised above
  what the pair can give): an all-zero ring and an empty pool, the old
  ring's buffers untouched (the triangulation ran on a copy); the array
  keeps the triangulated frame as ``last_frame``, as JAX's does.
"""

import numpy as np
import torch

from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerArray, FrameHandlerMono, FrameHandlerStereo, Stage)

from test_pipeline_array import T_BODY_CAMS, bundle
from test_pipeline_mono import make_config, trajectory
from test_pipeline_stereo import T_BODY_CAM0, T_BODY_CAM1, stereo_pair
from test_torch_array import array_config
from test_torch_init import sphere_sequence
from torch_parity_utils import (camera_dict, port_config, rig_config,
                                sequence, slice_config, to_dict,
                                uint8_views)


def leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree for x in leaves(v)]


def snapshot(tree) -> list:
    return [x.clone() for x in leaves(tree)]


def unchanged(tree, snap) -> bool:
    return all(torch.equal(a, b) for a, b in zip(leaves(tree), snap))


def all_zero(tree) -> bool:
    return all(not torch.any(x.to(torch.float32) != 0) for x in leaves(tree))


def _cam():
    return convert.camera(camera_dict(CAM))


def test_failed_relocalization_trial_leaves_ring_and_pool():
    h = FrameHandlerMono(port_config(slice_config()), _cam(), device="cpu")
    views = sequence(6)
    blank = np.full_like(views[0], 128)
    for t, img in enumerate(views + [blank]):
        h.add_image(img, t * 0.05)
    assert h.stage == Stage.RELOCALIZING
    ring, pool = h.ring, h.pool
    ring_s, pool_s = snapshot(ring), snapshot(pool)
    res = h.add_image(blank, 0.4)                 # a failed trial
    assert res.stage == Stage.RELOCALIZING and h.reloc_trials == 1
    assert h.ring is ring and h.pool is pool
    assert unchanged(ring, ring_s) and unchanged(pool, pool_s)


def test_failed_two_view_bootstrap_zeroes_only_the_ring():
    cfg = make_config()                           # FivePoint
    h = FrameHandlerMono(port_config(cfg), _cam(), device="cpu")
    img0 = sphere_sequence(1)[0]
    h.add_image(img0, 0.0)
    assert h.stage == Stage.INITIALIZING
    ring, pool = h.ring, h.pool
    ring_s, pool_s = snapshot(ring), snapshot(pool)
    res = h.add_image(np.full_like(img0, 128), 0.05)     # tracks lost
    assert res.stage == Stage.FIRST_FRAME
    assert all_zero(h.ring) and unchanged(ring, ring_s)
    assert h.pool is pool and unchanged(pool, pool_s)


def _check_rig_bootstrap(h, good, no_features, keeps_frame: bool):
    ring, pool = h.ring, h.pool
    ring_s, pool_s = snapshot(ring), snapshot(pool)
    res = h._add_views(no_features, 0.0)
    assert res.stage == Stage.FIRST_FRAME and res.n_tracked == 0
    assert h.ring is ring and h.pool is pool
    assert unchanged(ring, ring_s) and unchanged(pool, pool_s)
    assert h.last_frame is None
    # too few landmarks: a bar no triangulation can reach
    need = h.cfg.init.init_min_inliers
    h.cfg.init.init_min_inliers = h.max_fts + 1
    res = h._add_views(good, 0.05)
    h.cfg.init.init_min_inliers = need
    assert res.stage == Stage.FIRST_FRAME and res.n_tracked >= need
    assert all_zero(h.ring) and unchanged(ring, ring_s)
    assert int(h.pool.valid.sum()) == 0 and unchanged(pool, pool_s)
    assert (h.last_frame is not None) == keeps_frame
    res = h._add_views(good, 0.1)
    assert res.stage == Stage.TRACKING and res.is_keyframe


def test_failed_stereo_bootstrap_leaves_no_trace():
    cam = _cam()
    h = FrameHandlerStereo(port_config(rig_config()), cam, cam,
                           convert.se3(to_dict(T_BODY_CAM0)),
                           convert.se3(to_dict(T_BODY_CAM1)), device="cpu")
    pair = uint8_views(stereo_pair(trajectory(1)[0]))
    blank = np.full_like(pair[0], 128)
    _check_rig_bootstrap(h, pair, [blank, blank], False)


def test_failed_array_bootstrap_leaves_no_trace():
    h = FrameHandlerArray(port_config(array_config()), [_cam()] * 3,
                          [convert.se3(to_dict(T)) for T in T_BODY_CAMS],
                          device="cpu")
    views = uint8_views(bundle(trajectory(1)[0]))
    blank = np.full_like(views[0], 128)
    _check_rig_bootstrap(h, views, [blank] * 3, True)
