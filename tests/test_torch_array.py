"""The port's N-camera array VO (DevicePipelineArray) against the JAX
package's, on the CPU, at 160×120 on tests/test_pipeline_array.py's
three-camera rig (cam1 0.11 m along x, cam2 0.09 m along y) and
tests/test_pipeline_mono.py's sphere trajectory. The JAX device pipeline
runs once per module.

- Stepwise: the JAX world before frame k converted into the port, one step
  each: the same stage and keyframe decision, n_tracked within ±2, the
  landmarks a keyframe triangulates within ±2, position ≤ 1 mm and
  rotation ≤ 0.05° on every frame.
- Joint alignment: the port's ``_stage_align`` with ``joint_alignment`` on
  against the JAX host ``FrameHandlerArray._stage_align`` given both
  secondary cameras' pyramids: rotation ≤ 1e-4 rad, translation ≤
  1e-4·depth.
- Free run of the port from the first frame: the JAX test's gates
  (TRACKING by frame 1 and on, metric unaligned ATE < 0.15 × path).
- Unequal resolutions are refused; the pipeline runs on the card by
  default; ``convert`` round trip.
"""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerArray, Stage)
from svo_pro_universal_tpu.frontend.pipeline_array import (
    DevicePipelineArray as JaxArray)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.frontend.pipeline_array import (
    DevicePipelineArray)

from test_pipeline_array import T_BODY_CAMS, bundle
from test_pipeline_mono import trajectory
from torch_parity_utils import (assert_tree_equal, camera_dict,
                                new_own_landmarks, port_config, pose_gap,
                                rig_config, rotation_angle_deg, to_dict,
                                uint8_views, unaligned_ate)

N_FRAMES = 18                    # tests/test_device_pipeline_array.py


def array_config():
    """tests/test_device_pipeline_array.py's config (no stereo flag)."""
    cfg = rig_config()
    cfg.pipeline_is_stereo = False
    return cfg


@pytest.fixture(scope="module")
def array_run():
    cfg = array_config()
    gt = trajectory(N_FRAMES)
    bundles = [uint8_views(bundle(T)) for T in gt]
    h = JaxArray(cfg, [CAM] * 3, T_BODY_CAMS, trace_capacity=64)
    jworlds = []
    for t, imgs in enumerate(bundles):
        jworlds.append(h.world)
        h.add_image_bundle(imgs, t * 0.05)
    jworlds.append(h.world)
    mats, meta = h.drain()
    return dict(cfg=cfg, gt=gt, bundles=bundles, jworlds=jworlds,
                worlds=[to_dict(w) for w in jworlds], mats=mats, meta=meta)


def _port(cfg, joint=False, device="cpu", cams=None):
    cam = convert.camera(camera_dict(CAM))
    return DevicePipelineArray(
        port_config(cfg), cams or [cam] * 3,
        [convert.se3(to_dict(T)) for T in T_BODY_CAMS], trace_capacity=64,
        joint_alignment=joint, device=device)


def test_array_run_covers_the_path(array_run):
    meta = array_run["meta"]
    assert (meta[:, 0] == Stage.TRACKING.value).all()
    assert meta[1:, 2].sum() >= 1


def test_array_stepwise_matches_jax(array_run):
    r = array_run
    worlds, meta = r["worlds"], r["meta"]
    pipe = _port(r["cfg"])
    checked = []
    for k, imgs in enumerate(r["bundles"]):
        pipe.world = convert.world_array(worlds[k])
        pipe._t_epoch = 0.0
        pipe.add_image_bundle(imgs, k * 0.05)
        w, jw = pipe.world, worlds[k + 1]
        m = w.trace_meta[w.trace_ptr - 1]
        assert w.stage == int(meta[k, 0]), k
        assert bool(m[2]) == bool(meta[k, 2]), k
        assert abs(int(m[1]) - int(meta[k, 1])) <= 2, (k, m[1], meta[k, 1])
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


def test_array_joint_alignment_matches_jax_host(array_run):
    """Frame 3's sparse alignment on all three cameras, from the world
    before it."""
    k = 3
    cfg = array_run["cfg"]
    jw, jn = array_run["jworlds"][k], array_run["jworlds"][k + 1]
    jh = FrameHandlerArray(cfg, [CAM] * 3, T_BODY_CAMS)
    jextra = dict(pyr_last=list(jn.pyrs_prev), pyr_cur=list(jn.pyrs_cur))
    Tj, _ = jh._stage_align(jw.ring, jw.pool, jw.last_frame,
                            jn.last_frame.pyramid, jw.T_rel_prev, jextra)
    Tj = convert.se3(to_dict(Tj)).inverse().as_matrix().numpy()
    w, n = array_run["worlds"][k], array_run["worlds"][k + 1]
    tw = convert.world_array(w)
    pyrs_prev = convert.tensor(n["pyrs_prev"])
    pyrs_cur = convert.tensor(n["pyrs_cur"])
    pipe = _port(cfg, joint=True)
    inputs = pipe._extra_align_inputs(
        tw.ring, tw.pool, tw.last_frame,
        dict(pyr_last=list(pyrs_prev), pyr_cur=list(pyrs_cur)))
    assert len(inputs) == 2
    Tt, _ = pipe._stage_align(
        tw.ring, tw.pool, tw.last_frame,
        convert.tensor(n["last_frame"]["pyramid"]), tw.T_rel_prev,
        dict(pyr_last=list(pyrs_prev), pyr_cur=list(pyrs_cur)))
    Tt = Tt.inverse().as_matrix().numpy()
    depth = float(np.asarray(jw.depth_state)[0])
    rot = np.radians(rotation_angle_deg(Tt[:3, :3], Tj[:3, :3]))
    trans = float(np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]))
    assert rot <= 1e-4 and trans <= 1e-4 * depth, (rot, trans)


def test_array_free_run(array_run):
    r = array_run
    pipe = _port(r["cfg"])
    for t, imgs in enumerate(r["bundles"]):
        pipe.add_image_bundle(imgs, t * 0.05)
    mats, meta = pipe.drain()
    stages = meta[:, 0].astype(int)
    start = int(np.argmax(stages == Stage.TRACKING.value))
    assert start <= 1 and (stages[start:] == Stage.TRACKING.value).all()
    np.testing.assert_array_equal(meta[:, 0], r["meta"][:, 0])
    gt_pos = np.stack([np.asarray(p.inverse().t) for p in r["gt"][start:]])
    ate, path = unaligned_ate(mats[start:], gt_pos)
    assert ate < 0.15 * max(path, 0.1), (ate, path)


def test_array_refuses_unequal_resolutions(array_run):
    cam = convert.camera(camera_dict(CAM))
    small = convert.camera(dict(camera_dict(CAM), width=80))
    with pytest.raises(ValueError, match="equal resolutions"):
        _port(array_run["cfg"], cams=[cam, cam, small])


def test_array_pipeline_defaults_to_the_card(monkeypatch, array_run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(array_run["cfg"], device=None)
    pipe = _port(array_run["cfg"])
    assert pipe.n_cams == 3 and pipe.world.pyrs_cur.shape[0] == 2
    assert all(c.intrinsics.device.type == "cpu" for c in pipe.cams)


def test_convert_round_trip_array(array_run):
    jw = array_run["worlds"][-1]
    back = convert.to_numpy(convert.world_array(jw))
    for key in ("ring", "pool", "last_frame", "pyrs_cur", "pyrs_prev",
                "T_rel_prev", "stage", "trace_ptr"):
        assert_tree_equal(back[key], jw[key])
