"""The port's stereo VO (DevicePipelineStereo) against the JAX package's, on
the CPU, at 160×120 on tests/test_pipeline_stereo.py's rig (two copies of
the test camera, 0.11 m apart) and tests/test_pipeline_mono.py's sphere
trajectory. The JAX device pipeline runs once per module.

- ``triangulate_pair`` on the first stereo pair: success counts within 1;
  cam1 position within 1e-3 px where both succeed, and depth within 1e-4
  relative where the match also triangulates in front of the cameras. (The
  matcher returns |depth|, as the JAX package's does: a match on the wrong
  side of the epipole is mirrored, and its float32 depth, from two nearly
  parallel rays, carries ~1e-3 relative rounding.)
- Joint alignment: the port's ``_stage_align`` with ``joint_alignment`` on
  against the JAX host ``FrameHandlerStereo._stage_align`` given cam1's
  pyramids, on converted worlds: rotation ≤ 1e-4 rad, translation ≤
  1e-4·depth. With the flag off the port equals JAX's cam0-only alignment
  (what the JAX device pipeline does), and the two differ.
- Stepwise: the JAX world before frame k converted into the port, one step
  each: the same stage and keyframe decision, n_tracked within ±2, the
  stereo landmarks of a keyframe within ±2, position ≤ 1 mm and rotation ≤
  0.05° on every frame.
- Free run of the port from the first frame: the JAX test's gates
  (TRACKING by frame 1 and on, metric unaligned ATE < 0.15 × path).
- The pipeline runs on the card by default; ``convert`` round trip.
"""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.frontend import stereo_triangulation as jst
from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerStereo, Stage)
from svo_pro_universal_tpu.frontend.pipeline_stereo import (
    DevicePipelineStereo as JaxStereo)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.frontend import stereo_triangulation as st
from svo_pro_universal_tpu_torch.frontend.pipeline_stereo import (
    DevicePipelineStereo)

from test_pipeline_mono import trajectory
from test_pipeline_stereo import T_BODY_CAM0, T_BODY_CAM1, stereo_pair
from torch_parity_utils import (assert_tree_equal, camera_dict,
                                new_own_landmarks, port_config, pose_gap,
                                rig_config, rotation_angle_deg, to_dict,
                                uint8_views, unaligned_ate)

N_FRAMES = 20                    # tests/test_device_pipeline_stereo.py


def _port_se3(T):
    return convert.se3(to_dict(T))


@pytest.fixture(scope="module")
def stereo_run():
    cfg = rig_config()
    gt = trajectory(N_FRAMES)
    pairs = [tuple(uint8_views(stereo_pair(T))) for T in gt]
    h = JaxStereo(cfg, CAM, CAM, T_BODY_CAM0, T_BODY_CAM1, trace_capacity=64)
    jworlds = []
    for t, (a, b) in enumerate(pairs):
        jworlds.append(h.world)
        h.add_image_pair(a, b, t * 0.05)
    jworlds.append(h.world)
    mats, meta = h.drain()
    return dict(cfg=cfg, gt=gt, pairs=pairs, jworlds=jworlds,
                worlds=[to_dict(w) for w in jworlds], mats=mats, meta=meta)


def _port(cfg, joint=False, device="cpu"):
    cam = convert.camera(camera_dict(CAM))
    return DevicePipelineStereo(port_config(cfg), cam, cam,
                                _port_se3(T_BODY_CAM0),
                                _port_se3(T_BODY_CAM1), trace_capacity=64,
                                joint_alignment=joint, device=device)


def test_stereo_run_covers_the_path(stereo_run):
    """The JAX run bootstraps on frame 0 and selects keyframes."""
    meta = stereo_run["meta"]
    assert (meta[:, 0] == Stage.TRACKING.value).all()
    assert meta[1:, 2].sum() >= 2


def test_triangulate_pair_matches_jax(stereo_run):
    """Both triangulations of the first pair's detections (the first
    keyframe's features, cam0's and cam1's pyramids of frame 0)."""
    jw = stereo_run["jworlds"][1]
    fr = jw.last_frame
    opts = jst.StereoTriangulationOptions(
        *st.options_from_config(port_config(stereo_run["cfg"])))
    T = T_BODY_CAM1.inverse().compose(T_BODY_CAM0)
    valid = fr.valid_mask()
    jm = jst.triangulate_pair(fr.pyramid, jw.pyr1_cur, CAM, CAM, T, fr.px,
                              fr.f, fr.grad, fr.level, fr.ftype, valid, opts)
    w = stereo_run["worlds"][1]
    f = convert.frame(w["last_frame"])
    cam = convert.camera(camera_dict(CAM))
    tm = st.triangulate_pair(f.pyramid, convert.tensor(w["pyr1_cur"]), cam,
                             cam, _port_se3(T), f.px, f.f, f.grad, f.level,
                             f.ftype, f.valid_mask(), st.options_from_config(
                                 port_config(stereo_run["cfg"])))
    js, ts_ = np.asarray(jm.success), tm.success.numpy()
    assert js.sum() >= 100
    assert abs(int(js.sum()) - int(ts_.sum())) <= 1
    both = js & ts_
    np.testing.assert_allclose(tm.px1.numpy()[both], np.asarray(jm.px1)[both],
                               atol=1e-3)
    front = both & (_signed_depth(f.f, cam, np.asarray(jm.px1),
                                  _port_se3(T)) > 0)
    assert both.sum() - front.sum() <= 2
    np.testing.assert_allclose(tm.depth0.numpy()[front],
                               np.asarray(jm.depth0)[front], rtol=1e-4)


def _signed_depth(f0, cam1, px1, T_c1_c0) -> np.ndarray:
    """Depth along cam0's bearings ``f0`` of the least-squares intersection
    with cam1's rays through ``px1``, in float64 (negative: behind)."""
    f1 = proj.backproject(cam1, torch.from_numpy(px1.copy())).numpy()
    R = T_c1_c0.as_matrix().numpy()[:3, :3].astype(np.float64)
    t = T_c1_c0.t.numpy().astype(np.float64)
    A = np.stack([f0.numpy().astype(np.float64) @ R.T,
                  -f1.astype(np.float64)], -1)
    return np.array([np.linalg.lstsq(a, -t, rcond=None)[0][0] for a in A])


def _pose_diff(Ta: np.ndarray, Tb: np.ndarray) -> tuple[float, float]:
    """(rotation rad, translation m) between two 4×4 poses."""
    return (np.radians(rotation_angle_deg(Ta[:3, :3], Tb[:3, :3])),
            float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])))


@pytest.mark.parametrize("k", [3, 8])
def test_joint_alignment_matches_jax_host(stereo_run, k):
    """Frame k's sparse alignment from the world before it: the port's
    with cam1 (joint_alignment) against the JAX host stereo handler's given
    cam1's pyramids; the port's without it against JAX's cam0-only."""
    cfg = stereo_run["cfg"]
    jw, jn = stereo_run["jworlds"][k], stereo_run["jworlds"][k + 1]
    jh = FrameHandlerStereo(cfg, CAM, CAM, T_BODY_CAM0, T_BODY_CAM1)
    jextra = dict(pyr_last=[jn.pyr1_prev], pyr_cur=[jn.pyr1_cur])
    cur = jn.last_frame.pyramid

    def jax_pose(extra):
        T, _ = jh._stage_align(jw.ring, jw.pool, jw.last_frame, cur,
                               jw.T_rel_prev, extra)
        return convert.se3(to_dict(T)).inverse().as_matrix().numpy()

    w, n = stereo_run["worlds"][k], stereo_run["worlds"][k + 1]
    tw = convert.world_stereo(w)
    textra = dict(pyr_last=[convert.tensor(n["pyr1_prev"])],
                  pyr_cur=[convert.tensor(n["pyr1_cur"])])
    tcur = convert.tensor(n["last_frame"]["pyramid"])

    def port_pose(joint):
        pipe = _port(cfg, joint=joint)
        T, _ = pipe._stage_align(tw.ring, tw.pool, tw.last_frame, tcur,
                                 tw.T_rel_prev, textra)
        return T.inverse().as_matrix().numpy()

    depth = float(np.asarray(jw.depth_state)[0])       # median depth
    joint_j, joint_t = jax_pose(jextra), port_pose(True)
    mono_j, mono_t = jax_pose(None), port_pose(False)
    rot, trans = _pose_diff(joint_t, joint_j)
    assert rot <= 1e-4 and trans <= 1e-4 * depth, (rot, trans)
    rot, trans = _pose_diff(mono_t, mono_j)
    assert rot <= 1e-4 and trans <= 1e-4 * depth, (rot, trans)
    # cam1 moves the solution: the flag reaches the alignment
    rot, trans = _pose_diff(joint_t, mono_t)
    assert rot > 1e-5 or trans > 1e-5, (rot, trans)


def test_stereo_stepwise_matches_jax(stereo_run):
    r = stereo_run
    worlds, meta = r["worlds"], r["meta"]
    pipe = _port(r["cfg"])
    checked = []
    for k, (a, b) in enumerate(r["pairs"]):
        pipe.world = convert.world_stereo(worlds[k])
        pipe._t_epoch = 0.0
        pipe.add_image_pair(a, b, k * 0.05)
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


def test_stereo_free_run(stereo_run):
    """The port alone over the whole sequence: the JAX test's gates, and
    the JAX run's stages."""
    r = stereo_run
    pipe = _port(r["cfg"])
    for t, (a, b) in enumerate(r["pairs"]):
        pipe.add_image_pair(a, b, t * 0.05)
    mats, meta = pipe.drain()
    stages = meta[:, 0].astype(int)
    start = int(np.argmax(stages == Stage.TRACKING.value))
    assert start <= 1 and (stages[start:] == Stage.TRACKING.value).all()
    np.testing.assert_array_equal(meta[:, 0], r["meta"][:, 0])
    gt_pos = np.stack([np.asarray(p.inverse().t) for p in r["gt"][start:]])
    ate, path = unaligned_ate(mats[start:], gt_pos)
    assert ate < 0.15 * max(path, 0.1), (ate, path)


def test_stereo_pipeline_defaults_to_the_card(monkeypatch, stereo_run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(stereo_run["cfg"], device=None)
    pipe = _port(stereo_run["cfg"])
    assert pipe.cam1.intrinsics.device.type == "cpu"
    assert pipe.world.pyr1_cur.device.type == "cpu"


def test_convert_round_trip_stereo(stereo_run):
    jw = stereo_run["worlds"][-1]
    back = convert.to_numpy(convert.world_stereo(jw))
    assert set(back) - {"rng"} == set(jw) - {"rng_key"}
    for key in set(jw) - {"rng_key"}:
        assert_tree_equal(back[key], jw[key])
