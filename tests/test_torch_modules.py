"""The port's modules against their JAX counterparts, on the CPU.

Small functions get seeded random inputs; the stages of the tracking step
(alignment, reprojection + direct matching, pose, structure, depth filter
with the epipolar matcher, detection, keyframe step) get the world state of
a short JAX run — the JAX world is converted into the port and both run the
same stage on the same frame. Tolerances:

- pure copies, masks, integer outputs and the detector (integer-valued
  images, exact arithmetic): exact;
- float32 elementwise math in the same order: ~1e-6 relative;
- GN solves and matches (sums in another order, iterated): stated per test,
  with at most 2 features allowed to flip on a near-tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.cameras import projections as jproj
from svo_pro_universal_tpu.common.frame import make_empty_frame as jempty
from svo_pro_universal_tpu.frontend.map import overlap_mask as joverlap
from svo_pro_universal_tpu.frontend.pipeline import (
    DevicePipelineMono as JaxPipeline)
from svo_pro_universal_tpu.ops import detector as jdet
from svo_pro_universal_tpu.ops import tiles as jtl
from svo_pro_universal_tpu.ops.pyramid import build_pyramid as jbuild
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu.utils import robust as jrobust
from svo_pro_universal_tpu.utils import transform as jtf
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.cameras import projections as tproj
from svo_pro_universal_tpu_torch.common.frame import make_empty_frame as tempty
from svo_pro_universal_tpu_torch.frontend.map import overlap_mask as toverlap
from svo_pro_universal_tpu_torch.frontend.pipeline import DevicePipelineMono
from svo_pro_universal_tpu_torch.ops import detector as tdet
from svo_pro_universal_tpu_torch.ops import tiles as ttl
from svo_pro_universal_tpu_torch.ops.pyramid import build_pyramid as tbuild
from svo_pro_universal_tpu_torch.utils import robust as trobust
from svo_pro_universal_tpu_torch.utils import transform as ttf

from torch_parity_utils import (camera_dict, port_config, rotation_angle_deg,
                                sequence, slice_config, to_dict)


def _t(a):
    return convert.tensor(np.asarray(a))


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


# ---------------------------------------------------------------------------
# small functions, seeded random inputs
# ---------------------------------------------------------------------------

def test_transform_matches_jax(rng):
    tw = rng.normal(0, 0.3, (64, 6)).astype(np.float32)
    tw[:4, 3:] *= 1e-5                        # small-angle branches
    x = rng.normal(0, 2, (64, 3)).astype(np.float32)
    jT, tT = jtf.se3_exp(jnp.asarray(tw)), ttf.se3_exp(_t(tw))
    _close(tT.q, jT.q, atol=1e-6)
    _close(tT.t, jT.t, atol=1e-6)
    _close(tT.apply(_t(x)), jT.apply(jnp.asarray(x)), atol=1e-5)
    _close(ttf.se3_log(tT), jtf.se3_log(jT), atol=2e-5)
    jI = jT.inverse()
    jC = jT.compose(jtf.SE3(jI.q[::-1], jI.t[::-1]))
    tI = tT.inverse()
    tC = tT.compose(ttf.SE3(torch.flip(tI.q, [0]), torch.flip(tI.t, [0])))
    _close(tC.q, jC.q, atol=1e-6)
    _close(tC.t, jC.t, atol=1e-5)
    _close(tT.as_matrix(), jT.as_matrix(), atol=1e-6)
    _close(ttf.matrix_to_quat(tT.as_matrix()[:, :3, :3]),
           jtf.matrix_to_quat(jT.as_matrix()[:, :3, :3]), atol=1e-6)


def test_robust_matches_jax(rng):
    x = rng.normal(0, 3, 101).astype(np.float32)
    for frac in (0.0, 0.3, 1.0):
        m = rng.uniform(size=101) >= frac
        assert float(trobust.masked_median(_t(x), _t(m))) == float(
            jrobust.masked_median(jnp.asarray(x), jnp.asarray(m)))
        assert float(trobust.mad_scale(_t(x), _t(m))) == float(
            jrobust.mad_scale(jnp.asarray(x), jnp.asarray(m)))
    _close(trobust.tukey_weight(_t(x)), jrobust.tukey_weight(jnp.asarray(x)),
           atol=1e-7)
    _close(trobust.tukey_rho(_t(x)), jrobust.tukey_rho(jnp.asarray(x)),
           rtol=1e-6)


@pytest.mark.parametrize("distortion", ["none", "radtan"])
def test_projections_match_jax(rng, distortion):
    if distortion == "none":
        jcam = jproj.Camera.pinhole(450.0, 455.0, 370.0, 245.0, 752, 480)
    else:
        jcam = jproj.Camera.pinhole(
            450.0, 455.0, 370.0, 245.0, 752, 480,
            distortion=jproj.DistortionModel.RADTAN,
            dist_params=(-0.28, 0.07, 2e-4, 1.8e-5))
    tcam = convert.camera(camera_dict(jcam))
    xyz = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-0.7, 0.7, 200),
                    rng.uniform(0.5, 4, 200)], -1).astype(np.float32)
    juv, jok = jproj.project(jcam, jnp.asarray(xyz))
    tuv, tok = tproj.project(tcam, _t(xyz))
    _close(tuv, juv, rtol=1e-6, atol=1e-4)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    _close(tproj.backproject(tcam, tuv), jproj.backproject(jcam, juv),
           atol=1e-6)
    _close(tproj.pinhole_unit_plane_jacobian(_t(xyz)),
           jproj.pinhole_unit_plane_jacobian(jnp.asarray(xyz)), rtol=1e-6)
    _close(tcam.focal_length, jcam.focal_length)


def test_tile_helpers_match_jax(rng):
    img = rng.integers(0, 256, (120, 160)).astype(np.uint8)
    jp, tp = jbuild(jnp.asarray(img), 4), tbuild(torch.from_numpy(img), 4)
    assert torch.equal(tp, _t(jp))
    n = 31
    lvl = rng.integers(0, 3, n)
    cyx = np.stack([rng.uniform(5, 55, n), rng.uniform(5, 75, n)],
                   -1).astype(np.float32)
    jt = jtl.extract_tiles(jp, jnp.asarray(lvl, jnp.int32), jnp.asarray(cyx),
                           24, 24)
    tt = ttl.extract_tiles(tp, _t(lvl), _t(cyx), 24, 24)
    ys = cyx[:, :1] + rng.uniform(-12, 12, (n, 20)).astype(np.float32)
    xs = cyx[:, 1:] + rng.uniform(-12, 12, (n, 20)).astype(np.float32)
    jv, jin = jtl.tile_bilinear(jt, jnp.asarray(ys), jnp.asarray(xs))
    tv, tin = ttl.tile_bilinear(tt, _t(ys), _t(xs))
    assert np.array_equal(tin.numpy(), np.asarray(jin))
    _close(tv, jv, rtol=1e-6, atol=1e-4)
    ref = rng.uniform(0, 255, (n, 64)).astype(np.float32)
    js, jok = jtl.zmssd_score_map(jt, jnp.asarray(ref), 8)
    ts, tok = ttl.zmssd_score_map(tt, _t(ref), 8)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    # sums of ~64 products of values ≤ 255: float32 order differences
    _close(ts, js, rtol=1e-4, atol=1.0)
    A = rng.normal(0, 1, (n, 6, 6)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    g = rng.normal(0, 1, (n, 6)).astype(np.float32)
    _close(ttl.solve_psd_small(_t(H), _t(g)),
           jtl.solve_psd_small(jnp.asarray(H), jnp.asarray(g)), rtol=1e-5,
           atol=1e-6)


def test_detector_matches_jax():
    img = sequence(1)[0]
    jp, tp = jbuild(jnp.asarray(img), 4), tbuild(torch.from_numpy(img), 4)
    occ = np.zeros(16 * 12, bool)
    occ[::7] = True
    kw = dict(cell_size=10, n_cols=16, n_rows=12, max_features=256,
              threshold_primary=5.0, max_level=3)
    jd = jdet.detect_features(jp, jnp.asarray(occ), **kw)
    td = tdet.detect_features(tp, _t(occ), **kw)
    assert int(td.valid.sum()) > 100
    for name in ("px", "level", "ftype", "valid"):
        assert np.array_equal(getattr(td, name).numpy(),
                              np.asarray(getattr(jd, name))), name
    _close(td.score, jd.score, rtol=1e-6)
    _close(td.grad, jd.grad, atol=1e-6)
    # every detector type is ported (tests/test_torch_detectors.py holds
    # each against JAX); an unknown name raises
    with pytest.raises(ValueError, match="unknown detector_type"):
        tdet.detect_features(tp, _t(occ), detector_type="harris", **kw)


# ---------------------------------------------------------------------------
# stages of the tracking step, from the world of a short JAX run
# ---------------------------------------------------------------------------

N_WORLD = 8    # frames 0..7: OneShot start, then a keyframe with seeds


@pytest.fixture(scope="module")
def stage_inputs():
    imgs = sequence(N_WORLD + 1)
    cfg = slice_config()
    jh = JaxPipeline(cfg, CAM, trace_capacity=16)
    for t in range(N_WORLD):
        jh.add_image(imgs[t], t * 0.05)
    th = DevicePipelineMono(port_config(cfg), convert.camera(
        camera_dict(CAM)), trace_capacity=16, device="cpu")
    jw = jh.world
    tw = convert.world(to_dict(jw), "cpu")
    img = imgs[N_WORLD]
    jcur = jempty(jbuild(jnp.asarray(img, jnp.float32), jh.n_levels),
                  jh.max_fts, T_cam_body=jh.T_cam_body,
                  timestamp=N_WORLD * 0.05)
    tcur = tempty(tbuild(torch.from_numpy(img), th.n_levels), th.max_fts,
                  timestamp=N_WORLD * 0.05)
    return jh, th, jw, tw, jcur, tcur


def _frame(jframe):
    return convert.frame(to_dict(jframe), "cpu")


def _assert_pose_close(T_port, T_jax, depth=2.0, trans=1e-4, rot_rad=1e-4):
    Tp = T_port.as_matrix().numpy()
    Tj = np.asarray(T_jax.as_matrix())
    assert np.linalg.norm(Tp[:3, 3] - Tj[:3, 3]) <= trans * depth
    assert np.radians(rotation_angle_deg(Tp[:3, :3], Tj[:3, :3])) <= rot_rad


def _at_most_flips(a, b, n=2):
    assert int(np.sum(np.asarray(a) != np.asarray(b))) <= n


def test_world_has_keyframe_and_seeds(stage_inputs):
    _, _, jw, tw, _, _ = stage_inputs
    assert int(tw.ring.valid.sum()) == 2
    assert int((tw.ring.frames.ftype < 3).sum()) > 20   # live seeds


def test_stage_align_matches_jax(stage_inputs):
    jh, th, jw, tw, jcur, tcur = stage_inputs
    jT, jst = jh._stage_align(jw.ring, jw.pool, jw.last_frame, jcur.pyramid,
                              jw.T_rel_prev)
    tT, tst = th._stage_align(tw.ring, tw.pool, tw.last_frame, tcur.pyramid,
                              tw.T_rel_prev)
    _assert_pose_close(tT, jT)
    assert int(tst.n_tracked) == int(jst.n_tracked)


def test_stage_reproject_matches_jax(stage_inputs):
    """Reprojection with per-cell winners, stable compaction and direct
    matching (find_matches_direct, ring tiles): same candidates, matches
    within 1e-3 px."""
    jh, th, jw, tw, jcur, tcur = stage_inputs
    T = jw.last_frame.T_cam_world
    jov = joverlap(jw.ring, T, 5)
    tT = convert.se3(to_dict(T))
    tov = toverlap(tw.ring, tT, 5)
    assert np.array_equal(tov.numpy(), np.asarray(jov))
    jf, jrep = jh._stage_reproject(jw.ring, jw.pool, jcur, T, jov)
    tf, trep = th._stage_reproject(tw.ring, tw.pool, tcur, tT, tov)
    assert int(trep.n_trials) == int(jrep.n_trials)
    assert abs(int(trep.n_matches) - int(jrep.n_matches)) <= 2
    _at_most_flips(tf.landmark_id.numpy(), jf.landmark_id)
    _at_most_flips(tf.ftype.numpy(), jf.ftype)
    both = (tf.valid_mask().numpy() & np.asarray(jf.valid_mask())
            & (tf.landmark_id.numpy() == np.asarray(jf.landmark_id)))
    _close(tf.px.numpy()[both], np.asarray(jf.px)[both], atol=1e-3)


def test_stage_pose_and_structure_match_jax(stage_inputs):
    jh, th, jw, tw, jcur, _ = stage_inputs
    T = jw.last_frame.T_cam_world
    jov = joverlap(jw.ring, T, 5)
    jf, _ = jh._stage_reproject(jw.ring, jw.pool, jcur, T, jov)
    jf2, jpo, _, _ = jh._stage_pose(jw.ring, jw.pool, jf)
    tf2, tpo, _, _ = th._stage_pose(tw.ring, tw.pool, _frame(jf))
    _assert_pose_close(tf2.T_cam_world, jf2.T_cam_world)
    _at_most_flips(tf2.ftype.numpy(), jf2.ftype)
    jpool = jh._stage_structure(jw.ring, jw.pool, jf2)
    tpool = th._stage_structure(tw.ring, tw.pool, _frame(jf2))
    _close(tpool.pos.numpy(), np.asarray(jpool.pos), atol=2e-4)
    assert np.array_equal(tpool.last_structure_optim.numpy(),
                          np.asarray(jpool.last_structure_optim))


def test_stage_seeds_match_jax(stage_inputs):
    """Depth-filter update (epipolar ZMSSD scan, subpixel alignment,
    Vogiatzis update) of the ring's seeds."""
    jh, th, jw, tw, jcur, tcur = stage_inputs
    T = jw.last_frame.T_cam_world
    jov = joverlap(jw.ring, T, 5)
    jring, jupd = jh._stage_seeds(jw.ring, jcur.pyramid, T, jw.depth_state,
                                  jov)
    tring, tupd = th._stage_seeds(tw.ring, tcur.pyramid,
                                  convert.se3(to_dict(T)), tw.depth_state,
                                  _t(jov))
    assert int(jupd.n_updated) > 10
    assert abs(int(tupd.n_updated) - int(jupd.n_updated)) <= 2
    jft = np.asarray(jring.frames.ftype)
    tft = tring.frames.ftype.numpy()
    _at_most_flips(tft, jft)
    same = tft == jft
    _close(tring.frames.seed_state.numpy()[same],
           np.asarray(jring.frames.seed_state)[same], rtol=1e-3, atol=1e-5)


def test_keyframe_step_matches_jax(stage_inputs):
    """Seed upgrade, eviction slot, detection into free slots, insert."""
    jh, th, jw, tw, jcur, _ = stage_inputs
    T = jw.last_frame.T_cam_world
    jov = joverlap(jw.ring, T, 5)
    jf, _ = jh._stage_reproject(jw.ring, jw.pool, jcur, T, jov)
    jring, jpool, jkf, jup, jnew = jh._keyframe_step(
        jw.ring, jw.pool, jf, None, jw.depth_state)
    tring, tpool, tkf, tup, tnew = th._keyframe_step(
        convert.ring(to_dict(jw.ring)), convert.pool(to_dict(jw.pool)),
        _frame(jf), tw.depth_state)
    assert int(tup) == int(jup) and int(tnew) == int(jnew)
    for name in ("px", "level", "ftype", "landmark_id", "seed_ref_kf"):
        assert np.array_equal(getattr(tkf, name).numpy(),
                              np.asarray(getattr(jkf, name))), name
    _close(tkf.seed_state.numpy(), np.asarray(jkf.seed_state), rtol=1e-6)
    assert np.array_equal(tring.valid.numpy(), np.asarray(jring.valid))
    assert int(tring.last_added) == int(jring.last_added)
    for name in ("obs_kf", "obs_idx", "n_obs", "ids"):
        assert np.array_equal(getattr(tpool, name).numpy(),
                              np.asarray(getattr(jpool, name))), name
