"""The port's FivePoint initialization against the JAX package's, on the CPU.

- RANSAC (``frontend/initialization.py``) on the scenes of
  tests/test_init_reprojector.py:33-86, with the JAX run's own Gumbel noise
  injected (first held equal to ``jax.random.choice``'s banks): the chosen
  pose within 0.05° (rotation, and the direction of the unit translation),
  the inlier sets equal up to 2 features near the gate; depths within
  1e-3 relative where both call a feature an inlier.
- ``align_pyr_2d`` and the bidirectional ``_klt_track`` on two 160×120 views
  of the textured plane: positions within 1e-3 px where both converge, the
  ``ok`` masks equal up to 1 feature; the ``align2d`` / ``align1d`` oracles
  within 2e-3 px.
- ``DevicePipelineMono`` with FivePoint through FIRST_FRAME, INITIALIZING
  and into TRACKING on the sphere+plane scene of tests/test_pipeline_mono.py
  (a plane alone is degenerate for the 8-point essential matrix), stepwise
  from the JAX world before each frame (the JAX
  step's RANSAC noise injected): same stage and keyframe decision, n_tracked
  within ±2, position ≤ 1 mm, rotation ≤ 0.05°; and a free run from scratch
  over the same frames (the port drawing the JAX noise too): same stage
  sequence, positions within 5 mm; and a free run with an IMU handler on
  each side, whose gyro rotation prior seeds the tracking frames: the same.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.frontend import initialization as jinit
from svo_pro_universal_tpu.frontend.pipeline import (
    DevicePipelineMono as JaxPipeline)
from svo_pro_universal_tpu.ops import alignment as jalign
from svo_pro_universal_tpu.ops.pyramid import build_pyramid as jbuild
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu.utils.transform import SE3 as JSE3, se3_exp
from svo_pro_universal_tpu.utils.transform import quat_to_matrix as jq2m
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.frontend import initialization as tinit
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono, Stage)
from svo_pro_universal_tpu_torch.frontend.pipeline import DevicePipelineMono
from svo_pro_universal_tpu_torch.ops import alignment as talign
from svo_pro_universal_tpu_torch.ops.pyramid import build_pyramid as tbuild
from svo_pro_universal_tpu_torch.utils.transform import SE3, quat_to_matrix

from synthetic_utils import render_sphere_view
from test_pipeline_mono import make_config, trajectory
from torch_parity_utils import (camera_dict, port_config, rotation_angle_deg,
                                sequence, slice_config, to_dict)

ANGLE_TOL_DEG = 0.05


def jax_ransac_noise(key, n_hyp: int, n: int) -> np.ndarray:
    """The Gumbel noise ``ransac_relative_pose`` draws from ``key``: one
    row per hypothesis key."""
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (n,), jnp.float32))(keys))


def _scene(rng, twist, n=120, outliers=0):
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                    rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    f_ref = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    T = se3_exp(jnp.array(twist, jnp.float32))
    p_cur = np.asarray(T.apply(jnp.asarray(pts)))
    f_cur = p_cur / np.linalg.norm(p_cur, axis=-1, keepdims=True)
    if outliers:
        bad = rng.normal(size=(outliers, 3)).astype(np.float32)
        bad /= np.linalg.norm(bad, axis=-1, keepdims=True)
        bad[:, 2] = np.abs(bad[:, 2])
        f_cur[:outliers] = bad
    return f_ref.astype(np.float32), f_cur.astype(np.float32), T


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_same_result(jres, tres, n_near=2):
    Rj = np.asarray(jq2m(jres.T_cur_ref.q))
    Rt = quat_to_matrix(tres.T_cur_ref.q).numpy()
    assert rotation_angle_deg(Rj, Rt) <= ANGLE_TOL_DEG
    tj = np.asarray(jres.T_cur_ref.t, np.float64)
    tt = tres.T_cur_ref.t.numpy().astype(np.float64)
    cos = tj @ tt / (np.linalg.norm(tj) * np.linalg.norm(tt))
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= ANGLE_TOL_DEG
    ij, it = np.asarray(jres.inliers), tres.inliers.numpy()
    assert (ij != it).sum() <= n_near
    assert abs(int(jres.n_inliers) - int(tres.n_inliers)) <= n_near
    both = ij & it
    dj, dt = np.asarray(jres.depth_ref)[both], tres.depth_ref.numpy()[both]
    np.testing.assert_allclose(dt, dj, rtol=1e-3)


@pytest.mark.parametrize("case", ["clean", "outliers"])
def test_ransac_matches_jax_with_its_noise(case, rng):
    """8-point LO-RANSAC on test_init_reprojector's scenes (clean and 25
    outliers); the banks drawn from the injected noise equal
    ``jax.random.choice``'s."""
    twist, outl, seed = (([0.3, -0.1, 0.1, 0.02, -0.04, 0.03], 0, 0)
                         if case == "clean" else
                         ([0.2, 0.1, 0.0, 0.0, 0.02, -0.01], 25, 1))
    f_ref, f_cur, _ = _scene(rng, twist, outliers=outl)
    n = f_ref.shape[0]
    valid = np.ones(n, bool)
    valid[-7:] = False              # some p = 0 entries: -inf keys
    key = jax.random.PRNGKey(seed)
    noise = jax_ransac_noise(key, 128, n)
    # the banks of the JAX draw are the top-k of noise + log p
    p = valid.astype(np.float32) / valid.sum()
    keys = jax.random.split(key, 128)
    for h, size in ((0, 8), (63, 8), (64, 16), (127, 16)):
        want = np.asarray(jax.random.choice(keys[h], jnp.arange(n), (size,),
                                            replace=False, p=jnp.asarray(p)))
        got = tinit._top_indices(_t(noise[h]) + tinit._log_p(_t(valid)),
                                 size).numpy()
        np.testing.assert_array_equal(got, want)
    jres = jinit.ransac_relative_pose(
        jnp.asarray(f_ref), jnp.asarray(f_cur), jnp.asarray(valid), key,
        CAM.focal_length, reproj_thresh_px=2.0)
    tres = tinit.ransac_relative_pose(
        _t(f_ref), _t(f_cur), _t(valid), _t(noise),
        torch.tensor(float(CAM.focal_length)), reproj_thresh_px=2.0)
    _assert_same_result(jres, tres)
    if case == "outliers":
        assert tres.inliers.numpy()[25:n - 7].mean() > 0.9


def test_two_point_matches_jax_with_its_noise(rng):
    f_ref, f_cur, T = _scene(rng, [0.25, 0.05, -0.1, 0.01, 0.03, -0.02])
    n = f_ref.shape[0]
    valid = np.ones(n, bool)
    key = jax.random.PRNGKey(2)
    p = jnp.asarray(valid, jnp.float32) / n
    logits = jnp.log(jnp.maximum(p, 1e-12))[None, :].repeat(128, 0)
    # categorical draws argmax(gumbel(key, logits.shape) + logits)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    want = np.asarray(jax.random.categorical(key, logits))
    np.testing.assert_array_equal(np.argmax(noise + np.asarray(logits), -1),
                                  want)
    R = jq2m(T.q)
    jres = jinit.two_point_relative_pose(
        jnp.asarray(f_ref), jnp.asarray(f_cur), jnp.asarray(valid), R, key,
        CAM.focal_length)
    tres = tinit.two_point_relative_pose(
        _t(f_ref), _t(f_cur), _t(valid), _t(np.asarray(R)), _t(noise),
        torch.tensor(float(CAM.focal_length)))
    _assert_same_result(jres, tres)


def test_homography_matches_jax_with_its_noise(rng):
    """A planar scene (z = 3): the homography initializer."""
    n = 100
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                    np.full(n, 3.0)], -1).astype(np.float32)
    f_ref = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    T = se3_exp(jnp.array([0.2, -0.05, 0.05, 0.01, 0.02, -0.01]))
    p_cur = np.asarray(T.apply(jnp.asarray(pts)))
    f_cur = (p_cur / np.linalg.norm(p_cur, axis=-1, keepdims=True)
             ).astype(np.float32)
    valid = np.ones(n, bool)
    key = jax.random.PRNGKey(3)
    noise = jax_ransac_noise(key, 64, n)
    jres = jinit.homography_relative_pose(
        jnp.asarray(f_ref), jnp.asarray(f_cur), jnp.asarray(valid), key,
        CAM.focal_length)
    tres = tinit.homography_relative_pose(
        _t(f_ref), _t(f_cur), _t(valid), _t(noise),
        torch.tensor(float(CAM.focal_length)))
    _assert_same_result(jres, tres)


def test_rescale_and_disparity_match_jax():
    T = JSE3(jnp.array([1.0, 0, 0, 0]), jnp.array([1.0, 0.0, 0.0]))
    depths = np.array([1.0, 2.0, 3.0, 4.0, 100.0], np.float32)
    inl = np.array([True, True, True, True, False])
    T2, d2, s = jinit.rescale_to_mean_depth(T, jnp.asarray(depths),
                                            jnp.asarray(inl), 5.0)
    t2, e2, s2 = tinit.rescale_to_mean_depth(
        SE3(_t(np.asarray(T.q)), _t(np.asarray(T.t))), _t(depths), _t(inl),
        5.0)
    assert float(s2) == float(s) == 2.5
    np.testing.assert_array_equal(e2.numpy(), np.asarray(d2))
    np.testing.assert_array_equal(t2.t.numpy(), np.asarray(T2.t))
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    b = a + rng.normal(0, 5, (50, 2)).astype(np.float32)
    m = rng.uniform(size=50) > 0.3
    assert float(tinit.disparity(_t(a), _t(b), _t(m))) == float(
        jinit.disparity(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)))


# ---------------------------------------------------------------------------
# KLT
# ---------------------------------------------------------------------------

def _klt_views():
    imgs = sequence(6)
    return imgs[0], imgs[5]


def _grid(n_side=12, border=14):
    u = np.linspace(border, 160 - border, n_side)
    v = np.linspace(border, 120 - border, n_side)
    return np.stack(np.meshgrid(u, v), -1).reshape(-1, 2).astype(np.float32)


def test_align_pyr_2d_matches_jax():
    a, b = _klt_views()
    px = _grid()
    valid = np.ones(px.shape[0], bool)
    valid[::9] = False
    init = px + np.float32(1.5)
    jp = [jbuild(jnp.asarray(x, jnp.float32), 5) for x in (a, b)]
    tp = [tbuild(_t(x.astype(np.float32)), 5) for x in (a, b)]
    jr = jalign.align_pyr_2d(jp[0], jp[1], jnp.asarray(px), jnp.asarray(init),
                             max_level=4, valid=jnp.asarray(valid))
    tr = talign.align_pyr_2d(tp[0], tp[1], _t(px), _t(init), max_level=4,
                             valid=_t(valid))
    cj, ct = np.asarray(jr.converged), tr.converged.numpy()
    assert (cj != ct).sum() <= 1
    both = cj & ct
    assert both.sum() > 100
    np.testing.assert_allclose(tr.px.numpy()[both], np.asarray(jr.px)[both],
                               atol=1e-3)


@pytest.mark.parametrize("mode", ["align2d", "align1d"])
def test_align_oracles_match_jax(mode):
    """The explicit-image oracles: align2d (offset estimated) and align1d
    along a per-feature direction, from templates of view 0 and guesses
    1.5 px off in view 5: positions within 2e-3 px where both converge
    (10 GN steps of float32 sums in another order; the offset is
    estimated), convergence masks equal up to 1."""
    a, b = _klt_views()
    px = _grid(n_side=8, border=20)
    n = px.shape[0]
    ja = jnp.asarray(a, jnp.float32)
    border, ok = jalign.extract_patch_with_border(ja, jnp.asarray(px), 8)
    patch, dx, dy = jalign.patch_with_border_to_inner(border, 8)
    tpatch, tdx, tdy = talign.patch_with_border_to_inner(
        _t(np.asarray(border)), 8)
    for x, y in ((tpatch, patch), (tdx, dx), (tdy, dy)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    init = (px + np.float32(1.5)).astype(np.float32)
    jb, tb = jnp.asarray(b, jnp.float32), _t(b.astype(np.float32))
    valid = np.asarray(ok)
    args_j = (patch, dx, dy, jnp.asarray(init))
    args_t = (tpatch, tdx, tdy, _t(init))
    if mode == "align2d":
        jr = jalign.align2d(jb, *args_j, valid=jnp.asarray(valid))
        tr = talign.align2d(tb, *args_t, valid=_t(valid))
    else:
        ang = np.linspace(0, np.pi, n, dtype=np.float32)
        d = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
        jr = jalign.align1d(jb, jnp.asarray(d), *args_j,
                            valid=jnp.asarray(valid))
        tr = talign.align1d(tb, _t(d), *args_t, valid=_t(valid))
    cj, ct = np.asarray(jr.converged), tr.converged.numpy()
    assert (cj != ct).sum() <= 1
    both = cj & ct
    assert both.sum() > n // 2
    np.testing.assert_allclose(tr.px.numpy()[both], np.asarray(jr.px)[both],
                               atol=2e-3)


def test_klt_track_matches_jax():
    """The forward/backward KLT of the init branch with its 1 px
    round-trip check, at the slice config's levels and patch size."""
    a, b = _klt_views()
    cfg = slice_config()
    cfg.init.init_method = "FivePoint"
    px = _grid()
    valid = np.ones(px.shape[0], bool)
    init = px + np.float32(0.7)
    jh = JaxPipeline(cfg, CAM)
    th = FrameHandlerMono(port_config(cfg), convert.camera(camera_dict(CAM)),
                          device="cpu")
    nl = jh.n_levels
    jref = jh.world.init_ref._replace(pyramid=jbuild(jnp.asarray(
        a, jnp.float32), nl))
    jpx, jok = jh._klt_track(jref, jbuild(jnp.asarray(b, jnp.float32), nl),
                             jnp.asarray(px), jnp.asarray(valid),
                             jnp.asarray(init))
    tref = SimpleNamespace(pyramid=tbuild(_t(a.astype(np.float32)), nl))
    tpx, tok = th._klt_track(tref, tbuild(_t(b.astype(np.float32)), nl),
                             _t(px), _t(valid), _t(init))
    oj, ot = np.asarray(jok), tok.numpy()
    assert (oj != ot).sum() <= 1
    both = oj & ot
    assert both.sum() > 30
    np.testing.assert_allclose(tpx.numpy()[both], np.asarray(jpx)[both],
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the FivePoint pipeline
# ---------------------------------------------------------------------------

N_FRAMES = 10       # first frame, 5 initializing, TRACKING from frame 6


def sphere_sequence(n: int) -> list:
    """uint8 views of the sphere+plane scene along the trajectory of
    tests/test_pipeline_mono.py (a plane alone leaves the 8-point
    essential matrix degenerate)."""
    return [np.clip(np.rint(np.asarray(render_sphere_view(T))), 0,
                    255).astype(np.uint8) for T in trajectory(n)]


def init_noise_of(world_dict, n: int) -> np.ndarray:
    """The Gumbel noise the JAX ``_branch_init`` hands to RANSAC from the
    world's PRNG key (key, k = split(rng_key); RANSAC splits k)."""
    _, k = jax.random.split(jnp.asarray(world_dict["rng_key"]))
    return jax_ransac_noise(k, 128, n)


def _fivepoint_jax_run(imgs):
    cfg = make_config()           # FivePoint, the config's default
    h = JaxPipeline(cfg, CAM, trace_capacity=64)
    worlds = []
    for t, img in enumerate(imgs):
        worlds.append(to_dict(h.world))
        h.add_image(img, t * 0.05)
    mats, meta = h.drain()
    return cfg, worlds, mats, meta


@pytest.fixture(scope="module")
def fivepoint_run():
    imgs = sphere_sequence(N_FRAMES)
    return (imgs,) + _fivepoint_jax_run(imgs)


class _JaxNoise:
    """Feeds the port's init branch the noise of the JAX world."""

    def __init__(self, pipe, noise_for_frame):
        self.noise_for_frame = noise_for_frame
        self.frame = 0
        pipe._init_noise = self

    def __call__(self, world, n_hyp, n):
        return torch.from_numpy(self.noise_for_frame(self.frame))


def _port(cfg):
    return DevicePipelineMono(port_config(cfg),
                              convert.camera(camera_dict(CAM)),
                              trace_capacity=64, device="cpu")


def test_fivepoint_stepwise_matches_jax(fivepoint_run):
    imgs, cfg, worlds, mats, meta = fivepoint_run
    stages = meta[:, 0].astype(int).tolist()
    assert Stage.INITIALIZING.value in stages
    assert stages[-1] == Stage.TRACKING.value
    port = _port(cfg)
    noise = _JaxNoise(port, lambda k: init_noise_of(worlds[k],
                                                    port.max_fts))
    for k in range(len(imgs)):
        noise.frame = k
        world = convert.world(worlds[k], "cpu")
        world, n_tracked, is_kf = port.step(world, imgs[k], k * 0.05)
        assert world.stage == int(meta[k, 0]), k
        assert is_kf == bool(meta[k, 2]), k
        assert abs(n_tracked - int(meta[k, 1])) <= 2, (k, n_tracked,
                                                       meta[k, 1])
        T = world.last_frame.T_world_cam.as_matrix().numpy()
        assert np.linalg.norm(T[:3, 3] - mats[k, :3, 3]) <= 1e-3, k
        assert rotation_angle_deg(T[:3, :3], mats[k, :3, :3]) <= 0.05, k


def _mono_twist(t: float) -> np.ndarray:
    """tests/test_pipeline_mono.py's trajectory as a twist of frame time."""
    return np.array([0.025 * t, 0.012 * np.sin(t * 0.3), 0.004 * t,
                     0.002 * np.sin(t * 0.2), 0.003 * t * 0.1, 0.001 * t],
                    np.float32)


def test_fivepoint_with_gyro_prior_matches_jax(fivepoint_run):
    """Both pipelines given an IMU handler fed a 200 Hz stream consistent
    with the trajectory: the tracking frames start from the gyro rotation
    prior (JAX pipeline.py:430-440). Same stages, positions within 5 mm."""
    from svo_pro_universal_tpu.frontend.imu_handler import ImuHandler as JImu
    from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
    from svo_pro_universal_tpu_torch.testing import synthetic as tsyn
    imgs, cfg, worlds, _, _ = fivepoint_run
    stream = tsyn.bench_imu_stream(_mono_twist, len(imgs))
    jimu, timu = JImu(), ImuHandler()
    jh = JaxPipeline(cfg, CAM, imu_handler=jimu, trace_capacity=64)
    port = DevicePipelineMono(port_config(cfg),
                              convert.camera(camera_dict(CAM)),
                              imu_handler=timu, trace_capacity=64,
                              device="cpu")
    jworlds = []
    noise = _JaxNoise(port, lambda k: init_noise_of(jworlds[k],
                                                    port.max_fts))
    i = 0
    for t, img in enumerate(imgs):
        while i < len(stream) and stream[i][0] <= t * 0.05:
            jimu.add_measurement(*stream[i])
            timu.add_measurement(*stream[i])
            i += 1
        jworlds.append(to_dict(jh.world))
        jh.add_image(img, t * 0.05)
        noise.frame = t
        port.add_image(img, t * 0.05)
    mats, meta = jh.drain()
    pmats, pmeta = port.drain()
    np.testing.assert_array_equal(pmeta[:, 0], meta[:, 0])
    assert (meta[:, 0] == Stage.TRACKING.value).sum() >= 3
    gap = np.linalg.norm(pmats[:, :3, 3] - mats[:, :3, 3], axis=-1)
    assert gap.max() <= 5e-3, gap


def test_fivepoint_free_run_matches_jax(fivepoint_run):
    imgs, cfg, worlds, mats, meta = fivepoint_run
    port = _port(cfg)
    noise = _JaxNoise(port, lambda k: init_noise_of(worlds[k],
                                                    port.max_fts))
    for t, img in enumerate(imgs):
        noise.frame = t
        port.add_image(img, t * 0.05)
    pmats, pmeta = port.drain()
    np.testing.assert_array_equal(pmeta[:, 0], meta[:, 0])
    gap = np.linalg.norm(pmats[:, :3, 3] - mats[:, :3, 3], axis=-1)
    assert gap.max() <= 5e-3, gap
