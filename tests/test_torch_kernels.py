"""The port's three kernel modules against the JAX package, on the CPU.

- Tile gathers (kernels 1, 2): the port's plain versions are pure copies,
  so they must equal the JAX CPU path (exact ``dynamic_slice`` windows,
  same origins, ``lh``, ``lw``) and the Pallas kernels run in interpret
  mode at aligned origins — ``torch.equal``, no tolerance.
- Fused evaluate (kernel 3): the plain version against the Pallas kernel in
  interpret mode and against the unfused ``compute_residuals`` + einsum path
  of sparse alignment, at the tolerances of tests/test_pallas_align.py:51-54
  (H rtol 2e-5 / atol 1e-2, g rtol 2e-4 / atol 0.5, chi2 2e-4 relative, n
  exact): the same float32 arithmetic with sums taken in another order.
- Align level (kernel 4): its plain version, one pyramid level of the LM
  keep-best loop (``run`` with max_level = min_level), against the JAX
  ``run`` at that level, in each branch the kernel implements: the prior,
  alpha/beta, two cameras, the fisheye, omni and atan camera models.
  Rotation ≤ 1e-4 rad and translation ≤ 1e-4·depth (float32 solves from
  the same start), n_tracked equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.cameras import projections as jproj
from svo_pro_universal_tpu.cameras.projections import Camera as JaxCamera
from svo_pro_universal_tpu.ops import pallas_align, pallas_tiles
from svo_pro_universal_tpu.ops import sparse_img_align as jsia
from svo_pro_universal_tpu.ops import tiles as jtl
from svo_pro_universal_tpu.ops.pyramid import build_pyramid as jbuild
from svo_pro_universal_tpu.utils.transform import SE3 as JaxSE3
from svo_pro_universal_tpu.utils.transform import se3_exp as jse3_exp
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.ops import _cuda, cuda_align, cuda_tiles
from svo_pro_universal_tpu_torch.ops import sparse_img_align as tsia
from svo_pro_universal_tpu_torch.ops import tiles as ttl
from svo_pro_universal_tpu_torch.ops.pyramid import build_pyramid as tbuild
from svo_pro_universal_tpu_torch.testing import synthetic as syn

from torch_parity_utils import camera_dict  # noqa: F401  (sets threads)


def _t(a):
    return convert.tensor(np.asarray(a))


def _pyramid(rng, H=120, W=160, L=4):
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    jp = jbuild(jnp.asarray(img), L)
    tp = tbuild(torch.from_numpy(img), L)
    assert torch.equal(tp, _t(jp))
    return jp, tp


@pytest.mark.parametrize("R,T", [(12, 12), (24, 24), (40, 40)])
def test_extract_tiles_matches_jax_cpu_path(rng, R, T):
    jp, tp = _pyramid(rng)
    L, H, W = jp.shape
    n = 37
    lvl = rng.integers(0, L, n)
    # centers spread over (and past) each level's extent, to hit the clips
    cy = rng.uniform(-10, H + 10, n).astype(np.float32)
    cx = rng.uniform(-10, W + 10, n).astype(np.float32)
    cyx = np.stack([cy, cx], -1)
    jt = jtl.extract_tiles(jp, jnp.asarray(lvl, jnp.int32), jnp.asarray(cyx),
                           R, T)
    tt = ttl.extract_tiles(tp, _t(lvl), _t(cyx), R, T)
    for a, b in zip(tt, jt):
        assert torch.equal(a, _t(b))


@pytest.mark.parametrize("R,T", [(24, 24), (40, 40)])
def test_extract_tiles_ring_matches_jax_cpu_path(rng, R, T):
    pyrs = [_pyramid(rng) for _ in range(3)]
    jring = jnp.stack([p[0] for p in pyrs])
    tring = torch.stack([p[1] for p in pyrs])
    K, L, H, W = jring.shape
    n = 29
    kf = rng.integers(-1, K + 1, n)           # out-of-range slots clip
    lvl = rng.integers(0, L, n)
    cyx = np.stack([rng.uniform(0, H, n), rng.uniform(0, W, n)],
                   -1).astype(np.float32)
    jt = jtl.extract_tiles_ring(jring, jnp.asarray(kf, jnp.int32),
                                jnp.asarray(lvl, jnp.int32),
                                jnp.asarray(cyx), R, T)
    tt = ttl.extract_tiles_ring(tring, _t(kf), _t(lvl), _t(cyx), R, T)
    for a, b in zip(tt, jt):
        assert torch.equal(a, _t(b))


def _aligned(rng, n, H, W, L, RA, TA):
    lvl = rng.integers(0, L, n)
    y0 = rng.integers(0, (H - RA) // 8 + 1, n) * 8
    x0 = rng.integers(0, (W - TA) // 128 + 1, n) * 128
    return lvl, y0, x0


def test_gather_tiles_plain_matches_pallas_interpret(rng):
    jp, tp = _pyramid(rng, H=160, W=256, L=3)
    L, H, W = jp.shape
    lvl, y0, x0 = _aligned(rng, 13, H, W, L, 32, 128)
    out = pallas_tiles.gather_tiles(
        jp, jnp.asarray(lvl, jnp.int32), jnp.asarray(y0, jnp.int32),
        jnp.asarray(x0, jnp.int32), 32, 128, interpret=True)
    got = cuda_tiles.gather_tiles(tp, _t(lvl), _t(y0), _t(x0), 32, 128)
    assert torch.equal(got, _t(out))


def test_gather_tiles_ring_plain_matches_pallas_interpret(rng):
    pyrs = [_pyramid(rng, H=160, W=256, L=3) for _ in range(4)]
    jring = jnp.stack([p[0] for p in pyrs])
    tring = torch.stack([p[1] for p in pyrs])
    K, L, H, W = jring.shape
    kf = rng.integers(0, K, 8)
    lvl, y0, x0 = _aligned(rng, 8, H, W, L, 24, 128)
    out = pallas_tiles.gather_tiles_ring(
        jring, jnp.asarray(kf, jnp.int32), jnp.asarray(lvl, jnp.int32),
        jnp.asarray(y0, jnp.int32), jnp.asarray(x0, jnp.int32), 24, 128,
        interpret=True)
    got = cuda_tiles.gather_tiles_ring(tring, _t(kf), _t(lvl), _t(y0),
                                       _t(x0), 24, 128)
    assert torch.equal(got, _t(out))


def _assert_normal_system(got, want):
    H, g, chi2, nm = [np.asarray(x, np.float64) for x in got]
    H0, g0, chi20, nm0 = [np.asarray(x, np.float64) for x in want]
    np.testing.assert_allclose(H, H0, rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(g, g0, rtol=2e-4, atol=0.5)
    assert abs(chi2 - chi20) <= max(2e-4 * abs(chi20), 1.0)
    assert nm == nm0


@pytest.mark.parametrize("origins", ["fractional", "integer"])
def test_fused_evaluate_plain_matches_pallas_interpret(rng, origins):
    n, R, T, P = 13, 24, 24, 4            # 13: not a multiple of the block
    tiles = rng.uniform(0, 255, (n, R, T)).astype(np.float32)
    if origins == "fractional":
        ty = rng.uniform(0.0, R - P - 1.0, n).astype(np.float32)
        tx = rng.uniform(0.0, T - P - 1.0, n).astype(np.float32)
    else:   # the second bilinear tap lies at row R / column T, weight 0
        ty = np.full((n,), float(R - P), np.float32)
        tx = np.full((n,), float(T - P), np.float32)
    w = (rng.uniform(size=n) > 0.3).astype(np.float32)
    ref = rng.uniform(0, 255, (n, P * P)).astype(np.float32)
    jac = rng.normal(0, 1, (n, P * P, 8)).astype(np.float32)
    alpha, beta = 0.03, -1.5
    want = pallas_align.fused_evaluate(
        *[jnp.asarray(a) for a in (tiles, ty, tx, w, ref, jac)], alpha, beta,
        P, interpret=True)
    got = cuda_align.fused_evaluate(
        *[_t(a) for a in (tiles, ty, tx, w, ref, jac)],
        torch.tensor([alpha, beta]), P)
    _assert_normal_system(got, want)


def _align_inputs(rng):
    """A sparse-alignment problem: a textured pyramid pair, features with
    depth, and a perturbed relative pose — for both implementations."""
    H, W = 120, 160
    y, x = np.mgrid[0:H, 0:W]
    img = (120 + 40 * np.sin(x / 7.0) * np.cos(y / 5.0)
           + 30 * np.sin((x + y) / 11.0))
    img_cur = np.roll(img, (1, 2), axis=(0, 1))
    imgs = [np.clip(i, 0, 255).astype(np.uint8) for i in (img, img_cur)]
    n = 50
    px = np.stack([rng.uniform(12, W - 12, n), rng.uniform(12, H - 12, n)],
                  -1).astype(np.float32)
    fx = fy = 150.0
    f = np.stack([(px[:, 0] - W / 2) / fx, (px[:, 1] - H / 2) / fy,
                  np.ones(n)], -1)
    f = (f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(np.float32)
    depth = rng.uniform(1.8, 2.2, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    twist = np.array([0.01, -0.005, 0.003, 0.002, -0.001, 0.0015],
                     np.float32)
    jcam = JaxCamera.pinhole(fx, fy, W / 2, H / 2, W, H)
    T = jse3_exp(jnp.asarray(twist))
    jinp = jsia.CameraInput(
        jbuild(jnp.asarray(imgs[0]), 3), jbuild(jnp.asarray(imgs[1]), 3),
        jnp.asarray(px), jnp.asarray(f), jnp.asarray(depth),
        jnp.asarray(valid), T._replace(q=T.q * 0 + jnp.asarray(
            [1.0, 0, 0, 0]), t=T.t * 0), jcam)
    tinp = tsia.CameraInput(
        tbuild(torch.from_numpy(imgs[0]), 3),
        tbuild(torch.from_numpy(imgs[1]), 3), _t(px), _t(f), _t(depth),
        _t(valid), convert.se3({"q": np.array([1.0, 0, 0, 0]),
                                "t": np.zeros(3)}),
        convert.camera(camera_dict(jcam)))
    return jinp, tinp, T


def test_fused_evaluate_plain_matches_unfused_path(rng):
    """Kernel 3's plain version inside the port's evaluate vs the JAX
    compute_residuals + einsum evaluate (sparse_img_align.py:300-308)."""
    jinp, tinp, T = _align_inputs(rng)
    P, level = 4, 1
    xyz, J = jsia.precompute_base(jinp, False)
    ref_patch, jac, ok = jsia.precompute_level(jinp, level, P, J, False,
                                               False)
    tb = jsia.extract_cur_tiles(jinp, xyz, T, level)
    res, vis = jsia.compute_residuals(jinp, tb, xyz, ref_patch, T, 0.0, 0.0,
                                      level, P)
    w = (vis & ok & jinp.valid).astype(jnp.float32)[:, None]
    want = (jnp.einsum("npi,npj->ij", jac * w[..., None], jac),
            -jnp.einsum("npi,np->i", jac, res * w),
            jnp.sum(res * w * res), jnp.sum(w))

    txyz, tJ = tsia.precompute_base(tinp, False)
    tref, tjac, tok = tsia.precompute_level(tinp, level, P, tJ, False, False)
    Tt = convert.se3({"q": np.asarray(T.q), "t": np.asarray(T.t)})
    ttb = tsia.extract_cur_tiles(tinp, txyz, Tt, level)
    st = tsia.make_state(Tt)
    got = tsia.evaluate_camera(tinp, (txyz, tref, tjac, tok & tinp.valid,
                                      ttb), st, level, P)
    assert float(got[3]) > 20          # most features visible
    _assert_normal_system(got, want)


def test_sparse_img_align_run_matches_jax(rng):
    """The LM keep-best loop over levels 2..0: rotation ≤ 1e-4 rad and
    translation ≤ 1e-4·depth apart (float32 solves from the same start)."""
    jinp, tinp, _ = _align_inputs(rng)
    opts = dict(max_level=2, min_level=0, max_iter=10)
    jst, _ = jsia.run([jinp], jsia.make_state(),
                      jsia.SparseImgAlignOptions(**opts))
    tst, stats = tsia.run([tinp], tsia.make_state(),
                          tsia.SparseImgAlignOptions(**opts))
    assert int(stats.n_iter_total) > 3
    jT = jst.T_icur_iref
    q = tst.T_icur_iref.q.numpy()
    dq = abs(float(np.dot(q, np.asarray(jT.q))))
    assert 2 * np.arccos(min(dq, 1.0)) <= 1e-4
    assert np.linalg.norm(tst.T_icur_iref.t.numpy()
                          - np.asarray(jT.t)) <= 1e-4 * 2.2


def _camera_inputs(rng, jcam, twist_cam_body=None, seed=0, shift=(1, 2),
                   gain=1.0, offset=0.0, n=50):
    """One camera's sparse-alignment inputs for both implementations: a
    textured pyramid pair (the cur image shifted by ``shift`` px, then
    ``gain``·I + ``offset``), n features with bearings through ``jcam`` and
    depths in 1.8..2.2, and T_cam_body = exp(``twist_cam_body``)."""
    H, W = 120, 160
    y, x = np.mgrid[0:H, 0:W]
    p = 1.7 * seed
    img = (120 + 40 * np.sin(x / 7.0 + p) * np.cos(y / 5.0)
           + 30 * np.sin((x + y) / 11.0))
    img_cur = np.roll(img, shift, axis=(0, 1)) * gain + offset
    imgs = [np.clip(i, 0, 255).astype(np.uint8) for i in (img, img_cur)]
    px = np.stack([rng.uniform(12, W - 12, n), rng.uniform(12, H - 12, n)],
                  -1).astype(np.float32)
    f = np.asarray(jproj.backproject(jcam, jnp.asarray(px)), np.float32)
    depth = rng.uniform(1.8, 2.2, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    if twist_cam_body is None:
        q, t = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    else:
        Tcb = jse3_exp(jnp.asarray(twist_cam_body, jnp.float32))
        q, t = np.asarray(Tcb.q), np.asarray(Tcb.t)
    jinp = jsia.CameraInput(
        jbuild(jnp.asarray(imgs[0]), 3), jbuild(jnp.asarray(imgs[1]), 3),
        jnp.asarray(px), jnp.asarray(f), jnp.asarray(depth),
        jnp.asarray(valid), JaxSE3(jnp.asarray(q), jnp.asarray(t)), jcam)
    tinp = tsia.CameraInput(
        tbuild(torch.from_numpy(imgs[0]), 3),
        tbuild(torch.from_numpy(imgs[1]), 3), _t(px), _t(f), _t(depth),
        _t(valid), convert.se3({"q": q, "t": t}),
        convert.camera(camera_dict(jcam)))
    return jinp, tinp


def _pinhole():
    return JaxCamera.pinhole(150.0, 150.0, 80.0, 60.0, 160, 120)


def _assert_level_matches_jax(jinps, tinps, twist_prior=None, level=1,
                              **opts):
    """One level through both ``run``s from the identity: rotation ≤ 1e-4
    rad, translation ≤ 1e-4·depth (2.2), n_tracked equal."""
    o = dict(max_level=level, min_level=level, max_iter=10, **opts)
    jprior = tprior = None
    if twist_prior is not None:
        jprior = jse3_exp(jnp.asarray(twist_prior, jnp.float32))
        tprior = convert.se3({"q": np.asarray(jprior.q),
                              "t": np.asarray(jprior.t)})
    jst, jstats = jsia.run(jinps, jsia.make_state(),
                           jsia.SparseImgAlignOptions(**o), T_prior=jprior)
    tst, tstats = tsia.run(tinps, tsia.make_state(),
                           tsia.SparseImgAlignOptions(**o), T_prior=tprior)
    assert int(tstats.n_tracked) == int(jstats.n_tracked) > 20
    assert int(tstats.n_iter_total) >= 2
    assert syn.rotation_gap(tst.T_icur_iref.q,
                            np.asarray(jst.T_icur_iref.q)) <= 1e-4
    assert np.linalg.norm(tst.T_icur_iref.t.numpy()
                          - np.asarray(jst.T_icur_iref.t)) <= 1e-4 * 2.2
    return tst, jst


def test_align_level_plain_matches_jax_with_prior(rng):
    """(a) the prior on, T_prior away from the start."""
    jinp, tinp = _camera_inputs(rng, _pinhole())
    _assert_level_matches_jax(
        [jinp], [tinp], twist_prior=[0.004, -0.002, 0.001, 0.001, 0.0005,
                                     -0.001],
        prior_lambda_rot=0.1, prior_lambda_trans=0.05)


def test_align_level_plain_matches_jax_alpha_beta(rng):
    """(b) alpha and beta estimated, on a cur image with gain and offset."""
    jinp, tinp = _camera_inputs(rng, _pinhole(), gain=1.08, offset=-6.0)
    tst, jst = _assert_level_matches_jax([jinp], [tinp], estimate_alpha=True,
                                         estimate_beta=True)
    assert abs(float(tst.alpha) - float(jst.alpha)) <= 1e-3
    assert abs(float(tst.beta) - float(jst.beta)) <= 0.1


def test_align_level_plain_matches_jax_two_cameras(rng):
    """(c) two cameras with their own T_cam_body, images and features."""
    j0, t0 = _camera_inputs(rng, _pinhole())
    j1, t1 = _camera_inputs(rng, _pinhole(), seed=1, shift=(2, 1),
                            twist_cam_body=[0.1, 0.0, 0.0, 0.0, 0.05, 0.0])
    _assert_level_matches_jax([j0, j1], [t0, t1])


@pytest.mark.parametrize("model", ["fisheye_equidistant", "omni_radtan",
                                   "pinhole_atan"])
def test_align_level_plain_matches_jax_camera_models(rng, model):
    """(d) the other projection and distortion models of the kernel."""
    P, D = jproj.ProjectionModel, jproj.DistortionModel
    jcam = {
        "fisheye_equidistant": JaxCamera(
            P.FISHEYE_EQUIDISTANT, D.EQUIDISTANT, [110.0, 110.0, 80.0, 60.0],
            [0.02, -0.01, 0.003, -0.001], 160, 120),
        "omni_radtan": JaxCamera(
            P.OMNI, D.RADTAN, [260.0, 260.0, 80.0, 60.0],
            [-0.05, 0.01, 0.001, -0.001, 0.8], 160, 120),
        "pinhole_atan": JaxCamera.pinhole(
            150.0, 150.0, 80.0, 60.0, 160, 120, distortion=D.ATAN,
            dist_params=[0.9]),
    }[model]
    jinp, tinp = _camera_inputs(rng, jcam)
    _assert_level_matches_jax([jinp], [tinp])


def test_wrappers_reject_other_devices():
    x = torch.zeros((2, 8, 8), device="meta")
    idx = torch.zeros((1,), dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_tiles.gather_tiles(x, idx, idx, idx, 4, 4)


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: a kernel whose library cannot be built raises."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_libs", {})
    k = _cuda.Kernel("gather_tiles", "tiles.cu", "svo_gather_tiles", [],
                     "test")
    with pytest.raises(RuntimeError, match="nvcc"):
        k.launch()
    assert k.launches == 0
