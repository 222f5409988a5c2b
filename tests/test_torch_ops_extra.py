"""The ops no pipeline reaches, the port against the JAX package on the CPU:
the occupancy grid, the GN/LM solvers, ``bilinear_with_gradient``,
``pyr_bilinear`` / ``pyr_nearest``, ``tile_bilinear_grad``, and
``edge_depth`` (``detect_edges``, ``refine_depth_photometric``), plus the
gates of tests/test_common.py and tests/test_edge_depth.py on the port.

Tolerances: integer outputs, masks and gathers exact; float32 elementwise
math in the same order 1e-5 absolute on values of order 255 (2e-6
relative: XLA fuses products differently); the edge map's response 1e-3
relative to its largest value (Scharr cascades and a 3×3 blur, ~20
float32 operations a pixel) with the chosen level equal on 99.9% of
pixels; the solvers and the depth refinement (iterated; a 2×2 solve by
LAPACK against XLA's) 1e-4 relative on the state, chi2 within 1e-4
relative or 1e-9 absolute (a noise-free fit ends at float32's rounding
floor, ~1e-14), the same iteration count; depths within 1e-4 m and the
same converged flags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.common import occupancy as jocc
from svo_pro_universal_tpu.ops import edge_depth as jed
from svo_pro_universal_tpu.ops import interp as jip
from svo_pro_universal_tpu.ops import tiles as jtl
from svo_pro_universal_tpu.ops.pyramid import build_pyramid as jbuild
from svo_pro_universal_tpu.testing import synthetic as jsyn
from svo_pro_universal_tpu.utils import solver as jsolver
from svo_pro_universal_tpu.utils.transform import se3_exp as jse3_exp
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.common import occupancy as tocc
from svo_pro_universal_tpu_torch.ops import edge_depth as ted
from svo_pro_universal_tpu_torch.ops import interp as tip
from svo_pro_universal_tpu_torch.ops import tiles as ttl
from svo_pro_universal_tpu_torch.ops.pyramid import build_pyramid as tbuild
from svo_pro_universal_tpu_torch.ops.pyramid import level_view
from svo_pro_universal_tpu_torch.utils import solver as tsolver
from svo_pro_universal_tpu_torch.utils.transform import SE3

from torch_parity_utils import camera_dict


def _t(x):
    return torch.from_numpy(np.array(x))


def _image(seed=3):
    """The textured plane's image, rounded to integers (as a camera's):
    both pyramids then agree to the bit."""
    return np.rint(np.asarray(jsyn.textured_image(seed=seed), np.float32))


# ---------------------------------------------------------------------------
# occupancy and solvers
# ---------------------------------------------------------------------------

def test_occupancy_matches_jax():
    rng = np.random.default_rng(0)
    px = rng.uniform(-15, 175, (300, 2)).astype(np.float32)
    mask = rng.uniform(size=300) < 0.6
    n_cols, n_rows = jocc.grid_dims(160, 120, 20)
    assert tocc.grid_dims(160, 120, 20) == (n_cols, n_rows)
    jg = jocc.set_occupied(jocc.make_grid(160, 120, 20), jnp.asarray(px),
                           jnp.asarray(mask), 20, n_cols)
    tg = tocc.set_occupied(tocc.make_grid(160, 120, 20), _t(px), _t(mask),
                           20, n_cols)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert np.array_equal(tocc.cell_index(_t(px), 20, n_cols).numpy(),
                          np.asarray(jocc.cell_index(jnp.asarray(px), 20,
                                                     n_cols)))
    assert np.array_equal(
        tocc.is_occupied(tg, _t(px), 20, n_cols).numpy(),
        np.asarray(jocc.is_occupied(jg, jnp.asarray(px), 20, n_cols)))
    # the gate of tests/test_common.py
    g = tocc.set_occupied(tocc.make_grid(100, 60, 20),
                          torch.tensor([[5.0, 5.0], [25.0, 5.0]]),
                          torch.tensor([True, True]), 20, 5)
    occ = tocc.is_occupied(g, torch.tensor([[5.0, 5.0], [25.0, 5.0]]), 20, 5)
    assert bool(occ[0]) and bool(occ[1])
    assert not bool(tocc.is_occupied(g, torch.tensor([[45.0, 5.0]]), 20,
                                     5)[0])


def _linear_problem():
    A = np.asarray([[2.0, 0.3], [0.1, 1.5], [0.5, 0.5]], np.float32)
    b = np.asarray([1.0, -2.0, 0.5], np.float32)
    return A, b


def _evaluate(lib, A, b):
    def evaluate(x):
        r = A @ x - b
        return A.T @ A, -A.T @ r, (r * r).sum()
    return evaluate


def test_gauss_newton_quadratic():
    """The gate of tests/test_common.py:95: GN solves a linear least
    squares in one step."""
    A, b = _linear_problem()
    res = tsolver.gauss_newton(_evaluate(torch, _t(A), _t(b)),
                               lambda x, dx: x + dx, torch.zeros(2),
                               max_iter=5)
    np.testing.assert_allclose(res.state.numpy(),
                               np.linalg.lstsq(A, b, rcond=None)[0],
                               atol=1e-5)


def _rosenbrock_like(lib):
    """A small nonlinear least squares: fit y = a·exp(b·x) (state [2]) to
    noise-free samples, so that chi2 falls on every accepted step and the
    stopping round is not decided by rounding at a flat minimum."""
    xs = np.linspace(0, 1, 12).astype(np.float32)
    ys = (2.0 * np.exp(-1.3 * xs)).astype(np.float32)
    X, Y = (_t(xs), _t(ys)) if lib is torch else (jnp.asarray(xs),
                                                  jnp.asarray(ys))
    ex = torch.exp if lib is torch else jnp.exp
    st = torch.stack if lib is torch else jnp.stack

    def evaluate(p):
        e = ex(p[1] * X)
        r = p[0] * e - Y
        J = st([e, p[0] * X * e], -1)
        return J.T @ J, -J.T @ r, (r * r).sum()
    return evaluate


@pytest.mark.parametrize("method", ["gauss_newton", "levenberg_marquardt"])
def test_solvers_match_jax(method):
    p0 = np.asarray([1.0, 0.0], np.float32)
    jr = getattr(jsolver, method)(_rosenbrock_like(jnp),
                                  lambda x, dx: x + dx, jnp.asarray(p0),
                                  max_iter=8)
    tr = getattr(tsolver, method)(_rosenbrock_like(torch),
                                  lambda x, dx: x + dx, _t(p0), max_iter=8)
    np.testing.assert_allclose(tr.state.numpy(), np.asarray(jr.state),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tr.chi2), float(jr.chi2), rtol=1e-4,
                               atol=1e-9)
    assert int(tr.n_iter) == int(jr.n_iter)
    assert bool(tr.converged) == bool(jr.converged)


def test_solver_with_a_named_tuple_state_and_a_singular_system():
    """A (named) tuple state is carried; a singular system gives a zero
    step, not an exception."""
    A, b = _linear_problem()
    ev = _evaluate(torch, _t(A), _t(b))
    res = tsolver.gauss_newton(lambda s: ev(s.t), lambda s, dx: SE3(
        s.q, s.t + dx), SE3(torch.ones(4), torch.zeros(2)), max_iter=3)
    assert torch.equal(res.state.q, torch.ones(4))
    dx = tsolver.solve_normal_eq(torch.zeros(3, 3), torch.ones(3))
    assert torch.isfinite(dx).all()


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def _uv(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-3, w + 2, n), rng.uniform(-3, h + 2, n)],
                    -1).astype(np.float32)


def test_bilinear_with_gradient_matches_jax():
    img = _image()
    uv = _uv(500, *img.shape)
    jv = jip.bilinear_with_gradient(jnp.asarray(img), jnp.asarray(uv))
    tv = tip.bilinear_with_gradient(_t(img), _t(uv))
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=2e-6)


def test_pyr_bilinear_and_nearest_match_jax():
    img = _image()
    jp = jbuild(jnp.asarray(img), 4)
    tp = tbuild(_t(img), 4)
    from svo_pro_universal_tpu.ops.pyramid import level_view as jlevel
    jfp = jip.FlatPyramid([jlevel(jp, lv) for lv in range(4)])
    tfp = tip.FlatPyramid([level_view(tp, lv) for lv in range(4)])
    assert torch.equal(tfp.flat, _t(jfp.flat))
    rng = np.random.default_rng(1)
    level = rng.integers(0, 4, 400)
    uv = _uv(400, 120, 160) / (1 << level)[:, None]
    jv, ji = jip.pyr_bilinear(jfp, jnp.asarray(level, jnp.int32),
                              jnp.asarray(uv, jnp.float32))
    tv, ti = tip.pyr_bilinear(tfp, _t(level), _t(uv.astype(np.float32)))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=2e-6)
    xi = rng.integers(-5, 170, 400)
    yi = rng.integers(-5, 130, 400)
    jv, ji = jip.pyr_nearest(jfp, jnp.asarray(level, jnp.int32),
                             jnp.asarray(xi, jnp.int32),
                             jnp.asarray(yi, jnp.int32))
    tv, ti = tip.pyr_nearest(tfp, _t(level), _t(xi), _t(yi))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_tile_bilinear_grad_matches_jax():
    img = _image()
    jp = jbuild(jnp.asarray(img), 3)
    tp = tbuild(_t(img), 3)
    rng = np.random.default_rng(2)
    n = 64
    level = rng.integers(0, 3, n)
    cyx = np.stack([rng.uniform(0, 120, n), rng.uniform(0, 160, n)], -1)
    cyx = (cyx / (1 << level)[:, None]).astype(np.float32)
    jtb = jtl.extract_tiles(jp, jnp.asarray(level, jnp.int32),
                            jnp.asarray(cyx), 24, 24)
    ttb = ttl.extract_tiles(tp, _t(level), _t(cyx), 24, 24)
    assert torch.equal(ttb.tiles, _t(jtb.tiles))
    off = rng.uniform(-14, 14, (n, 20, 2)).astype(np.float32)
    ys, xs = cyx[:, None, 0] + off[..., 0], cyx[:, None, 1] + off[..., 1]
    jo = jtl.tile_bilinear_grad(jtb, jnp.asarray(ys), jnp.asarray(xs))
    to = ttl.tile_bilinear_grad(ttb, _t(ys), _t(xs))
    assert np.array_equal(to[3].numpy(), np.asarray(jo[3]))
    assert to[3].numpy().mean() > 0.3
    for a, b in zip(to[:3], jo[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# edge depth
# ---------------------------------------------------------------------------

def _step_image(h=96, w=128, edge_col=64, lo=40.0, hi=200.0):
    img = np.full((h, w), lo, np.float32)
    img[:, edge_col:] = hi
    return img


@pytest.mark.parametrize("scene", ["textured", "step"])
def test_detect_edges_matches_jax(scene):
    img = _image() if scene == "textured" else _step_image()
    je = jed.detect_edges(jbuild(jnp.asarray(img), 4))
    te = ted.detect_edges(tbuild(_t(img), 4))
    jedge = np.asarray(je.edge)
    scale = np.abs(jedge).max()
    assert scale > 0
    same = te.level.numpy() == np.asarray(je.level)
    assert same.mean() >= 0.999, same.mean()
    err = np.abs(te.edge.numpy() - jedge)[same].max() / scale
    assert err <= 1e-3, err
    ang = np.abs(te.angle.numpy() - np.asarray(je.angle))[same]
    assert np.quantile(ang, 0.999) <= 1e-4


def test_detect_edges_gates():
    """tests/test_edge_depth.py's TestDetectEdges on the port."""
    out = ted.detect_edges(tbuild(_t(_step_image()), 4))
    resp = np.abs(out.edge.numpy())
    flat = np.concatenate([resp[8:-8, 8:48], resp[8:-8, 80:-8]], axis=1)
    assert resp[8:-8, 56:72].max() > 0.0 and flat.max() == 0.0
    strong = resp > 0.5 * resp.max()
    assert np.abs(np.cos(out.angle.numpy()[strong])).mean() > 0.9
    silent = ted.detect_edges(tbuild(torch.full((96, 128), 127.0), 4))
    assert float(silent.edge.abs().max()) == 0.0
    assert int(silent.level.max()) == 0
    lev = ted.detect_edges(tbuild(_t(_image()), 4)).level.numpy()
    assert lev.min() >= 0 and lev.max() <= 2


def _refine_setup(n=60, depth_err=0.12, seed=1):
    """tests/test_edge_depth.py's scene: a slanted textured plane seen from
    two poses, reference patches at level 0, depths off by ±12%."""
    rng = np.random.default_rng(seed)
    img_ref = jsyn.textured_image(seed=3)
    slope = (0.25, -0.15)
    T_cur_ref = jse3_exp(jnp.asarray([0.04, -0.02, 0.015, 0.004, -0.006,
                                      0.003]))
    img_cur = jsyn.render_plane_view(img_ref, T_cur_ref, slope=slope)
    uv = jnp.asarray(np.stack([rng.uniform(20, jsyn.W - 20, n),
                               rng.uniform(20, jsyn.H - 20, n)], -1),
                     jnp.float32)
    f_ref = jsyn.backproject(jsyn.CAM, uv)
    d_true = jsyn.plane_depth(f_ref, slope=slope)
    r = jnp.arange(jed.PATCH, dtype=jnp.float32) - (jed.HALF_PATCH - 0.5)
    ou, ov = jnp.meshgrid(r, r, indexing="xy")
    offs = jnp.stack([ou.ravel(), ov.ravel()], -1)
    ref_patch, _ = jip.bilinear(img_ref, (uv[:, None, :]
                                          + offs[None]).reshape(-1, 2))
    d0 = d_true * (1.0 + depth_err * jnp.asarray(rng.uniform(-1, 1, n),
                                                 jnp.float32))
    return dict(pyr=jbuild(img_cur, 4), T=T_cur_ref, f=f_ref,
                patch=ref_patch.reshape(n, -1), d0=d0, d_true=d_true)


def _port_refine(s, level, valid):
    cam = convert.camera(camera_dict(jsyn.CAM))
    T = SE3(_t(s["T"].q), _t(s["T"].t))
    return ted.refine_depth_photometric(
        _t(s["pyr"]), cam, T, _t(s["f"]), _t(s["patch"]), _t(s["d0"]),
        _t(level), _t(valid))


def test_refine_depth_photometric_matches_jax():
    s = _refine_setup()
    n = s["d0"].shape[0]
    level = np.zeros(n, np.int32)
    level[::3] = 1
    valid = np.ones(n, bool)
    valid[::11] = False
    jo = jed.refine_depth_photometric(s["pyr"], jsyn.CAM, s["T"], s["f"],
                                      s["patch"], s["d0"],
                                      jnp.asarray(level), jnp.asarray(valid))
    to = _port_refine(s, level.astype(np.int64), valid)
    assert np.array_equal(to.converged.numpy(), np.asarray(jo.converged))
    assert to.converged.numpy().mean() > 0.5
    np.testing.assert_allclose(to.depth.numpy(), np.asarray(jo.depth),
                               atol=1e-4)
    jc, tc = np.asarray(jo.cost), to.cost.numpy()
    fin = np.isfinite(jc)
    assert np.array_equal(np.isfinite(tc), fin)
    np.testing.assert_allclose(tc[fin], jc[fin], rtol=1e-3, atol=1e-3)


def test_refine_depth_gates():
    """tests/test_edge_depth.py's TestRefineDepthPhotometric on the port."""
    s = _refine_setup()
    n = s["d0"].shape[0]
    out = _port_refine(s, np.zeros(n, np.int64), np.ones(n, bool))
    conv = out.converged.numpy()
    assert conv.mean() > 0.7
    d0, dt = np.asarray(s["d0"]), np.asarray(s["d_true"])
    err0 = np.abs(d0 - dt)[conv]
    err1 = np.abs(out.depth.numpy() - dt)[conv]
    assert np.median(err1) < 0.25 * np.median(err0)
    assert np.median(err1) < 0.02
    s8 = _refine_setup(n=8)
    out8 = _port_refine(s8, np.zeros(8, np.int64), np.zeros(8, bool))
    assert not bool(out8.converged.any())
