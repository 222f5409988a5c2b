"""The last small JAX functions that no pipeline reaches, each against the
port's copy on seeded inputs (one parametrised test): the Gaussian depth
fusion, the image border-patch cut, the SE(3) helpers, the seed accessors,
the feature-type predicates, the Huber weight and unit scale, the pyramid's
level views and the synthetic feature grid; the frame's pose and seed
accessors, ``SE3 @``, the native loader's JAX-named entry points, the
tile crop, and the JAX toolkit's sphere scene. Integer and mask outputs are
equal; float outputs within 1e-6 relative (5e-6 absolute for the SE(3)
exponential and logarithm and the frame's poses, float32; 1e-4 for the
sphere scene's ray distances and renders, float32 square roots and sines of
metre-scale points)."""

import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu import native_loader as jnl
from svo_pro_universal_tpu.common import frame as jframe
from svo_pro_universal_tpu.common import seed as jseed
from svo_pro_universal_tpu.common import types as jtypes
from svo_pro_universal_tpu.ops import alignment as jalign
from svo_pro_universal_tpu.ops import depth_filter as jdf
from svo_pro_universal_tpu.ops import pyramid as jpyr
from svo_pro_universal_tpu.ops import tiles as jtiles
from svo_pro_universal_tpu.testing import synthetic as jsyn
from svo_pro_universal_tpu.utils import robust as jrobust
from svo_pro_universal_tpu.utils import transform as jtf
from svo_pro_universal_tpu_torch import native_loader as tnl
from svo_pro_universal_tpu_torch.cameras.projections import Camera
from svo_pro_universal_tpu_torch.common import frame as tframe
from svo_pro_universal_tpu_torch.common import seed as tseed
from svo_pro_universal_tpu_torch.common import types as ttypes
from svo_pro_universal_tpu_torch.ops import alignment as talign
from svo_pro_universal_tpu_torch.ops import depth_filter as tdf
from svo_pro_universal_tpu_torch.ops import pyramid as tpyr
from svo_pro_universal_tpu_torch.ops import tiles as ttiles
from svo_pro_universal_tpu_torch.testing import asl
from svo_pro_universal_tpu_torch.testing import synthetic as tsyn
from svo_pro_universal_tpu_torch.utils import robust as trobust
from svo_pro_universal_tpu_torch.utils import transform as ttf


def _poses(rng, n):
    tw = rng.normal(0, 0.4, (n, 6)).astype(np.float32)
    return (jtf.se3_exp(jnp.asarray(tw)),
            ttf.se3_exp(torch.as_tensor(tw)))


def _update_gaussian(rng):
    n = 64
    state = np.stack([rng.uniform(0.1, 1.0, n), rng.uniform(1e-3, 0.1, n),
                      rng.uniform(1, 20, n), rng.uniform(1, 20, n)],
                     -1).astype(np.float32)
    z = rng.uniform(0.1, 1.0, n).astype(np.float32)
    tau2 = rng.uniform(1e-4, 0.05, n).astype(np.float32)
    apply = rng.uniform(size=n) > 0.3
    j = jdf.update_gaussian(jnp.asarray(state), jnp.asarray(z),
                            jnp.asarray(tau2), jnp.asarray(apply))
    t = tdf.update_gaussian(torch.as_tensor(state), torch.as_tensor(z),
                            torch.as_tensor(tau2), torch.as_tensor(apply))
    return list(j), list(t), 1e-6


def _extract_patch_with_border(rng):
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    centers = rng.uniform(-3, 53, (80, 2)).astype(np.float32)
    j = jalign.extract_patch_with_border(jnp.asarray(img),
                                         jnp.asarray(centers), 4)
    t = talign.extract_patch_with_border(torch.as_tensor(img),
                                         torch.as_tensor(centers), 4)
    return list(j), list(t), 1e-6


def _se3_helpers(rng):
    (ja, ta), (jb, tb) = _poses(rng, 32), _poses(rng, 32)
    tw = rng.normal(0, 0.3, (32, 6)).astype(np.float32)
    jbox = jtf.se3_boxplus(ja, jnp.asarray(tw))
    tbox = ttf.se3_boxplus(ta, torch.as_tensor(tw))
    jint = jtf.se3_interpolate(ja, jb, 0.3)
    tint = ttf.se3_interpolate(ta, tb, 0.3)
    jm = ja.as_matrix()
    j = [*jbox, *jtf.se3_distance(ja, jb), *jint,
         *jtf.SE3.from_matrix(jm), ja.rotation_matrix()]
    t = [*tbox, *ttf.se3_distance(ta, tb), *tint,
         *ttf.SE3.from_matrix(torch.as_tensor(np.array(jm))),
         ta.rotation_matrix()]
    return j, t, 5e-6


def _seed_accessors(rng):
    state = np.stack([rng.uniform(0.05, 1.0, 50), rng.uniform(0, 0.1, 50),
                      rng.uniform(1, 20, 50), rng.uniform(1, 20, 50)],
                     -1).astype(np.float32)
    j, t = jnp.asarray(state), torch.as_tensor(state)
    return ([jseed.depth(j), jseed.inv_depth(j),
             jseed.increase_outlier_probability(j)],
            [tseed.depth(t), tseed.inv_depth(t),
             tseed.increase_outlier_probability(t)], 1e-6)


def _type_predicates(rng):
    codes = np.arange(-1, 13, dtype=np.int32)
    j, t = jnp.asarray(codes), torch.as_tensor(codes)
    names = ("is_corner", "is_landmark", "is_map_point")
    return ([getattr(jtypes, n)(j) for n in names],
            [getattr(ttypes, n)(t) for n in names], 0.0)


def _robust(rng):
    x = rng.normal(0, 3, 200).astype(np.float32)
    mask = rng.uniform(size=200) > 0.2
    return ([jrobust.huber_weight(jnp.asarray(x)),
             jrobust.huber_weight(jnp.asarray(x), 2.5),
             jrobust.unit_scale(jnp.asarray(x), jnp.asarray(mask))],
            [trobust.huber_weight(torch.as_tensor(x)),
             trobust.huber_weight(torch.as_tensor(x), 2.5),
             trobust.unit_scale(torch.as_tensor(x), torch.as_tensor(mask))],
            1e-6)


def _pyramid_levels(rng):
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    j = jpyr.pyramid_levels(jpyr.build_pyramid(jnp.asarray(img), 3))
    t = tpyr.pyramid_levels(tpyr.build_pyramid(torch.as_tensor(img), 3))
    return list(j), list(t), 1e-6


def _grid_features(rng):
    cam = Camera.pinhole(*tsyn.INTRINSICS, tsyn.W, tsyn.H, device="cpu")
    return (list(jsyn.grid_features(n_grid=6, border=15)),
            list(tsyn.grid_features(n_grid=6, border=15, cam=cam)), 1e-6)


def _frame_accessors(rng):
    (jT, tT), (jB, tB), (jN, tN) = (_poses(rng, 1) for _ in range(3))
    n = 16
    f = rng.normal(0, 1, (n, 3)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    state = np.stack([rng.uniform(-0.1, 1.0, n), rng.uniform(0, 0.1, n),
                      rng.uniform(1, 20, n), rng.uniform(1, 20, n)],
                     -1).astype(np.float32)
    pyr = np.zeros((3, 24, 32), np.float32)

    def one(mod, Tc, Tb, Tn, arr):
        sq = (lambda T: type(T)(T.q[0], T.t[0]))
        fr = mod.make_empty_frame(arr(pyr), n, T_cam_world=sq(Tc),
                                  T_cam_body=sq(Tb))
        fr = fr._replace(f=arr(f), seed_state=arr(state))
        Tbw = fr.T_body_world
        moved = fr.set_pose_cam_world(sq(Tn)).T_cam_world
        return [arr(np.asarray(fr.img_shape)), Tbw.q, Tbw.t, fr.pos(), moved.q,
                moved.t, *[fr.seed_pos_in_frame(i) for i in (0, 3, n - 1)]]
    return (one(jframe, jT, jB, jN, jnp.asarray),
            one(tframe, tT, tB, tN, torch.as_tensor), 5e-6)


def _se3_matmul(rng):
    (ja, ta), (jb, tb) = _poses(rng, 8), _poses(rng, 8)
    x = rng.normal(0, 2, (8, 3)).astype(np.float32)
    jc, tc = ja @ jb, ta @ tb
    return ([jc.q, jc.t, ja @ jnp.asarray(x)],
            [tc.q, tc.t, ta @ torch.as_tensor(x)], 5e-6)


def _native_loader(rng):
    img = rng.integers(0, 256, (30, 41)).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "x.png"
        asl.write_png(path, img, filt=4)
        data = path.read_bytes()
    out = []
    for nl in (jnl, tnl):
        avail = nl.native_available()
        dec = nl.decode_png_gray8(data)
        out.append([torch.tensor(avail),
                    torch.tensor(nl.decode_png_gray8(b"not a png") is None),
                    torch.as_tensor(img if dec is None else dec)])
    # the JAX package builds the same sources: both decode or neither
    return out[0], out[1], 0.0


def _crop_tiles(rng):
    n, Rp, Tp, R, T = 24, 20, 26, 8, 10
    tiles = rng.uniform(0, 255, (n, Rp, Tp)).astype(np.float32)
    y0 = rng.integers(0, 50, n)
    x0 = rng.integers(0, 50, n)
    lh, lw = np.full(n, 60), np.full(n, 80)
    # windows inside, across the edge of and outside the big tile
    ny = (y0 + rng.integers(-3, Rp - R + 4, n)).astype(np.int32)
    nx = (x0 + rng.integers(-3, Tp - T + 4, n)).astype(np.int32)
    out = []
    for mod, arr in ((jtiles, jnp.asarray), (ttiles, torch.as_tensor)):
        tb = mod.TileBatch(arr(tiles), arr(y0.astype(np.int32)),
                           arr(x0.astype(np.int32)), arr(lh), arr(lw))
        out.append(list(mod.crop_tiles(tb, arr(ny), arr(nx), R, T))
                   + [mod.crop_tiles(tb, arr(ny), arr(nx), Rp, Tp).tiles])
    return out[0], out[1], 1e-6


def _sphere_scene(rng):
    tw = np.array([0.05, -0.03, 0.1, 0.02, -0.04, 0.01], np.float32)
    jT, tT = jtf.se3_exp(jnp.asarray(tw)), ttf.se3_exp(torch.as_tensor(tw))
    uv = rng.uniform([0, 0], [tsyn.W, tsyn.H], (200, 2)).astype(np.float32)
    jf = jsyn.backproject(jsyn.CAM, jnp.asarray(uv))
    tf = torch.as_tensor(np.array(jf))
    p = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    o = np.array([0.1, -0.2, 0.3], np.float32)
    j = [jsyn.CAM.intrinsics, jsyn.SPHERE_C, jnp.asarray(jsyn.SPHERE_R),
         jsyn.plane_depth(jf), jsyn.plane_depth(jf, 3.0, (0.1, -0.2)),
         *jsyn.sphere_hit(jnp.asarray(o), jf),
         *jsyn._scene_hit(jnp.asarray(o), jf),
         jsyn.sphere_texture(jnp.asarray(p)),
         *jsyn.sphere_depth_along(jT, jf), jsyn.render_sphere_view(jT)]
    t = [tsyn.CAM.intrinsics, tsyn.SPHERE_C, torch.tensor(tsyn.SPHERE_R),
         tsyn.plane_depth(tf), tsyn.plane_depth(tf, 3.0, (0.1, -0.2)),
         *tsyn.sphere_hit(torch.as_tensor(o), tf),
         *tsyn._scene_hit(torch.as_tensor(o), tf),
         tsyn.sphere_texture(torch.as_tensor(p)),
         *tsyn.sphere_depth_along(tT, tf), tsyn.render_sphere_view(tT)]
    return j, t, 1e-4


CASES = {f.__name__.lstrip("_"): f for f in (
    _update_gaussian, _extract_patch_with_border, _se3_helpers,
    _seed_accessors, _type_predicates, _robust, _pyramid_levels,
    _grid_features, _frame_accessors, _se3_matmul, _native_loader,
    _crop_tiles, _sphere_scene)}


@pytest.mark.parametrize("case", list(CASES))
def test_leftover_function_matches_jax(case):
    want, got, tol = CASES[case](np.random.default_rng(5))
    assert len(want) == len(got)
    for k, (j, t) in enumerate(zip(want, got)):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape, (k, j.shape, t.shape)
        if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
            assert np.array_equal(j, t), k
        else:
            np.testing.assert_allclose(t, j, rtol=tol, atol=tol,
                                       err_msg=str(k))
