"""Every detector of the port against the JAX package's, on the CPU.

- Score maps of every corner kind (FAST-10, Shi-Tomasi, Sobel, Canny,
  Huang-Mumford, the Scharr edgelet magnitude) on a rendered, degraded
  160×120 view and its pyramid levels: within 1e-4 relative to the map's
  largest score (float32 sums in another order; Shi-Tomasi's box sums are
  cumsum differences).
- ``detect_features`` for every ``detector_type`` the JAX package accepts:
  the same valid cells, pixels, levels and feature types (exact), scores
  within 1e-4 relative, gradient directions within 1e-5.
- The gates of tests/test_detector.py and
  tests/test_homography_detectors.py:52-80, on the port.
- A host mono run (``FrameHandlerMono``, OneShot) with ``shitomasi_grad``
  against JAX's, 12 frames from scratch: the first frame's detections equal
  (pixels, types), then the same stage, quality and keyframe decision on
  every frame, tracked counts within ±2 (a reprojection match near a tie
  flips with float32 rounding: frame 2 tracks 115 against JAX's 114; the
  bound of tests/test_torch_host_mono.py's FivePoint run), positions
  within 1 mm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerMono as JaxHandler)
from svo_pro_universal_tpu.ops import detector as jdet
from svo_pro_universal_tpu.ops.pyramid import build_pyramid as jbuild
from svo_pro_universal_tpu.ops.pyramid import level_view as jlevel
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.common.types import FeatureType
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono)
from svo_pro_universal_tpu_torch.ops import detector as tdet
from svo_pro_universal_tpu_torch.ops.pyramid import build_pyramid as tbuild
from svo_pro_universal_tpu_torch.ops.pyramid import level_view
from svo_pro_universal_tpu_torch.testing import synthetic as syn

from torch_parity_utils import (camera_dict, port_config, rotation_angle_deg,
                                sequence, slice_config)

SCORE_RTOL = 1e-4
JAX_MAPS = {
    "fast": jdet.fast_score_map,
    "shitomasi": jdet.shitomasi_score_map,
    "canny": jdet.canny_score_map,
    "gradhm": jdet.grad_huang_mumford_score_map,
}
KINDS = ("fast", "grad", "shitomasi", "sobel", "canny", "gradhm",
         "allpixels")
N_HOST = 12


def _image() -> np.ndarray:
    """A degraded (noise, vignette, blur) uint8 view of the textured plane."""
    return syn.degrade_sequence(sequence(1), seed=3)[0]


def _jax_score(img, kind):
    if kind in JAX_MAPS:
        return np.asarray(JAX_MAPS[kind](img))
    if kind == "grad":
        dx, dy = jdet.scharr_gradient(img)
    else:
        dx, dy = jdet.sobel_gradient(img)
    return np.asarray(jnp.sqrt(dx * dx + dy * dy))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [0, 1, 2])
def test_score_maps_match_jax(kind, level):
    img = _image().astype(np.float32)
    jl = np.asarray(jlevel(jbuild(jnp.asarray(img), 3), level))
    tl = level_view(tbuild(torch.from_numpy(img), 3), level)
    assert np.array_equal(tl.numpy(), jl)
    score, angle, cand = tdet.score_maps(tl, kind)
    if kind == "allpixels":
        assert bool((score == 1).all() and cand.all())
        return
    ref = _jax_score(jnp.asarray(jl), kind)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(score.numpy() - ref).max()) / scale
    assert err <= SCORE_RTOL, (kind, level, err)
    assert float(np.abs(ref).max()) > 0


def _detect(kind, img, occ, **kw):
    jp, tp = jbuild(jnp.asarray(img), 4), tbuild(torch.from_numpy(img), 4)
    jd = jdet.detect_features(jp, jnp.asarray(occ), detector_type=kind, **kw)
    td = tdet.detect_features(tp, torch.from_numpy(occ), detector_type=kind,
                              **kw)
    return jd, td


@pytest.mark.parametrize("kind", tdet.DETECTOR_TYPES)
def test_detect_features_matches_jax(kind):
    img = _image().astype(np.float32)
    occ = np.zeros(16 * 12, bool)
    occ[::7] = True
    kw = dict(cell_size=10, n_cols=16, n_rows=12, max_features=160,
              threshold_primary=5.0, threshold_secondary=60.0,
              threshold_shitomasi=20.0, max_level=3)
    jd, td = _detect(kind, img, occ, **kw)
    valid = td.valid.numpy()
    assert valid.sum() > 40, (kind, valid.sum())
    for name in ("valid", "px", "level", "ftype"):
        assert np.array_equal(getattr(td, name).numpy(),
                              np.asarray(getattr(jd, name))), (kind, name)
    js = np.asarray(jd.score)
    assert (np.abs(td.score.numpy() - js).max()
            <= SCORE_RTOL * max(np.abs(js).max(), 1.0)), kind
    assert np.abs(td.grad.numpy() - np.asarray(jd.grad)).max() <= 1e-5


# ---------------------------------------------------------------------------
# the gates of the JAX package's detector tests, on the port
# ---------------------------------------------------------------------------

def _naive_fast10(img, y, x):
    c = img[y, x]
    d = np.array([img[y + dy, x + dx] - c for dx, dy in tdet.FAST_RING])
    best = 0.0
    for sign in (1.0, -1.0):
        s = sign * d
        for j in range(16):
            best = max(best, min(s[(j + i) % 16]
                                 for i in range(tdet.FAST_ARC)))
    return max(best, 0.0)


def test_fast_score_matches_oracle():
    img = np.random.default_rng(0).uniform(0, 255, (24, 32)).astype(
        np.float32)
    score = tdet.fast_score_map(torch.from_numpy(img)).numpy()
    for y in range(4, 20, 3):
        for x in range(4, 28, 5):
            assert score[y, x] == pytest.approx(_naive_fast10(img, y, x),
                                                abs=1e-3)


def test_fast_corner_nms_and_shitomasi_gates():
    sq = torch.zeros((48, 48))
    sq[16:32, 16:32] = 200.0
    score = tdet.fast_score_map(sq)
    assert score[16, 16] > 100.0 and score[8, 8] == 0.0
    assert score[16, 24] < score[16, 16]
    s = torch.zeros((16, 16))
    s[5, 5], s[5, 6] = 10.0, 8.0
    m = tdet.nms_3x3(s)
    assert bool(m[5, 5]) and not bool(m[5, 6])
    img = torch.zeros((64, 64))
    img[24:, 24:] = 180.0
    st = tdet.shitomasi_score_map(img).numpy()
    assert st[20:28, 20:28].max() > 10 * max(st[40:48, 22:26].max(), 1e-6)
    assert st[8:16, 8:16].max() == pytest.approx(0.0, abs=1e-3)


def _blobs():
    img = torch.zeros((96, 128))
    centers = [(20, 24), (20, 88), (68, 40), (68, 100)]
    for y, x in centers:
        img[y - 4:y + 4, x - 4:x + 4] = 220.0
    return tbuild(img, 3), centers


def test_detect_features_on_checker_corners_and_occupancy():
    pyr, centers = _blobs()
    out = tdet.detect_features(pyr, torch.zeros(12, dtype=torch.bool), 32,
                               4, 3, max_features=16, threshold_primary=10.0,
                               detector_type="fast")
    got = out.px.numpy()[out.valid.numpy()]
    assert len(got) >= 4
    for y, x in centers:
        assert np.abs(got - np.array([x, y])).sum(axis=1).min() <= 8.0
    full = tdet.detect_features(pyr, torch.ones(12, dtype=torch.bool), 32, 4,
                                3, 16, detector_type="fast")
    assert not bool(full.valid.any())
    assert bool((full.ftype == int(FeatureType.INVALID)).all())
    two = tdet.detect_features(pyr, torch.zeros(12, dtype=torch.bool), 32, 4,
                               3, 2, detector_type="fast")
    assert int(two.valid.sum()) == 2


def test_edgelets_fill_cells_without_corners():
    img = torch.zeros((96, 128))
    img[:, 64:] = 150.0
    out = tdet.detect_features(tbuild(img, 3),
                               torch.zeros(12, dtype=torch.bool), 32, 4, 3,
                               16, threshold_secondary=100.0,
                               detector_type="fast_grad")
    v = out.valid.numpy()
    assert v.any()
    assert (out.ftype.numpy()[v] == int(FeatureType.EDGELET_SEED)).all()
    assert np.all(np.abs(out.grad.numpy()[v][:, 0]) > 0.9)


def _edge_image():
    img = torch.zeros((64, 96))
    img[:, 48:] = 180.0
    img[20:40, 10:30] = 120.0
    return img


def test_canny_sobel_and_gradhm_gates():
    img = _edge_image()
    s = tdet.canny_score_map(img).numpy()
    assert s[:, 46:50].max() > 100.0 and s[5:15, 60:90].max() == 0.0
    dx, _ = tdet.sobel_gradient(img)
    assert float(torch.abs(dx[32, 47])) > 300.0
    hm = tdet.grad_huang_mumford_score_map(img).numpy()
    assert hm[32, 47] > 100.0 and hm.max() <= 255.0
    assert hm[5, 70] == pytest.approx(0.0, abs=1e-3)


@pytest.mark.parametrize("kind", ["sobel", "canny", "gradhm", "allpixels",
                                  "grid_grad"])
def test_detector_variants_run(kind):
    out = tdet.detect_features(
        tbuild(_edge_image(), 3), torch.zeros(24, dtype=torch.bool), 16, 6,
        4, max_features=24, threshold_primary=10.0, threshold_secondary=50.0,
        detector_type=kind)
    assert bool(out.valid.any())


def test_allpixels_ties_go_to_the_first_pixel_of_each_cell():
    """Every pixel scores 1: each cell's winner is its first in-border
    candidate of the first level, as ``jnp.argmax`` picks it."""
    img = _image().astype(np.float32)
    kw = dict(cell_size=10, n_cols=16, n_rows=12, max_features=192,
              max_level=3, border=8)
    jd, td = _detect("allpixels", img, np.zeros(192, bool), **kw)
    assert np.array_equal(td.px.numpy(), np.asarray(jd.px))
    px = td.px.numpy()[td.valid.numpy()]
    assert (px % 10 == np.where(px < 10, 8, 0)).all()


# ---------------------------------------------------------------------------
# a host run with Shi-Tomasi corners
# ---------------------------------------------------------------------------

def test_host_mono_with_shitomasi_grad_matches_jax():
    cfg = slice_config()
    cfg.detector.detector_type = "shitomasi_grad"
    cfg.detector.threshold_shitomasi = 20.0
    imgs = sequence(N_HOST)
    jh = JaxHandler(cfg, CAM)
    th = FrameHandlerMono(port_config(cfg), convert.camera(camera_dict(CAM)),
                          device="cpu")
    for t, img in enumerate(imgs):
        jr = jh.add_image(img, t * 0.05)
        tr = th.add_image(img, t * 0.05)
        if t == 0:
            jf, tf = jh.last_frame, th.last_frame
            assert np.array_equal(tf.px.numpy(), np.asarray(jf.px))
            assert np.array_equal(tf.ftype.numpy(), np.asarray(jf.ftype))
            n_corner = int(torch.isin(tf.ftype, torch.tensor(
                [int(FeatureType.CORNER_SEED), int(FeatureType.CORNER)]))
                .sum())
        assert (tr.stage.value, tr.quality.value, tr.is_keyframe) == (
            jr.stage.value, jr.quality.value, bool(jr.is_keyframe)), t
        assert abs(tr.n_tracked - int(jr.n_tracked)) <= 2, t
        Tj = np.asarray(jr.T_world_cam)
        assert np.linalg.norm(tr.T_world_cam[:3, 3] - Tj[:3, 3]) <= 1e-3, t
        assert rotation_angle_deg(tr.T_world_cam[:3, :3], Tj[:3, :3]) < 0.05
    assert tr.stage.name == "TRACKING"
    assert n_corner > 20
