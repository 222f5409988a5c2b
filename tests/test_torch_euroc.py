"""The port's EuRoC path against the JAX package's, on the CPU at 160×120,
at EuRoC-epoch nanosecond stamps (1403636579763555584 ns on, as the
dataset's MH_01 starts).

The scenes are written as ASL folders (cam0 [+ cam1] PNGs and CSVs, a
200 Hz IMU CSV, the ground-truth CSV), as tests/test_euroc_path.py:27-70
writes them, but with integer nanosecond stamps at the epoch.

- ``EurocDataset``: images, IMU, ground truth and ``synced_stream`` equal
  to JAX's (stamps, paths, values, event order; with cam1 too).
- PNG decoding: the native decoder (native/png_decode.cc built by the
  port), the numpy decoder and JAX's loader agree to the bit on every
  filter type and colour format; ``PrefetchLoader`` returns frames in
  order.
- Evaluation: ``save_trajectory_tum`` writes JAX's text; ``associate``,
  ``relative_errors`` (1e-12) and ``write_rpg_results`` (text files equal,
  YAML documents equal after loading, numbers within 1e-12) equal JAX's.
- The runners: ``run_euroc_mono.main`` against the JAX runner's loop
  (examples/run_euroc_mono.py: ``synced_stream`` → ``add_image``) with a
  OneShot configuration: every frame the same stage, quality, keyframe
  decision and tracked count, positions within 1 mm and rotations within
  0.05° (tests/test_torch_host_mono.py's free-run bounds), and the same
  map at the end: the structure stage's last-optimized stamps equal (XLA's
  saturating int32 cast of the ms stamp, 2147483647 at the epoch) and
  landmarks within 1 mm. ``run_euroc_vio.main`` against the JAX runner's
  loop with the host ``FrameHandlerVIO`` on tests/test_torch_host_vio.py's
  scene and configuration (its gravity, JAX's RANSAC noise injected, the
  window solve's ``void_on_single_view`` as that test sets it): the same
  stages and keyframe decisions up to the first frame where a keyframe
  decision differs (none here), tracked counts within ±2, and on every
  TRACKING frame positions within 5 mm (the bootstrap frame 1 cm:
  tests/test_torch_vio.py's free-run bounds) and rotations within 0.2°
  (the host VIO test's bootstrap bound; the window's float32 solves move
  the two runs ~2.7 mm and 0.13° apart by frame 15); then the TUM file
  and the results layout read back. On this configuration (the parameter
  files' keys leave the capacities at their defaults) both lose track at
  frame 17, as the JAX runner does at session-relative stamps too.
  ``run_image_dir`` (a folder of PNGs at ``--fps``) and ``run_video`` (its
  capture replaced by a function that yields the same frames) give the
  same results to the bit, and the TUM file of examples/run_image_dir.py
  (the JAX package) within 1 mm.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from svo_pro_universal_tpu import evaluation as jev
from svo_pro_universal_tpu import native_loader as jnl
from svo_pro_universal_tpu.cameras.rig import load_rig_yaml as jload_rig
from svo_pro_universal_tpu.config import load_config as jload_config
from svo_pro_universal_tpu.datasets.euroc import EurocDataset as JEuroc
from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerMono as JaxMono)
from svo_pro_universal_tpu.frontend.frame_handler import (
    FrameHandlerVIO as JaxVIO)
from svo_pro_universal_tpu.frontend.imu_handler import ImuHandler as JImu
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import evaluation as tev
from svo_pro_universal_tpu_torch import native_loader as tnl
from svo_pro_universal_tpu_torch.datasets.euroc import EurocDataset
from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.runners import (
    run_euroc_mono, run_euroc_vio, run_image_dir, run_video)
from svo_pro_universal_tpu_torch.testing import asl
from svo_pro_universal_tpu_torch.utils import yaml_lite

from synthetic_utils import render_sphere_view
from test_device_pipeline_vio import simulate_fast
from test_pipeline_vio import G_W
from test_torch_init import init_noise_of
from torch_parity_utils import gt_pose, rotation_angle_deg, sequence

T0_NS = asl.EUROC_T0_NS
N_MONO = 16
VIO_DURATION = 2.0

# a OneShot configuration at 160×120, in the parameter files' keys
MONO_PARAMS = """\
n_pyr_levels: 4
max_fts: 256
max_n_kfs: 6
grid_size: 10
detector_threshold_primary: 5.0
init_method: OneShot
init_min_features: 40
seed_convergence_sigma2_thresh: 30.0
quality_min_fts: 15
kfselect_numkfs_lower_thresh: 40
kfselect_numkfs_upper_thresh: 120
kfselect_min_disparity: 12.0
kfselect_min_dist_metric: 0.05
kfselect_min_angle: 6.0
img_align_max_level: 2
img_align_min_level: 0
structure_optimization_max_pts: 20
"""
# tests/test_torch_vio.py's vio_config in the parameter files' keys
VIO_PARAMS = """\
n_pyr_levels: 4
max_fts: 256
max_n_kfs: 6
grid_size: 10
detector_threshold_primary: 5.0
init_method: FivePoint
init_min_features: 40
init_min_tracked: 30
init_min_inliers: 25
init_min_disparity: 12.0
reproj_err_thresh: 1.0
seed_convergence_sigma2_thresh: 30.0
quality_min_fts: 8
kfselect_numkfs_lower_thresh: 40
kfselect_numkfs_upper_thresh: 120
kfselect_min_disparity: 12.0
kfselect_min_dist_metric: 0.05
kfselect_min_angle: 6.0
img_align_max_level: 2
img_align_min_level: 0
ceres_num_iterations: 3
"""


def write_calib(path, imu: bool) -> None:
    """The synthetic camera's rig calibration (body = camera), with the
    default IMU parameters when ``imu``."""
    asl.write_calib(path, np.asarray(CAM.intrinsics), CAM.width, CAM.height,
                    imu_params=ImuParams() if imu else None)


@pytest.fixture(scope="module")
def mono_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("mono")
    frames = sequence(N_MONO)
    cam_ns = [T0_NS + k * 50_000_000 for k in range(N_MONO)]
    imu = [(T0_NS + k * 5_000_000, np.float32([0.01, -0.02, 0.03]) * k,
            np.float32([0.1, 9.81, -0.2])) for k in range(10 * N_MONO)]
    gts = [np.linalg.inv(gt_pose(k)) for k in range(N_MONO)]
    asl.write_asl(str(root / "seq"), frames, cam_ns, gts, imu, frames1=frames)
    write_calib(str(root / "calib.yaml"), imu=False)
    (root / "params.yaml").write_text(MONO_PARAMS)
    return root, frames


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _fields(x):
    return {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in vars(x).items() if k != "decode"}


def _same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert np.array_equal(fa[k], fb[k]) and fa[k].dtype == \
                fb[k].dtype, k
        else:
            assert fa[k] == fb[k], k


def test_dataset_matches_jax(mono_folder):
    root, frames = mono_folder
    seq = str(root / "seq")
    jd, td = JEuroc(seq), EurocDataset(seq, png_decoder="numpy")
    for cam in (0, 1):
        for a, b in zip(td.images(cam), jd.images(cam), strict=True):
            _same(a, b)
            assert a.timestamp > 1.4e9
    for a, b in zip(td.imu(), jd.imu(), strict=True):
        _same(a, b)
    for a, b in zip(td.ground_truth(), jd.ground_truth(), strict=True):
        _same(a, b)
    for use_cam1 in (False, True):
        tev_ = list(td.synced_stream(use_cam1=use_cam1))
        jev_ = list(jd.synced_stream(use_cam1=use_cam1))
        assert [e[0] for e in tev_] == [e[0] for e in jev_]
        for te, je in zip(tev_, jev_):
            for a, b in zip(te[1:], je[1:], strict=True):
                _same(a, b)
    t0 = td.images(0)[5].timestamp
    assert ([e[0] for e in td.synced_stream(t0=t0)]
            == [e[0] for e in jd.synced_stream(t0=t0)])
    img = td.images(0)[3].load()
    assert img.dtype == np.float32
    assert np.array_equal(img, jd.images(0)[3].load())
    assert np.array_equal(img.astype(np.uint8), frames[3])


@pytest.mark.parametrize("fmt", ["gray8", "gray16", "gray_alpha", "rgb",
                                 "rgba"])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_decoders_agree(tmp_path, fmt, filt):
    rng = np.random.default_rng(filt)
    shape = {"gray8": (23, 31), "gray16": (23, 31), "gray_alpha": (23, 31, 2),
             "rgb": (23, 31, 3), "rgba": (23, 31, 4)}[fmt]
    color = {"gray8": 0, "gray16": 0, "gray_alpha": 4, "rgb": 2,
             "rgba": 6}[fmt]
    depth = 16 if fmt == "gray16" else 8
    img = rng.integers(0, 2 ** depth, shape).astype(
        np.uint16 if depth == 16 else np.uint8)
    path = str(tmp_path / "x.png")
    asl.write_png(path, img, filt=filt, color=color, depth=depth)
    data = open(path, "rb").read()
    native = tnl.decoder("native")(data)
    plain = tnl.decode_png_gray8_numpy(data)
    assert native.dtype == plain.dtype == np.uint8
    assert np.array_equal(native, plain)
    if jnl.native_available():
        assert np.array_equal(native, jnl.decode_png_gray8(data))
    if fmt == "gray8":
        assert np.array_equal(plain, img)


def test_prefetch_loader_in_order(mono_folder):
    root, frames = mono_folder
    paths = [s.path for s in EurocDataset(str(root / "seq"),
                                          "numpy").images(0)]
    loader = tnl.PrefetchLoader(paths, capacity=3, n_threads=3)
    got = list(loader)
    loader.close()
    assert len(got) == len(frames)
    for g, ref in zip(got, frames):
        assert np.array_equal(g, ref)
    with pytest.raises(ValueError, match="unknown PNG decoder"):
        tnl.decoder("pil")


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def test_evaluation_matches_jax(mono_folder, tmp_path):
    root, _ = mono_folder
    jd = JEuroc(str(root / "seq"))
    gt = jd.ground_truth()
    rng = np.random.default_rng(4)
    stamps = [g.timestamp + 1e-4 for g in gt]
    poses = []
    for g in gt:
        T = np.eye(4, dtype=np.float32)
        w = rng.normal(0, 0.05, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        T[:3, :3] = (np.eye(3) + np.sin(th) / th * K
                     + (1 - np.cos(th)) / th ** 2 * K @ K)
        T[:3, 3] = g.p + rng.normal(0, 0.01, 3)
        poses.append(T)
    tev.save_trajectory_tum(str(tmp_path / "t.txt"), stamps, poses)
    jev.save_trajectory_tum(str(tmp_path / "j.txt"), stamps, poses)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for a, b in zip(tev.load_trajectory_tum(str(tmp_path / "t.txt")),
                    jev.load_trajectory_tum(str(tmp_path / "j.txt"))):
        assert np.array_equal(a, b)
    ts_gt = np.asarray([g.timestamp for g in gt])
    for ta, ja in zip(tev.associate(np.asarray(stamps), ts_gt),
                      jev.associate(np.asarray(stamps), ts_gt)):
        assert np.array_equal(ta, ja)
    est = np.stack([T[:3, 3] for T in poses]).astype(np.float64)
    gpos = np.stack([g.p for g in gt])
    for align in ("se3", "sim3"):
        np.testing.assert_allclose(
            tev.relative_errors(est, gpos, delta=4, align=align),
            jev.relative_errors(est, gpos, delta=4, align=align),
            rtol=1e-12, atol=1e-12)
    ts = tev.write_rpg_results(str(tmp_path / "rt"), stamps, poses, gt,
                               align_type="sim3")
    js = jev.write_rpg_results(str(tmp_path / "rj"), stamps, poses, gt,
                               align_type="sim3")
    assert ts.keys() == js.keys() and "ate_rmse_sim3_m" in ts
    for name in ("stamped_traj_estimate.txt", "stamped_groundtruth.txt"):
        assert ((tmp_path / "rt" / name).read_text()
                == (tmp_path / "rj" / name).read_text())
    for name in ("eval_cfg.yaml", "ate_summary.yaml"):
        a = yaml.safe_load((tmp_path / "rt" / name).read_text())
        b = yaml.safe_load((tmp_path / "rj" / name).read_text())
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], float):
                np.testing.assert_allclose(a[k], float(b[k]), rtol=1e-12)
            else:
                assert a[k] == b[k], k
        assert yaml_lite.load_file(str(tmp_path / "rt" / name)) == a


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------

def _jax_mono_loop(seq, calib, params):
    """examples/run_euroc_mono.py's loop, in-process."""
    rig = jload_rig(calib)
    h = JaxMono(jload_config(params), rig.cameras[0],
                T_cam_body=rig.T_cam_body(0))
    stamps, results = [], []
    for ev in JEuroc(seq).synced_stream():
        if ev[0] != "image":
            continue
        results.append(h.add_image(ev[1].load(), ev[1].timestamp))
        stamps.append(ev[1].timestamp)
    return h, stamps, results


def _assert_frame(res, jres, k, n_tol=0, pos_tol=1e-3, rot_tol=0.05):
    assert (res.stage.value, res.quality.value, res.is_keyframe) == (
        jres.stage.value, jres.quality.value, bool(jres.is_keyframe)), k
    assert abs(res.n_tracked - int(jres.n_tracked)) <= n_tol, (
        k, res.n_tracked, int(jres.n_tracked))
    Tj = np.asarray(jres.T_world_cam)
    assert np.linalg.norm(res.T_world_cam[:3, 3] - Tj[:3, 3]) <= pos_tol, k
    assert rotation_angle_deg(res.T_world_cam[:3, :3], Tj[:3, :3]) <= rot_tol


def test_mono_runner_matches_jax_at_epoch_stamps(mono_folder, tmp_path):
    root, _ = mono_folder
    seq, calib, params = (str(root / "seq"), str(root / "calib.yaml"),
                          str(root / "params.yaml"))
    jh, jstamps, jres = _jax_mono_loop(seq, calib, params)
    out = run_euroc_mono.main([seq, "--calib", calib, "--config", params,
                               "--out", str(tmp_path / "traj.txt"),
                               "--device", "cpu", "--png-decoder", "numpy",
                               "--trace-dir", str(tmp_path / "trace")])
    assert out.stamps == jstamps and jstamps[0] > 1.4e9
    assert all(r.stage == Stage.TRACKING for r in out.results)
    assert sum(r.is_keyframe for r in out.results[1:]) >= 1
    for k, (res, jr) in enumerate(zip(out.results, jres, strict=True)):
        _assert_frame(res, jr, k)
    # the same map: the structure stage stamps its points with XLA's
    # saturating int32 of the ms stamp, and ranks by them
    jp, tp = jh.pool, out.handler.pool
    lso = tp.last_structure_optim.numpy()
    assert np.array_equal(lso, np.asarray(jp.last_structure_optim))
    assert (lso == 2 ** 31 - 1).sum() > 20
    v = np.asarray(jp.valid)
    assert np.array_equal(tp.valid.numpy(), v)
    assert np.abs(tp.pos.numpy()[v] - np.asarray(jp.pos)[v]).max() <= 1e-3
    ts, pos = tev.load_trajectory_tum(out.out)
    assert np.abs(ts - np.asarray(jstamps)).max() <= 1e-6
    assert np.abs(pos - np.stack([r.T_world_cam[:3, 3]
                                  for r in out.results])).max() <= 5e-7
    lines = (tmp_path / "trace" / "trace.csv").read_text().splitlines()
    assert len(lines) == N_MONO + 1 and lines[0].startswith(
        "timer_pyramid_creation")


@pytest.fixture(scope="module")
def vio_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("vio")
    imu_stream, cam_poses, cam_ts = simulate_fast(duration=VIO_DURATION)
    frames = [np.clip(np.rint(np.asarray(render_sphere_view(T))), 0,
                      255).astype(np.uint8) for T in cam_poses]
    cam_ns = [T0_NS + int(round(t * 1e9)) for t in cam_ts]
    imu = [(T0_NS + int(round(t * 1e9)), g, np.asarray(a))
           for t, g, a in imu_stream]
    gts = [np.asarray(T.inverse().as_matrix(), np.float64) for T in cam_poses]
    asl.write_asl(str(root / "seq"), frames, cam_ns, gts, imu)
    write_calib(str(root / "calib.yaml"), imu=True)
    (root / "params.yaml").write_text(VIO_PARAMS)
    return root


def test_vio_runner_matches_jax_at_epoch_stamps(vio_folder, tmp_path):
    root = vio_folder
    seq, calib, params = (str(root / "seq"), str(root / "calib.yaml"),
                          str(root / "params.yaml"))
    rig = jload_rig(calib)
    jh = JaxVIO(jload_config(params), rig.cameras[0],
                T_cam_body=rig.T_cam_body(0),
                imu_handler=JImu(rig.imu_params, rig.imu_init),
                imu_params=rig.imu_params, gravity=tuple(G_W))
    keys, jres, jstamps = [], [], []
    for ev in JEuroc(seq).synced_stream():
        if ev[0] == "imu":
            jh.add_imu_measurement(ev[1].timestamp, ev[1].gyro, ev[1].acc)
            continue
        keys.append(np.asarray(jh.rng_key))
        jres.append(jh.add_image(ev[1].load(), ev[1].timestamp))
        jstamps.append(ev[1].timestamp)

    def hook(h):
        """JAX's gravity, solve rule and RANSAC noise (frame h.k's key)."""
        h.backend.opts = h.backend.opts._replace(gravity=tuple(G_W),
                                                 void_on_single_view=True)
        h.k = 0
        add = h.add_image

        def add_image(img, ts):
            out = add(img, ts)
            h.k += 1
            return out

        h.add_image = add_image
        h._init_noise = lambda n_hyp, n: torch.from_numpy(np.array(
            init_noise_of({"rng_key": keys[h.k]}, n)))

    results_dir = str(tmp_path / "results")
    out = run_euroc_vio.main([seq, "--calib", calib, "--config", params,
                              "--out", str(tmp_path / "traj.txt"),
                              "--results-dir", results_dir,
                              "--device", "cpu", "--png-decoder", "numpy"],
                             on_handler=hook)
    assert out.stamps == jstamps and jstamps[0] > 1.4e9
    stages = [r.stage for r in out.results]
    assert Stage.TRACKING in stages and out.handler.backend.n_states >= 2
    boot = stages.index(Stage.TRACKING)
    held = []
    for k, (res, jr) in enumerate(zip(out.results, jres, strict=True)):
        assert res.stage.value == jr.stage.value, k
        if res.is_keyframe != bool(jr.is_keyframe):
            break
        if res.stage == Stage.TRACKING:
            _assert_frame(res, jr, k, n_tol=2,
                          pos_tol=1e-2 if k == boot else 5e-3,
                          rot_tol=0.2)
            held.append(k)
    assert len(held) >= 8, held
    ts, pos = tev.load_trajectory_tum(out.out)
    assert np.abs(pos - np.stack([p[:3, 3] for p in out.poses])).max() \
        <= 5e-7
    summary = yaml_lite.load_file(os.path.join(results_dir,
                                               "ate_summary.yaml"))
    assert summary["n_frames"] == len(jstamps)
    assert np.isfinite(summary["ate_rmse_sim3_m"])


def test_image_dir_and_video_runners(mono_folder, tmp_path, monkeypatch):
    root, frames = mono_folder
    img_dir = str(root / "seq" / "mav0" / "cam0" / "data")
    calib, params = str(root / "calib.yaml"), str(root / "params.yaml")
    a = run_image_dir.main([img_dir, "--calib", calib, "--config", params,
                            "--fps", "20", "--device", "cpu",
                            "--png-decoder", "numpy",
                            "--out", str(tmp_path / "dir.txt")])
    b = run_video.main(["clip.mp4", "--calib", calib, "--config", params,
                        "--device", "cpu", "--out",
                        str(tmp_path / "video.txt")],
                       capture=lambda src: (iter(frames), 20.0))
    assert len(a.results) == len(b.results) == N_MONO
    for x, y in zip(a.results, b.results):
        assert np.array_equal(x.T_world_cam, y.T_world_cam)
        assert (x.stage, x.n_tracked) == (y.stage, y.n_tracked)
    assert ((tmp_path / "dir.txt").read_text()
            == (tmp_path / "video.txt").read_text())
    # the JAX package's runner on the same folder
    import runpy
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setattr(sys, "argv", [
        "run_image_dir.py", img_dir, "--calib", calib, "--config", params,
        "--fps", "20", "--out", str(tmp_path / "jax.txt")])
    runpy.run_path(os.path.join(repo, "examples", "run_image_dir.py"),
                   run_name="__main__")
    jts, jpos = tev.load_trajectory_tum(str(tmp_path / "jax.txt"))
    ts, pos = tev.load_trajectory_tum(str(tmp_path / "dir.txt"))
    assert np.array_equal(ts, jts)
    assert np.abs(pos - jpos).max() <= 1e-3
