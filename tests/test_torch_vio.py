"""The port's mono VIO pipeline (DevicePipelineVIO, FivePoint init, window
backend) against the JAX package's, on the CPU, at 160×120 on the
sphere+plane scene of tests/test_device_pipeline_vio.py (``simulate_fast``:
10 Hz camera, 200 Hz IMU), over frames that cover initialization, backend
calls and marginalizations. The JAX run is made once per module.

- Stepwise: the JAX world before frame k is converted into the port (the JAX
  step's RANSAC noise injected on init frames) and both take one step on
  the same frame and IMU stream: same stage and keyframe decision,
  n_tracked within ±2, the backend's window count and keyframe clock equal;
  position ≤ 1 mm and rotation ≤ 0.05° on every frame, backend frames
  included, but the bootstrap frame. There the pose is a float32 eigh in
  JAX at a near-degenerate baseline: the test shows that the port's step
  with its nullspace in float32 too lands more than 5 mm from JAX's, and
  holds the port's (float64) step to 1 cm and 0.2°.
- Free run from the JAX world after the bootstrap: the same stage sequence
  to the end, positions within 5 mm up to and including the first frame
  whose keyframe decision or tracked-feature count differs from JAX's.
- Free run in segments: the same, but after a frame whose decisions differ
  the port restarts from the JAX world of the next frame; positions within
  5 mm on every frame whose decisions equal JAX's, to the end.
- ``convert`` round trip of a WorldStateVIO and of ImuParams.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.cameras.rig import ImuParams as JImuParams
from svo_pro_universal_tpu.frontend.frame_handler import Stage
from svo_pro_universal_tpu.frontend.imu_handler import ImuHandler as JImu
from svo_pro_universal_tpu.frontend.pipeline_vio import (
    DevicePipelineVIO as JaxVIO)
from svo_pro_universal_tpu.testing.synthetic import CAM
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.frontend import initialization as tinit
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
    DevicePipelineVIO)

from synthetic_utils import render_sphere_view
from test_device_pipeline_vio import simulate_fast
from test_pipeline_mono import make_config
from test_pipeline_vio import G_W
from test_torch_init import init_noise_of, _JaxNoise
from torch_parity_utils import (camera_dict, port_config, rotation_angle_deg,
                                to_dict)

DURATION = 3.2        # s: 33 frames: init, then ≥ 6 backend calls


def vio_config():
    """tests/test_device_pipeline_vio.py's config (FivePoint, a 5-state
    window, 3 LM iterations, quality gate 8)."""
    cfg = make_config()
    cfg.backend.num_keyframes = 5
    cfg.backend.max_iterations = 3
    cfg.base.quality_min_fts = 8
    return cfg


def _inputs():
    imu_stream, cam_poses, cam_ts = simulate_fast(duration=DURATION)
    frames = [np.clip(np.rint(np.asarray(render_sphere_view(T))), 0,
                      255).astype(np.uint8) for T in cam_poses]
    return imu_stream, frames, cam_ts, cam_poses


def _feed(handler, imu, imu_stream, frames, cam_ts, before=None):
    """Feed frames with the IMU up to each frame's time; ``before(k)`` runs
    just before frame k."""
    i_imu = 0
    for k, (img, ts) in enumerate(zip(frames, cam_ts)):
        while i_imu < len(imu_stream) and imu_stream[i_imu][0] <= ts:
            t, w, a = imu_stream[i_imu]
            imu.add_measurement(t, w, a)
            i_imu += 1
        if before is not None:
            before(k)
        handler.add_image(img, ts)


@pytest.fixture(scope="module")
def vio_run():
    imu_stream, frames, cam_ts, cam_poses = _inputs()
    cfg = vio_config()
    imu = JImu(JImuParams())
    h = JaxVIO(cfg, CAM, imu_handler=imu, imu_params=JImuParams(),
               trace_capacity=64, gravity=tuple(G_W))
    worlds, counts = [], []

    def before(k):
        worlds.append(to_dict(h.world))
        counts.append(h.frame_count)
    _feed(h, imu, imu_stream, frames, cam_ts, before=before)
    worlds.append(to_dict(h.world))
    counts.append(h.frame_count)
    mats, meta = h.drain()
    return dict(imu_stream=imu_stream, frames=frames, cam_ts=cam_ts,
                cam_poses=cam_poses, cfg=cfg, worlds=worlds, mats=mats,
                meta=meta, frame_counts=counts)


def _port(cfg):
    """The port's pipeline with the window solve's strict void rule: every
    backend call's window holds once-seen landmarks, and JAX's float32
    solve voids or keeps its state step by float32 rounding of their
    blocks, which the port's float64 solve does not reproduce."""
    imu = ImuHandler(ImuParams())
    pipe = DevicePipelineVIO(port_config(cfg),
                             convert.camera(camera_dict(CAM)),
                             imu_handler=imu, imu_params=ImuParams(),
                             trace_capacity=64, gravity=tuple(G_W),
                             device="cpu")
    pipe.backend.opts = pipe.backend.opts._replace(void_on_single_view=True)
    return pipe, imu


def test_vio_run_covers_the_path(vio_run):
    """The JAX reference run initializes, tracks, and slides its window."""
    stages = vio_run["meta"][:, 0].astype(int)
    first = int(np.argmax(stages == Stage.TRACKING.value))
    assert 0 < first < 10 and (stages[first:] == Stage.TRACKING.value).all()
    worlds = vio_run["worlds"]
    assert max(int(w["backend_k"]) for w in worlds) == 5   # window filled
    calls = sum(float(b["last_kf_ts"]) != float(a["last_kf_ts"])
                for a, b in zip(worlds, worlds[1:]))
    assert calls >= 6                         # so it marginalized


def _essential_from_8pt_float32(fr, fc):
    """``initialization._essential_from_8pt`` with its nullspace and
    projection in float32, as the JAX package computes them."""
    A = torch.cat([fc[..., 0:1] * fr, fc[..., 1:2] * fr,
                   fc[..., 2:3] * fr], dim=-1)
    _, vecs = torch.linalg.eigh(torch.einsum("hni,hnj->hij", A, A))
    E = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    U, _, Vt = torch.linalg.svd(E)
    return (U * (torch.arange(3) < 2).to(E.dtype)) @ Vt


def _jax_pose(worlds, k):
    """The pose JAX traced at frame k (its drained trace is rescaled later
    by every scale correction)."""
    jw = worlds[k + 1]
    return convert.SE3(*(torch.from_numpy(np.asarray(jw[f][k]))
                         for f in ("trace_q", "trace_t"))).as_matrix().numpy()


def _gap(pipe, worlds, k):
    """(position gap m, rotation gap °) of the port's frame k to JAX's."""
    T = pipe.world.last_frame.T_world_cam.as_matrix().numpy()
    Tj = _jax_pose(worlds, k)
    return (float(np.linalg.norm(T[:3, 3] - Tj[:3, 3])),
            rotation_angle_deg(T[:3, :3], Tj[:3, :3]))


def _decisions_equal(pipe, meta, k):
    """Frame k's stage, keyframe decision and tracked-feature count equal
    JAX's."""
    w = pipe.world
    m = w.trace_meta[w.trace_ptr - 1]
    return (w.stage == int(meta[k, 0]) and bool(m[2]) == bool(meta[k, 2])
            and int(m[1]) == int(meta[k, 1]))


def test_vio_stepwise_matches_jax(vio_run, monkeypatch):
    r = vio_run
    worlds, meta = r["worlds"], r["meta"]
    k_boot = int(np.argmax(meta[:, 0].astype(int) == Stage.TRACKING.value))
    pipe, imu = _port(r["cfg"])
    noise = _JaxNoise(pipe, lambda k: init_noise_of(worlds[k],
                                                    pipe.max_fts))

    def before(k):
        noise.frame = k
        pipe.world = convert.world_vio(worlds[k], "cpu")

    checked = []

    def after(k):
        w, jw = pipe.world, worlds[k + 1]
        assert w.stage == int(meta[k, 0]), k
        m = w.trace_meta[w.trace_ptr - 1]
        assert bool(m[2]) == bool(meta[k, 2]), k
        assert abs(int(m[1]) - int(meta[k, 1])) <= 2, (k, m[1], meta[k, 1])
        assert w.backend_k == int(jw["backend_k"]), k
        assert w.last_kf_ts == np.float32(jw["last_kf_ts"]), k
        backend_ran = float(jw["last_kf_ts"]) != float(
            worlds[k]["last_kf_ts"])
        pos_tol, ang_tol = (1e-2, 0.2) if k == k_boot else (1e-3, 0.05)
        gap, ang = _gap(pipe, worlds, k)
        checked.append((k, backend_ran, gap, ang))
        assert gap <= pos_tol and ang <= ang_tol, checked[-1]

    frames = r["frames"]
    i_imu = 0
    for k, (img, ts) in enumerate(zip(frames, r["cam_ts"])):
        while (i_imu < len(r["imu_stream"])
               and r["imu_stream"][i_imu][0] <= ts):
            imu.add_measurement(*r["imu_stream"][i_imu])
            i_imu += 1
        if k == k_boot:
            # the same step with a float32 nullspace: two float32 eigh
            # implementations (XLA's, LAPACK's) disagree here by more than
            # the 5 mm pipeline limit, which is why this frame gets 1 cm
            last_ts = pipe._last_ts
            before(k)
            with monkeypatch.context() as mp:
                mp.setattr(tinit, "_essential_from_8pt",
                           _essential_from_8pt_float32)
                pipe.add_image(img, ts)
            assert pipe.world.stage == Stage.TRACKING.value
            gap32, _ = _gap(pipe, worlds, k)
            assert gap32 > 5e-3, gap32
            pipe._last_ts = last_ts
        before(k)
        pipe.add_image(img, ts)
        after(k)
    assert sum(b for _, b, _, _ in checked) >= 6


def _free_run(r, k0):
    """(port pipeline, its IMU handler, the IMU samples after frame k0−1),
    the port holding the JAX world before frame k0."""
    pipe, imu = _port(r["cfg"])
    pipe.world = convert.world_vio(r["worlds"][k0], "cpu")
    pipe._t_epoch = r["cam_ts"][0]
    pipe._last_ts = r["cam_ts"][k0 - 1]
    for t, w, a in r["imu_stream"]:
        if t <= r["cam_ts"][k0 - 1]:
            imu.add_measurement(t, w, a)
    stream = [m for m in r["imu_stream"] if m[0] > r["cam_ts"][k0 - 1]]
    return pipe, imu, stream


def test_vio_free_run_matches_jax(vio_run):
    """From the JAX world just after the two-view bootstrap, the port runs
    the remaining frames on its own: tracking, keyframes, every backend
    call, marginalization and scale transfer. (The bootstrap itself is a
    float32 eigh near a degenerate baseline here, 48 inliers after a
    restart: JAX's and the port's float64 pose differ by ~0.1°/6 mm; the
    FivePoint free run from scratch is tests/test_torch_init.py's.) This
    scene tracks ~20–60 features, so once one feature or keyframe decision
    flips the two runs see different maps: positions are held up to that
    frame, the stages to the end."""
    r = vio_run
    stages = r["meta"][:, 0].astype(int)
    k0 = int(np.argmax(stages == Stage.TRACKING.value)) + 1
    pipe, imu, stream = _free_run(r, k0)
    _feed(pipe, imu, stream, r["frames"][k0:], r["cam_ts"][k0:])
    pmats, pmeta = pipe.drain()
    np.testing.assert_array_equal(pmeta[:, 0], r["meta"][:, 0])
    differ = np.flatnonzero((pmeta[k0:, 1] != r["meta"][k0:, 1])
                            | (pmeta[k0:, 2] != r["meta"][k0:, 2]))
    k_end = k0 + (int(differ[0]) + 1 if differ.size else len(pmeta))
    # the first flip (one tracked feature) comes 7 frames after the
    # bootstrap on this scene
    assert k_end - k0 >= 7, k_end
    gap = np.linalg.norm(pmats[:, :3, 3] - r["mats"][:, :3, 3], axis=-1)
    assert gap[:k_end].max() <= 5e-3, gap
    assert pipe.world.backend_k == int(r["worlds"][-1]["backend_k"])
    assert torch.isfinite(pipe.world.backend_chi2)


def test_vio_free_run_in_segments_matches_jax(vio_run):
    """The free run of :func:`test_vio_free_run_matches_jax` carried on to
    the end: after a frame whose keyframe decision or tracked-feature count
    differs from JAX's, the port restarts from the JAX world of the next
    frame. Every frame's stage equals JAX's, and every frame whose
    decisions equal JAX's is within 5 mm; most frames run free."""
    r = vio_run
    worlds, meta = r["worlds"], r["meta"]
    k0 = int(np.argmax(meta[:, 0].astype(int) == Stage.TRACKING.value)) + 1
    pipe, imu, stream = _free_run(r, k0)
    restart, restarts, gaps = False, [], []

    def before(i):
        if restart:
            pipe.world = convert.world_vio(worlds[k0 + i], "cpu")
            restarts.append(k0 + i)

    def step(k):
        nonlocal restart
        assert pipe.world.stage == int(meta[k, 0]), k
        restart = not _decisions_equal(pipe, meta, k)
        if not restart:
            gaps.append((k, _gap(pipe, worlds, k)[0]))
            assert gaps[-1][1] <= 5e-3, gaps[-1]

    i_imu = 0
    for i, (img, ts) in enumerate(zip(r["frames"][k0:], r["cam_ts"][k0:])):
        while i_imu < len(stream) and stream[i_imu][0] <= ts:
            imu.add_measurement(*stream[i_imu])
            i_imu += 1
        before(i)
        pipe.add_image(img, ts)
        step(k0 + i)
    n = len(meta) - k0
    assert len(gaps) >= n - 3 and len(restarts) <= 3, (gaps, restarts)


def test_vio_frame_count_matches_jax(vio_run):
    """frame_count after 2 frames through add_image and 2 through
    add_images_batched equals JAX's after as many frames."""
    r = vio_run
    pipe, imu = _port(r["cfg"])
    n = 4
    for t, w, a in r["imu_stream"]:
        if t <= r["cam_ts"][n - 1]:
            imu.add_measurement(t, w, a)
    for k in range(2):
        pipe.add_image(r["frames"][k], r["cam_ts"][k])
    pipe.add_images_batched(r["frames"][2:n], r["cam_ts"][2:n])
    assert pipe.frame_count == r["frame_counts"][n] == n
    assert pipe.world.trace_ptr == n


def test_vio_pipeline_defaults_to_the_card(monkeypatch):
    """Like the mono pipeline, DevicePipelineVIO runs on the card unless it
    is given a device: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(vio_config())
    cam = convert.camera(camera_dict(CAM))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePipelineVIO(cfg, cam, imu_handler=ImuHandler())
    pipe = DevicePipelineVIO(cfg, cam, imu_handler=ImuHandler(),
                             device="cpu")
    assert pipe.backend.device.type == "cpu"
    assert pipe.world.backend.window.q.device.type == "cpu"


def test_convert_round_trip_vio(vio_run):
    """JAX WorldStateVIO → port → numpy gives back the JAX arrays (integers
    as int32); host counters as scalars of the same value."""
    jw = vio_run["worlds"][-1]
    back = convert.to_numpy(convert.world_vio(jw, "cpu"))

    def check(a, b):
        if isinstance(b, dict):
            for k in b:
                check(a[k], b[k])
            return
        b = np.asarray(b)
        a = np.asarray(a)
        if b.ndim == 0:
            assert a == b
            return
        assert a.dtype == b.dtype and np.array_equal(a, b)

    for key in ("ring", "pool", "last_frame", "init_ref", "init_px",
                "backend", "imu_packed", "backend_chi2", "T_rel_prev",
                "depth_state"):
        check(back[key], jw[key])
    assert back["backend_k"] == int(jw["backend_k"])
    assert back["last_kf_ts"] == np.float32(jw["last_kf_ts"])
    assert back["rng"] is None
    jp = JImuParams(sigma_acc_c=0.02, imu_rate=400.0)
    assert convert.to_numpy(convert.imu_params(dataclasses.asdict(jp))) \
        == dataclasses.asdict(jp)
