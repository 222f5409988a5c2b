"""The port's benchmark on one NVIDIA card: the counterpart of the
repository's ``bench.py``.

    python3 -m svo_pro_universal_tpu_torch.bench [--batch 8] [--no-slam]
        [--no-stages] [--no-ba] [--device cuda] [--frames 140] [--warmup 20]
        [--slam-frames 160] [--slam-warmup 16] [--ba-reps 24]

Prints ONE JSON line with bench.py's keys and definitions (bench.py:159-418):

- Mono VIO (``DevicePipelineVIO``) in bench.py's mono_vio_degraded_imagery
  configuration (``vio_config``) on its degraded sphere + plane scene
  (``testing.synthetic.bench_sequence``, degrade seed 7, a 200 Hz IMU).
  20 warm-up frames, then ``block()``; 120 timed frames in three chunks,
  each fed through ``add_images_batched`` in batches of ``--batch`` (the
  IMU first, up to the chunk's last frame) and ended by ``block()``.
  ``value`` is the overall frames/s (timed frames over the three chunks'
  wall time), ``fps_steady_state`` the best chunk's; both are 0 when fewer
  than 90% of the timed frames are TRACKING. ``vs_baseline`` is value / 20,
  the camera rate. ``ate_m`` (Sim3), ``ate_se3_m``, ``scale_error`` and
  ``traj_len_m`` come from the same run, from its first TRACKING frame.
- ``slam``: ``DevicePipelineSLAM`` with bench.py's SlamOptions
  (``slam_options``) on its closed loop (160 frames, 16 warm-up, degrade
  seed 11): frames/s over the timed frames' wall time, TRACKING count,
  ``slam_stats()``, Sim3 ATE and path length.
- ``stages_ms``: the mean host ms a call of each span of the VIO run's
  tracer (``utils.perf.Tracer``, started before its first frame, so the
  bootstrap's spans are there too): the stages as the run made them.
- ``ba_solve_ms`` and ``ba_iters_per_s``: bench.py's window
  (``synthetic_ba_window(S=8, 200 landmarks, L=256, No=1024, 120 a
  state)``, ``BAOptions(max_iter=3)``, focal 460), the mean of 24 solves
  timed by CUDA events after a warm-up.
- ``dcn_comms``: ``parallel.sharded_ba.comms_volume_per_solve(S=32,
  n_iter=4)``.

Beside bench.py's keys the line carries ``card`` (nvidia-smi's name and
power limit of the card), ``device``, ``opt_in`` (the backend's
``zupt_require_rest``, on as in chip_smoke.py) and ``launches`` (each CUDA
kernel's launches in the VIO and in the SLAM run, counted from 0 just
before each).

Unlike bench.py, a section that fails raises and the command exits non-zero:
there are no ``*_error`` fields. It runs on the card; ``--device cpu`` runs
the same code on the CPU (for the tests: its times are host times, never a
card's). Imports no JAX and reads no file outside the repository.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.cameras.projections import Camera
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.evaluation import ate_rmse
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    Stage, resolve_device)
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
from svo_pro_universal_tpu_torch.frontend.pipeline_slam import (
    DevicePipelineSLAM, SlamOptions)
from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
    DevicePipelineVIO)
from svo_pro_universal_tpu_torch.ops import _cuda
from svo_pro_universal_tpu_torch.parallel.sharded_ba import (
    comms_volume_per_solve)
from svo_pro_universal_tpu_torch.testing import synthetic as syn
from svo_pro_universal_tpu_torch.utils import perf
from svo_pro_universal_tpu_torch.utils.transform import SE3

VIO_FRAMES = 140                   # bench.py:186-187
VIO_WARMUP = 20
SLAM_FRAMES = syn.LOOP_FRAMES      # bench.py:310-311
SLAM_WARMUP = 16
FEED_BATCH = 8                     # bench.py:90 (SVO_BENCH_BATCH)
BASELINE_FPS = 20.0                # the EuRoC camera rate (bench.py:256)
TRACKING_SHARE = 0.9               # bench.py:250
BA_REPS = 24                       # bench.py:404
BA_WINDOW = dict(S=8, n_landmarks=200, L=256, No=1024, obs_per_state=120)
BA_ITERS = 3
BA_FOCAL = 460.0
DCN_SHAPE = dict(S=32, n_iter=4)   # bench.py:411

OPT_IN = {"zupt_require_rest": (
    "on: the port's fix of the reference's zero-velocity prior; without "
    "it the float64 window solve drags the moving window to rest (Sim3 "
    "ATE 0.448 m on this scene)")}

# the keys of the line: bench.py's, then the port's own
VIO_KEYS = ("metric", "value", "unit", "vs_baseline", "config", "feed_batch",
            "fps_steady_state", "fps_chunks", "backend_keyframes",
            "n_tracking", "depth_med_final", "ate_m", "ate_se3_m",
            "scale_error", "traj_len_m", "card", "device", "opt_in",
            "launches")
SLAM_KEYS = ("fps", "n_tracking", "n_keyframes", "n_loops_closed",
             "last_loop_to", "lc_db_size", "gm_landmarks", "lc_best_sim",
             "pgo_saturated", "lc_diag", "ate_m", "traj_len_m")
STAGE_KEYS = ("stages_ms",)
BA_KEYS = ("ba_solve_ms", "ba_iters_per_s", "dcn_comms")


def vio_config(cell_size: int = 30) -> Config:
    """bench.py:159-184, the mono_vio_degraded_imagery configuration
    (FivePoint initialization, the Config default), with the backend's
    ``zupt_require_rest`` on."""
    cfg = Config()
    cfg.capacity.max_fts = 360
    cfg.capacity.max_kfs = 8
    cfg.capacity.max_points = 4096
    cfg.n_pyr_levels = 4
    cfg.detector.cell_size = cell_size
    cfg.detector.threshold_primary = 8.0
    cfg.init.init_min_disparity = 20.0
    cfg.init.reproj_error_thresh = 1.0
    cfg.init.expected_avg_depth = 3.4
    cfg.init.init_min_features = 60
    cfg.init.init_min_tracked = 40
    cfg.init.init_min_inliers = 30
    cfg.depth_filter.seed_convergence_sigma2_thresh = 60.0
    cfg.base.quality_min_fts = 20
    cfg.base.kfselect_numkfs_lower_thresh = 60
    cfg.base.kfselect_min_disparity = 30.0
    cfg.base.kfselect_min_dist_metric = 0.1
    cfg.reprojector.max_n_features_per_frame = 200
    cfg.backend.num_keyframes = 5
    cfg.backend.max_iterations = 3
    # the port's opt-in fix of the reference's zero-velocity prior: with
    # the window solve stepping its states, bench.py's noise-free IMU reads
    # as stationary and the prior drags the moving window (the JAX package
    # with the same float64 solve: Sim3 ATE 0.4475 m on this scene,
    # reference_cpu.py)
    cfg.backend.zupt_require_rest = True
    return cfg


def slam_options() -> SlamOptions:
    """bench.py:314-316."""
    return SlamOptions(max_db_keyframes=128, max_nodes=128, gm_landmarks=384,
                       min_temporal_gap=6, min_similarity=0.75, min_inliers=15)


class VioRun:
    """DevicePipelineVIO (DevicePipelineSLAM given ``slam_opts``) on one
    device, with bench.py's IMU stream."""

    def __init__(self, cam: Camera, cfg: Config, imu_meas: list, device,
                 n_frames: int, slam_opts: SlamOptions | None = None):
        self.imu = ImuHandler(ImuParams())
        kw = dict(imu_handler=self.imu, imu_params=ImuParams(),
                  trace_capacity=n_frames + 1, device=device)
        if slam_opts is None:
            self.pipe = DevicePipelineVIO(cfg, cam, **kw)
        else:
            self.pipe = DevicePipelineSLAM(cfg, cam, slam_opts=slam_opts,
                                           **kw)
        self.imu_meas = imu_meas
        self.i_imu = 0

    def _imu_until(self, ts: float) -> None:
        while (self.i_imu < len(self.imu_meas)
               and self.imu_meas[self.i_imu][0] <= ts):
            self.imu.add_measurement(*self.imu_meas[self.i_imu])
            self.i_imu += 1

    def feed(self, frames: list, t0: int, t1: int, wall=None) -> None:
        """Frame by frame (bench.py:139-148 with a batch of 1): the IMU up
        to each frame's time, the frame, then ``block()``; with ``wall``,
        each frame's wall time is appended to it."""
        for t in range(t0, t1):
            ts = t * syn.CAM_DT
            self._imu_until(ts)
            c0 = time.perf_counter()
            self.pipe.add_image(frames[t], ts)
            self.pipe.block()
            if wall is not None:
                wall.append(time.perf_counter() - c0)

    def feed_batched(self, frames: list, t0: int, t1: int,
                     batch: int) -> None:
        """bench.py's ``Feeder.feed`` (bench.py:128-148): the IMU up to
        frame ``t1 - 1``, then the frames through ``add_images_batched``
        in batches of ``batch`` (``add_image`` each with a batch of 1).
        Nothing waits for the device."""
        self._imu_until((t1 - 1) * syn.CAM_DT)
        if batch <= 1:
            for t in range(t0, t1):
                self.pipe.add_image(frames[t], t * syn.CAM_DT)
            return
        for b0 in range(t0, t1, batch):
            b1 = min(b0 + batch, t1)
            self.pipe.add_images_batched(
                [frames[t] for t in range(b0, b1)],
                [t * syn.CAM_DT for t in range(b0, b1)])


def card_name(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card (raises where it
    cannot be read); ``cpu`` for a CPU run."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def host_ms(fn, reps: int) -> float:
    """Mean host-clock ms of ``fn`` after one warm-up call: the timer of a
    CPU run, where host time is the device's."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def cuda_event_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` on the card: one warm-up call, then CUDA events
    around each of ``reps`` calls, one synchronization at the end."""
    fn()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def timer_for(device: torch.device):
    return cuda_event_ms if device.type == "cuda" else host_ms


def kernel_launches() -> dict:
    return {k.name: k.launches for k in _cuda.KERNELS}


def trajectory_fields(mats: np.ndarray, meta: np.ndarray, poses: list,
                      se3: bool) -> dict:
    """bench.py:260-278 / :336-344: Sim3 ATE (with ``se3`` also the SE3
    ATE and the Sim3 scale error) and the path length, from the first
    TRACKING frame (frame 0 when none is, as bench.py's ``argmax``);
    ``poses`` are T_cam_world [4×4]."""
    ft = int(np.argmax(meta[:, 0].astype(int) == Stage.TRACKING.value))
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses[ft:]])
    ep = mats[ft:, :3, 3]
    rmse_sim3, a3 = ate_rmse(ep, gt, align="sim3")
    out = {"ate_m": round(float(rmse_sim3), 4)}
    if se3:
        rmse_se3, _ = ate_rmse(ep, gt, align="se3")
        out |= {"ate_se3_m": round(float(rmse_se3), 4),
                "scale_error": round(abs(float(a3.s) - 1.0), 4)}
    out["traj_len_m"] = round(float(np.linalg.norm(np.diff(gt, axis=0),
                                                   axis=-1).sum()), 2)
    return out


def vio_fields(meta: np.ndarray, warmup: int, chunk_fps: list, dt: float,
               batch: int) -> dict:
    """bench.py:241-258: throughput of the timed frames (``dt`` their
    wall time, ``chunk_fps`` each chunk's), 0 below 90% TRACKING."""
    n_timed = len(meta) - warmup
    stages = meta[warmup:, 0].astype(int)
    n_tracking = int((stages == Stage.TRACKING.value).sum())
    ok = n_tracking >= TRACKING_SHARE * n_timed
    fps_overall = n_timed / dt if ok else 0.0
    fps_steady = max(chunk_fps) if ok else 0.0
    return {"metric": "frontend_fps", "value": round(fps_overall, 2),
            "unit": "frames/s",
            "vs_baseline": round(fps_overall / BASELINE_FPS, 3),
            "config": "mono_vio_degraded_imagery", "feed_batch": batch,
            "fps_steady_state": round(fps_steady, 2),
            "fps_chunks": [round(f, 1) for f in chunk_fps],
            "n_tracking": n_tracking}


def vio_section(args, dev: torch.device) -> tuple[dict, VioRun]:
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    n, warmup = args.frames, args.warmup
    poses, frames, imu_meas = syn.bench_sequence(n, 7, dev)
    run = VioRun(cam, vio_config(), imu_meas, dev, n)
    if not args.no_stages:
        run.pipe.tracer.start()
    _cuda.reset_counts()
    run.feed_batched(frames, 0, warmup, args.batch)
    run.pipe.block()
    edges = [warmup + (n - warmup) * i // 3 for i in range(4)]
    chunk_fps = []
    t0 = time.perf_counter()
    for a, b in zip(edges[:-1], edges[1:]):
        tc = time.perf_counter()
        run.feed_batched(frames, a, b, args.batch)
        run.pipe.block()
        chunk_fps.append((b - a) / (time.perf_counter() - tc))
    dt = time.perf_counter() - t0
    launches = kernel_launches()
    mats, meta = run.pipe.drain()
    w = run.pipe.world
    out = vio_fields(meta, warmup, chunk_fps, dt, args.batch)
    out |= {"backend_keyframes": int(w.backend_k),
            "depth_med_final": round(float(w.depth_state[0]), 3)}
    return out | trajectory_fields(mats, meta, poses, se3=True) | {
        "launches": {"vio": launches}}, run


def slam_section(args, dev: torch.device) -> tuple[dict, dict]:
    """bench.py:291-350. Returns (the ``slam`` block, its launches)."""
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    n, warmup = args.slam_frames, args.slam_warmup
    poses, frames, imu_meas = syn.bench_sequence(
        n, syn.LOOP_DEGRADE_SEED, dev, twist_fn=syn.loop_twist)
    run = VioRun(cam, vio_config(), imu_meas, dev, n,
                 slam_opts=slam_options())
    _cuda.reset_counts()
    run.feed_batched(frames, 0, warmup, args.batch)
    run.pipe.block()
    t0 = time.perf_counter()
    run.feed_batched(frames, warmup, n, args.batch)
    run.pipe.block()
    dt = time.perf_counter() - t0
    launches = kernel_launches()
    mats, meta = run.pipe.drain()
    stages = meta[:, 0].astype(int)
    out = {"fps": round((n - warmup) / dt, 2),
           "n_tracking": int((stages[warmup:]
                              == Stage.TRACKING.value).sum()),
           **run.pipe.slam_stats()}
    return out | trajectory_fields(mats, meta, poses, se3=False), launches


def stages_section(pipe) -> dict:
    """bench.py:352-380's stage times: the mean ms a call of each span the
    VIO run's tracer recorded."""
    ms = perf.mean_ms(pipe.tracer.take())
    return {"stages_ms": {k: round(v, 3) for k, v in ms.items()}}


def ba_section(dev: torch.device, reps: int) -> dict:
    """bench.py:383-414: bench.py's window solved ``reps`` times."""
    w = syn.synthetic_ba_window(**BA_WINDOW, device=dev)
    opts = wba.BAOptions(max_iter=BA_ITERS)
    Tcb = SE3.identity(device=dev)
    focal = torch.tensor(BA_FOCAL, device=dev)
    ms = timer_for(dev)(lambda: wba.optimize(w, Tcb, focal, opts), reps)
    return {"ba_solve_ms": round(ms, 3),
            "ba_iters_per_s": round(BA_ITERS / (ms / 1e3), 1),
            "dcn_comms": comms_volume_per_solve(**DCN_SHAPE)}


def required_keys(args) -> list[str]:
    """The keys the line carries under ``args`` (``slam.<key>`` for the
    SLAM block's)."""
    keys = list(VIO_KEYS)
    if not args.no_slam:
        keys += ["slam"] + [f"slam.{k}" for k in SLAM_KEYS]
    if not args.no_stages:
        keys += list(STAGE_KEYS)
    if not args.no_ba:
        keys += list(BA_KEYS)
    return keys


def missing_keys(line: dict, args) -> list[str]:
    def has(key):
        d = line
        for part in key.split("."):
            if not isinstance(d, dict) or part not in d:
                return False
            d = d[part]
        return True
    return [k for k in required_keys(args) if not has(k)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m svo_pro_universal_tpu_torch.bench",
        description="The port's bench.py: one JSON line of mono-VIO and "
                    "SLAM throughput, accuracy, stage and BA times.")
    p.add_argument("--batch", type=int, default=FEED_BATCH,
                   help="frames per add_images_batched call (bench.py's "
                        "SVO_BENCH_BATCH)")
    p.add_argument("--no-slam", action="store_true",
                   help="skip the SLAM section (SVO_BENCH_SLAM=0)")
    p.add_argument("--no-stages", action="store_true",
                   help="skip stages_ms, and run the VIO section with its "
                        "tracer off (SVO_BENCH_STAGES=0)")
    p.add_argument("--no-ba", action="store_true",
                   help="skip ba_solve_ms / dcn_comms (SVO_BENCH_BA=0)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, default) or cpu")
    p.add_argument("--frames", type=int, default=VIO_FRAMES)
    p.add_argument("--warmup", type=int, default=VIO_WARMUP)
    p.add_argument("--slam-frames", type=int, default=SLAM_FRAMES)
    p.add_argument("--slam-warmup", type=int, default=SLAM_WARMUP)
    p.add_argument("--ba-reps", type=int, default=BA_REPS)
    args = p.parse_args(argv)
    if not (0 < args.warmup < args.frames
            and 0 < args.slam_warmup < args.slam_frames):
        p.error("need 0 < warmup < frames for both sections")
    return args


def main(argv=None) -> dict:
    """Run the sections, print the line, return it."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    out, run = vio_section(args, dev)
    out |= {"card": card_name(dev),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "opt_in": OPT_IN}
    if not args.no_slam:
        out["slam"], out["launches"]["slam"] = slam_section(args, dev)
    if not args.no_stages:
        out |= stages_section(run.pipe)
    if not args.no_ba:
        out |= ba_section(dev, args.ba_reps)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
