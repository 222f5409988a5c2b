"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths on the card and checks them end to end:
``DevicePipelineMono`` (mono VO tracking, OneShot initialization),
``DevicePipelineVIO`` (FivePoint initialization, IMU, window backend: the
configuration bench.py drives), ``DevicePipelineSLAM`` (the same VIO plus
loop closing, pose graph and global map: bench.py's second section) and the
multi-camera pipelines (stereo VO, stereo VIO, a 3-camera array), then the
host handlers a user calls (``FrameHandlerMono`` / ``VIO`` / ``Stereo`` /
``Array`` / ``SLAM``: ``add_image`` returns a ``FrameResult``) and the host
backends (``BackendInterface``, ``GlobalMap``), then the entry points a user
starts from (the EuRoC runners on ASL folders at EuRoC-epoch stamps,
checkpoints), every detector and the edge-depth ops, all at EuRoC size,
752×480, with the capacities of bench.py:159-184, and last the sharded
programs of ``parallel/`` on four ranks sharing the card. Phases, one JSON
line each:

1. device   the card (nvidia-smi name and power limit), torch and CUDA.
2. build    every csrc/*.cu compiled with nvcc for sm_90a, in parallel.
3. kernels  each CUDA kernel against its plain PyTorch version on the card
            at the shapes the tracking step gives it: CUDA-event times
            (median), the byte/operation bound, and one PyTorch library call
            for the gathers. The gathers: each extract_tiles /
            extract_tiles_ring call (tile origins computed in the kernel)
            and each origins-given call at the ten path shapes, equal to
            the plain versions, timed by gather_bench.py in a subprocess
            (the ring also with a cold L2), exactly one CUDA kernel per call
            in its torch.profiler traces, gated, and the device ms per
            launch; then NaN/inf/huge/.5/border centres,
            levels and slots out of range, int32 indices and N = 0 on both
            copy routes (TMA at 752 wide, plain loads at 754 and for
            10×10 tiles). align_level
            runs on two rendered views of the
            plane (levels 4..2, each level from the same inputs for both)
            through five camera models (EuRoC's pinhole + radtan among
            them) with the prior and alpha/beta off and on (N = 360), two
            pairs of cameras on one body (one the EuRoC stereo rig), and
            N = 768: pose within 1e-4 rad / 1e-4·depth, n_tracked equal.
            fused_evaluate also at N = 90, one rank's share of the
            multidevice alignment (the shape the kernels line reports).
4. slice    40 frames of a textured plane: TRACKING from frame 0 on,
            n_tracked ≥ quality_min_fts, ≥ 2 keyframes, the gathers
            launched on the path and align_level once per pyramid level of
            every sparse alignment, the standalone fused_evaluate not at
            all (counts reset just before the run); frames/s and per-stage
            ms (CUDA events).
   profile  2 frames under torch.profiler: device busy ms and kernel
            launches per frame, idle share, host syncs per frame.
5. cpu      the same first frames through the port on the CPU; the poses
            must agree with the card's within 5 mm.
6. vio      ``DevicePipelineVIO`` (FivePoint init, window backend, 200 Hz
            IMU) in bench.py's mono_vio_degraded_imagery configuration on
            its degraded sphere scene (bench.py:159-222), with the backend's
            opt-in ``zupt_require_rest`` (see ``vio_config``): 20 warm-up and
            120 timed frames; fps overall / steady (best of three chunks),
            median frame ms, per-stage and backend ms per call (CUDA
            events), accuracy (Sim3/SE3 ATE, scale error), the share of
            window LM iterations whose state step was voided, and peak
            memory. Gates: TRACKING on ≥ 90% of the timed frames and within
            the warm-up, backend ≥ 2 states with finite chi2 > 0, Sim3 ATE
            < 0.15 × path, gather_tiles launched in the bootstrap frames,
            align_level once per level of every sparse alignment and
            fused_evaluate never.
   determinism  the first 40 frames again in a second pipeline: the pose
            trace must equal the first run's to the bit.
   vio_profile  2 frames, the second a backend call, as the profile phase.
   vio_cpu  the same frames through the bootstrap + 2 on the CPU: the same
            stages and poses within 5 mm of a card run.
7. slam     ``DevicePipelineSLAM`` in bench.py's SLAM configuration
            (bench.py:291-350: the vio configuration, SlamOptions with 128
            database keyframes and nodes, 384 global landmarks) on its
            closed loop (64-frame laps, 160 frames, 16 warm-up, degrade
            seed 11): fps (timed frames over their wall time), slam_stats,
            Sim3 ATE, stage ms per call of the SLAM step, verification and
            pose-graph optimization (CUDA events), launches, peak memory.
            Gates (tests/test_device_pipeline_slam.py:96-123): TRACKING on
            ≥ 90% of the timed frames, ≥ 20 global landmarks, backend ≥ 2
            states with a finite chi2, Sim3 ATE < 0.15 × path, the gathers
            launched and align_level once per level of every sparse
            alignment, fused_evaluate never. Its "≥ 1 verified loop" is
            recorded (``loop_gate_passed``), not held: the JAX package on
            the CPU closes no loop on this scene either (JAX_SLAM_CPU).
   slam_loop_parts  the run's first verification again on the card and on
            the CPU (match and inlier counts equal, translation within
            1e-3), and a loop closure of the run's final pose graph
            (128-node capacity) on both: nodes within 1e-3, ms per call.
   slam_profile  2 frames around the first verified loop, else the first
            verification, in a second run: device busy ms, launches, idle
            share, and the port's stream synchronizations per frame from
            the profiler's own trace (no sync debug mode in the window).

8. stereo   ``DevicePipelineStereo`` on the EuRoC stereo rig
            (examples/param/euroc_stereo.yaml: both pinhole + radtan cameras,
            body at cam0, a 0.110 m baseline) in ``stereo_config``: bench.py's
            scene along its twist, each view rendered through its own camera
            and degraded with its own seed (7, 8), 20 warm-up and 120 timed
            frames; fps, per-stage ms (CUDA events, ``_stereo_triangulate``
            included), the landmarks and gather launches of each keyframe
            triangulation, metric unaligned and SE3 ATE, launches, peak
            memory. Gates (tests/test_device_pipeline_stereo.py:38-48):
            TRACKING by frame 1 and on ≥ 90% of the timed frames, ≥ 2
            keyframes, unaligned ATE < 0.15 × path, gather_tiles launched in
            every triangulation, align_level once per level of every sparse
            alignment (on cam0 alone), fused_evaluate never.
   stereo_cpu  the bootstrap + 3 tracking frames on the CPU: the same
            stages, positions within 5 mm of the card's.
   stereo_joint  the first 60 frames with ``joint_alignment``: the same
            gates, every sparse alignment on both cameras (one align_level
            launch a level carrying both).
   stereo_vio  ``DevicePipelineStereoVIO`` on the same views plus bench.py's
            200 Hz IMU (5-state window, 3 LM iterations, the opt-in
            ``zupt_require_rest``, the window's state steps voided as the
            JAX package's float32 solve voids them here: see
            ``STEREO_VIO_SOLVE``): as stereo, plus backend ms per call and
            the voided share; gated also on backend ≥ 2 states with a finite
            chi2 > 0 (tests/test_device_pipeline_stereo_vio.py:58-75).
   stereo_vio_profile  2 frames holding a backend call, as vio_profile.
   array    ``DevicePipelineArray``: three copies of EuRoC's cam0 in
            tests/test_pipeline_array.py's layout (+0.11 m in x, +0.09 m in
            y), degrade seeds 7, 8, 9, 60 frames, 10 warm-up; the stereo
            gates, and TRACKING on every frame from the first
            (tests/test_device_pipeline_array.py:34-44).
9. host phases (the handlers' one read a frame is ``host_reads``):
   host_mono  ``FrameHandlerMono`` on the slice's 40 frames: the slice's
            gates, stages and keyframes equal to the slice's
            ``DevicePipelineMono`` and every pose within 1e-4 m of it.
   stage_profile  the trace tool ``utils.stage_profile.profile_frontend``
            (CUDA events, 4 calls a stage) on host_mono's live state, and
            ``roofline_summary``: every stage's ms finite and positive.
   host_vio  ``FrameHandlerVIO`` on the vio phase's first 80 frames and its
            configuration (the IMU through ``add_imu_measurement``, the
            backend's host
            API ``add_keyframe_device`` on every keyframe): the vio gates
            (TRACKING on ≥ 90% of the timed frames and within the warm-up,
            backend ≥ 2 states with a finite chi2 > 0, Sim3 ATE < 0.15 ×
            path, gathers in the bootstrap frames, align_level 3 per
            alignment), fps, stage and backend ms, host reads a frame.
   host_vio_cpu  the bootstrap + 2 frames on the CPU: the same stages,
            positions within 5 mm of the card's.
   host_slam  ``FrameHandlerSLAM`` (mono, loop closing with slam_options()'s
            thresholds, pose graph, the default global map) on the slam
            phase's input: TRACKING on ≥ 90% of the timed frames, a global
            solve with a finite chi2, Sim3 ATE < 0.15 × path, the launch
            gates; ≥ 6 nodes, ≥ 6 global states and ≥ 1 loop recorded, not
            held (the JAX package on the CPU: 4, 4 and 0; JAX_HOST_SLAM_CPU).
   host_stereo, host_array  ``FrameHandlerStereo`` on the stereo phase's
            first 60 views and ``FrameHandlerArray`` on the array's first
            40 (10 warm-up): TRACKING by frame 1 and at the end, unaligned
            ATE < 0.15 × path, stereo's path scale within 0.85–1.18
            (tests/test_pipeline_stereo.py:50-63, test_pipeline_array.py
            :46-54), every alignment on every camera, gathers in every
            triangulation, the launch gates.
   host_backends  ``BackendInterface`` (tests/test_backend_interface.py's
            window) and ``GlobalMap`` (tests/test_global_map.py's
            absorb-and-evict input, 40 keyframes through an 8-state ring)
            on the card and on the CPU: chi2, poses and landmarks within
            1e-3.
   checkpoint  ``FrameHandlerMono`` on host_mono's input: 20 frames,
            ``io.save_state``, a new handler, ``load_state``, 20 frames:
            equal to host_mono's uninterrupted 40 to the bit.
10. entry points (the runners' ``main`` called in-process; the PNG decoder
            chosen once, ``png_decoder``: native when the C++ compiler
            builds it with zlib, else numpy, printed):
   euroc, euroc_device  the vio phase's first 80 frames written as an ASL
            folder at EuRoC-epoch ns stamps (1403636579763555584 on) with
            a calibration of bench.py's camera and IMU, through
            ``run_euroc_vio.main`` with the vio configuration and
            ``--results-dir``: the host ``FrameHandlerVIO`` and
            ``--device-pipeline``; the vio gates (the Sim3 ATE from the
            rpg summary), the TUM file equal to the poses returned, read ms
            a frame; for the host run, its ATE and gap beside host_vio's
            same frames at session stamps and the JAX package's on the CPU
            at both, recorded.
   euroc_mono  ``run_euroc_mono.main`` with examples/param/pinhole.yaml and
            ``--trace-dir`` on the folder's first 60 frames: TRACKING within
            the warm-up, a tracefile row a frame, the TUM file, the launch
            gates; TRACKING after the bootstrap and the ATE are recorded
            beside the JAX package's on the CPU (JAX_EUROC_MONO_CPU).
   euroc_stereo  the rig input's first 40 frames as cam0/cam1 through
            ``run_euroc_stereo.main`` (examples/param/euroc_stereo.yaml,
            body at the IMU, and pinhole.yaml): host_stereo's gates on the
            motion relative to the first frame.
   detectors  every ``detector_type`` on bench.py's first frame, card
            against CPU (the same cells, pixels, levels, types; scores
            within 1e-4), card ms each; ``FrameHandlerMono`` with
            ``shitomasi_grad`` on host_mono's first 20 frames, TRACKING on
            every frame, the launch gates.
   edge_depth  ``detect_edges`` on bench.py's first frame and
            ``refine_depth_photometric`` of its 512 strongest edge pixels
            into the second, card against CPU (levels, response 1e-3,
            converged sets, depths 1e-3), one gather_tiles launch per GN
            iteration.
11. multidevice  one spawn of four ranks sharing the card
            (``parallel.mesh.launch``; gloo, since NCCL refuses two ranks on
            one device), each step against the one-rank result this process
            computes on the card: ``distributed_align`` of the vio
            configuration's last alignment after 12 frames (90 features a
            rank; pose within 1e-5, exactly levels × (max_iter + 1)
            fused_evaluate launches a rank, gather_tiles launched);
            ``distributed_seed_update`` of bench.py's first frame's 360
            features against its second frame at the true pose (ftype and
            counts equal, state within 1e-5 relative);
            ``distributed_optimize`` of bench.py's BA window (8 states, 256
            landmark slots, 2048 rows: its 1024 drop rows over 4 shards),
            perturbed
            (p, q within 2e-4, chi2 2%, no row dropped, the counted bytes
            equal to ``comms_volume_per_solve``; bench.py's ba_solve_ms and
            ba_iters_per_s of one rank); ``GlobalMap(mesh=...)`` at the
            default capacities fed 40 keyframes on (2, 2) over (h, f) and
            (4, 1) over (h,) (poses, landmarks 1e-3 of one rank, chi2 2%,
            no row dropped, mean position error < 0.03 m; one rank's run on
            the CPU printed beside it); the dry run;
            the alignment and BA again in the same ranks (equal to the bit,
            gated; the seed state's bit-equality with one rank recorded).
            Four ranks on one card measure correctness and bytes, not
            scale-out.

The ``kernels`` line's ``launches`` are the vio run's, counted from 0 just
before it (``launches_mono_slice``: the slice run's; ``launches_slam``,
``launches_stereo``, ``launches_stereo_vio``, ``launches_array``,
``launches_host_mono``, ``launches_host_vio``, ``launches_host_slam``,
``launches_host_stereo``, ``launches_host_array``, ``launches_checkpoint``,
``launches_euroc``, ``launches_euroc_device``, ``launches_euroc_mono``,
``launches_euroc_stereo``, ``launches_detectors``,
``launches_edge_depth``: those runs'; ``launches_multidevice``: the
multidevice steps', summed over the ranks).
``python3 chip_smoke.py --only host_vio,euroc,detectors,...`` runs just the
named host and entry-point phases (host_mono, checkpoint, host_vio,
host_vio_epoch, host_slam, host_stereo, host_array, host_backends, euroc,
euroc_mono, euroc_stereo, detectors, edge_depth, multidevice) after the
build (a
development call: no kernels or result line; ``host_vio_epoch``, host_vio
at EuRoC-epoch stamps, and ``epoch_effect``, its gap to host_vio a frame,
run only there).
The line before the last is the ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from svo_pro_universal_tpu_torch import io as sio
from svo_pro_universal_tpu_torch import native_loader
from svo_pro_universal_tpu_torch.backend import loop_closing as lc_mod
from svo_pro_universal_tpu_torch.backend import pgo as pgo_mod
from svo_pro_universal_tpu_torch.backend.global_map import (
    GlobalMap, GlobalMapOptions)
from svo_pro_universal_tpu_torch.backend.interface import BackendInterface
from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.backend.window_ba import BAOptions
from svo_pro_universal_tpu_torch.cameras.projections import (
    Camera, DistortionModel, ProjectionModel)
from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams, load_rig_yaml
from svo_pro_universal_tpu_torch.common import seed as seed_mod
from svo_pro_universal_tpu_torch.common.types import FeatureType
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.evaluation import (
    ate_rmse, load_trajectory_tum)
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerArray, FrameHandlerMono, FrameHandlerStereo, FrameHandlerVIO,
    Stage)
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
from svo_pro_universal_tpu_torch.frontend.pipeline import DevicePipelineMono
from svo_pro_universal_tpu_torch.frontend.pipeline_array import (
    DevicePipelineArray)
from svo_pro_universal_tpu_torch.frontend.pipeline_slam import (
    DevicePipelineSLAM, SlamOptions)
from svo_pro_universal_tpu_torch.frontend.pipeline_stereo import (
    DevicePipelineStereo)
from svo_pro_universal_tpu_torch.frontend.pipeline_stereo_vio import (
    DevicePipelineStereoVIO)
from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
    DevicePipelineVIO)
from svo_pro_universal_tpu_torch.frontend.slam import FrameHandlerSLAM
from svo_pro_universal_tpu_torch.ops import _cuda, cuda_align, cuda_tiles
from svo_pro_universal_tpu_torch.ops import depth_filter as df_mod
from svo_pro_universal_tpu_torch.ops import detector as det_mod
from svo_pro_universal_tpu_torch.ops import edge_depth, interp
from svo_pro_universal_tpu_torch.ops import matcher as matcher_mod
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.ops import tiles
from svo_pro_universal_tpu_torch.ops.pyramid import (
    build_pyramid, image_to_float, level_view)
from svo_pro_universal_tpu_torch.parallel.mesh import choose_backend, launch
from svo_pro_universal_tpu_torch.parallel.sharded_ba import (
    comms_volume_per_solve, partition_observations)
from svo_pro_universal_tpu_torch.runners import (
    run_euroc_mono, run_euroc_stereo, run_euroc_vio)
from svo_pro_universal_tpu_torch.testing import asl
from svo_pro_universal_tpu_torch.testing import gather_shapes as gs
from svo_pro_universal_tpu_torch.testing.parallel_cases import (
    global_map_step, run_steps)
from svo_pro_universal_tpu_torch.testing import synthetic as syn
from svo_pro_universal_tpu_torch.utils import stage_profile
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, matrix_to_quat, se3_exp)

ROOT = Path(__file__).resolve().parent
W, H = 752, 480
INTR = (460.0, 460.0, 376.0, 240.0)
PLANE_Z = 2.5
N_FRAMES = 40
N_CPU_FRAMES = 5
POSE_TOL_M = 5e-3
ALIGN_ROT_TOL = 1e-4       # rad, align_level vs its plain version
ALIGN_TRANS_TOL = 1e-4     # × depth

# peak rates by card name (NVIDIA data sheets; dense, no sparsity)
_BANDWIDTH = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
_DEFAULT_BANDWIDTH = 3.35e12       # H100 SXM, 80 GB HBM3
_FP32_FLOPS = 67e12


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = obj | {"t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bandwidth(name: str) -> float:
    for key, bw in _BANDWIDTH.items():
        if key in name:
            return bw
    return _DEFAULT_BANDWIDTH


def euroc_config() -> Config:
    """bench.py:159-182 capacities with OneShot at the plane's depth."""
    cfg = Config()
    cfg.capacity.max_fts = 360
    cfg.capacity.max_kfs = 8
    cfg.capacity.max_points = 4096
    cfg.n_pyr_levels = 4
    cfg.detector.cell_size = 30
    cfg.detector.detector_type = "fast_grad"
    cfg.detector.threshold_primary = 8.0
    cfg.init.init_method = "OneShot"
    cfg.init.expected_avg_depth = PLANE_Z
    cfg.init.init_min_features = 60
    cfg.depth_filter.seed_convergence_sigma2_thresh = 60.0
    cfg.base.quality_min_fts = 20
    cfg.base.kfselect_numkfs_lower_thresh = 60
    cfg.base.kfselect_min_disparity = 30.0
    cfg.base.kfselect_min_dist_metric = 0.1
    cfg.reprojector.max_n_features_per_frame = 200
    # bench.py keeps the default upper bound of 120 tracked features for a
    # new keyframe; the textured plane here keeps all 200 reprojected
    # features in view, so the bound is lifted above the reprojector's cap
    # and the disparity / distance gates above decide
    cfg.base.kfselect_numkfs_upper_thresh = 250
    return cfg


def gt_pose(t: int) -> np.ndarray:
    """T_cam_world: 1.2 cm/frame sideways (≈2.2 px at 2.5 m) with a wobble."""
    return syn.pose(0.012 * t, 0.004 * np.sin(0.2 * t), 0.002 * t,
                    0.003 * np.sin(0.15 * t), 0.0004 * t,
                    0.001 * np.sin(0.1 * t))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gather_bytes(n: int, R: int, T: int, ring: bool, centres: bool,
                 idx_bytes: int = 8) -> int:
    """Bytes a tile gather must move: each tile read once and written once,
    each index at its width (int64 on the path); in centres mode the float32
    centres in and the four int64 origin vectors out, else the given
    (level, y0, x0) in."""
    nbytes = 2 * n * R * T * 4
    if centres:
        return nbytes + n * (2 * 4 + idx_bytes * (1 + ring) + 4 * 8)
    return nbytes + n * idx_bytes * (3 + ring)


def bench_gathers() -> list[dict]:
    """gather_bench.py's rows for this tree, from a subprocess, so that the
    profiler sessions it needs stay out of this process (one may slow the
    process's later launches, and the slice is timed later)."""
    root = Path(__file__).resolve().parent
    run = subprocess.run([sys.executable, str(root / "gather_bench.py")],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    if run.returncode != 0:
        fail(f"gather_bench.py failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])["shapes"]


def gather_cases(bw: float, cases: list) -> dict:
    """Both gathers at the eleven shapes of the path, on gather_bench.py's
    inputs (gather_shapes.path_inputs, same seed): one extract_tiles /
    extract_tiles_ring call (centres mode) against extract_tiles_plain and
    the origins-given gather against gather_tiles_plain, torch.equal; the
    plain versions and the
    advanced-indexing library call timed here, the calls themselves by
    gather_bench.py, whose torch.profiler traces gate exactly one CUDA
    kernel per call. Then every edge case of syn.tile_case on both copy
    routes (752 wide: TMA for tiles of 12, 24 and 40; 754 wide, and 10×10
    tiles: plain loads). Returns the representative case of each kernel."""
    bench = bench_gathers()
    dev = torch.device("cuda")
    pyr, ring, shapes = gs.path_inputs(0, dev)
    if len(bench) != len(shapes):
        fail(f"gather_bench.py gave {len(bench)} rows for {len(shapes)} "
             "shapes")
    main = {}
    for (name, n, R, where, lvl, kf, cyx), row in zip(shapes, bench):
        label = f"{name} N={n} {R}x{R}"
        if (row["name"], row["n"], row["tile"]) != (name, n, [R, R]):
            fail(f"{label}: gather_bench row {row}")
        if row["kernels_one_call"] != 1 or row["kernels_per_call"] != 1:
            fail(f"{label}: {row['kernels_one_call']} CUDA kernels in a "
                 f"one-call trace, {row['kernels_per_call']} a call over "
                 "20 calls; expected exactly 1")
        is_ring = name == "gather_tiles_ring"
        call, given = gs.shape_calls(tiles, cuda_tiles, pyr, ring, name, R,
                                     lvl, kf, cyx)
        src = ring if is_ring else pyr
        if is_ring:
            plain = lambda: cuda_tiles.extract_tiles_ring_plain(  # noqa: E731
                ring, kf, lvl, cyx, R, R)
        else:
            plain = lambda: cuda_tiles.extract_tiles_plain(  # noqa: E731
                pyr, lvl, cyx, R, R)
        got, want = call(), plain()
        y0, x0 = want[1], want[2]
        if is_ring:
            given_plain = lambda: cuda_tiles.gather_tiles_ring_plain(  # noqa
                ring, kf, lvl, y0, x0, R, R)
            idx = (kf[:, None, None], lvl[:, None, None])
        else:
            given_plain = lambda: cuda_tiles.gather_tiles_plain(  # noqa: E731
                pyr, lvl, y0, x0, R, R)
            idx = (lvl[:, None, None],)
        rows = y0[:, None, None] + torch.arange(R, device=dev)[None, :, None]
        cols = x0[:, None, None] + torch.arange(R, device=dev)[None, None, :]
        library = lambda: src[idx + (rows, cols)]  # noqa: E731
        g = given()
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(got, want))
                and torch.equal(g, want[0])):
            fail(f"{label}: kernel differs from plain version")
        case = dict(
            name=name, n=n, tile=[R, R], where=where,
            copy_route="tma" if cuda_tiles.tma_route(src, R, R) else "lsu",
            max_abs_err=float((got[0] - want[0]).abs().max()),
            ms=row["call_ms"], plain_ms=gs.cuda_ms(plain),
            origins_given_ms=row["given_ms"],
            origins_given_plain_ms=gs.cuda_ms(given_plain),
            library_ms=gs.cuda_ms(library),
            device_ms=row["device_ms"],
            origins_given_device_ms=row["given_device_ms"],
            **{k: row[k] for k in ("kernels_one_call", "kernels_per_call",
                                   "call_device_ms", "gather_kernels")},
            bound_ms=gather_bytes(n, R, R, is_ring, True) / bw * 1e3,
            origins_given_bound_ms=gather_bytes(n, R, R, is_ring, False)
            / bw * 1e3,
            old_bound_ms=(2 * n * R * R * 4 + n * (3 + is_ring) * 4)
            / bw * 1e3,
            bound_by="bytes")
        if is_ring:
            case |= dict(cold_ms=row["cold_call_ms"],
                         cold_origins_given_ms=row["cold_given_ms"],
                         cold_library_ms=gs.cold_ms(library))
        cases.append(case)
        main.setdefault(name, {})[(n, R)] = case
    edge = {}
    rng = np.random.default_rng(0)
    for width in (W, W + 2):
        e_pyr = torch.rand((gs.L, H, width), device=dev) * 255
        e_ring = torch.rand((gs.K, gs.L, H, width), device=dev) * 255
        routes = {R: "tma" if cuda_tiles.tma_route(e_pyr, R, R) else "lsu"
                  for R in syn.TILE_SIZES}
        bad = syn.tile_gather_mismatches(e_pyr, e_ring, rng)
        torch.cuda.synchronize()
        if bad or any((v == "tma") != (width == W and R % 4 == 0)
                      for R, v in routes.items()):
            fail(f"gather edge cases at width {width}: routes {routes}, "
                 f"mismatches {bad[:10]}")
        edge[width] = routes
        del e_ring
    cases.append(dict(name="gather_edge_cases", routes=edge,
                      cases=list(syn.TILE_CASES) + ["nonfinite"],
                      all_equal=True))
    return {"gather_tiles": main["gather_tiles"][(360, 24)],
            "gather_tiles_ring": main["gather_tiles_ring"][(768, 24)]}


def kernel_cases(bw: float) -> tuple[list, dict]:
    dev = torch.device("cuda")
    cases: list = []
    main = gather_cases(bw, cases)
    rng = np.random.default_rng(1)

    # kernel 3 at the sparse-alignment shapes, plus exact-integer origins
    n, R, T, P = 360, 24, 24, 4
    tile_data = torch.as_tensor(rng.uniform(0, 255, (n, R, T))
                                .astype(np.float32), device=dev)
    ref = torch.as_tensor(rng.uniform(0, 255, (n, P * P))
                          .astype(np.float32), device=dev)
    jac = torch.as_tensor(rng.normal(0, 1, (n, P * P, 8))
                          .astype(np.float32), device=dev)
    w = torch.as_tensor((rng.uniform(size=n) > 0.3).astype(np.float32),
                        device=dev)
    ab = torch.tensor([0.03, -1.5], device=dev)
    def fe_case(label: str, m: int, ty, tx) -> None:
        ty = torch.as_tensor(ty.astype(np.float32), device=dev)
        tx = torch.as_tensor(tx.astype(np.float32), device=dev)
        args = (tile_data[:m], ty, tx, w[:m], ref[:m], jac[:m], ab, P)
        run = lambda: cuda_align.fused_evaluate(*args)  # noqa: E731
        plain = lambda: cuda_align.fused_evaluate_plain(*args)  # noqa: E731
        Hk, gk, ck, nk = run()
        Hp, gp, cp, np_ = plain()
        torch.cuda.synchronize()
        ok = (torch.allclose(Hk, Hp, rtol=2e-5, atol=1e-2)
              and torch.allclose(gk, gp, rtol=2e-4, atol=0.5)
              and abs(float(ck) - float(cp)) <= max(2e-4 * abs(float(cp)),
                                                    1.0)
              and float(nk) == float(np_))
        err = max(float((Hk - Hp).abs().max()), float((gk - gp).abs().max()),
                  abs(float(ck) - float(cp)), abs(float(nk) - float(np_)))
        if not ok:
            fail(f"fused_evaluate ({label}, N={m}): kernel vs plain error "
                 f"{err}")
        nbytes = m * ((P + 1) ** 2 + 3 + P * P * 9) * 4 + 74 * 4 + 8
        flops = m * P * P * (6 + 3 + 2 * 64 + 2 * 8 + 3)
        bound = max(nbytes / bw, flops / _FP32_FLOPS) * 1e3
        cases.append(dict(
            name="fused_evaluate", n=m, tile=[R, T], origins=label,
            max_abs_err=err, ms=gs.cuda_ms(run), plain_ms=gs.cuda_ms(plain),
            library_ms=None, bound_ms=bound,
            bound_by="bytes" if nbytes / bw >= flops / _FP32_FLOPS
            else "operations"))

    fe_case("fractional", n, rng.uniform(0.0, R - P - 1.0, n),
            rng.uniform(0.0, T - P - 1.0, n))
    fe_case("integer", n, np.full(n, float(R - P)), np.full(n, float(T - P)))
    # the multidevice path's shape: one rank's 90 of the 360 features
    m = 360 // MD_RANKS
    fe_case("fractional", m, rng.uniform(0.0, R - P - 1.0, m),
            rng.uniform(0.0, T - P - 1.0, m))
    # the representative shape of each kernel on its path (fused_evaluate:
    # the multidevice path's)
    main["fused_evaluate"] = cases[-1]
    main["align_level"] = align_cases(bw, cases)
    return cases, main


ALIGN_CAMERAS = {
    "pinhole": lambda: Camera.pinhole(*INTR, W, H),
    # EuRoC's cameras (examples/param/euroc_stereo.yaml): pinhole + radtan
    "pinhole_radtan": lambda: syn.euroc_stereo_rig()[0][0],
    "euroc_cam1": lambda: syn.euroc_stereo_rig()[0][1],
    "fisheye_equidistant": lambda: Camera(
        ProjectionModel.FISHEYE_EQUIDISTANT, DistortionModel.EQUIDISTANT,
        [300.0, 300.0, 376.0, 240.0], [0.02, -0.01, 0.003, -0.001], W, H),
    "omni_radtan": lambda: Camera(
        ProjectionModel.OMNI, DistortionModel.RADTAN,
        [874.0, 874.0, 376.0, 240.0], [-0.05, 0.01, 0.001, -0.001, 0.9], W,
        H),
    "pinhole_atan": lambda: Camera.pinhole(
        *INTR, W, H, distortion=DistortionModel.ATAN, dist_params=[0.9]),
}


# (label, [(camera, T_cam_body or None)], prior and alpha/beta on, grid):
# every camera model with the extras off and on, two cameras on one body
# (the EuRoC stereo rig among them, body at cam0, as the stereo pipelines'
# joint alignment gives it), and N = 768, beyond the 560 features the
# cluster stages
ALIGN_CASES = [
    (name, [(name, None)], extras, (24, 15))
    for name in ("pinhole", "fisheye_equidistant", "omni_radtan",
                 "pinhole_atan", "pinhole_radtan")
    for extras in (False, True)] + [
    ("pinhole+fisheye_equidistant", [
        ("pinhole", None),
        ("fisheye_equidistant", syn.pose(0.1, 0.0, 0.0, 0.0, 0.3, 0.0))],
     False, (24, 15)),
    ("euroc_stereo", [
        ("pinhole_radtan", None),
        ("euroc_cam1", np.linalg.inv(syn.euroc_stereo_rig()[1][1]))],
     False, (24, 15)),
    ("pinhole_n768", [("pinhole", None)], False, (32, 24)),
]


def align_cases(bw: float, cases: list, dev=torch.device("cuda")) -> dict:
    """align_level against align_level_plain on two rendered views of the
    plane (body at frames 0 and 2 of the slice's motion), 360 features a
    camera on a grid (768 in one case), each of levels 4..2 started from
    the same state for both; the next level starts from the plain
    version's result. The first case (pinhole, no prior, no alpha/beta,
    N = 360) is the main path's: its timing is the summary's (mean over
    the three levels, per launch). max_abs_err is the largest pose gap,
    rotation (rad) or translation (m)."""
    T_prior = se3_exp(torch.tensor([0.02, 0.0, 0.0, 0.0, 0.001, 0.0],
                                   device=dev))
    summary = None
    for label, cams_spec, extras, grid in ALIGN_CASES:
        gain, offset = (1.08, -6.0) if extras else (1.0, 0.0)
        inputs = [syn.align_problem(ALIGN_CAMERAS[name](), gt_pose(0),
                                    gt_pose(2), INTR, PLANE_Z, 5, grid=grid,
                                    gain=gain, offset=offset, T_cam_body=Tcb,
                                    device=dev)
                  for name, Tcb in cams_spec]
        opts = sia.SparseImgAlignOptions(
            estimate_alpha=extras, estimate_beta=extras,
            prior_lambda_rot=0.1 if extras else 0.0,
            prior_lambda_trans=0.05 if extras else 0.0)
        timed = summary is None
        pre = [sia.precompute_base(inp, False) for inp in inputs]
        state = sia.make_state(device=dev)
        depth = max(float(inp.depth_ref.max()) for inp in inputs)
        levels = []
        for level in range(opts.max_level, opts.min_level - 1, -1):
            cams = sia.level_cameras(inputs, pre, state, opts, level)
            args = (cams, state, opts, level, T_prior)
            got = cuda_align.align_level(*args)
            want = cuda_align.align_level_plain(*args)
            torch.cuda.synchronize()
            rot = syn.rotation_gap(got[0].T_icur_iref.q,
                                   want[0].T_icur_iref.q)
            trans = float((got[0].T_icur_iref.t
                           - want[0].T_icur_iref.t).norm())
            n_k, n_p = int(got[2]), int(want[2])
            it = int(got[3])
            line = dict(level=level, rot_err_rad=rot, trans_err_m=trans,
                        n_tracked=n_k, n_tracked_plain=n_p, iters=it,
                        iters_plain=int(want[3]),
                        alpha=[float(got[0].alpha), float(want[0].alpha)],
                        beta=[float(got[0].beta), float(want[0].beta)])
            if (rot > ALIGN_ROT_TOL or trans > ALIGN_TRANS_TOL * depth
                    or n_k != n_p):
                fail(f"align_level {label} extras={extras}: kernel vs "
                     f"plain {line}")
            if timed:
                n = sum(lc.xyz_ref.shape[0] for lc in cams)
                R, T = cams[0].tb.shape_rt
                area = opts.patch_size ** 2
                nbytes = (n * (R * T * 4 + area * 9 * 4 + 3 * 4 + 4 * 8 + 1)
                          + 16 * 4 * len(cams) + 9 * 4 + 12 * 4)
                flops = (1 + it) * n * area * (6 + 3 + 2 * 64 + 2 * 8 + 3)
                line |= dict(
                    ms=gs.cuda_ms(lambda: cuda_align.align_level(*args)),
                    plain_ms=gs.cuda_ms(
                        lambda: cuda_align.align_level_plain(*args),
                        reps=1, samples=3),
                    bytes=nbytes, flops=flops,
                    bound_ms=max(nbytes / bw, flops / _FP32_FLOPS) * 1e3,
                    bound_by="bytes" if nbytes / bw >= flops / _FP32_FLOPS
                    else "operations")
            levels.append(line)
            state = want[0]
        case = dict(name="align_level", case=label, prior_alpha_beta=extras,
                    n=sum(int(inp.px_ref.shape[0]) for inp in inputs),
                    depth_m=depth,
                    max_abs_err=max(max(lv["rot_err_rad"], lv["trans_err_m"])
                                    for lv in levels),
                    levels=levels)
        if timed:
            case |= {k: float(np.mean([lv[k] for lv in levels]))
                     for k in ("ms", "plain_ms", "bound_ms")}
            case |= dict(bound_by=levels[-1]["bound_by"], library_ms=None)
            summary = case
        cases.append(case)
    return summary


# ---------------------------------------------------------------------------
# phase 4 / 5: the slice
# ---------------------------------------------------------------------------

STAGES = ("_stage_align", "_stage_reproject", "_stage_pose",
          "_stage_structure", "_stage_seeds", "_stage_kf_policy",
          "_keyframe_step")


def time_methods(obj, names, events: list) -> None:
    """Wrap methods of ``obj`` (a pipeline's stages) with CUDA-event
    pairs."""
    for name in names:
        fn = getattr(obj, name)

        def timed(*a, _fn=fn, _name=name, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = _fn(*a, **k)
            e.record()
            events.append((_name, s, e))
            return out
        setattr(obj, name, timed)


def run_slice(frames: list, device: str, timed: bool = False):
    cam = Camera.pinhole(*INTR, W, H)
    pipe = DevicePipelineMono(euroc_config(), cam, trace_capacity=256,
                              device=device)
    events: list = []
    if timed:
        time_methods(pipe, STAGES, events)
    wall = []
    for t, img in enumerate(frames):
        t0 = time.perf_counter()
        pipe.add_image(img, t * 0.05)
        if device == "cuda":
            torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    mats, meta = pipe.drain()
    return pipe, mats, meta, np.asarray(wall), events


def profile_frames(frames: list) -> dict:
    """Device busy time and kernel launches per frame from torch.profiler,
    and the host↔device synchronizations per frame from PyTorch's sync
    debug mode, over a short run of the slice."""
    run_slice(frames[:2], "cuda")              # warm-up
    return profile_run(lambda: run_slice(frames, "cuda"),
                       lambda: run_slice(frames, "cuda"), len(frames))


def profile_run(run, run_sync, n: int) -> dict:
    """torch.profiler over ``run()`` (n frames): device busy ms, kernel
    launches, the port kernels' launches and device ms, the stream and
    device synchronizations the profiler records; then the host syncs of
    ``run_sync()`` (another n frames) in PyTorch's sync debug mode (none
    with ``run_sync`` None)."""
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if run_sync is not None:
            del caught[:]
            torch.cuda.set_sync_debug_mode(1)
            try:
                run_sync()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    syncs = (sum("synchroniz" in str(w.message) for w in caught)
             if run_sync is not None else None)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def host_ms(names):
        return sum(e.cpu_time_total for e in events if e.key in names) / 1e3
    # host time blocked in the frame's synchronizations (the blocking
    # image upload and the stats read) and spent launching kernels
    sync_ms = host_ms({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                       "cudaMemcpyAsync"})
    launch_ms = host_ms({"cudaLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernel", "cuLaunchKernelEx"})
    # the port's own __global__ functions: launches per frame and device
    # ms per launch
    port = {}
    for e in kernels:
        for fn in ("gather_tiles_kernel", "gather_tiles_ring_kernel",
                   "fused_evaluate_partials", "fused_evaluate_reduce",
                   "align_level_kernel"):
            if fn in e.key and e.count:
                c, t = port.get(fn, (0, 0.0))
                port[fn] = (c + e.count, t + e.self_device_time_total)
    port = {k: {"launches_per_frame": c / n, "device_ms_per_launch":
                t / 1e3 / c} for k, (c, t) in port.items()}
    return {"phase": "profile", "frames": n,
            "device_busy_ms_per_frame": busy_ms / n,
            "wall_ms_per_frame_profiled": wall * 1e3 / n,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "kernel_launches_per_frame": sum(e.count for e in kernels) / n,
            "host_sync_wait_ms_per_frame": sync_ms / n,
            "host_launch_api_ms_per_frame": launch_ms / n,
            "host_syncs_per_frame": None if syncs is None else syncs / n,
            # the port's reads (a device-to-host copy waits on its stream;
            # the harness's own per-frame synchronize is a device one)
            "stream_syncs_per_frame": sum(
                e.count for e in events
                if e.key == "cudaStreamSynchronize") / n,
            "port_kernels": port}


# ---------------------------------------------------------------------------
# phase 6: mono VIO (FivePoint init, window backend) on bench.py's scene
# ---------------------------------------------------------------------------

VIO_FRAMES = 140             # bench.py:186-187
VIO_WARMUP = 20
VIO_CPU_TRACKING = 2         # tracking frames after the bootstrap, on CPU
VIO_PROFILE_AT = 40          # the profiled window holds the first backend
VIO_PROFILE_FRAMES = 2       # call from this frame on, as its second frame
VIO_STAGES = STAGES + ("_branch_init", "_klt_track", "_vio_backend_step")
BACKEND_PROGRAMS = ("_step_program", "_marginalize_program",
                    "_apply_program")
# JAX on a TPU, same scene and gates (BENCH_r05.json); accuracy only
JAX_REFERENCE = {"ate_m": 0.009, "ate_se3_m": 0.0481, "scale_error": 0.1152,
                 "n_tracking": "120/120"}


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


class VioRun:
    """DevicePipelineVIO (DevicePipelineSLAM given ``slam_opts``) on one
    device, fed like bench.py's Feeder (bench.py:139-148): the IMU up to
    each frame's time, then the frame."""

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
        self.device = torch.device(device)

    def feed(self, frames: list, t0: int, t1: int, wall=None) -> None:
        for t in range(t0, t1):
            ts = t * syn.CAM_DT
            while (self.i_imu < len(self.imu_meas)
                   and self.imu_meas[self.i_imu][0] <= ts):
                self.imu.add_measurement(*self.imu_meas[self.i_imu])
                self.i_imu += 1
            c0 = time.perf_counter()
            self.pipe.add_image(frames[t], ts)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            if wall is not None:
                wall.append(time.perf_counter() - c0)


def count_launches_in(obj, name: str, kernel: _cuda.Kernel,
                      log: list) -> None:
    """Record the launches of ``kernel`` made inside each call of
    ``obj.name``."""
    fn = getattr(obj, name)

    def counted(*a, **k):
        before = kernel.launches
        out = fn(*a, **k)
        log.append(kernel.launches - before)
        return out
    setattr(obj, name, counted)


def determinism_check(smi: str, run: VioRun, first: np.ndarray,
                      frames: list) -> None:
    """A second run of the first ``len(first)`` frames in this process must
    give the same pose trace to the bit (the backend's float sums are in an
    order fixed by their inputs: ``utils.indexing.segment_sum``)."""
    run.feed(frames, 0, first.shape[0])
    again = run.pipe.drain()[0]
    line = {"phase": "determinism", "card": smi, "frames": first.shape[0],
            "max_pos_diff_m": float(np.abs(again[:, :3, 3]
                                           - first[:, :3, 3]).max()),
            "max_abs_diff": float(np.abs(again - first).max()),
            "bit_identical": bool(np.array_equal(again, first))}
    emit(line)
    if not line["bit_identical"]:
        fail(f"vio: two runs of the first {first.shape[0]} frames differ: "
             f"{line}")


def vio_phase(smi: str) -> dict:
    """bench.py's mono VIO on the card: 20 warm-up frames (bootstrap and
    first keyframes), 120 timed frames in three chunks; accuracy against
    the ground truth; the gates. Returns the launch counts, the input and
    the pose trace of the run."""
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    t0 = time.perf_counter()
    poses, frames, imu_meas = syn.bench_sequence(VIO_FRAMES, 7, "cuda")
    data_s = time.perf_counter() - t0
    cfg = vio_config()
    run = VioRun(cam, cfg, imu_meas, "cuda", VIO_FRAMES)
    pipe = run.pipe
    events: list = []
    time_methods(pipe, VIO_STAGES, events)
    time_methods(pipe.backend, BACKEND_PROGRAMS, events)
    init_gathers: list = []
    count_launches_in(pipe, "_branch_init", cuda_tiles.GATHER_TILES,
                      init_gathers)
    wall: list = []
    step_frames: list = []
    step = pipe.backend._step_program

    def logged_step(*a, **k):
        step_frames.append(len(wall))
        return step(*a, **k)
    pipe.backend._step_program = logged_step
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    run.feed(frames, 0, VIO_WARMUP, wall)
    edges = [VIO_WARMUP + (VIO_FRAMES - VIO_WARMUP) * i // 3
             for i in range(4)]
    chunk_fps = []
    for a, b in zip(edges[:-1], edges[1:]):
        c0 = time.perf_counter()
        run.feed(frames, a, b, wall)
        chunk_fps.append((b - a) / (time.perf_counter() - c0))
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    mats, meta = pipe.drain()
    stage_ms: dict = {}
    for nm, s, e in events:
        c, t = stage_ms.get(nm, (0, 0.0))
        stage_ms[nm] = (c + 1, t + s.elapsed_time(e))
    stages = meta[:, 0].astype(int)
    n_timed = VIO_FRAMES - VIO_WARMUP
    n_tracking = int((stages[VIO_WARMUP:] == Stage.TRACKING.value).sum())
    tracking = stages == Stage.TRACKING.value
    first_track = int(np.argmax(tracking)) if tracking.any() else -1
    timed_wall = np.asarray(wall[VIO_WARMUP:])
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    w = pipe.world
    line = {
        "phase": "vio", "card": smi, "config": "mono_vio_degraded_imagery",
        "resolution": [syn.BENCH_W, syn.BENCH_H], "frames": VIO_FRAMES,
        "warmup": VIO_WARMUP, "data_s": data_s,
        "fps_overall": float(n_timed / timed_wall.sum()),
        "fps_steady": float(max(chunk_fps)), "fps_chunks": chunk_fps,
        "frame_ms_median": float(np.median(timed_wall) * 1e3),
        "n_tracking": n_tracking, "n_timed": n_timed,
        "first_tracking_frame": first_track,
        "backend_keyframes": w.backend_k,
        "backend_chi2": float(w.backend_chi2),
        # LM iterations of the window solve, and those whose state step a
        # once-seen landmark voided (window_ba.solve_schur)
        "backend_lm_iterations": pipe.backend.lm_iterations,
        "backend_lm_voided": int(pipe.backend.lm_voided),
        "backend_lm_voided_share": (int(pipe.backend.lm_voided)
                                    / max(pipe.backend.lm_iterations, 1)),
        "depth_med_final": float(w.depth_state[0]),
        "stage_ms_per_call": {k.lstrip("_"): t / c
                              for k, (c, t) in stage_ms.items()},
        "stage_calls": {k.lstrip("_"): c for k, (c, _) in stage_ms.items()},
        "launches": counts,
        "launches_per_frame": {k: v / VIO_FRAMES for k, v in counts.items()},
        "gather_launches_in_init_frames": init_gathers,
        "peak_mem_MB": torch.cuda.max_memory_allocated() / 2 ** 20,
        "jax_reference_accuracy_tpu": JAX_REFERENCE}
    if first_track >= 0:
        ep = mats[first_track:, :3, 3]
        g = gt[first_track:]
        ate, a3 = ate_rmse(ep, g, align="sim3")
        ate_se3, _ = ate_rmse(ep, g, align="se3")
        line |= {"ate_m": ate, "ate_se3_m": ate_se3,
                 "scale_error": abs(float(a3.s) - 1.0),
                 "traj_len_m": float(np.linalg.norm(np.diff(g, axis=0),
                                                    axis=-1).sum())}
    emit(line)

    # ---- gates ---------------------------------------------------------
    if n_tracking < 0.9 * n_timed:
        fail(f"vio: TRACKING on {n_tracking}/{n_timed} timed frames")
    if not 0 <= first_track < VIO_WARMUP:
        fail(f"vio: TRACKING first reached at frame {first_track}")
    if not (w.backend_k >= 2 and np.isfinite(line["backend_chi2"])
            and line["backend_chi2"] > 0):
        fail(f"vio: backend {w.backend_k} states, chi2 "
             f"{line['backend_chi2']}")
    if not (np.isfinite(mats).all()
            and line["ate_m"] < 0.15 * line["traj_len_m"]):
        fail(f"vio: Sim3 ATE {line['ate_m']} m over "
             f"{line['traj_len_m']} m")
    if not init_gathers or min(init_gathers) <= 0:
        fail(f"vio: gather_tiles launches in the init frames "
             f"{init_gathers}")
    ia = cfg.img_align
    n_align = stage_ms.get("_stage_align", (0, 0.0))[0]
    if (n_align == 0 or counts["align_level"]
            != (ia.max_level - ia.min_level + 1) * n_align
            or counts["fused_evaluate"] != 0):
        fail(f"vio: {counts['align_level']} align_level and "
             f"{counts['fused_evaluate']} fused_evaluate launches for "
             f"{n_align} sparse alignments")

    # ---- profile: a window holding a backend call ----------------------
    # (a second card run of the same frames, which also gives the card's
    # trace right after the bootstrap for the CPU comparison below: the
    # first run's trace is rescaled by every later scale correction)
    n_cpu = first_track + 1 + VIO_CPU_TRACKING
    prof_run = VioRun(cam, cfg, imu_meas, "cuda", VIO_FRAMES)
    prof_run.feed(frames, 0, n_cpu)
    card_mats, card_meta = prof_run.pipe.drain()
    prof_run.feed(frames, n_cpu, VIO_PROFILE_AT)
    determinism_check(smi, VioRun(cam, cfg, imu_meas, "cuda", VIO_FRAMES),
                      prof_run.pipe.drain()[0], frames)
    n = VIO_PROFILE_FRAMES
    a = next((f for f in step_frames if f > VIO_PROFILE_AT),
             VIO_PROFILE_AT + 1) - 1
    prof_run.feed(frames, VIO_PROFILE_AT, a)
    k0 = prof_run.pipe.world.last_kf_ts
    prof = profile_run(lambda: prof_run.feed(frames, a, a + n),
                       lambda: prof_run.feed(frames, a + n, a + 2 * n), n)
    prof |= {"phase": "vio_profile", "card": smi, "frames": [a, a + n],
             "backend_calls_in_window": int(prof_run.pipe.world.last_kf_ts
                                            != k0)}
    emit(prof)

    # ---- the same frames through the bootstrap on the CPU --------------
    cpu = VioRun(cam, cfg, imu_meas, "cpu", VIO_FRAMES)
    c0 = time.perf_counter()
    cpu.feed(frames, 0, n_cpu)
    cmats, cmeta = cpu.pipe.drain()
    gap = np.linalg.norm(cmats[:, :3, 3] - card_mats[:, :3, 3], axis=-1)
    same = bool((cmeta[:, 0] == card_meta[:, 0]).all())
    emit({"phase": "vio_cpu", "frames": n_cpu, "max_pos_gap_m":
          float(gap.max()), "stages_equal": same,
          "stages": cmeta[:, 0].astype(int).tolist(),
          "cpu_s": time.perf_counter() - c0})
    if gap.max() > POSE_TOL_M or not same:
        fail(f"vio: card and CPU disagree: gap {gap.max()} m, stages "
             f"{cmeta[:, 0].tolist()} vs {card_meta[:, 0].tolist()}")
    return counts, (poses, frames, imu_meas)


# ---------------------------------------------------------------------------
# phase 7: mono SLAM (loop closing, pose graph, global map) on bench.py's loop
# ---------------------------------------------------------------------------

SLAM_WARMUP = 16                   # bench.py:311
SLAM_PROFILE_FRAMES = 2
SLAM_STAGES = VIO_STAGES + ("_run_slam_kf", "_snapshot", "_close_loop",
                            "_gm_refine", "_gm_feedback")
# the JAX package on the CPU, same scene and configuration, float32 as it
# ships (reference_cpu.py slam); counts only
JAX_SLAM_CPU = {"n_tracking": "144/144", "n_keyframes": 8,
                "n_loops_closed": 0, "n_cand": 2, "nn_max": 25, "inl_max": 0,
                "gm_landmarks": 217}
LOOP_TOL = 1e-3          # m and rad: card vs CPU, verification and graph
# JAX on a TPU, same scene and gates (BENCH_r05.json "slam"); accuracy and
# counts only
JAX_SLAM_REFERENCE = {"n_tracking": "144/144", "n_keyframes": 25,
                      "n_loops_closed": 2, "last_loop_to": 16,
                      "gm_landmarks": 384, "lc_best_sim": 0.991,
                      "ate_m": 0.0745, "traj_len_m": 4.22}


def slam_options() -> SlamOptions:
    """bench.py:314-316."""
    return SlamOptions(max_db_keyframes=128, max_nodes=128, gm_landmarks=384,
                       min_temporal_gap=6, min_similarity=0.75, min_inliers=15)


def slam_phase(smi: str) -> dict:
    """bench.py's SLAM section (bench.py:291-350) on the card: the vio
    phase's configuration on the closed loop (160 frames, 16 warm-up,
    degrade seed 11); fps by bench.py's definition (timed frames over their
    wall time), slam_stats, Sim3 ATE, stage ms (CUDA events), launches; the
    gates; then a 7-frame profile around the first verified loop. Returns
    the launch counts of the run."""
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    n_frames = syn.LOOP_FRAMES
    t0 = time.perf_counter()
    poses, frames, imu_meas = syn.bench_sequence(
        n_frames, syn.LOOP_DEGRADE_SEED, "cuda", twist_fn=syn.loop_twist)
    data_s = time.perf_counter() - t0
    cfg = vio_config()
    so = slam_options()
    run = VioRun(cam, cfg, imu_meas, "cuda", n_frames, slam_opts=so)
    pipe = run.pipe
    events: list = []
    time_methods(pipe, SLAM_STAGES, events)
    time_methods(pipe.backend, BACKEND_PROGRAMS, events)
    time_methods(pgo_mod, ("optimize",), events)
    time_methods(lc_mod, ("verify_candidate",), events)
    wall: list = []
    loop_frames: list = []
    cand_frames: list = []
    first_cand: list = []
    close_loop, verify = pipe._close_loop, lc_mod.verify_candidate

    def logged_loop(w, *a, **k):
        loop_frames.append(len(wall))
        return close_loop(w, *a, **k)

    def logged_verify(cur, old, *a, **k):
        cand_frames.append(len(wall))
        if not first_cand:
            first_cand.append((cur, old, a, k))
        return verify(cur, old, *a, **k)
    pipe._close_loop = logged_loop
    lc_mod.verify_candidate = logged_verify
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    run.feed(frames, 0, SLAM_WARMUP, wall)
    run.feed(frames, SLAM_WARMUP, n_frames, wall)
    lc_mod.verify_candidate = verify
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    mats, meta = pipe.drain()
    stage_ms: dict = {}
    for nm, s, e in events:
        c, t = stage_ms.get(nm, (0, 0.0))
        stage_ms[nm] = (c + 1, t + s.elapsed_time(e))
    stages = meta[:, 0].astype(int)
    n_timed = n_frames - SLAM_WARMUP
    n_tracking = int((stages[SLAM_WARMUP:] == Stage.TRACKING.value).sum())
    tracking = stages == Stage.TRACKING.value
    first_track = int(np.argmax(tracking)) if tracking.any() else -1
    timed_wall = np.asarray(wall[SLAM_WARMUP:])
    w = pipe.world
    stats = pipe.slam_stats()
    line = {
        "phase": "slam", "card": smi, "config": "mono_vio_degraded_imagery "
        "+ SLAM (bench.py:291-350)", "slam_options": so._asdict(),
        "resolution": [syn.BENCH_W, syn.BENCH_H], "frames": n_frames,
        "warmup": SLAM_WARMUP, "data_s": data_s,
        "fps": float(n_timed / timed_wall.sum()),
        "frame_ms_median": float(np.median(timed_wall) * 1e3),
        "frame_ms_max": float(timed_wall.max() * 1e3),
        "n_tracking": n_tracking, "n_timed": n_timed,
        "first_tracking_frame": first_track, **stats,
        "loop_frames": loop_frames, "candidate_frames": cand_frames,
        "backend_keyframes": w.backend_k,
        "backend_chi2": float(w.backend_chi2),
        "backend_lm_iterations": pipe.backend.lm_iterations,
        "backend_lm_voided_share": (int(pipe.backend.lm_voided)
                                    / max(pipe.backend.lm_iterations, 1)),
        "stage_ms_per_call": {k.lstrip("_"): t / c
                              for k, (c, t) in stage_ms.items()},
        "stage_calls": {k.lstrip("_"): c for k, (c, _) in stage_ms.items()},
        "launches": counts,
        "launches_per_frame": {k: v / n_frames for k, v in counts.items()},
        "peak_mem_MB": torch.cuda.max_memory_allocated() / 2 ** 20,
        "jax_reference_tpu": JAX_SLAM_REFERENCE,
        "jax_reference_cpu": JAX_SLAM_CPU}
    if first_track >= 0:
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses[first_track:]])
        ate, _ = ate_rmse(mats[first_track:, :3, 3], gt, align="sim3")
        line |= {"ate_m": ate, "traj_len_m": float(np.linalg.norm(
            np.diff(gt, axis=0), axis=-1).sum())}
    # the loop gate of tests/test_device_pipeline_slam.py, recorded: on
    # this scene the JAX package on the CPU closes no loop either
    # (JAX_SLAM_CPU), so it is no check of the port (PERF.md §6)
    line["loop_gate_passed"] = stats["n_loops_closed"] >= 1
    emit(line)

    # ---- gates (tests/test_device_pipeline_slam.py:96-123) -------------
    if n_tracking < 0.9 * n_timed:
        fail(f"slam: TRACKING on {n_tracking}/{n_timed} timed frames")
    if stats["gm_landmarks"] < 20:
        fail(f"slam: {stats['gm_landmarks']} global landmarks")
    if not (w.backend_k >= 2 and np.isfinite(line["backend_chi2"])):
        fail(f"slam: backend {w.backend_k} states, chi2 "
             f"{line['backend_chi2']}")
    if not (np.isfinite(mats).all()
            and line["ate_m"] < 0.15 * line["traj_len_m"]):
        fail(f"slam: Sim3 ATE {line.get('ate_m')} m over "
             f"{line.get('traj_len_m')} m")
    ia = cfg.img_align
    n_align = stage_ms.get("_stage_align", (0, 0.0))[0]
    if (min(counts["gather_tiles"], counts["gather_tiles_ring"]) <= 0
            or n_align == 0 or counts["align_level"]
            != (ia.max_level - ia.min_level + 1) * n_align
            or counts["fused_evaluate"] != 0):
        fail(f"slam: launches {counts} for {n_align} sparse alignments")

    slam_loop_parts(smi, pipe, first_cand)

    # ---- profile: 2 frames around the first verified loop, else the first
    # verification (a second run of the same frames; the card's runs are
    # deterministic)
    at = (loop_frames or cand_frames or [n_frames - SLAM_PROFILE_FRAMES])[0]
    n = SLAM_PROFILE_FRAMES
    a = min(max(at - n // 2, SLAM_WARMUP), n_frames - n)
    prof_run = VioRun(cam, cfg, imu_meas, "cuda", n_frames, slam_opts=so)
    prof_run.feed(frames, 0, a)
    w0 = prof_run.pipe.world
    loops0, diag0 = w0.n_loops, int(w0.lc_diag[0])
    prof = profile_run(lambda: prof_run.feed(frames, a, a + n), None, n)
    w1 = prof_run.pipe.world
    prof |= {"phase": "slam_profile", "card": smi, "frames": [a, a + n],
             "loops_in_window": w1.n_loops - loops0,
             "verifications_in_window": int(w1.lc_diag[0]) - diag0}
    emit(prof)
    return counts, (poses, frames)


# ---------------------------------------------------------------------------
# phase 8: the multi-camera pipelines (stereo VO, stereo VIO, N-camera array)
# on the EuRoC stereo rig and bench.py's scene
# ---------------------------------------------------------------------------

RIG_FRAMES = 140                   # bench.py:186-187, as the vio phase
RIG_WARMUP = 20
STEREO_SEEDS = (7, 8)              # degrade seeds of cam0 and cam1
STEREO_CPU_TRACKING = 3            # tracking frames after the bootstrap
STEREO_JOINT_FRAMES = 60
STEREO_PROFILE_AT = 23             # the first window holds frame 24's call
ARRAY_FRAMES = 60
ARRAY_WARMUP = 10
ARRAY_SEEDS = (7, 8, 9)
# tests/test_pipeline_array.py's layout, every camera EuRoC's cam0
ARRAY_T_BODY_CAMS = (np.eye(4), syn.pose(0.11, 0.0, 0.0),
                     syn.pose(0.0, 0.09, 0.0))
# Why the stereo_vio cell voids the window's state steps
# (BAOptions.void_on_single_view): on this input the JAX package's stereo
# VIO as it ships (float32 solve) voids every state step and tracks 40/40
# timed frames of 60; with its solve in float64 (the port's default) each
# backend call moves the pose by 1-2 cm, the per-frame structure stage
# re-triangulates landmarks from those poses, and it falls to 28/40 with a
# 0.33 m unaligned ATE, as the port does frame for frame (CPU,
# tests/reference_cpu.py stereo_vio; PERF.md §6).
STEREO_VIO_SOLVE = "void_on_single_view"
RIG_KINDS = {"stereo": ("_stereo_triangulate", DevicePipelineStereo),
             "stereo_vio": ("_stereo_triangulate", DevicePipelineStereoVIO),
             "array": ("_triangulate_bundle", DevicePipelineArray)}


def stereo_config() -> Config:
    """vio_config's capacities and frontend settings (bench.py:159-184) as a
    stereo pipeline, ``cfg.stereo`` at its defaults, with the upper bound
    of tracked features for a new keyframe at 180, the value of the EuRoC
    pipeline parameters (examples/param/pinhole.yaml). A stereo map keeps
    125–195 of its ~340 first landmarks tracked on this scene, so the
    default bound of 120 lets no keyframe through after the first (a CPU
    run: 1 keyframe in 140 frames; with 180: 5)."""
    cfg = vio_config()
    cfg.pipeline_is_stereo = True
    cfg.base.kfselect_numkfs_upper_thresh = 180
    return cfg


def se3_of(T: np.ndarray) -> SE3:
    Tt = torch.as_tensor(np.asarray(T, np.float32))
    return SE3(matrix_to_quat(Tt[:3, :3]), Tt[:3, 3])


class RigRun:
    """A stereo, stereo-VIO or array pipeline (``kind``) on one device, fed
    like VioRun: the IMU (stereo VIO) up to each frame's time, then the
    frame's views."""

    def __init__(self, kind: str, cams: list, T_body_cams: list, cfg: Config,
                 imu_meas: list, device, n_frames: int,
                 joint_alignment: bool = False):
        cls = RIG_KINDS[kind][1]
        Tb = [se3_of(T) for T in T_body_cams]
        kw = dict(trace_capacity=n_frames + 1, device=device,
                  joint_alignment=joint_alignment)
        self.imu = None
        if kind == "array":
            self.pipe = cls(cfg, cams, Tb, **kw)
            self.add = self.pipe.add_image_bundle
        else:
            if kind == "stereo_vio":
                self.imu = ImuHandler(ImuParams())
                kw |= dict(imu_handler=self.imu, imu_params=ImuParams())
            self.pipe = cls(cfg, cams[0], cams[1], Tb[0], Tb[1], **kw)
            if kind == "stereo_vio":
                # the JAX package's shipped numerics here (STEREO_VIO_SOLVE)
                self.pipe.backend.opts = self.pipe.backend.opts._replace(
                    void_on_single_view=True)
            self.add = lambda v, ts: self.pipe.add_image_pair(v[0], v[1], ts)
        self.imu_meas = imu_meas
        self.i_imu = 0
        self.device = torch.device(device)

    def feed(self, views: list, t0: int, t1: int, wall=None) -> None:
        for t in range(t0, t1):
            ts = t * syn.CAM_DT
            while (self.imu is not None and self.i_imu < len(self.imu_meas)
                   and self.imu_meas[self.i_imu][0] <= ts):
                self.imu.add_measurement(*self.imu_meas[self.i_imu])
                self.i_imu += 1
            c0 = time.perf_counter()
            self.add(views[t], ts)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            if wall is not None:
                wall.append(time.perf_counter() - c0)


def unaligned_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """Metric ATE with no alignment, positions taken relative to the first
    frame (tests/test_device_pipeline_stereo.py:38-48)."""
    d = (est - est[0]) - (gt - gt[0])
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def rig_run(smi: str, kind: str, cams: list, T_body_cams: list, views: list,
            imu_meas: list, n_frames: int, warmup: int, poses: list,
            joint_alignment: bool = False, phase: str | None = None) -> dict:
    """One timed run of a rig pipeline on the card: fps overall and steady
    (best of three chunks), per-stage ms per call (CUDA events), the
    landmarks each keyframe triangulation made, the gathers it launched,
    metric unaligned and SE3 ATE, launches, peak memory; and the gates of
    the JAX tests (TRACKING by frame 1 and on ≥ 90% of the timed frames,
    ≥ 2 keyframes, unaligned ATE < 0.15 × path, the gathers launched in
    every triangulation, align_level once per level of every sparse
    alignment, fused_evaluate never). Returns the run's record."""
    tri = RIG_KINDS[kind][0]
    cfg = stereo_config()
    if kind == "array":
        cfg.pipeline_is_stereo = False
    run = RigRun(kind, cams, T_body_cams, cfg, imu_meas, "cuda", n_frames,
                 joint_alignment)
    pipe = run.pipe
    events: list = []
    names = STAGES + (tri,)
    if kind == "stereo_vio":
        names += ("_vio_backend_step",)
        time_methods(pipe.backend, BACKEND_PROGRAMS, events)
    time_methods(pipe, names, events)
    tri_gathers: list = []
    count_launches_in(pipe, tri, cuda_tiles.GATHER_TILES, tri_gathers)
    landmarks: list = []
    inner = getattr(pipe, tri)

    def logged(*a, **k):
        out = inner(*a, **k)
        landmarks.append(out[3])          # read after the run
        return out
    setattr(pipe, tri, logged)
    n_align_cams: list = []
    extra_inputs = pipe._extra_align_inputs

    def counted_inputs(*a, **k):
        out = extra_inputs(*a, **k)
        n_align_cams.append(1 + len(out))
        return out
    pipe._extra_align_inputs = counted_inputs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    wall: list = []
    run.feed(views, 0, warmup, wall)
    edges = [warmup + (n_frames - warmup) * i // 3 for i in range(4)]
    chunk_fps = []
    for a, b in zip(edges[:-1], edges[1:]):
        c0 = time.perf_counter()
        run.feed(views, a, b, wall)
        chunk_fps.append((b - a) / (time.perf_counter() - c0))
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    mats, meta = pipe.drain()
    stage_ms: dict = {}
    for nm, s, e in events:
        c, t = stage_ms.get(nm, (0, 0.0))
        stage_ms[nm] = (c + 1, t + s.elapsed_time(e))
    stages = meta[:, 0].astype(int)
    n_timed = n_frames - warmup
    n_tracking = int((stages[warmup:] == Stage.TRACKING.value).sum())
    tracking = stages == Stage.TRACKING.value
    first_track = int(np.argmax(tracking)) if tracking.any() else -1
    timed_wall = np.asarray(wall[warmup:])
    n_kf = int(meta[1:, 2].sum())
    line = {
        "phase": phase or kind, "card": smi, "pipeline": type(pipe).__name__,
        "cameras": [c.label for c in cams],
        "resolution": [cams[0].width, cams[0].height], "frames": n_frames,
        "warmup": warmup, "joint_alignment": joint_alignment,
        "fps_overall": float(n_timed / timed_wall.sum()),
        "fps_steady": float(max(chunk_fps)), "fps_chunks": chunk_fps,
        "frame_ms_median": float(np.median(timed_wall) * 1e3),
        "n_tracking": n_tracking, "n_timed": n_timed,
        "first_tracking_frame": first_track, "keyframes_after_first": n_kf,
        "landmarks_per_triangulation": [int(x) for x in landmarks],
        "gathers_per_triangulation": tri_gathers,
        "align_cameras": sorted(set(n_align_cams)),
        "stage_ms_per_call": {k.lstrip("_"): t / c
                              for k, (c, t) in stage_ms.items()},
        "stage_calls": {k.lstrip("_"): c for k, (c, _) in stage_ms.items()},
        "launches": counts,
        "launches_per_frame": {k: v / n_frames for k, v in counts.items()},
        "peak_mem_MB": torch.cuda.max_memory_allocated() / 2 ** 20}
    if kind == "stereo_vio":
        w = pipe.world
        line |= {"window_solve": STEREO_VIO_SOLVE,
                 "backend_keyframes": w.backend_k,
                 "backend_chi2": float(w.backend_chi2),
                 "backend_lm_iterations": pipe.backend.lm_iterations,
                 "backend_lm_voided_share": (
                     int(pipe.backend.lm_voided)
                     / max(pipe.backend.lm_iterations, 1))}
    if first_track >= 0:
        gt = np.stack([np.linalg.inv(T)[:3, 3]
                       for T in poses[first_track:n_frames]])
        est = mats[first_track:, :3, 3]
        line |= {"ate_unaligned_m": unaligned_ate(est, gt),
                 "ate_se3_m": ate_rmse(est, gt, align="se3")[0],
                 "traj_len_m": float(np.linalg.norm(np.diff(gt, axis=0),
                                                    axis=-1).sum())}
    emit(line)

    # ---- gates ---------------------------------------------------------
    label = line["phase"]
    if not 0 <= first_track <= 1:
        fail(f"{label}: TRACKING first reached at frame {first_track}")
    if n_tracking < 0.9 * n_timed:
        fail(f"{label}: TRACKING on {n_tracking}/{n_timed} timed frames")
    if n_kf < 2:
        fail(f"{label}: {n_kf} keyframes after the first")
    if not (np.isfinite(mats).all()
            and line["ate_unaligned_m"] < 0.15 * line["traj_len_m"]):
        fail(f"{label}: unaligned ATE {line.get('ate_unaligned_m')} m over "
             f"{line.get('traj_len_m')} m")
    if not tri_gathers or min(tri_gathers) <= 0:
        fail(f"{label}: gather_tiles launches per triangulation "
             f"{tri_gathers}")
    ia = cfg.img_align
    n_align = stage_ms.get("_stage_align", (0, 0.0))[0]
    if (n_align == 0 or counts["align_level"]
            != (ia.max_level - ia.min_level + 1) * n_align
            or counts["fused_evaluate"] != 0
            or min(counts["gather_tiles"], counts["gather_tiles_ring"]) <= 0):
        fail(f"{label}: launches {counts} for {n_align} sparse alignments")
    want_cams = len(cams) if joint_alignment else 1
    if line["align_cameras"] != [want_cams]:
        fail(f"{label}: sparse alignment on {line['align_cameras']} cameras,"
             f" expected {want_cams}")
    if kind == "stereo_vio" and not (
            line["backend_keyframes"] >= 2
            and np.isfinite(line["backend_chi2"])
            and line["backend_chi2"] > 0):
        fail(f"{label}: backend {line['backend_keyframes']} states, chi2 "
             f"{line['backend_chi2']}")
    return dict(line=line, counts=counts, mats=mats, meta=meta,
                first_track=first_track)


def stereo_phases(smi: str) -> dict:
    """The stereo VO, its CPU check and joint-alignment run, the stereo VIO
    and its profile, and the array. Returns the launch counts of each main
    run."""
    cams, T_body = syn.euroc_stereo_rig()
    t0 = time.perf_counter()
    poses, views, imu_meas = syn.rig_sequence(RIG_FRAMES, cams, T_body,
                                              STEREO_SEEDS, "cuda")
    data_s = time.perf_counter() - t0
    out = {}

    # ---- stereo VO -----------------------------------------------------
    st = rig_run(smi, "stereo", cams, T_body, views, [], RIG_FRAMES,
                 RIG_WARMUP, poses)
    out["stereo"] = st["counts"]

    # ---- the bootstrap + 3 tracking frames on the CPU ------------------
    n_cpu = st["first_track"] + 1 + STEREO_CPU_TRACKING
    cpu = RigRun("stereo", cams, T_body, stereo_config(), [], "cpu",
                 RIG_FRAMES)
    c0 = time.perf_counter()
    cpu.feed(views, 0, n_cpu)
    cmats, cmeta = cpu.pipe.drain()
    gap = np.linalg.norm(cmats[:, :3, 3] - st["mats"][:n_cpu, :3, 3], axis=-1)
    same = bool((cmeta[:, 0] == st["meta"][:n_cpu, 0]).all())
    emit({"phase": "stereo_cpu", "card": smi, "frames": n_cpu,
          "max_pos_gap_m": float(gap.max()), "stages_equal": same,
          "n_tracked_card": st["meta"][:n_cpu, 1].astype(int).tolist(),
          "n_tracked_cpu": cmeta[:, 1].astype(int).tolist(),
          "cpu_s": time.perf_counter() - c0, "data_s": data_s})
    if gap.max() > POSE_TOL_M or not same:
        fail(f"stereo: card and CPU disagree: gap {gap.max()} m, stages "
             f"{cmeta[:, 0].tolist()}")

    # ---- joint alignment on both cameras -------------------------------
    rig_run(smi, "stereo", cams, T_body, views, [], STEREO_JOINT_FRAMES,
            RIG_WARMUP, poses, joint_alignment=True, phase="stereo_joint")

    # ---- stereo VIO, then a profile holding a backend call -------------
    sv = rig_run(smi, "stereo_vio", cams, T_body, views, imu_meas,
                 RIG_FRAMES, RIG_WARMUP, poses)
    out["stereo_vio"] = sv["counts"]
    prof_run = RigRun("stereo_vio", cams, T_body, stereo_config(), imu_meas,
                      "cuda", RIG_FRAMES)
    prof_run.feed(views, 0, STEREO_PROFILE_AT)
    a, n = STEREO_PROFILE_AT, VIO_PROFILE_FRAMES
    k0 = prof_run.pipe.world.last_kf_ts
    prof = profile_run(lambda: prof_run.feed(views, a, a + n),
                       lambda: prof_run.feed(views, a + n, a + 2 * n), n)
    prof |= {"phase": "stereo_vio_profile", "card": smi,
             "frames": [a, a + n],
             "backend_calls_in_window": int(prof_run.pipe.world.last_kf_ts
                                            != k0)}
    emit(prof)
    del prof_run
    out["host_stereo"] = host_rig_phase(smi, "stereo", cams, T_body, views,
                                        poses, HOST_STEREO_FRAMES)
    del views

    # ---- the 3-camera array --------------------------------------------
    acams = [cams[0]] * 3
    poses, views, _ = syn.rig_sequence(ARRAY_FRAMES, acams,
                                       list(ARRAY_T_BODY_CAMS), ARRAY_SEEDS,
                                       "cuda")
    ar = rig_run(smi, "array", acams, list(ARRAY_T_BODY_CAMS), views, [],
                 ARRAY_FRAMES, ARRAY_WARMUP, poses)
    stages = ar["meta"][:, 0].astype(int)
    if not (stages[ar["first_track"]:] == Stage.TRACKING.value).all():
        fail(f"array: left TRACKING: stages {stages.tolist()}")
    out["array"] = ar["counts"]
    out["host_array"] = host_rig_phase(smi, "array", acams,
                                       list(ARRAY_T_BODY_CAMS), views, poses,
                                       HOST_ARRAY_FRAMES)
    return out


def _to(x, device):
    """A NamedTuple of tensors (and host values) on ``device``."""
    return type(x)(*(t.to(device) if torch.is_tensor(t) else t for t in x))


def slam_loop_parts(smi: str, pipe, first_cand: list) -> None:
    """The loop branch's parts on the card against the same calls on the
    CPU: the run's first verification on its own inputs (the match counts
    equal; its inliers and pose are not held: with few inliers the robust
    GN follows wrong matches, where rounding moves it), the current keyframe
    verified against its own snapshot (verified on both, counts equal,
    translation within LOOP_TOL), and a loop closure of the run's final
    pose graph (the newest node to the oldest, at their relative pose
    moved by 2 cm and 0.01 rad): ``pgo.optimize`` at bench.py's 128 nodes,
    every node within LOOP_TOL of the CPU's, and its ms per call (CUDA
    events)."""
    so = pipe.slam
    out = {"phase": "slam_loop_parts", "card": smi}
    if first_cand:
        cur, old, a, k = first_cand[0]
        a_cpu = [x.cpu() if torch.is_tensor(x) else x for x in a]
        for name, (c, o) in (("first", (cur, old)), ("self", (cur, cur))):
            vg = lc_mod.verify_candidate(c, o, *a, **k)
            vc = lc_mod.verify_candidate(_to(c, "cpu"), _to(o, "cpu"),
                                         *a_cpu, **k)
            cg = [int(x) for x in (vg.verified, vg.n_nn, vg.n_matches,
                                   vg.n_inliers)]
            cc = [int(x) for x in (vc.verified, vc.n_nn, vc.n_matches,
                                   vc.n_inliers)]
            gap = float(torch.linalg.norm(vg.T_cur_old.t.cpu()
                                          - vc.T_cur_old.t))
            out |= {f"verify_{name}_card": cg, f"verify_{name}_cpu": cc,
                    f"verify_{name}_t_gap": gap}
            # the first: the match counts (the inliers of a GN on wrong
            # matches can differ by rounding); the self check: all
            held = cg[1:3] == cc[1:3] if name == "first" else (
                cg == cc and cg[0] == 1 and gap <= LOOP_TOL)
            if not held:
                fail(f"slam: {name} verification card {cg} vs CPU {cc}, "
                     f"translation gap {gap}")
    w = pipe.world
    n = min(w.pgo_n, so.max_nodes)
    g = w.pgo
    T_new, T_old = SE3(g.q[n - 1], g.t[n - 1]), SE3(g.q[0], g.t[0])
    T_loop = T_new.inverse().compose(T_old).compose(se3_exp(torch.tensor(
        [0.02, -0.02, 0.02, 0.01, -0.01, 0.01], device=g.q.device)))
    g = pgo_mod.add_constraint(g, w.pgo_c, n - 1, 0, T_loop, so.loop_weight,
                               so.loop_weight)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g_card, chi2 = pgo_mod.optimize(g, max_iter=so.pgo_iters)
    e1.record()
    torch.cuda.synchronize()
    g_cpu, chi2_c = pgo_mod.optimize(_to(g, "cpu"), max_iter=so.pgo_iters)
    gap_t = float((g_card.t.cpu() - g_cpu.t)[:n].abs().max())
    gap_q = float((g_card.q.cpu() - g_cpu.q)[:n].abs().max())
    moved = float((g_card.t - g.t)[:n].abs().max())
    out |= {"pgo_nodes": n, "pgo_constraints": w.pgo_c + 1,
            "pgo_ms": e0.elapsed_time(e1), "pgo_chi2_card": float(chi2),
            "pgo_chi2_cpu": float(chi2_c), "pgo_node_gap_m": gap_t,
            "pgo_quat_gap": gap_q, "pgo_max_node_move_m": moved}
    emit(out)
    if not (gap_t <= LOOP_TOL and gap_q <= LOOP_TOL and moved > 1e-3):
        fail(f"slam: pose graph card vs CPU {gap_t} m, {gap_q}; "
             f"moved {moved} m")


# ---------------------------------------------------------------------------
# phase 9: the host handlers (add_image → FrameResult) and host backends
# ---------------------------------------------------------------------------

HOST_STAGES = STAGES + ("_process_init", "_klt_track")
HOST_BACKEND = ("add_keyframe_device", "_apply_program")
HOST_VIO_CPU_TRACKING = 2          # tracking frames after the bootstrap
HOST_VIO_FRAMES = 80               # the vio input's first 80 (cut from 140:
#                                    the euroc phase reruns them at epoch
#                                    stamps through the runner)
HOST_MONO_TOL = 1e-4               # m: host vs device mono path
PROFILE_REPS = 4                   # stage_profile calls a stage (+1 warm-up)
HOST_STEREO_FRAMES = 60
HOST_ARRAY_FRAMES = 40
HOST_RIG_WARMUP = 10
HOST_SLAM_LC = dict(min_temporal_gap=6, min_similarity=0.75, min_inliers=15)
HOST_BACKEND_TOL = 1e-3            # card vs CPU: chi2 (relative), m
# the JAX package's host handlers on the CPU, same inputs
# (tests/reference_cpu.py host_vio --frames 80 [--epoch] / host_slam,
# float32 as it ships; ate_m is the Sim3 ATE from the first TRACKING frame)
JAX_HOST_VIO_CPU = {"frames": 80, "n_tracking": "60/60",
                    "keyframes_after_first": 7, "ate_m": 0.0311,
                    "scale_error": 0.3763, "lm_zero_step_share": 0.94}
JAX_HOST_VIO_EPOCH_CPU = {"frames": 80, "n_tracking": "60/60",
                          "keyframes_after_first": 5, "ate_m": 0.0177,
                          "scale_error": 0.3678, "lm_zero_step_share": 1.0}
JAX_HOST_SLAM_CPU = {"n_tracking": "144/144", "pgo_nodes": 4,
                     "n_loops_closed": 0, "gm_states": 4,
                     "fixed_landmarks": 157, "ate_m": 0.0057}


class HostRun:
    """A host handler fed like VioRun: the IMU up to each frame's time
    (through ``add_imu_measurement``), then the frame through ``add``, every
    stamp offset by ``t0`` s; keeps every FrameResult."""

    def __init__(self, handler, add, imu_meas: list, device,
                 t0: float = 0.0):
        self.h = handler
        self.add = add
        self.imu_meas = imu_meas
        self.t0 = t0
        self.i_imu = 0
        self.device = torch.device(device)
        self.results: list = []

    def feed(self, inputs: list, t0: int, t1: int, wall=None) -> None:
        for t in range(t0, t1):
            ts = t * syn.CAM_DT
            while (self.i_imu < len(self.imu_meas)
                   and self.imu_meas[self.i_imu][0] <= ts):
                tm, g, a = self.imu_meas[self.i_imu]
                self.h.add_imu_measurement(self.t0 + tm, g, a)
                self.i_imu += 1
            c0 = time.perf_counter()
            self.results.append(self.add(inputs[t], self.t0 + ts))
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            if wall is not None:
                wall.append(time.perf_counter() - c0)

    def trace(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(T_world_cam [N, 4, 4], stages [N], keyframe flags [N])."""
        r = self.results
        return (np.stack([x.T_world_cam for x in r]),
                np.array([x.stage.value for x in r]),
                np.array([bool(x.is_keyframe) for x in r]))


def host_vio_run(cam: Camera, cfg: Config, imu_meas: list, device,
                 t0: float = 0.0) -> HostRun:
    h = FrameHandlerVIO(cfg, cam, imu_handler=ImuHandler(ImuParams()),
                        imu_params=ImuParams(), device=device)
    return HostRun(h, h.add_image, imu_meas, device, t0)


def per_call(events: list) -> dict:
    out: dict = {}
    for nm, s, e in events:
        c, t = out.get(nm, (0, 0.0))
        out[nm] = (c + 1, t + s.elapsed_time(e))
    return out


def timed_run(run: HostRun, inputs: list, n: int, warmup: int
              ) -> tuple[list, list]:
    """Feed ``n`` frames: ``warmup``, then the rest in three chunks.
    Returns (wall seconds per frame, frames/s per chunk)."""
    wall: list = []
    run.feed(inputs, 0, warmup, wall)
    edges = [warmup + (n - warmup) * i // 3 for i in range(4)]
    chunk_fps = []
    for a, b in zip(edges[:-1], edges[1:]):
        c0 = time.perf_counter()
        run.feed(inputs, a, b, wall)
        chunk_fps.append((b - a) / (time.perf_counter() - c0))
    return wall, chunk_fps


def run_fields(run: HostRun, wall: list, chunk_fps: list, warmup: int,
               stage_ms: dict, counts: dict) -> dict:
    n = len(wall)
    timed = np.asarray(wall[warmup:])
    return {
        "frames": n, "warmup": warmup,
        "fps_overall": float(len(timed) / timed.sum()),
        "fps_steady": float(max(chunk_fps)), "fps_chunks": chunk_fps,
        "frame_ms_median": float(np.median(timed) * 1e3),
        "host_reads_per_frame": run.h.host_reads / n,
        "stage_ms_per_call": {k.lstrip("_"): t / c
                              for k, (c, t) in stage_ms.items()},
        "stage_calls": {k.lstrip("_"): c for k, (c, _) in stage_ms.items()},
        "launches": counts,
        "launches_per_frame": {k: v / n for k, v in counts.items()},
        "peak_mem_MB": torch.cuda.max_memory_allocated() / 2 ** 20}


def launch_gates(label: str, counts: dict, stage_ms: dict, cfg: Config,
                 ring: bool = True) -> None:
    """The gathers launched (the ring's too, given ``ring``), align_level
    once per level of every sparse alignment, fused_evaluate never."""
    ia = cfg.img_align
    n_align = stage_ms.get("_stage_align", (0, 0.0))[0]
    gathers = (min(counts["gather_tiles"], counts["gather_tiles_ring"])
               if ring else counts["gather_tiles"])
    if (gathers <= 0 or n_align == 0 or counts["align_level"]
            != (ia.max_level - ia.min_level + 1) * n_align
            or counts["fused_evaluate"] != 0):
        fail(f"{label}: launches {counts} for {n_align} sparse alignments")


def host_vio_phase(smi: str, poses: list, frames: list, imu_meas: list,
                   t0: float = 0.0) -> dict:
    """``FrameHandlerVIO`` at the vio phase's configuration on its input
    (the first 80 frames, 20 warm-up, the IMU through add_imu_measurement,
    stamps offset by ``t0``: ``host_vio_epoch`` with EuRoC's, a development
    phase of ``--only``); the vio phase's gates; then the bootstrap + 2
    frames on the CPU (``host_vio_cpu``). Returns the launch counts and
    the card run's pose trace and Sim3 ATE from the first TRACKING
    frame."""
    label = "host_vio_epoch" if t0 else "host_vio"
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    cfg = vio_config()
    run = host_vio_run(cam, cfg, imu_meas, "cuda", t0)
    h = run.h
    events: list = []
    time_methods(h, HOST_STAGES, events)
    time_methods(h.backend, HOST_BACKEND, events)
    init_gathers: list = []
    count_launches_in(h, "_process_init", cuda_tiles.GATHER_TILES,
                      init_gathers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    wall, chunk_fps = timed_run(run, frames, HOST_VIO_FRAMES, VIO_WARMUP)
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    stage_ms = per_call(events)
    mats, stages, _ = run.trace()
    tracking = stages == Stage.TRACKING.value
    first_track = int(np.argmax(tracking)) if tracking.any() else -1
    n_timed = HOST_VIO_FRAMES - VIO_WARMUP
    n_tracking = int(tracking[VIO_WARMUP:].sum())
    chi2 = h.stats.get("backend_chi2", float("nan"))
    be = h.backend
    line = {"phase": label, "card": smi, "first_stamp_s": t0,
            "handler": "FrameHandlerVIO",
            "config": "mono_vio_degraded_imagery",
            "resolution": [syn.BENCH_W, syn.BENCH_H],
            **run_fields(run, wall, chunk_fps, VIO_WARMUP, stage_ms, counts),
            "n_tracking": n_tracking, "n_timed": n_timed,
            "first_tracking_frame": first_track,
            "keyframes_after_first": int(sum(
                r.is_keyframe for r in run.results[1:])),
            "backend_keyframes": be.n_states, "backend_chi2": float(chi2),
            "backend_lm_iterations": be.lm_iterations,
            "backend_lm_voided_share": (int(be.lm_voided)
                                        / max(be.lm_iterations, 1)),
            "gather_launches_in_init_frames": init_gathers,
            "jax_host_reference_cpu": (JAX_HOST_VIO_EPOCH_CPU if t0
                                       else JAX_HOST_VIO_CPU)}
    if first_track >= 0:
        gt = np.stack([np.linalg.inv(T)[:3, 3]
                       for T in poses[:HOST_VIO_FRAMES]])
        ep, g = mats[first_track:, :3, 3], gt[first_track:]
        ate, a3 = ate_rmse(ep, g, align="sim3")
        line |= {"ate_m": ate, "ate_se3_m": ate_rmse(ep, g, align="se3")[0],
                 "scale_error": abs(float(a3.s) - 1.0),
                 "traj_len_m": float(np.linalg.norm(np.diff(g, axis=0),
                                                    axis=-1).sum())}
    emit(line)
    if n_tracking < 0.9 * n_timed:
        fail(f"{label}: TRACKING on {n_tracking}/{n_timed} timed frames")
    if not 0 <= first_track < VIO_WARMUP:
        fail(f"{label}: TRACKING first reached at frame {first_track}")
    if not (np.isfinite(chi2) and chi2 > 0 and be.n_states >= 2):
        fail(f"{label}: backend {be.n_states} states, chi2 {chi2}")
    if not (np.isfinite(mats).all()
            and line["ate_m"] < 0.15 * line["traj_len_m"]):
        fail(f"{label}: Sim3 ATE {line.get('ate_m')} m over "
             f"{line.get('traj_len_m')} m")
    if not init_gathers or min(init_gathers) <= 0:
        fail(f"{label}: gather_tiles launches in the init frames "
             f"{init_gathers}")
    launch_gates(label, counts, stage_ms, cfg)

    # ---- the bootstrap + 2 frames on the CPU ---------------------------
    n_cpu = first_track + 1 + HOST_VIO_CPU_TRACKING
    cpu = host_vio_run(cam, cfg, imu_meas, "cpu", t0)
    c0 = time.perf_counter()
    cpu.feed(frames, 0, n_cpu)
    cmats, cstages, _ = cpu.trace()
    gap = np.linalg.norm(cmats[:, :3, 3] - mats[:n_cpu, :3, 3], axis=-1)
    same = bool((cstages == stages[:n_cpu]).all())
    emit({"phase": f"{label}_cpu", "card": smi, "frames": n_cpu,
          "max_pos_gap_m": float(gap.max()), "stages_equal": same,
          "stages": cstages.tolist(), "cpu_s": time.perf_counter() - c0})
    if gap.max() > POSE_TOL_M or not same:
        fail(f"{label}: card and CPU disagree: gap {gap.max()} m, stages "
             f"{cstages.tolist()} vs {stages[:n_cpu].tolist()}")
    return counts, (mats, line["ate_m"])


def host_mono_phase(smi: str, frames: list, slice_mats: np.ndarray,
                    slice_meta: np.ndarray) -> dict:
    """``FrameHandlerMono`` (OneShot) on the slice phase's 40 frames: the
    slice's gates, and every pose within HOST_MONO_TOL of the slice's
    ``DevicePipelineMono`` (the JAX package's two mono paths agree within
    1e-4 m on the CPU: tests/test_torch_host_reloc.py). Returns the
    launch counts and the run's (poses, stages, keyframe flags)."""
    cam = Camera.pinhole(*INTR, W, H)
    cfg = euroc_config()
    h = FrameHandlerMono(cfg, cam, device="cuda")
    run = HostRun(h, h.add_image, [], "cuda")
    events: list = []
    time_methods(h, STAGES, events)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    wall, chunk_fps = timed_run(run, frames, N_FRAMES, 5)
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    stage_ms = per_call(events)
    mats, stages, kf = run.trace()
    gap = np.linalg.norm(mats[:, :3, 3] - slice_mats[:, :3, 3], axis=-1)
    same = bool((stages == slice_meta[:, 0]).all()
                and (kf == slice_meta[:, 2].astype(bool)).all())
    line = {"phase": "host_mono", "card": smi, "handler": "FrameHandlerMono",
            "resolution": [W, H],
            **run_fields(run, wall, chunk_fps, 5, stage_ms, counts),
            "max_pos_gap_to_slice_m": float(gap.max()),
            "stages_keyframes_equal_to_slice": same}
    emit(line)
    if not (stages == Stage.TRACKING.value).all():
        fail(f"host_mono left TRACKING: stages {stages.tolist()}")
    if not same or gap.max() > HOST_MONO_TOL:
        fail(f"host_mono: {gap.max()} m from the slice's DevicePipelineMono"
             f", stages/keyframes equal {same}")
    launch_gates("host_mono", counts, stage_ms, cfg)
    stage_profile_step(smi, h)
    return counts, (mats, stages, kf)


def stage_profile_step(smi: str, h) -> None:
    """The trace tool on the card: ``utils.stage_profile.profile_frontend``
    (CUDA events, PROFILE_REPS calls a stage) on ``h``'s live state after
    its run, and ``roofline_summary`` at the H100's memory rate; every
    stage's ms finite and positive, both image-touching stages bounded."""
    prof = stage_profile.profile_frontend(h, h.ring, h.pool, h.last_frame,
                                          h._depth_state, reps=PROFILE_REPS)
    roof = stage_profile.roofline_summary(prof, H, W, h.n_levels)
    emit({"phase": "stage_profile", "card": smi, "handler": type(h).__name__,
          "reps": PROFILE_REPS, "stage_ms": prof, "roofline": roof})
    bad = {k: v for k, v in prof.items() if not (np.isfinite(v) and v > 0)}
    if bad or len(prof) != 8:
        fail(f"stage_profile: stage ms {prof}")
    if set(roof) != {"pyramid_creation", "sparse_img_align"} or not all(
            np.isfinite(r["x_from_roof"]) and r["x_from_roof"] > 0
            for r in roof.values()):
        fail(f"stage_profile: roofline {roof}")


def host_rig_phase(smi: str, kind: str, cams: list, T_body_cams: list,
                   views: list, poses: list, n_frames: int) -> dict:
    """``FrameHandlerStereo`` (``kind`` "stereo") or ``FrameHandlerArray``
    on a rig phase's views: fps, stage ms, the landmarks and gathers of
    every keyframe triangulation, unaligned ATE; the gates of the JAX host
    tests (tests/test_pipeline_stereo.py:50-63, test_pipeline_array.py
    :46-54: TRACKING by frame 1 and at the end, unaligned ATE < 0.15 ×
    path; stereo also the path's scale within 0.85–1.18), every sparse
    alignment on every camera, the gathers in every triangulation, the
    launch gates. Returns the launch counts."""
    cfg = stereo_config()
    Tb = [se3_of(T) for T in T_body_cams]
    if kind == "stereo":
        h = FrameHandlerStereo(cfg, cams[0], cams[1], Tb[0], Tb[1],
                               device="cuda")
        add = lambda v, ts: h.add_image_pair(v[0], v[1], ts)  # noqa: E731
    else:
        cfg.pipeline_is_stereo = False
        h = FrameHandlerArray(cfg, cams, Tb, device="cuda")
        add = h.add_image_bundle
    run = HostRun(h, add, [], "cuda")
    events: list = []
    time_methods(h, STAGES + ("_triangulate_keyframe",), events)
    tri_gathers: list = []
    count_launches_in(h, "_triangulate_keyframe", cuda_tiles.GATHER_TILES,
                      tri_gathers)
    landmarks: list = []
    inner = h._triangulate_keyframe

    def logged(*a, **k):
        out = inner(*a, **k)
        landmarks.append(out[3])          # read after the run
        return out
    h._triangulate_keyframe = logged
    n_align_cams: list = []
    extra_inputs = h._extra_align_inputs

    def counted_inputs(*a, **k):
        out = extra_inputs(*a, **k)
        n_align_cams.append(1 + len(out))
        return out
    h._extra_align_inputs = counted_inputs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    wall, chunk_fps = timed_run(run, views, n_frames, HOST_RIG_WARMUP)
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    stage_ms = per_call(events)
    mats, stages, kf = run.trace()
    tracking = stages == Stage.TRACKING.value
    first_track = int(np.argmax(tracking)) if tracking.any() else -1
    label = f"host_{kind}"
    line = {"phase": label, "card": smi, "handler": type(h).__name__,
            "cameras": [c.label for c in cams],
            "resolution": [cams[0].width, cams[0].height],
            **run_fields(run, wall, chunk_fps, HOST_RIG_WARMUP, stage_ms,
                         counts),
            "n_tracking": int(tracking[HOST_RIG_WARMUP:].sum()),
            "n_timed": n_frames - HOST_RIG_WARMUP,
            "first_tracking_frame": first_track,
            "keyframes_after_first": int(kf[1:].sum()),
            "landmarks_per_triangulation": [int(x) for x in landmarks],
            "gathers_per_triangulation": tri_gathers,
            "align_cameras": sorted(set(n_align_cams))}
    if first_track >= 0:
        gt = np.stack([np.linalg.inv(T)[:3, 3]
                       for T in poses[first_track:n_frames]])
        est = mats[first_track:, :3, 3]
        g_rel, e_rel = gt - gt[0], est - est[0]
        line |= {"ate_unaligned_m": unaligned_ate(est, gt),
                 "ate_se3_m": ate_rmse(est, gt, align="se3")[0],
                 "path_scale": float(np.sum(g_rel * e_rel) / max(
                     np.sum(e_rel * e_rel), 1e-12)),
                 "traj_len_m": float(np.linalg.norm(np.diff(gt, axis=0),
                                                    axis=-1).sum())}
    emit(line)
    if not 0 <= first_track <= 1 or stages[-1] != Stage.TRACKING.value:
        fail(f"{label}: stages {stages.tolist()}")
    if not (np.isfinite(mats).all()
            and line["ate_unaligned_m"] < 0.15 * line["traj_len_m"]):
        fail(f"{label}: unaligned ATE {line.get('ate_unaligned_m')} m over "
             f"{line.get('traj_len_m')} m")
    if kind == "stereo" and not 0.85 < line["path_scale"] < 1.18:
        fail(f"{label}: path scale {line['path_scale']}")
    if line["align_cameras"] != [len(cams)]:
        fail(f"{label}: sparse alignment on {line['align_cameras']} "
             f"cameras, expected {len(cams)}")
    if not tri_gathers or min(tri_gathers) <= 0:
        fail(f"{label}: gather_tiles launches per triangulation "
             f"{tri_gathers}")
    launch_gates(label, counts, stage_ms, cfg)
    return counts


def host_slam_phase(smi: str, poses: list, frames: list) -> dict:
    """``FrameHandlerSLAM`` (mono, no IMU; the vio phase's frontend
    configuration, slam_options()'s loop-closing thresholds, the default
    GlobalMapOptions) on the slam phase's input (160 frames, 16 warm-up).
    Held: TRACKING on ≥ 90% of the timed frames, a global-map solve with a
    finite chi2, Sim3 ATE < 0.15 × path, the launch gates. Recorded: ≥ 6
    pose-graph nodes, ≥ 6 global-map states, ≥ 1 loop (the JAX package on
    the CPU reaches 4 nodes, 4 states and no loop on this input:
    JAX_HOST_SLAM_CPU). Returns the launch counts."""
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    cfg = vio_config()
    h = FrameHandlerSLAM(cfg, cam, lc_opts=lc_mod.LoopClosingOptions(
        **HOST_SLAM_LC), device="cuda")
    run = HostRun(h, h.add_image, [], "cuda")
    events: list = []
    time_methods(h, HOST_STAGES + ("_snapshot_data", "_keyframe_rows",
                                   "_reinject_fixed_landmarks"), events)
    time_methods(h.global_map, ("add_keyframe",), events)
    time_methods(pgo_mod, ("optimize",), events)
    time_methods(lc_mod, ("verify_candidate",), events)
    gm_chi2: list = []
    gm_add = h.global_map.add_keyframe

    def logged_gm(*a, **k):
        out = gm_add(*a, **k)
        if out is not None:
            gm_chi2.append(out)
        return out
    h.global_map.add_keyframe = logged_gm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    n = syn.LOOP_FRAMES
    wall, chunk_fps = timed_run(run, frames, n, SLAM_WARMUP)
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    stage_ms = per_call(events)
    mats, stages, kf = run.trace()
    tracking = stages == Stage.TRACKING.value
    first_track = int(np.argmax(tracking)) if tracking.any() else -1
    n_timed = n - SLAM_WARMUP
    n_tracking = int(tracking[SLAM_WARMUP:].sum())
    line = {"phase": "host_slam", "card": smi, "handler": "FrameHandlerSLAM",
            "lc_options": HOST_SLAM_LC,
            "resolution": [syn.BENCH_W, syn.BENCH_H],
            **run_fields(run, wall, chunk_fps, SLAM_WARMUP, stage_ms,
                         counts),
            "n_tracking": n_tracking, "n_timed": n_timed,
            "first_tracking_frame": first_track,
            "keyframes_after_first": int(kf[1:].sum()),
            "pgo_nodes": h._pgo_n, "n_loops_closed": h.n_loops_closed,
            "gm_states": len(h.global_map), "gm_solves": len(gm_chi2),
            "gm_chi2": gm_chi2,
            "fixed_landmarks": int(h.pool.fixed.sum()),
            "jax_host_reference_cpu": JAX_HOST_SLAM_CPU}
    if first_track >= 0:
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses[first_track:]])
        ate, _ = ate_rmse(mats[first_track:, :3, 3], gt, align="sim3")
        line |= {"ate_m": ate, "traj_len_m": float(np.linalg.norm(
            np.diff(gt, axis=0), axis=-1).sum())}
    # recorded, not held (JAX_HOST_SLAM_CPU: 4 nodes, 4 states, no loop)
    line |= {"nodes_gate_passed": h._pgo_n >= 6,
             "gm_states_gate_passed": len(h.global_map) >= 6,
             "loop_gate_passed": h.n_loops_closed >= 1}
    emit(line)
    if n_tracking < 0.9 * n_timed:
        fail(f"host_slam: TRACKING on {n_tracking}/{n_timed} timed frames")
    if not gm_chi2 or not np.isfinite(gm_chi2).all():
        fail(f"host_slam: global-map solves {gm_chi2}")
    if not (np.isfinite(mats).all()
            and line["ate_m"] < 0.15 * line["traj_len_m"]):
        fail(f"host_slam: Sim3 ATE {line.get('ate_m')} m over "
             f"{line.get('traj_len_m')} m")
    launch_gates("host_slam", counts, stage_ms, cfg)
    return counts


def seen_twice(w) -> torch.Tensor:
    """[L] valid landmarks of window ``w`` with two or more valid
    observations."""
    views = torch.zeros(w.L, dtype=torch.long, device=w.q.device)
    views.index_add_(0, torch.clamp(w.obs_lm, 0, w.L - 1),
                     w.obs_valid.long())
    return w.lm_valid & (views >= 2)


def host_backends_phase(smi: str) -> None:
    """``BackendInterface`` on tests/test_backend_interface.py's synthetic
    window (8 keyframes through a 5-state window, IMU factors, 6 LM
    iterations) and ``GlobalMap`` absorbing 40 keyframes through an 8-state
    ring and 100 landmark slots (tests/test_global_map.py's absorb-and-evict
    drift; eviction and slot reuse), each on the card and on the CPU: every
    chi2 within HOST_BACKEND_TOL relative, the poses and the landmarks seen
    from two or more window states within HOST_BACKEND_TOL m; ms per call
    on the card. A landmark seen once has no depth along its bearing, and
    the solve's rounding places it anywhere there: the interface's first
    call holds one state and only such landmarks, so it runs with
    ``void_on_single_view`` (with the default solve the card and the CPU
    ended 0.93 m apart on one landmark); on the JAX test's own global-map
    scene, whose solves hold such landmarks, the first global costs were
    2.4× apart, so the global map's scene keeps every landmark in front of
    every camera of its half of the run. The global map's costs are held
    after a final ``force_optimize``; each earlier solve's gap is
    printed."""
    rng = np.random.default_rng(42)
    states, stream = syn.vi_sequence(8, 0.25)
    lm = rng.uniform([-2, -2, 1.5], [2, 2, 6], (60, 3)).astype(np.float32)
    feeds = []
    for k in range(8):
        q, p = states["q"][k], states["p"][k]
        R = syn.quat_to_matrix_np(q)
        if k == 0:
            dR, dp = np.eye(3), np.zeros(3)
        else:
            dR = syn.se3_exp_np(np.concatenate(
                [np.zeros(3), rng.normal(0, 0.01, 3)]))[:3, :3]
            dp = rng.normal(0, 0.03, 3)
        T_wb = np.eye(4)
        T_wb[:3, :3], T_wb[:3, 3] = R @ dR, p + dp
        pb = (lm - p[None]) @ R
        vis = pb[:, 2] > 0.3
        f = (pb / np.linalg.norm(pb, axis=-1, keepdims=True)).astype(
            np.float32)
        feeds.append((float(states["t"][k]), np.linalg.inv(T_wb),
                      np.where(vis, np.arange(60), -1), f,
                      lm + rng.normal(0, 0.02, lm.shape).astype(np.float32)))
    # the global map's input: test_global_map.py's drift along x with two
    # landmark sets, the first seen by keyframes 0–19 and the second by
    # 20–39 (every landmark in front of every camera of its half, so none is
    # seen once when a solve runs), 100 slots: the second set takes over
    # slots the first still holds
    glm = np.concatenate([
        rng.uniform([-2, -2, 2], [2, 2, 6], (60, 3)),
        rng.uniform([0, -2, 2], [4, 2, 6], (60, 3))]).astype(np.float32)
    gfeeds = []
    for k in range(40):
        T_wb = syn.se3_exp_np([0.04 * k, 0.05 * np.sin(0.2 * k), 0.01 * k,
                               0.0, 0.005 * np.sin(0.1 * k), 0.0])
        R, p = T_wb[:3, :3], T_wb[:3, 3].copy()
        if k > 0:
            T_wb[:3, 3] += rng.normal(0, 0.02, 3)
        pb = (glm - p[None]) @ R
        half = np.arange(120) // 60 == k // 20
        f = (pb / np.linalg.norm(pb, axis=-1, keepdims=True)).astype(
            np.float32)
        gfeeds.append((k, np.linalg.inv(T_wb), np.where(
            half & (pb[:, 2] > 0.3), np.arange(120), -1), f,
            glm + rng.normal(0, 0.01, glm.shape).astype(np.float32)))
    out = {}
    for dev in ("cuda", "cpu"):
        Tcb = SE3.identity()
        imu = ImuHandler(ImuParams())
        for m in stream:
            imu.add_measurement(*m)
        # the first call's landmarks are all seen once: see the docstring
        be = BackendInterface(300.0, Tcb, num_keyframes=5,
                              imu_params=ImuParams(),
                              opts=BAOptions(max_iter=6,
                                             gravity=(0.0, 0.0, -9.81),
                                             void_on_single_view=True),
                              device=dev)
        ms, chi2, T_out = [], [], []
        for ts, T_cw, lids, f, lmn in feeds:
            c0 = time.perf_counter()
            res = be.add_keyframe(ts, se3_of(T_cw), lids, f, lmn,
                                  imu_handler=imu)
            if dev == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - c0) * 1e3)
            chi2.append(res.chi2)
            T_out.append(res.T_cam_world.as_matrix().cpu().numpy())
        lm_out = res.lm_pos[seen_twice(be.window)[
            torch.as_tensor(sorted(be.slot2lid))]].cpu().numpy()
        gm = GlobalMap(300.0, Tcb, GlobalMapOptions(
            max_keyframes=8, max_landmarks=100, max_obs=800,
            optimize_every=4, ba_iters=4), device=dev)
        gms, gchi2 = [], []
        for kid, T_cw, lids, f, lmn in gfeeds:
            c0 = time.perf_counter()
            c = gm.add_keyframe(kid, se3_of(T_cw), lids, f, lmn)
            if dev == "cuda":
                torch.cuda.synchronize()
            gms.append((time.perf_counter() - c0) * 1e3)
            if c is not None:
                gchi2.append(c)
        final = gm.force_optimize()
        w = gm.window
        out[dev] = dict(ms=ms, chi2=np.array(chi2), T=np.stack(T_out),
                        lm=lm_out, gms=gms, gchi2=np.array(gchi2),
                        final=final, gp=w.p.cpu().numpy(),
                        glm=w.lm_pos[seen_twice(w)].cpu().numpy(),
                        reused=gm._lm_cursor - w.L)
    g, c = out["cuda"], out["cpu"]

    def rel(a, b):
        """Largest relative gap (absolute below 1)."""
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return float("inf")
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0),
                            initial=0.0))

    held = {
        "interface_chi2_rel_gap": rel(g["chi2"], c["chi2"]),
        "interface_pose_gap_m": rel(g["T"], c["T"]),
        "interface_lm_gap_m": rel(g["lm"], c["lm"]),
        "global_map_final_chi2_rel_gap": abs(g["final"] - c["final"])
        / max(abs(c["final"]), 1e-12),
        "global_map_pose_gap_m": rel(g["gp"], c["gp"]),
        "global_map_lm_gap_m": rel(g["glm"], c["glm"])}
    emit({"phase": "host_backends", "card": smi,
          "interface_ms_per_call": float(np.median(g["ms"])),
          "interface_chi2_card": g["chi2"].tolist(),
          "global_map_ms_per_call": float(np.median(g["gms"])),
          "global_map_ms_max": float(np.max(g["gms"])),
          "global_map_solves": len(g["gchi2"]),
          "global_map_chi2_card": g["gchi2"].tolist(),
          "global_map_final_chi2_card": g["final"],
          # each solve runs ba_iters LM iterations from where the last one
          # left off; accept/reject ties part the card's path from the
          # CPU's on the way, the final solve's cost is held
          "global_map_solve_chi2_gap_max": rel(g["gchi2"], c["gchi2"]),
          "global_map_slots_reused": g["reused"], **held})
    if not all(np.isfinite(x) and x <= HOST_BACKEND_TOL
               for x in held.values()):
        fail(f"host_backends: card and CPU disagree: {held}")


# ---------------------------------------------------------------------------
# phase 10: the user's entry points (runners, loader, checkpoints), every
# detector, edge depth
# ---------------------------------------------------------------------------

EUROC_T0_NS = asl.EUROC_T0_NS      # EuRoC MH_01's first camera stamp
EUROC_FRAMES = 80                  # the vio input's first 80 frames
EUROC_WARMUP = 20
EUROC_MONO_FRAMES = 60
EUROC_STEREO_FRAMES = 40
EUROC_STEREO_WARMUP = 10
PINHOLE_YAML = ROOT / "examples" / "param" / "pinhole.yaml"
EUROC_STEREO_YAML = ROOT / "examples" / "param" / "euroc_stereo.yaml"
TUM_TOL = 1e-6                     # TUM file vs poses: %.6f m rounds by
#                                    5e-7; epoch seconds in float64 by 2.4e-7
CHECKPOINT_FRAMES = 20
DETECTOR_FRAMES = 20
DETECTOR_RTOL = 1e-4               # scores, card vs CPU, relative
EDGE_FEATURES = 512
EDGE_ITERS = 10
EDGE_TOL = 1e-3                    # edge response and depth, relative
# the JAX package on the CPU, same input and configuration
# (tests/reference_cpu.py euroc_mono): initializing 8 frames, TRACKING 2,
# then relocalizing to the end
JAX_EUROC_MONO_CPU = {"frames": 60, "first_tracking_frame": 8,
                      "n_tracking_after_warmup": 0,
                      "relocalizing_frames": 50}


def choose_png_decoder(smi: str) -> str:
    """The native PNG decoder when the local C++ compiler builds it
    with zlib (``native_loader.toolchain_check``), else the numpy decoder:
    chosen here once, explicitly, and printed."""
    ok, log = native_loader.toolchain_check()
    name = "native" if ok else "numpy"
    t0 = time.perf_counter()
    native_loader.decoder(name)                 # builds the native library
    emit({"phase": "png_decoder", "card": smi, "chosen": name,
          "native_toolchain": ok, "toolchain_log": log[-400:],
          "build_s": time.perf_counter() - t0})
    return name


def write_bench_folder(root: Path, poses: list, frames: list,
                       imu_meas: list) -> tuple[str, str]:
    """The vio input as an ASL folder at EuRoC-epoch ns stamps, and a rig
    calibration of bench.py's camera (body at the camera) with the default
    IMU parameters. Returns (dataset, calibration) paths."""
    n = len(frames)
    cam_ns = [EUROC_T0_NS + k * round(syn.CAM_DT * 1e9) for k in range(n)]
    t_end = (n - 1) * syn.CAM_DT
    imu = [(EUROC_T0_NS + round(t * 1e9), g, a) for t, g, a in imu_meas
           if t <= t_end]
    asl.write_asl(str(root / "seq"), [np.asarray(f) for f in frames], cam_ns,
                  [np.linalg.inv(T) for T in poses], imu, level=1)
    asl.write_calib(str(root / "calib.yaml"), syn.BENCH_INTRINSICS,
                    syn.BENCH_W, syn.BENCH_H, imu_params=ImuParams())
    return str(root / "seq"), str(root / "calib.yaml")


def tum_gap(out) -> float:
    """Largest gap between the TUM file the runner wrote and the poses it
    returned (positions and stamps)."""
    ts, pos = load_trajectory_tum(out.out)
    mats = np.stack(out.poses)
    if len(ts) != len(out.poses):
        return float("inf")
    return max(float(np.abs(pos - mats[:, :3, 3]).max()),
               float(np.abs(ts - np.asarray(out.stamps)).max()))


def runner_fields(out, wall_s: float, warmup: int, stage_ms: dict,
                  counts: dict) -> dict:
    n = len(out.stamps)
    return {"frames": n, "warmup": warmup, "png_decoder": out.png_decoder,
            "read_ms_per_frame": out.read_s / n * 1e3,
            "fps_overall": n / wall_s, "command_s": wall_s,
            "host_reads_per_frame": getattr(out.handler, "host_reads",
                                            0) / n,
            "stage_ms_per_call": {k.lstrip("_"): t / c
                                  for k, (c, t) in stage_ms.items()},
            "stage_calls": {k.lstrip("_"): c
                            for k, (c, _) in stage_ms.items()},
            "launches": counts,
            "peak_mem_MB": torch.cuda.max_memory_allocated() / 2 ** 20,
            "tum_max_gap": tum_gap(out)}


def euroc_vio_run(smi: str, label: str, seq: str, calib: str, decoder: str,
                  poses: list, session) -> dict:
    """``run_euroc_vio.main`` in-process on the folder, the host
    ``FrameHandlerVIO`` (``euroc``) or ``--device-pipeline`` (``euroc_
    device``), with the vio phase's configuration, the rpg results layout
    and the TUM file; the vio phase's gates. ``session``: for ``euroc``,
    the host_vio phase's trace of the same frames at session-relative
    stamps and its Sim3 ATE from the first TRACKING frame, recorded beside
    this run's and the JAX package's on the CPU at both (JAX_HOST_VIO_CPU,
    JAX_HOST_VIO_EPOCH_CPU), or
    None. Returns the launch counts."""
    device_pipeline = label == "euroc_device"
    events: list = []
    init_gathers: list = []

    def hook(h):
        if device_pipeline:
            time_methods(h, VIO_STAGES, events)
            time_methods(h.backend, BACKEND_PROGRAMS, events)
            count_launches_in(h, "_branch_init", cuda_tiles.GATHER_TILES,
                              init_gathers)
        else:
            time_methods(h, HOST_STAGES, events)
            time_methods(h.backend, HOST_BACKEND, events)
            count_launches_in(h, "_process_init", cuda_tiles.GATHER_TILES,
                              init_gathers)

    root = Path(seq).parent
    argv = [seq, "--calib", calib, "--results-dir",
            str(root / f"results_{label}"), "--out",
            str(root / f"{label}.txt"), "--max-frames", str(EUROC_FRAMES),
            "--png-decoder", decoder]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    c0 = time.perf_counter()
    out = run_euroc_vio.main(argv + ["--device-pipeline"] * device_pipeline,
                             on_handler=hook, cfg=vio_config())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - c0
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    stage_ms = per_call(events)
    h = out.handler
    if device_pipeline:
        stages = out.meta[:, 0].astype(int)
        n_states, chi2 = h.world.backend_k, float(h.world.backend_chi2)
    else:
        stages = np.array([r.stage.value for r in out.results])
        n_states = h.backend.n_states
        chi2 = float(h.stats.get("backend_chi2", float("nan")))
    mats = np.stack(out.poses)
    tracking = stages == Stage.TRACKING.value
    first_track = int(np.argmax(tracking)) if tracking.any() else -1
    n_timed = EUROC_FRAMES - EUROC_WARMUP
    summary = out.summary
    line = {"phase": label, "card": smi, "runner": "run_euroc_vio",
            "handler": type(h).__name__,
            "config": "mono_vio_degraded_imagery",
            "resolution": [syn.BENCH_W, syn.BENCH_H],
            "first_stamp_s": out.stamps[0],
            **runner_fields(out, wall_s, EUROC_WARMUP, stage_ms, counts),
            "n_tracking": int(tracking[EUROC_WARMUP:].sum()),
            "n_timed": n_timed, "first_tracking_frame": first_track,
            "backend_keyframes": int(n_states), "backend_chi2": chi2,
            "gather_launches_in_init_frames": init_gathers,
            "rpg_summary": summary}
    if first_track >= 0:
        gt = np.stack([np.linalg.inv(T)[:3, 3]
                       for T in poses[first_track:EUROC_FRAMES]])
        line["ate_m_from_first_tracking"] = ate_rmse(
            mats[first_track:, :3, 3], gt, align="sim3")[0]
    if session is not None:
        s_mats, s_ate = session
        gap = np.linalg.norm(mats[:, :3, 3] - s_mats[:EUROC_FRAMES, :3, 3],
                             axis=-1)
        line["session_stamps"] = {
            "ate_m_from_first_tracking": s_ate,
            "max_pos_gap_m": float(gap.max()),
            "median_pos_gap_m": float(np.median(gap)),
            "bit_identical": bool(np.array_equal(
                mats, s_mats[:EUROC_FRAMES]))}
        line["jax_reference_cpu"] = {"session_stamps": JAX_HOST_VIO_CPU,
                                     "epoch_stamps": JAX_HOST_VIO_EPOCH_CPU}
    emit(line)
    if line["n_tracking"] < 0.9 * n_timed:
        fail(f"{label}: TRACKING on {line['n_tracking']}/{n_timed} timed "
             "frames")
    if not 0 <= first_track < EUROC_WARMUP:
        fail(f"{label}: TRACKING first reached at frame {first_track}")
    if not (n_states >= 2 and np.isfinite(chi2) and chi2 > 0):
        fail(f"{label}: backend {n_states} states, chi2 {chi2}")
    if not (np.isfinite(mats).all() and "ate_rmse_sim3_m" in summary
            and summary["ate_rmse_sim3_m"]
            < 0.15 * summary["traj_length_m"]):
        fail(f"{label}: rpg summary {summary}")
    if line["tum_max_gap"] > TUM_TOL:
        fail(f"{label}: the TUM file is {line['tum_max_gap']} from the "
             "poses returned")
    if not init_gathers or min(init_gathers) <= 0:
        fail(f"{label}: gather_tiles launches in the init frames "
             f"{init_gathers}")
    launch_gates(label, counts, stage_ms, vio_config())
    return counts


def euroc_mono_run(smi: str, seq: str, calib: str, decoder: str,
                   poses: list) -> dict:
    """``run_euroc_mono.main`` with examples/param/pinhole.yaml and a
    tracefile on the folder's first 60 frames: the bootstrap reaches
    TRACKING within the warm-up, the tracefile has a row a frame, the TUM
    file equals the poses, the launch gates; TRACKING after the warm-up and
    the Sim3 ATE of the tracked frames are recorded beside the JAX
    package's on the same input (JAX_EUROC_MONO_CPU). Returns the launch
    counts."""
    events: list = []
    root = Path(seq).parent
    trace_dir = root / "trace_mono"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    c0 = time.perf_counter()
    out = run_euroc_mono.main(
        [seq, "--calib", calib, "--config", str(PINHOLE_YAML),
         "--trace-dir", str(trace_dir), "--out", str(root / "mono.txt"),
         "--max-frames", str(EUROC_MONO_FRAMES), "--png-decoder", decoder],
        on_handler=lambda h: time_methods(h, HOST_STAGES, events))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - c0
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    stage_ms = per_call(events)
    stages = np.array([r.stage.value for r in out.results])
    tracking = stages == Stage.TRACKING.value
    first_track = int(np.argmax(tracking)) if tracking.any() else -1
    rows = (trace_dir / "trace.csv").read_text().splitlines() \
        if (trace_dir / "trace.csv").exists() else []
    line = {"phase": "euroc_mono", "card": smi, "runner": "run_euroc_mono",
            "config": "examples/param/pinhole.yaml",
            **runner_fields(out, wall_s, EUROC_WARMUP, stage_ms, counts),
            "first_tracking_frame": first_track,
            "n_tracking_after_warmup": int(tracking[EUROC_WARMUP:].sum()),
            "relocalizing_frames": int(
                (stages == Stage.RELOCALIZING.value).sum()),
            "tracefile_rows": len(rows) - 1,
            "tracefile_columns": rows[0].split(",") if rows else [],
            "jax_reference_cpu": JAX_EUROC_MONO_CPU}
    tr = np.nonzero(tracking)[0]
    if len(tr) > 3:
        mats = np.stack(out.poses)
        gt = np.stack([np.linalg.inv(poses[k])[:3, 3] for k in tr])
        line["ate_m_tracked"] = ate_rmse(mats[tr, :3, 3], gt,
                                         align="sim3")[0]
    emit(line)
    if not 0 <= first_track < EUROC_WARMUP:
        fail(f"euroc_mono: TRACKING first reached at frame {first_track}")
    if line["tracefile_rows"] != EUROC_MONO_FRAMES:
        fail(f"euroc_mono: {line['tracefile_rows']} tracefile rows for "
             f"{EUROC_MONO_FRAMES} frames")
    if line["tum_max_gap"] > TUM_TOL:
        fail(f"euroc_mono: the TUM file is {line['tum_max_gap']} from the "
             "poses returned")
    launch_gates("euroc_mono", counts, stage_ms, out.handler.cfg)
    return counts


def euroc_stereo_run(smi: str, root: Path, decoder: str) -> dict:
    """The rig phases' two-camera input (first 40 frames) as cam0/cam1 of
    an ASL folder, through ``run_euroc_stereo.main`` with its default
    calibration (examples/param/euroc_stereo.yaml, body at the IMU) and
    examples/param/pinhole.yaml; host_stereo's gates on the motion relative
    to the first frame (the runner's world is the IMU's first pose):
    TRACKING by frame 1 and at the end, unaligned ATE < 0.15 × path, path
    scale 0.85–1.18, every alignment on both cameras, gathers in every
    triangulation, the launch gates. Returns the launch counts."""
    n = EUROC_STEREO_FRAMES
    cams, T_body = syn.euroc_stereo_rig()
    poses, views, _ = syn.rig_sequence(n, cams, T_body, STEREO_SEEDS, "cuda")
    cam_ns = [EUROC_T0_NS + k * round(syn.CAM_DT * 1e9) for k in range(n)]
    rig = load_rig_yaml(str(EUROC_STEREO_YAML), device="cpu")
    T_bc0 = rig.T_B_C_matrices[0]
    asl.write_asl(str(root / "seq"), [v[0] for v in views], cam_ns,
                  [np.linalg.inv(T) @ np.linalg.inv(T_bc0) for T in poses],
                  frames1=[v[1] for v in views], level=1)
    events: list = []
    tri_gathers: list = []
    n_align_cams: list = []

    def hook(h):
        time_methods(h, STAGES + ("_triangulate_keyframe",), events)
        count_launches_in(h, "_triangulate_keyframe",
                          cuda_tiles.GATHER_TILES, tri_gathers)
        extra = h._extra_align_inputs

        def counted(*a, **k):
            got = extra(*a, **k)
            n_align_cams.append(1 + len(got))
            return got
        h._extra_align_inputs = counted

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    c0 = time.perf_counter()
    out = run_euroc_stereo.main(
        [str(root / "seq"), "--config", str(PINHOLE_YAML), "--out",
         str(root / "stereo.txt"), "--png-decoder", decoder],
        on_handler=hook)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - c0
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    stage_ms = per_call(events)
    stages = np.array([r.stage.value for r in out.results])
    mats = np.stack(out.poses)
    # motion relative to the first frame, in cam0's first frame
    est = np.stack([np.linalg.inv(mats[0]) @ M for M in mats])[:, :3, 3]
    gt = np.stack([poses[0] @ np.linalg.inv(T) for T in poses])[:, :3, 3]
    g_rel, e_rel = gt - gt[0], est - est[0]
    line = {"phase": "euroc_stereo", "card": smi,
            "runner": "run_euroc_stereo",
            "config": "examples/param/pinhole.yaml",
            "calib": "examples/param/euroc_stereo.yaml",
            **runner_fields(out, wall_s, EUROC_STEREO_WARMUP, stage_ms,
                            counts),
            "stages": stages.tolist(),
            "keyframes_after_first": int(sum(r.is_keyframe
                                             for r in out.results[1:])),
            "gathers_per_triangulation": tri_gathers,
            "align_cameras": sorted(set(n_align_cams)),
            "ate_unaligned_m": unaligned_ate(est, gt),
            "path_scale": float(np.sum(g_rel * e_rel)
                                / max(np.sum(e_rel * e_rel), 1e-12)),
            "traj_len_m": float(np.linalg.norm(np.diff(gt, axis=0),
                                               axis=-1).sum())}
    emit(line)
    tracking = stages == Stage.TRACKING.value
    if not (tracking[:2].any() and tracking[-1]):
        fail(f"euroc_stereo: stages {stages.tolist()}")
    if not (np.isfinite(mats).all()
            and line["ate_unaligned_m"] < 0.15 * line["traj_len_m"]):
        fail(f"euroc_stereo: unaligned ATE {line['ate_unaligned_m']} m "
             f"over {line['traj_len_m']} m")
    if not 0.85 < line["path_scale"] < 1.18:
        fail(f"euroc_stereo: path scale {line['path_scale']}")
    if line["align_cameras"] != [2]:
        fail(f"euroc_stereo: sparse alignment on {line['align_cameras']} "
             "cameras")
    if not tri_gathers or min(tri_gathers) <= 0:
        fail(f"euroc_stereo: gather_tiles launches per triangulation "
             f"{tri_gathers}")
    if line["tum_max_gap"] > TUM_TOL:
        fail(f"euroc_stereo: the TUM file is {line['tum_max_gap']} from "
             "the poses returned")
    launch_gates("euroc_stereo", counts, stage_ms, out.handler.cfg)
    return counts


def euroc_phases(smi: str, poses: list, frames: list, imu_meas: list,
                 session) -> dict:
    """The EuRoC runners on the card, in-process, from ASL folders at
    EuRoC-epoch stamps: ``euroc`` (host VIO) and ``euroc_device``
    (``--device-pipeline``) on the vio input's first 80 frames,
    ``euroc_mono`` on its first 60, ``euroc_stereo`` on the rig input's
    first 40. ``session``: the host_vio phase's trace of the same frames
    at session-relative stamps and its ATE (what the epoch changed), or
    None. Returns the launch counts by phase."""
    decoder = choose_png_decoder(smi)
    counts = {}
    with tempfile.TemporaryDirectory() as d:
        c0 = time.perf_counter()
        seq, calib = write_bench_folder(Path(d), poses[:EUROC_FRAMES],
                                        frames[:EUROC_FRAMES], imu_meas)
        emit({"phase": "euroc_folder", "frames": EUROC_FRAMES,
              "write_s": time.perf_counter() - c0,
              "first_stamp_ns": EUROC_T0_NS})
        for label in ("euroc", "euroc_device"):
            counts[label] = euroc_vio_run(
                smi, label, seq, calib, decoder, poses,
                session if label == "euroc" else None)
        counts["euroc_mono"] = euroc_mono_run(smi, seq, calib, decoder,
                                              poses)
    with tempfile.TemporaryDirectory() as d:
        counts["euroc_stereo"] = euroc_stereo_run(smi, Path(d), decoder)
    return counts


def checkpoint_phase(smi: str, frames: list, whole: tuple) -> dict:
    """``FrameHandlerMono`` on host_mono's input: 20 frames, ``save_state``,
    a new handler, ``load_state``, 20 frames; the 40 results must equal
    host_mono's uninterrupted run (``whole``: its poses, stages and
    keyframe flags) to the bit. Returns the launch counts."""
    cam, cfg = Camera.pinhole(*INTR, W, H), euroc_config()
    h = FrameHandlerMono(cfg, cam, device="cuda")
    torch.cuda.synchronize()
    _cuda.reset_counts()
    first = HostRun(h, h.add_image, [], "cuda")
    first.feed(frames, 0, CHECKPOINT_FRAMES)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "state.npz")
        c0 = time.perf_counter()
        sio.save_state(path, h)
        save_s = time.perf_counter() - c0
        size = Path(path).stat().st_size
        h2 = FrameHandlerMono(cfg, cam, device="cuda")
        c0 = time.perf_counter()
        sio.load_state(path, h2)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - c0
    second = HostRun(h2, h2.add_image, [], "cuda")
    second.feed(frames, CHECKPOINT_FRAMES, 2 * CHECKPOINT_FRAMES)
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    got = [np.concatenate(x) for x in zip(first.trace(), second.trace())]
    n = 2 * CHECKPOINT_FRAMES
    same = all(np.array_equal(a, b[:n]) for a, b in zip(got, whole))
    emit({"phase": "checkpoint", "card": smi, "frames": n,
          "resumed_at": CHECKPOINT_FRAMES, "save_s": save_s,
          "load_s": load_s, "file_MB": size / 2 ** 20,
          "equal_to_uninterrupted": same,
          "max_pos_diff_m": float(np.abs(got[0][:, :3, 3]
                                         - whole[0][:n, :3, 3]).max()),
          "launches": counts})
    if not same:
        fail("checkpoint: the resumed run differs from the uninterrupted one")
    if min(counts["gather_tiles"], counts["align_level"]) <= 0:
        fail(f"checkpoint: launches {counts}")
    return counts


def _detections(det) -> np.ndarray:
    """Valid detections as rows (x, y, level, type, score), sorted by
    position: the set a detector found, whatever its rank order."""
    v = det.valid.cpu().numpy()
    rows = np.concatenate([det.px.cpu().numpy()[v],
                           det.level.cpu().numpy()[v, None],
                           det.ftype.cpu().numpy()[v, None],
                           det.score.cpu().numpy()[v, None]], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def detectors_phase(smi: str, bench_frame, plane_frames: list) -> dict:
    """Every ``detector_type`` on bench.py's first frame, card against CPU
    (the same cells, pixels, levels and types; scores within 1e-4 of the
    largest), with its card ms; then ``FrameHandlerMono`` with
    ``shitomasi_grad`` on host_mono's first 20 frames: TRACKING on every
    frame (the JAX package tracks every frame of the CPU test's run,
    tests/test_torch_detectors.py) and the launch gates. Returns the
    launch counts of the handler's run."""
    cs_ = 30
    n_cols, n_rows = -(-syn.BENCH_W // cs_), -(-syn.BENCH_H // cs_)
    pyr = {dev: build_pyramid(image_to_float(np.asarray(bench_frame), dev),
                              4) for dev in ("cuda", "cpu")}
    kinds = {}
    for kind in det_mod.DETECTOR_TYPES:
        got = {}
        for dev in ("cuda", "cpu"):
            occ = torch.zeros(n_cols * n_rows, dtype=torch.bool, device=dev)

            def run(dev=dev, occ=occ):
                return det_mod.detect_features(
                    pyr[dev], occ, cs_, n_cols, n_rows, max_features=360,
                    threshold_primary=8.0, max_level=3, detector_type=kind)
            got[dev] = _detections(run())
            if dev == "cuda":
                card_ms = gs.cuda_ms(run, reps=3, samples=3)
        a, b = got["cuda"], got["cpu"]
        same = a.shape == b.shape and np.array_equal(a[:, :4], b[:, :4])
        err = (float(np.abs(a[:, 4] - b[:, 4]).max()
                     / max(np.abs(b[:, 4]).max(), 1.0)) if same else None)
        kinds[kind] = {"n": int(b.shape[0]), "card_n": int(a.shape[0]),
                       "same_cells": bool(same), "score_rel_err": err,
                       "card_ms": card_ms}
    cam, cfg = Camera.pinhole(*INTR, W, H), euroc_config()
    cfg.detector.detector_type = "shitomasi_grad"
    h = FrameHandlerMono(cfg, cam, device="cuda")
    events: list = []
    time_methods(h, STAGES, events)
    run = HostRun(h, h.add_image, [], "cuda")
    torch.cuda.synchronize()
    _cuda.reset_counts()
    wall, chunk_fps = timed_run(run, plane_frames, DETECTOR_FRAMES, 5)
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    stage_ms = per_call(events)
    _, stages, kf = run.trace()
    emit({"phase": "detectors", "card": smi,
          "resolution": [syn.BENCH_W, syn.BENCH_H], "detectors": kinds,
          "shitomasi_grad_handler": {
              "frames": DETECTOR_FRAMES, "stages": stages.tolist(),
              "keyframes_after_first": int(kf[1:].sum()),
              "fps_overall": float(len(wall) / np.sum(wall)),
              "launches": counts}})
    bad = [k for k, v in kinds.items()
           if not v["same_cells"] or v["score_rel_err"] > DETECTOR_RTOL
           or v["n"] == 0]
    if bad:
        fail(f"detectors: card and CPU disagree for {bad}")
    if not (stages == Stage.TRACKING.value).all():
        fail(f"detectors: shitomasi_grad run left TRACKING: "
             f"{stages.tolist()}")
    launch_gates("detectors", counts, stage_ms, cfg)
    return counts


def edge_depth_phase(smi: str, poses: list, frames: list) -> dict:
    """``detect_edges`` on bench.py's first frame and
    ``refine_depth_photometric`` of its 512 strongest edge pixels (levels
    0–1, 3.4 m initial depth, 10 GN iterations) into the second frame, on
    the card and on the CPU: the finest reliable level equal on ≥ 99.9% of
    pixels and the edge response within 1e-3 of the largest there; the
    converged sets equal and depths within 1e-3 relative; gather_tiles
    launched once per GN iteration. The counts are set to 0 before the
    card's ``detect_edges`` and read after its refinement; each function is
    then timed again warm (CUDA events on the card, the wall clock on the
    CPU, 3 calls) beside its first, cold call. Returns the launch counts."""
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    T = np.asarray(poses[1]) @ np.linalg.inv(poses[0])
    res, counts = {}, {}
    for dev in ("cuda", "cpu"):
        pyr0 = build_pyramid(image_to_float(np.asarray(frames[0]), dev), 4)
        pyr1 = build_pyramid(image_to_float(np.asarray(frames[1]), dev), 4)
        if dev == "cuda":
            torch.cuda.synchronize()
            _cuda.reset_counts()
        c0 = time.perf_counter()
        edges = edge_depth.detect_edges(pyr0)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = {"edges": edges, "edges_s": time.perf_counter() - c0}
        if dev == "cuda":
            # features from the card's map, the same for both devices
            mag = torch.where(edges.level <= 1, edges.edge.abs(), 0.0)
            border = torch.zeros_like(mag, dtype=torch.bool)
            border[16:-16, 16:-16] = True
            flat = torch.where(border, mag, 0.0).reshape(-1)
            idx = torch.topk(flat, EDGE_FEATURES).indices
            uv = torch.stack([idx % syn.BENCH_W, idx // syn.BENCH_W],
                             -1).float()
            lvl = edges.level.reshape(-1)[idx]
            feats = (uv.cpu(), lvl.cpu())
        uv, lvl = feats[0].to(dev), feats[1].to(dev)
        camd = cam.to(dev)
        f_ref = proj.backproject(camd, uv)
        offs = interp.patch_offsets(edge_depth.PATCH, device=dev) + 0.5
        ref = torch.zeros((EDGE_FEATURES, edge_depth.PATCH ** 2),
                          device=dev)
        for lv in (0, 1):
            img = level_view(pyr0, lv)
            vals, _ = interp.bilinear(img, uv[:, None, :] / (1 << lv)
                                      + offs[None])
            ref = torch.where((lvl == lv)[:, None], vals, ref)
        Tcr = se3_of(T)
        Tcr = SE3(Tcr.q.to(dev), Tcr.t.to(dev))

        def refine(dev=dev, camd=camd, Tcr=Tcr, f_ref=f_ref, ref=ref,
                   lvl=lvl, pyr1=pyr1):
            return edge_depth.refine_depth_photometric(
                pyr1, camd, Tcr, f_ref, ref,
                torch.full((EDGE_FEATURES,), 3.4, device=dev), lvl,
                torch.ones(EDGE_FEATURES, dtype=torch.bool, device=dev),
                n_iter=EDGE_ITERS)
        c0 = time.perf_counter()
        out = refine()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in _cuda.KERNELS}
        res[dev] |= {"refine": out, "refine_s": time.perf_counter() - c0}
        if dev == "cuda":
            warm = {"edges_ms": gs.cuda_ms(
                        lambda: edge_depth.detect_edges(pyr0), 1, 3),
                    "refine_ms": gs.cuda_ms(refine, 1, 3)}
        else:
            warm = {}
            for key, fn in (("edges_ms",
                             lambda: edge_depth.detect_edges(pyr0)),
                            ("refine_ms", refine)):
                walls = []
                for _ in range(3):
                    c0 = time.perf_counter()
                    fn()
                    walls.append(time.perf_counter() - c0)
                warm[key] = float(np.median(walls) * 1e3)
        res[dev]["warm"] = warm
    ce, pe = res["cuda"]["edges"], res["cpu"]["edges"]
    lev_same = (ce.level.cpu() == pe.level).float().mean().item()
    m = ce.level.cpu() == pe.level
    scale = max(float(pe.edge.abs().max()), 1e-6)
    edge_err = float((ce.edge.cpu() - pe.edge).abs()[m].max()) / scale
    cr, pr = res["cuda"]["refine"], res["cpu"]["refine"]
    conv_same = bool(torch.equal(cr.converged.cpu(), pr.converged))
    both = cr.converged.cpu() & pr.converged
    depth_err = float(((cr.depth.cpu() - pr.depth).abs()
                       / pr.depth.abs())[both].max()) if both.any() else 0.0
    emit({"phase": "edge_depth", "card": smi,
          "resolution": [syn.BENCH_W, syn.BENCH_H],
          "features": EDGE_FEATURES, "gn_iterations": EDGE_ITERS,
          "edge_pixels": int((pe.edge != 0).sum()),
          "level_equal_share": lev_same, "edge_rel_err": edge_err,
          "converged": int(pr.converged.sum()),
          "converged_equal": conv_same, "depth_rel_err": depth_err,
          "launches": counts,
          "cold_s": {d: {k: res[d][k] for k in ("edges_s", "refine_s")}
                     for d in ("cuda", "cpu")},
          "warm_ms": {d: res[d]["warm"] for d in ("cuda", "cpu")}})
    if lev_same < 0.999 or edge_err > EDGE_TOL:
        fail(f"edge_depth: detect_edges card vs CPU: levels equal on "
             f"{lev_same}, response error {edge_err}")
    if not conv_same or depth_err > EDGE_TOL or int(pr.converged.sum()) == 0:
        fail(f"edge_depth: refinement card vs CPU: converged equal "
             f"{conv_same}, depth error {depth_err}")
    if counts["gather_tiles"] != EDGE_ITERS:
        fail(f"edge_depth: {counts['gather_tiles']} gather_tiles launches "
             f"for {EDGE_ITERS} GN iterations")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the multi-device paths, four ranks sharing the card
# ---------------------------------------------------------------------------

MD_RANKS = 4
MD_VIO_FRAMES = 12                 # VIO frames run for a tracked alignment
#                                    (TRACKING from frame 7)
MD_ALIGN_TOL = 1e-5                # tests/test_multichip.py:43-46
MD_SEED_RTOL = 1e-5
MD_SEED_DEPTH = (3.4, 1.4)         # seeds' mean depth (init's expected
#                                    average) and min depth (the sphere's
#                                    nearest point), m
MD_BA_SHAPE = dict(S=8, n_landmarks=200, L=256, obs_per_state=120)
MD_BA_NO = 2048                    # bench.py's No = 1024 (bench.py:390)
#                                    drops rows over 4 shards: a shard's
#                                    landmarks own up to 503 of its 256
MD_BA_ITERS = 3                    # bench.py:392
MD_BA_FOCAL = 460.0                # bench.py:394
MD_BA_TOL = 2e-4                   # p, q: tests/test_sharded_ba.py:92-97
MD_BA_CHI2 = 0.02
MD_GM_KEYFRAMES = 40               # > 32: the ring evicts
MD_GM_TOL = 1e-3                   # m: host_backends' bound on a GlobalMap
#                                    run with eviction across two roundings
#                                    (card vs CPU); test_global_map_dcn.py's
#                                    5e-4 holds one solve (the CPU test keeps
#                                    it), and 40 keyframes solve 11 times,
#                                    each keep-best LM accept/reject turning
#                                    on rounding: the line's ``card_vs_cpu``
#                                    shows how far rounding alone moves one
#                                    rank's run
MD_GM_ACCURACY = 0.03              # m, mean position error of states 1..:
#                                    tests/test_global_map_dcn.py:206-221
MD_GM_MESHES = (((2, 2), ("h", "f")), ((4, 1), ("h",)))


def perturbed_ba_window(No: int):
    """bench.py's window (``synthetic_ba_window``) with ``No`` rows, its
    states perturbed as tests/test_sharded_ba.py:70-79 does."""
    from svo_pro_universal_tpu_torch.utils.transform import (
        quat_multiply, quat_normalize, so3_exp)
    w = syn.synthetic_ba_window(**MD_BA_SHAPE, No=No)
    rng = np.random.default_rng(42)
    dq = [torch.tensor([1.0, 0.0, 0.0, 0.0])]
    for _ in range(w.S - 1):
        dq.append(so3_exp(torch.as_tensor(
            rng.normal(0, 0.02, 3).astype(np.float32))))
    dp = np.concatenate([np.zeros((1, 3)),
                         rng.normal(0, 0.04, (w.S - 1, 3))])
    return w._replace(q=quat_normalize(quat_multiply(w.q, torch.stack(dq))),
                      p=w.p + torch.as_tensor(dp.astype(np.float32)))


def md_alignment_input(poses: list, frames: list, imu_meas: list, dev):
    """The vio configuration's pipeline on bench.py's input for
    ``MD_VIO_FRAMES`` frames; the last sparse alignment's input (a tracked
    frame against the frame before it), state and options."""
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    run = VioRun(cam, vio_config(), imu_meas, dev, MD_VIO_FRAMES)
    calls = []
    run_fn = sia.run

    def recorded(inputs, state0, opts, *a, **k):
        calls.append((inputs, state0, opts))
        return run_fn(inputs, state0, opts, *a, **k)
    sia.run = recorded
    try:
        run.feed(frames, 0, MD_VIO_FRAMES)
    finally:
        sia.run = run_fn
    _, meta = run.pipe.drain()
    if not calls or meta[-1, 0] != Stage.TRACKING.value:
        fail(f"multidevice: frame {MD_VIO_FRAMES - 1} of the vio input not "
             f"tracked (stages {meta[:, 0].tolist()})")
    inputs, state0, opts = calls[-1]
    return inputs[0], state0, opts


def md_seed_input(poses: list, frames: list, dev):
    """The 360 features detected on bench.py's first frame (the vio
    configuration's detector) as fresh seeds, and the second frame with
    the true relative pose: ``update_seeds``' arguments on ``dev``."""
    cfg = vio_config()
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H,
                         device=dev)
    pyr0 = build_pyramid(image_to_float(np.asarray(frames[0]), dev),
                         cfg.n_pyr_levels)
    pyr1 = build_pyramid(image_to_float(np.asarray(frames[1]), dev),
                         cfg.n_pyr_levels)
    cs = cfg.detector.cell_size
    n_cols, n_rows = -(-syn.BENCH_W // cs), -(-syn.BENCH_H // cs)
    det = det_mod.detect_features(
        pyr0, torch.zeros((n_cols * n_rows,), dtype=torch.bool, device=dev),
        cs, n_cols, n_rows, max_features=cfg.capacity.max_fts,
        threshold_primary=cfg.detector.threshold_primary,
        threshold_secondary=cfg.detector.threshold_secondary,
        threshold_shitomasi=cfg.detector.threshold_shitomasi,
        min_level=0, max_level=cfg.detector.max_level,
        detector_type=cfg.detector.detector_type)
    n = det.px.shape[0]
    ones = torch.ones((n,), device=dev)
    ftype = torch.where(det.valid, det.ftype, int(FeatureType.INVALID))
    T = se3_of(np.asarray(poses[1]) @ np.linalg.inv(poses[0]))
    args = (pyr0, pyr1, cam, SE3(T.q.to(dev), T.t.to(dev)), det.px,
            proj.backproject(cam, det.px), det.grad, det.level, ftype,
            seed_mod.make(ones * MD_SEED_DEPTH[0], ones * MD_SEED_DEPTH[1]),
            torch.tensor(1.0 / MD_SEED_DEPTH[1], device=dev))
    kwargs = dict(max_search_level=cfg.detector.max_level,
                  sigma2_convergence_threshold=(
                      cfg.depth_filter.seed_convergence_sigma2_thresh))
    return args, kwargs


def _on_cpu(x):
    """``x`` (tensors, cameras, tuples and NamedTuples of them) on the
    CPU, to be pickled to the ranks."""
    if isinstance(x, tuple):
        vals = [_on_cpu(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x.to("cpu")


def _sum_launches(counts: list) -> dict:
    total = {k.name: 0 for k in _cuda.KERNELS}
    for c in counts:
        for k, v in c.items():
            total[k] += v
    return total


def gm_gap(a: dict, b: dict) -> tuple:
    """(pose gap, landmark gap by id, same ids, chi2 gap relative) of two
    ``global_map_step`` results."""
    same = set(a["lm_ids"].tolist()) == set(b["lm_ids"].tolist())
    lm = (float(np.abs(a["lm_pos"][np.argsort(a["lm_ids"])]
                       - b["lm_pos"][np.argsort(b["lm_ids"])]).max())
          if same else float("inf"))
    return (float(np.abs(a["poses"] - b["poses"]).max()), lm, same,
            abs(a["chi2"] - b["chi2"]) / max(b["chi2"], 1.0))


def gm_error(g: dict) -> float:
    """Mean position error of a global map's states after its first, against
    the feed's true positions (test_global_map_dcn.py's accuracy gate)."""
    err = np.linalg.norm(g["poses"] - g["true_p"][g["kf_ids"]], axis=-1)
    return float(err[1:].mean())


def multidevice_phase(smi: str, device: str = "cuda") -> dict:
    """The sharded programs of ``parallel/`` in one spawn of four ranks
    sharing the card (gloo: NCCL refuses two ranks on one device), each
    step held against the one-rank result this process computes on the
    card: alignment, the seed update, the window BA, the partitioned
    global map at (2, 2) and (4, 1), the dry run; the alignment and the BA
    run twice in the same ranks and must agree to the bit. Four ranks on one
    card share its SMs, and gloo stages every collective through host
    memory: the times measure correctness and bytes, not scale-out.
    Returns the launches summed over the ranks and steps. (``device`` is
    for a rehearsal on the CPU.)"""
    t_phase = time.perf_counter()
    dev = torch.device(device)
    bench = syn.bench_sequence(MD_VIO_FRAMES, 7, dev)
    inp, state0, aopts = md_alignment_input(*bench, dev)
    levels = aopts.max_level - aopts.min_level + 1
    seed_args, seed_kw = md_seed_input(bench[0], bench[1], dev)
    w = perturbed_ba_window(MD_BA_NO)
    wp, ba_dropped = partition_observations(w, MD_RANKS)
    ba_dropped_1024 = partition_observations(
        perturbed_ba_window(1024), MD_RANKS)[1]
    bopts = BAOptions(max_iter=MD_BA_ITERS)
    gm_opts = GlobalMapOptions()
    lm = np.random.default_rng(7).uniform(
        [-2, -2, 2], [2, 2, 6], (80, 3)).astype(np.float32)

    # one rank on the card: the references
    single_align, _ = sia.run([inp], state0, aopts)
    align_ms = gs.cuda_ms(lambda: sia.run([inp], state0, aopts), 1, 3)
    single_seeds = df_mod.update_seeds(
        *seed_args[:3], seed_args[2], *seed_args[3:], **seed_kw,
        matcher_opts=matcher_mod.MatcherOptions(max_epi_search_steps=32))
    wp_dev = wba.tree_map(lambda x: x.to(dev), wp)
    focal = torch.tensor(MD_BA_FOCAL, device=dev)
    Tcb = SE3.identity(device=dev)
    single_w, single_chi2, _ = wba.optimize(wp_dev, Tcb, focal, bopts)
    single_ba_ms = gs.cuda_ms(lambda: wba.optimize(wp_dev, Tcb, focal,
                                                   bopts), 1, 3)
    bench_w = syn.synthetic_ba_window(**MD_BA_SHAPE, No=1024, device=dev)
    ba_solve_ms = gs.cuda_ms(lambda: wba.optimize(bench_w, Tcb, focal,
                                                  bopts), 1, 3)
    single_gm = global_map_step(dev, None, gm_opts, lm, MD_GM_KEYFRAMES,
                                probe_shards=MD_RANKS)
    # the same run on the CPU: how far rounding alone moves it
    cpu_gm = global_map_step("cpu", None, gm_opts, lm, MD_GM_KEYFRAMES)
    ref_s = time.perf_counter() - t_phase

    steps = [
        ("align", dict(shape=(MD_RANKS,), inp=_on_cpu(inp),
                       state0=_on_cpu(state0), opts=aopts, repeats=2,
                       profile=dev.type == "cuda")),
        ("seeds", dict(shape=(MD_RANKS,), args=_on_cpu(seed_args),
                       kwargs=seed_kw)),
        ("ba", dict(shape=(MD_RANKS,), w=wp, T_cam_body=SE3.identity(),
                    focal=torch.tensor(MD_BA_FOCAL), opts=bopts, repeats=2)),
        *[("global_map", dict(shape=shape, axes=axes, opts=gm_opts, lm=lm,
                              n_kf=MD_GM_KEYFRAMES))
          for shape, axes in MD_GM_MESHES],
        ("dryrun", dict(n=MD_RANKS))]
    c0 = time.perf_counter()
    rank_dev = None if dev.type == "cuda" else device
    ranks = launch(MD_RANKS, run_steps, rank_dev, steps, device=rank_dev)
    spawn_s = time.perf_counter() - c0

    # alignment
    q0 = single_align.T_icur_iref.q.cpu()
    t0 = single_align.T_icur_iref.t.cpu()
    align_gap = max(max(float((a["q"] - q0).abs().max()),
                        float((a["t"] - t0).abs().max()))
                    for r in ranks for a in r["align"])
    align_fe = [a["launches"]["fused_evaluate"] for r in ranks
                for a in r["align"]]
    align_gt = [a["launches"]["gather_tiles"] for r in ranks
                for a in r["align"]]
    align_repeat = all(torch.equal(r["align"][0][k], r["align"][1][k])
                       for r in ranks for k in ("q", "t", "alpha", "beta",
                                                "chi2"))
    prof = ranks[0]["align"][-1].get("profile")
    # seeds
    s_single = single_seeds.seed_state.cpu()
    seeds_equal = all(
        torch.equal(r["seeds"]["ftype"], single_seeds.ftype.cpu())
        and r["seeds"]["n_updated"] == int(single_seeds.n_updated)
        and r["seeds"]["n_converged"] == int(single_seeds.n_converged)
        for r in ranks)
    seed_gap = max(float(((r["seeds"]["seed_state"] - s_single).abs()
                          / s_single.abs().clamp(min=1e-12)).max())
                   for r in ranks)
    seeds_bits = all(torch.equal(r["seeds"]["seed_state"], s_single)
                     for r in ranks)
    # BA
    sp, sq = single_w.p.cpu(), single_w.q.cpu()
    ba_gap = max(max(float((b["p"] - sp).abs().max()),
                     float((b["q"] - sq).abs().max()))
                 for r in ranks for b in r["ba"])
    ba_chi2_rel = max(abs(b["chi2"] - float(single_chi2))
                      / max(float(single_chi2), 1.0)
                      for r in ranks for b in r["ba"])
    vol = comms_volume_per_solve(w.S, MD_BA_ITERS)
    ba_bytes = [b["comm_bytes"]["all_reduce"] for r in ranks
                for b in r["ba"]]
    ba_repeat = all(torch.equal(r["ba"][0][k], r["ba"][1][k])
                    for r in ranks for k in ("p", "q", "lm_pos"))
    # global map
    gm = {}
    for i, (shape, axes) in enumerate(MD_GM_MESHES):
        key = "global_map" if i == 0 else f"global_map#{i + 1}"
        outs = [r[key] for r in ranks]
        gaps = [gm_gap(o, single_gm) for o in outs]
        gm[f"{shape} over {axes}"] = dict(
            pose_gap_m=max(g[0] for g in gaps),
            landmark_gap_m=max(g[1] for g in gaps),
            same_ids=all(g[2] for g in gaps),
            chi2=outs[0]["chi2"], chi2_rel_gap=max(g[3] for g in gaps),
            mean_pos_err_m=max(gm_error(o) for o in outs),
            last_dropped_obs=[o["last_dropped_obs"] for o in outs],
            feed_wall_ms=outs[0]["feed_wall_ms"],
            final_solve_wall_ms=outs[0]["wall_ms"],
            bytes_final_solve=outs[0]["comm_bytes"])
    cpu_gap = gm_gap(cpu_gm, single_gm)
    dry = [r["dryrun"]["result"] for r in ranks]
    launches = _sum_launches(
        [a["launches"] for r in ranks for a in r["align"]]
        + [r["seeds"]["launches"] for r in ranks]
        + [b["launches"] for r in ranks for b in r["ba"]]
        + [r[k]["launches"] for r in ranks
           for k in ("global_map", "global_map#2", "dryrun")])
    emit({"phase": "multidevice", "card": smi, "ranks": MD_RANKS,
          "backend": choose_backend(MD_RANKS, rank_dev),
          "note": "4 ranks share one card: correctness and bytes, not "
                  "scale-out",
          "spawn_s": spawn_s, "references_s": ref_s,
          "align": dict(
              features=int(inp.px_ref.shape[0]),
              per_rank=int(inp.px_ref.shape[0]) // MD_RANKS, levels=levels,
              max_iter=aopts.max_iter, pose_gap=align_gap,
              fused_evaluate_per_rank=align_fe,
              gather_tiles_per_rank=align_gt, bit_repeat=align_repeat,
              rank_wall_ms=[a["wall_ms"] for a in ranks[0]["align"]],
              single_rank_ms=align_ms,
              bytes_per_rank=ranks[0]["align"][0]["comm_bytes"],
              fused_evaluate_profile=prof),
          "seeds": dict(
              n=int(seed_args[4].shape[0]),
              n_updated=int(single_seeds.n_updated),
              n_converged=int(single_seeds.n_converged),
              ftype_and_counts_equal=seeds_equal, state_rel_gap=seed_gap,
              bit_equal=seeds_bits, rank_wall_ms=ranks[0]["seeds"]["wall_ms"],
              bytes_per_rank=ranks[0]["seeds"]["comm_bytes"]),
          "ba": dict(
              window=MD_BA_SHAPE | {"No": MD_BA_NO}, n_dropped=ba_dropped,
              n_dropped_at_No_1024=ba_dropped_1024, pose_gap=ba_gap,
              chi2=float(single_chi2), chi2_rel_gap=ba_chi2_rel,
              bytes_counted=ba_bytes, comms_volume_per_solve=vol,
              dcn_comms_global_map=comms_volume_per_solve(32, 4),
              bit_repeat=ba_repeat,
              rank_wall_ms_per_solve=[b["wall_ms"] for b in ranks[0]["ba"]],
              single_rank_ms_same_window=single_ba_ms,
              ba_solve_ms=ba_solve_ms,
              ba_iters_per_s=MD_BA_ITERS / (ba_solve_ms / 1e3)),
          "global_map": gm,
          "global_map_single": dict(
              chi2=single_gm["chi2"], keyframes=len(single_gm["kf_ids"]),
              landmarks=int(len(single_gm["lm_ids"])),
              mean_pos_err_m=gm_error(single_gm),
              contiguous_layout_dropped=single_gm["probe_dropped"],
              card_vs_cpu=dict(pose_gap_m=cpu_gap[0],
                               landmark_gap_m=cpu_gap[1],
                               chi2_rel_gap=cpu_gap[3])),
          "dryrun": dict(chi2_align=float(dry[0]["chi2_align"]),
                         n_updated=int(dry[0]["n_updated"]),
                         chi2_ba=float(dry[0]["chi2_ba"]),
                         chi2_ba_2d=float(dry[0]["chi2_ba_2d"])),
          "launches_summed_over_ranks": launches,
          "phase_s": time.perf_counter() - t_phase})
    if align_gap > MD_ALIGN_TOL:
        fail(f"multidevice: 4-rank alignment {align_gap} from one rank")
    if not (align_repeat and ba_repeat):
        fail(f"multidevice: a second run in the same ranks differs "
             f"(alignment equal {align_repeat}, BA equal {ba_repeat})")
    if any(c != levels * (aopts.max_iter + 1) for c in align_fe) or \
            min(align_gt) <= 0:
        fail(f"multidevice: fused_evaluate launches per rank {align_fe} "
             f"(want {levels * (aopts.max_iter + 1)}), gather_tiles "
             f"{align_gt}")
    if not seeds_equal or seed_gap > MD_SEED_RTOL or \
            int(single_seeds.n_updated) == 0:
        fail(f"multidevice: seed update ftype/counts equal {seeds_equal}, "
             f"state gap {seed_gap}, {int(single_seeds.n_updated)} updated")
    if ba_dropped or ba_gap > MD_BA_TOL or ba_chi2_rel > MD_BA_CHI2 or \
            any(b != vol["bytes_per_solve"] for b in ba_bytes):
        fail(f"multidevice: BA dropped {ba_dropped}, gap {ba_gap}, chi2 "
             f"{ba_chi2_rel}, bytes {ba_bytes} vs {vol['bytes_per_solve']}")
    for name, g in gm.items():
        if g["pose_gap_m"] > MD_GM_TOL or g["landmark_gap_m"] > MD_GM_TOL \
                or not g["same_ids"] or g["chi2_rel_gap"] > MD_BA_CHI2 \
                or g["mean_pos_err_m"] > MD_GM_ACCURACY \
                or any(g["last_dropped_obs"]):
            fail(f"multidevice: global map {name}: {g}")
    if not all(np.isfinite(float(d[k])) for d in dry
               for k in ("chi2_align", "chi2_ba", "chi2_ba_2d")):
        fail(f"multidevice: dry run {dry[0]}")
    return launches


def only_phases(smi: str, names: list) -> None:
    """``--only``: the named host and entry-point phases on their own
    inputs, for development calls (no kernels line, no result line; the
    euroc phase compared with session stamps when host_vio runs too).
    ``host_vio_epoch`` (here only) is host_vio at EuRoC-epoch stamps
    through the same loop; with host_vio, ``epoch_effect`` prints the
    position gap between the two a frame."""
    frames = [syn.render_textured_plane(gt_pose(t), INTR, W, H, PLANE_Z)
              for t in range(N_FRAMES)]
    if {"host_mono", "checkpoint"} & set(names):
        _, mats, meta, _, _ = run_slice(frames, "cuda")
        whole = host_mono_phase(smi, frames, mats, meta)[1]
        if "checkpoint" in names:
            checkpoint_phase(smi, frames, whole)
    bench = syn.bench_sequence(EUROC_FRAMES, 7, "cuda")
    session = None
    if "host_vio" in names:
        session = host_vio_phase(smi, *bench)[1]
    if "host_vio_epoch" in names:
        e_mats = host_vio_phase(smi, *bench, t0=EUROC_T0_NS * 1e-9)[1][0]
        if session is not None:
            gap = np.linalg.norm(e_mats[:, :3, 3] - session[0][:, :3, 3],
                                 axis=-1)
            emit({"phase": "epoch_effect", "card": smi,
                  "first_frame_apart": int(np.argmax(gap > 0))
                  if (gap > 0).any() else -1,
                  "max_pos_gap_m": float(gap.max()),
                  "pos_gap_by_frame_m": gap.tolist()})
    if {"euroc", "euroc_mono", "euroc_stereo"} & set(names):
        euroc_phases(smi, *bench, session)
    if "detectors" in names:
        detectors_phase(smi, bench[1][0], frames)
    if "edge_depth" in names:
        edge_depth_phase(smi, bench[0], bench[1])
    if "host_slam" in names:
        poses, frames, _ = syn.bench_sequence(
            syn.LOOP_FRAMES, syn.LOOP_DEGRADE_SEED, "cuda",
            twist_fn=syn.loop_twist)
        host_slam_phase(smi, poses, frames)
    cams, T_body = syn.euroc_stereo_rig()
    if "host_stereo" in names:
        poses, views, _ = syn.rig_sequence(HOST_STEREO_FRAMES, cams, T_body,
                                           STEREO_SEEDS, "cuda")
        host_rig_phase(smi, "stereo", cams, T_body, views, poses,
                       HOST_STEREO_FRAMES)
    if "host_array" in names:
        acams = [cams[0]] * 3
        poses, views, _ = syn.rig_sequence(
            HOST_ARRAY_FRAMES, acams, list(ARRAY_T_BODY_CAMS), ARRAY_SEEDS,
            "cuda")
        host_rig_phase(smi, "array", acams, list(ARRAY_T_BODY_CAMS), views,
                       poses, HOST_ARRAY_FRAMES)
    if "host_backends" in names:
        host_backends_phase(smi)
    if "multidevice" in names:
        multidevice_phase(smi)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw = bandwidth(name)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "bandwidth_Bps": bw})

    t0 = time.perf_counter()
    sources = _cuda.build_all()
    emit({"phase": "build", "sources": sources,
          "seconds": time.perf_counter() - t0, "nvcc_flags": _cuda.NVCC_FLAGS})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--only" in sys.argv:
        only_phases(smi, sys.argv[sys.argv.index("--only") + 1].split(","))
        return
    cases, main_cases = kernel_cases(bw)
    emit({"phase": "kernels", "card": smi, "cases": cases})

    frames = [syn.render_textured_plane(gt_pose(t), INTR, W, H, PLANE_Z)
              for t in range(N_FRAMES)]
    _cuda.reset_counts()
    pipe, mats, meta, wall, events = run_slice(frames, "cuda", timed=True)
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    torch.cuda.synchronize()
    stage_ms: dict = {}
    for nm, s, e in events:
        stage_ms[nm] = stage_ms.get(nm, 0.0) + s.elapsed_time(e)
    n_track = N_FRAMES - 1
    stage_ms = {k.lstrip("_"): v / (n_track if k != "_keyframe_step"
                                    else max(int(meta[1:, 2].sum()), 1))
                for k, v in stage_ms.items()}
    steady = wall[5:]
    gt_pos = np.stack([np.linalg.inv(gt_pose(t))[:3, 3]
                       for t in range(N_FRAMES)])
    est_pos = mats[:, :3, 3]
    ate = float(np.sqrt(np.mean(np.sum((est_pos - gt_pos) ** 2, -1))))
    path = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=-1).sum())
    n_kf = int(meta[1:, 2].sum())
    n_align = sum(1 for nm, _, _ in events if nm == "_stage_align")
    slice_line = {
        "phase": "slice", "card": smi, "frames": N_FRAMES,
        "resolution": [W, H], "fps_steady": float(len(steady) / steady.sum()),
        "fps_overall": float(N_FRAMES / wall.sum()),
        "frame_ms_median": float(np.median(steady) * 1e3),
        "stage_ms_per_call": stage_ms, "keyframes_after_first": n_kf,
        "n_tracked_min": int(meta[:, 1].min()),
        "n_tracked_mean": float(meta[:, 1].mean()),
        "launches": counts, "sparse_alignments": n_align,
        "launches_per_frame": {k: v / N_FRAMES for k, v in counts.items()},
        "ate_m": ate, "path_m": path,
        "peak_mem_MB": torch.cuda.max_memory_allocated() / 2 ** 20}
    emit(slice_line)
    if not (meta[:, 0] == Stage.TRACKING.value).all():
        fail(f"slice left TRACKING: stages {meta[:, 0].tolist()}")
    if meta[:, 1].min() < pipe.cfg.base.quality_min_fts:
        fail(f"n_tracked fell to {meta[:, 1].min()}")
    if n_kf < 2:
        fail(f"only {n_kf} keyframes selected after the first")
    # the gathers run on the path; align_level once per pyramid level of
    # every sparse alignment; the standalone fused evaluate not at all (its
    # device code runs inside align_level)
    ia = pipe.cfg.img_align
    n_levels = ia.max_level - ia.min_level + 1
    if min(counts["gather_tiles"], counts["gather_tiles_ring"]) <= 0:
        fail(f"a gather kernel was not launched on the main path: {counts}")
    if n_align == 0 or counts["align_level"] != n_levels * n_align:
        fail(f"align_level launched {counts['align_level']} times for "
             f"{n_align} sparse alignments of {n_levels} levels")
    if counts["fused_evaluate"] != 0:
        fail(f"fused_evaluate launched {counts['fused_evaluate']} times on "
             "the path: the per-iteration evaluates should be gone")
    # a gross-error check: the fronto-parallel plane leaves lateral motion
    # and rotation nearly ambiguous, so the bound is loose; the CPU phase
    # below is the tight check
    if not np.isfinite(mats).all() or ate > 0.25 * path:
        fail(f"trajectory off: ATE {ate} m over {path} m")

    emit(profile_frames(frames[:2]) | {"card": smi})

    _, cmats, cmeta, cwall, _ = run_slice(frames[:N_CPU_FRAMES], "cpu")
    gap = np.linalg.norm(cmats[:, :3, 3] - mats[:N_CPU_FRAMES, :3, 3],
                         axis=-1)
    emit({"phase": "cpu", "frames": N_CPU_FRAMES,
          "max_pos_gap_m": float(gap.max()),
          "stages_equal": bool((cmeta[:, 0] == meta[:N_CPU_FRAMES, 0]).all()),
          "cpu_frame_s_median": float(np.median(cwall))})
    if gap.max() > POSE_TOL_M or not (cmeta[:, 0]
                                      == meta[:N_CPU_FRAMES, 0]).all():
        fail(f"card and CPU runs disagree: position gap {gap.max()} m")

    host_counts = {}
    host_counts["host_mono"], whole = host_mono_phase(smi, frames, mats,
                                                      meta)
    host_counts["checkpoint"] = checkpoint_phase(smi, frames, whole)
    vio_counts, vio_input = vio_phase(smi)
    host_counts["host_vio"], host_vio_session = host_vio_phase(smi,
                                                               *vio_input)
    host_counts |= euroc_phases(smi, *vio_input, host_vio_session)
    host_counts["detectors"] = detectors_phase(smi, vio_input[1][0], frames)
    host_counts["edge_depth"] = edge_depth_phase(smi, vio_input[0],
                                                 vio_input[1])
    del vio_input
    slam_counts, slam_input = slam_phase(smi)
    host_counts["host_slam"] = host_slam_phase(smi, *slam_input)
    del slam_input
    rig_counts = stereo_phases(smi)
    host_backends_phase(smi)
    md_counts = multidevice_phase(smi)

    kernels = []
    for k in _cuda.KERNELS:
        c = main_cases[k.name]
        entry = dict(
            name=k.name, route="cuda",
            source=f"svo_pro_universal_tpu_torch/csrc/{k.source}",
            replaces=k.replaces, launches=vio_counts[k.name],
            launches_mono_slice=counts[k.name],
            launches_slam=slam_counts[k.name],
            **{f"launches_{kind}": cnt[k.name]
               for kind, cnt in (rig_counts | host_counts).items()},
            launches_multidevice=md_counts[k.name],
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"])
        entry |= {key: c[key] for key in ("device_ms", "origins_given_ms",
                                          "copy_route") if key in c}
        if k.name == "fused_evaluate":
            entry["on_path"] = ("the multidevice path: once per camera per "
                                "evaluate on every rank; on one device its "
                                "evaluate runs inside align_level")
        kernels.append(entry)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
