"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths on the card and checks them end to end:
``DevicePipelineMono`` (mono VO tracking, OneShot initialization),
``DevicePipelineVIO`` (FivePoint initialization, IMU, window backend: the
configuration bench.py drives) and ``DevicePipelineSLAM`` (the same VIO plus
loop closing, pose graph and global map: bench.py's second section), all at
EuRoC size, 752×480, with the capacities of bench.py:159-184. Phases, one
JSON line each:

1. device   the card (nvidia-smi name and power limit), torch and CUDA.
2. build    every csrc/*.cu compiled with nvcc for sm_90a, in parallel.
3. kernels  each CUDA kernel against its plain PyTorch version on the card
            at the shapes the tracking step gives it: CUDA-event times
            (median), the byte/operation bound, and one PyTorch library call
            for the gathers. The gathers: each extract_tiles /
            extract_tiles_ring call (tile origins computed in the kernel)
            and each origins-given call at the nine path shapes, equal to
            the plain versions, timed by gather_bench.py in a subprocess
            (the ring also with a cold L2), exactly one CUDA kernel per call
            in its torch.profiler traces, gated, and the device ms per
            launch; then NaN/inf/huge/.5/border centres,
            levels and slots out of range, int32 indices and N = 0 on both
            copy routes (TMA at 752 wide, plain loads at 754 and for
            10×10 tiles). align_level
            runs on two rendered views of the
            plane (levels 4..2, each level from the same inputs for both)
            through four camera models with the prior and alpha/beta off
            and on (N = 360), two cameras on one body, and N = 768: pose
            within 1e-4 rad / 1e-4·depth, n_tracked equal.
4. slice    40 frames of a textured plane: TRACKING from frame 0 on,
            n_tracked ≥ quality_min_fts, ≥ 2 keyframes, the gathers
            launched on the path and align_level once per pyramid level of
            every sparse alignment, the standalone fused_evaluate not at
            all (counts reset just before the run); frames/s and per-stage
            ms (CUDA events).
   profile  6 frames under torch.profiler: device busy ms and kernel
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
   vio_profile  7 frames holding a backend call, as the profile phase.
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
   slam_profile  7 frames around the first verified loop, else the first
            verification, in a second run: device busy ms, launches, idle
            share, and the port's stream synchronizations per frame from
            the profiler's own trace (no sync debug mode in the window).

The ``kernels`` line's ``launches`` are the vio run's, counted from 0 just
before it (``launches_mono_slice``: the slice run's; ``launches_slam``: the
slam run's).
The line before the last is the ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import loop_closing as lc_mod
from svo_pro_universal_tpu_torch.backend import pgo as pgo_mod
from svo_pro_universal_tpu_torch.cameras.projections import (
    Camera, DistortionModel, ProjectionModel)
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.evaluation import ate_rmse
from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
from svo_pro_universal_tpu_torch.frontend.pipeline import DevicePipelineMono
from svo_pro_universal_tpu_torch.frontend.pipeline_slam import (
    DevicePipelineSLAM, SlamOptions)
from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
    DevicePipelineVIO)
from svo_pro_universal_tpu_torch.ops import _cuda, cuda_align, cuda_tiles
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.ops import tiles
from svo_pro_universal_tpu_torch.testing import gather_shapes as gs
from svo_pro_universal_tpu_torch.testing import synthetic as syn
from svo_pro_universal_tpu_torch.utils.transform import SE3, se3_exp

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


def emit(obj) -> None:
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
    """Both gathers at the nine shapes of the path, on gather_bench.py's
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
    for label, ty, tx in (
            ("fractional",
             rng.uniform(0.0, R - P - 1.0, n), rng.uniform(0.0, T - P - 1.0,
                                                           n)),
            ("integer", np.full(n, float(R - P)), np.full(n, float(T - P)))):
        ty = torch.as_tensor(ty.astype(np.float32), device=dev)
        tx = torch.as_tensor(tx.astype(np.float32), device=dev)
        args = (tile_data, ty, tx, w, ref, jac, ab, P)
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
            fail(f"fused_evaluate ({label}): kernel vs plain error {err}")
        nbytes = n * ((P + 1) ** 2 + 3 + P * P * 9) * 4 + 74 * 4 + 8
        flops = n * P * P * (6 + 3 + 2 * 64 + 2 * 8 + 3)
        bound = max(nbytes / bw, flops / _FP32_FLOPS) * 1e3
        cases.append(dict(
            name="fused_evaluate", n=n, tile=[R, T], origins=label,
            max_abs_err=err, ms=gs.cuda_ms(run), plain_ms=gs.cuda_ms(plain),
            library_ms=None, bound_ms=bound,
            bound_by="bytes" if nbytes / bw >= flops / _FP32_FLOPS
            else "operations"))
    # the representative shape of each kernel on the main path
    main["fused_evaluate"] = cases[-2]
    main["align_level"] = align_cases(bw, cases)
    return cases, main


ALIGN_CAMERAS = {
    "pinhole": lambda: Camera.pinhole(*INTR, W, H),
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
# every camera model with the extras off and on, two cameras on one body,
# and N = 768, beyond the 560 features the cluster stages
ALIGN_CASES = [
    (name, [(name, None)], extras, (24, 15))
    for name in ALIGN_CAMERAS for extras in (False, True)] + [
    ("pinhole+fisheye_equidistant", [
        ("pinhole", None),
        ("fisheye_equidistant", syn.pose(0.1, 0.0, 0.0, 0.0, 0.3, 0.0))],
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
VIO_PROFILE_AT = 40          # the profiled window starts at this frame
VIO_PROFILE_FRAMES = 7       # ≥ one backend call (temporal states ≤ 0.3 s)
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
    the ground truth; the gates. Returns the launch counts of the run."""
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
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    wall: list = []
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
    a, n = VIO_PROFILE_AT, VIO_PROFILE_FRAMES
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
    return counts


# ---------------------------------------------------------------------------
# phase 7: mono SLAM (loop closing, pose graph, global map) on bench.py's loop
# ---------------------------------------------------------------------------

SLAM_WARMUP = 16                   # bench.py:311
SLAM_PROFILE_FRAMES = 7
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

    # ---- profile: 7 frames around the first verified loop, else the first
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
    return counts


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

    emit(profile_frames(frames[:6]) | {"card": smi})

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

    vio_counts = vio_phase(smi)
    slam_counts = slam_phase(smi)

    kernels = []
    for k in _cuda.KERNELS:
        c = main_cases[k.name]
        entry = dict(
            name=k.name, route="cuda",
            source=f"svo_pro_universal_tpu_torch/csrc/{k.source}",
            replaces=k.replaces, launches=vio_counts[k.name],
            launches_mono_slice=counts[k.name],
            launches_slam=slam_counts[k.name],
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"])
        entry |= {key: c[key] for key in ("device_ms", "origins_given_ms",
                                          "copy_route") if key in c}
        if k.name == "fused_evaluate":
            entry["on_path"] = ("held in the kernels phase; on the path its "
                                "per-feature evaluate runs inside align_level")
        kernels.append(entry)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
