"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — ``DevicePipelineMono`` (mono VO tracking,
OneShot initialization) at EuRoC size, 752×480, with the capacities of
bench.py:159-182 — on the card, and checks it end to end. Phases, one JSON
line each:

1. device   the card (nvidia-smi name and power limit), torch and CUDA.
2. build    every csrc/*.cu compiled with nvcc for sm_90a, in parallel.
3. kernels  each CUDA kernel against its plain PyTorch version on the card
            at the shapes the tracking step gives it: CUDA-event times
            (median), the byte/operation bound, and one PyTorch library call
            for the gathers. The gathers: each extract_tiles /
            extract_tiles_ring call (tile origins computed in the kernel)
            and each origins-given call at the seven path shapes, equal to
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
4. slice    ≥ 60 frames of a textured plane: TRACKING from frame 0 on,
            n_tracked ≥ quality_min_fts, ≥ 2 keyframes, the gathers
            launched on the path and align_level once per pyramid level of
            every sparse alignment, the standalone fused_evaluate not at
            all (counts reset just before the run); frames/s and per-stage
            ms (CUDA events).
   profile  6 frames under torch.profiler: device busy ms and kernel
            launches per frame, idle share, host syncs per frame.
5. cpu      the same first frames through the port on the CPU; the poses
            must agree with the card's within 5 mm.

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

from svo_pro_universal_tpu_torch.cameras.projections import (
    Camera, DistortionModel, ProjectionModel)
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
from svo_pro_universal_tpu_torch.frontend.pipeline import DevicePipelineMono
from svo_pro_universal_tpu_torch.ops import _cuda, cuda_align, cuda_tiles
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.ops import tiles
from svo_pro_universal_tpu_torch.testing import gather_shapes as gs
from svo_pro_universal_tpu_torch.testing import synthetic as syn
from svo_pro_universal_tpu_torch.utils.transform import se3_exp

W, H = 752, 480
INTR = (460.0, 460.0, 376.0, 240.0)
PLANE_Z = 2.5
N_FRAMES = 64
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
    """Both gathers at the seven shapes of the path, on gather_bench.py's
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


def time_stages(pipe, events: list) -> None:
    """Wrap the pipeline's stage methods with CUDA-event pairs."""
    for name in STAGES:
        fn = getattr(pipe, name)

        def timed(*a, _fn=fn, _name=name, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = _fn(*a, **k)
            e.record()
            events.append((_name, s, e))
            return out
        setattr(pipe, name, timed)


def run_slice(frames: list, device: str, timed: bool = False):
    cam = Camera.pinhole(*INTR, W, H)
    pipe = DevicePipelineMono(euroc_config(), cam, trace_capacity=256,
                              device=device)
    events: list = []
    if timed:
        time_stages(pipe, events)
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
    import warnings
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_slice(frames[:2], "cuda")              # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slice(frames, "cuda")
        wall = time.perf_counter() - t0
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
    n = len(frames)
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
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            run_slice(frames, "cuda")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return {"phase": "profile", "frames": n,
            "device_busy_ms_per_frame": busy_ms / n,
            "wall_ms_per_frame_profiled": wall * 1e3 / n,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "kernel_launches_per_frame": sum(e.count for e in kernels) / n,
            "host_sync_wait_ms_per_frame": sync_ms / n,
            "host_launch_api_ms_per_frame": launch_ms / n,
            "host_syncs_per_frame": syncs / n, "port_kernels": port}


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

    kernels = []
    for k in _cuda.KERNELS:
        c = main_cases[k.name]
        entry = dict(
            name=k.name, route="cuda",
            source=f"svo_pro_universal_tpu_torch/csrc/{k.source}",
            replaces=k.replaces, launches=counts[k.name],
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
