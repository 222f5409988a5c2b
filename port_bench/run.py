"""The port's benchmark: one cell of ``BENCHMARK.json`` on the card.

    python3 -m port_bench.run --workload euroc_mono_vio.laps --seed 7 \\
        --seconds 51 --trace 0

Drives ``svo_pro_universal_tpu_torch`` (never the JAX package) with one
stream, closed loop: the IMU up to a frame's time, then the frame, the next
frame once ``add_image`` has returned. The cell names a configuration file
(``configs/<name>.json``: the pipeline, its settings, the scene) and a
traffic file (``traffic/<name>.json``: trajectory, camera noise, warm-up);
its limits are ``limits/<workload>.json`` and each per-layer metric is read
by ``metrics/<metric>.py``. Nothing here names a cell.

Set-up renders the seed's frames on the card, builds the pipeline and feeds
whole laps until the stream is steady: TRACKING, a full backend window, the
last lap processed wholly so, and the caching allocator's reserve unchanged
over it. The window then feeds frames for ``--seconds`` and ends with
``block()``; ``frames_per_s`` is the frames fed over that wall time.
``--trace 1`` runs the same window with the harness's spans on and the
profiler over its first frames, and reports the per-layer metrics.

Once the window has closed, the plain reference (``reference.py``) judges
what the window produced: the pose trace against the scene's ground truth,
the backend window's cost, and a seeded sample of the hand-written kernels'
calls and of the backend's window solves. Each number is printed beside
its limit on standard error and in the result line.
The last line of standard output is the result, as JSON.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "svo_pro_universal_tpu")
HBM_BYTES_PER_S = 3.35e12          # one H100 SXM (NVIDIA's data sheet)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _set_cache_dirs() -> None:
    """Fixed build and kernel-cache directories inside the checkout (the
    port builds its CUDA sources into its own ``_build`` there)."""
    cache = ROOT / ".port_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def load_cell(workload: str) -> dict:
    """The cell's entries and files, found by the names in BENCHMARK.json."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    configs = {c["name"]: c["file"] for c in manifest["configs"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    return dict(
        manifest=manifest, cell=cell,
        config=json.loads((ROOT / configs[cell["config"]]).read_text()),
        traffic=json.loads(
            (HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads(
            (HERE / "limits" / f"{workload}.json").read_text())["checks"],
        per_layer=[m for m in manifest["per_layer"]
                   if workload in m.get("workloads", [workload])])


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

def build_pipeline(config: dict, device):
    """The port's pipeline and IMU handler, as the configuration file
    states them (the port's defaults for every key it leaves out)."""
    from svo_pro_universal_tpu_torch.cameras.projections import Camera
    from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
    from svo_pro_universal_tpu_torch.config import Config
    from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
    from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
        DevicePipelineVIO)

    cfg = Config()
    for key, value in config["settings"].items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = getattr(node, part)
        if not hasattr(node, leaf):
            raise KeyError(f"unknown setting {key}")
        setattr(node, leaf, value)
    cm = config["camera"]
    cam = Camera.pinhole(*cm["intrinsics"], cm["width"], cm["height"])
    params = ImuParams(**config["imu"]["params"])
    imu = ImuHandler(params, window_size=config["imu"]["window_size"])
    kw = dict(imu_handler=imu, imu_params=params,
              trace_capacity=config["trace_capacity"], device=device)
    if config["pipeline"] != "vio":
        raise ValueError(f"unknown pipeline {config['pipeline']!r}")
    return DevicePipelineVIO(cfg, cam, **kw), imu


class Stream:
    """Frames and IMU fed to the pipeline in the live order: the IMU up to
    the frame's time, then the frame. The inputs made cover whole laps;
    past their end the stream goes round them again (the trajectory and
    the IMU repeat each lap; the camera noise repeats too), with time
    running on."""

    def __init__(self, pipe, imu, frames, imu_data, cam_dt: float,
                 imu_dt: float):
        self.pipe, self.imu = pipe, imu
        self.frames = frames
        self.gyro, self.acc = imu_data[1], imu_data[2]
        self.cam_dt, self.imu_dt = cam_dt, imu_dt
        self.i = 0          # next frame
        self.j = 0          # next IMU sample

    def feed(self) -> None:
        ts = self.i * self.cam_dt
        m = len(self.gyro)
        while self.j * self.imu_dt <= ts:
            self.imu.add_measurement(self.j * self.imu_dt,
                                     self.gyro[self.j % m],
                                     self.acc[self.j % m])
            self.j += 1
        self.pipe.add_image(self.frames[self.i % len(self.frames)], ts)
        self.i += 1


class Counts:
    """An always-on host counter at the layer boundary the checks read: the
    frame of each backend state."""

    def __init__(self, pipe):
        self.backend_frames: list[int] = []
        step = pipe._vio_backend_step

        def backend(world, ts, is_kf):
            out = step(world, ts, is_kf)
            if out.last_kf_ts != world.last_kf_ts:
                self.backend_frames.append(pipe.frame_count - 1)
            return out
        pipe._vio_backend_step = backend


def install_spans(spans, pipe) -> None:
    """The harness's spans around calls into each layer (trace runs)."""
    spans.wrap(pipe, "add_image")
    spans.wrap(pipe, "_tracking_step")
    spans.wrap(pipe, "_keyframe_step")
    spans.wrap(pipe, "_vio_backend_step",
               ran=lambda a, out: out.last_kf_ts != a[0].last_kf_ts)


def read_metrics(per_layer: list, ctx: dict) -> dict:
    """Each per-layer metric by its reader ``metrics/<name>.py``; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in per_layer:
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"port_bench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             fault=None, keep: dict | None = None) -> dict:
    """Set-up, window and check of one cell; returns the result line.
    ``overrides`` replaces top-level traffic keys (the tests' small runs);
    ``fault(pipe, None)`` breaks the program as the window opens (the
    tests of the check); ``keep`` receives the captured state."""
    phases = {}
    mark = T_START

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    cellf = load_cell(workload)
    config, traffic = cellf["config"], dict(cellf["traffic"])
    traffic.update(overrides or {})
    seed = int(seed) % (1 << 63)
    import torch

    from port_bench import checks, devtrace, scene
    from port_bench.spans import KernelSampler, Spans
    from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
    from svo_pro_universal_tpu_torch.backend import window_ba
    from svo_pro_universal_tpu_torch.ops import _cuda, cuda_align, cuda_tiles
    phase("imports")

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.set_num_threads(1)
    if on_card:
        for source in _cuda.build_all():
            _cuda.load(source)
    phase("extensions")

    period = int(traffic["trajectory"]["period_frames"])
    cam_dt = 1.0 / float(traffic["camera_rate_hz"])
    n_frames = period * math.ceil(
        (traffic["warmup"]["max_laps"] * period
         + seconds * traffic["max_frames_per_s"]) / period)
    frames = scene.make_frames(config["scene"], config["camera"], traffic,
                               n_frames, seed, dev)
    imu_data = scene.imu_stream(traffic, n_frames)
    phase("inputs")

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    pipe, imu = build_pipeline(config, dev)
    counts = Counts(pipe)
    stream = Stream(pipe, imu, frames, imu_data, cam_dt,
                    1.0 / float(traffic["imu_rate_hz"]))
    sampler = KernelSampler(seed, traffic["samples"])
    sampler.install(cuda_tiles, cuda_align, window_ba)
    spans = Spans()
    if trace:
        install_spans(spans, pipe)
    phase("construct")

    # ---- warm-up: whole laps until the stream is steady ------------------
    S = config["settings"]["backend.num_keyframes"]
    reserved, steady_laps = [], 0
    while stream.i < period or pipe.stage != Stage.TRACKING:
        stream.feed()
        if stream.i >= traffic["warmup"]["max_laps"] * period:
            break
    phase("warmup_tracking")
    while True:
        while stream.i % period:
            stream.feed()
        pipe.block()
        reserved.append(torch.cuda.memory_reserved(dev) if on_card else 0)
        steady_now = (pipe.stage == Stage.TRACKING
                      and pipe.world.backend_k >= S)
        steady_laps = steady_laps + 1 if steady_now else 0
        laps = stream.i // period
        log(f"warm-up: lap {laps} ends at frame {stream.i}, stage "
            f"{pipe.stage.name}, backend states {pipe.world.backend_k}, "
            f"memory_reserved {reserved[-1]}, "
            f"{time.perf_counter() - T_START:.3f} s")
        if (laps >= traffic["warmup"]["min_laps"] and steady_laps >= 2
                and reserved[-1] == reserved[-2]):
            break
        if laps >= traffic["warmup"]["max_laps"]:
            log(f"warm-up: not steady after {laps} laps "
                f"(stage {pipe.stage.name}, backend states "
                f"{pipe.world.backend_k}, reserved {reserved})")
            break
        stream.feed()
    for name, shape, dtype in list(sampler.shapes_seen):
        sampler.reserve(name, shape, dtype, sampler.caps.get(name, 0),
                        on_card)
    # the heap built so far kept out of the collector's scans (with one
    # host thread, set above: the settings that narrowed the spread of
    # frames_per_s between runs, PERF.md)
    gc.collect()
    gc.freeze()
    phase("steady_laps")
    setup_s = time.perf_counter() - T_START

    # ---- the window -------------------------------------------------------
    w0 = stream.i
    world0 = dict(trace_ptr=pipe.world.trace_ptr,
                  backend_calls=len(counts.backend_frames))
    log(f"window: opens at frame {w0} after {len(reserved)} lap checks, "
        f"memory_reserved at lap ends {reserved}")
    if fault is not None:
        # under the sampler's wrappers, so the sample sees what it produces
        sampler.uninstall()
        fault(pipe, None)
        sampler.install(cuda_tiles, cuda_align, window_ba)
    prof = devtrace.Profiler(dev, traffic["trace_frames"]) if trace else None
    sampler.active = True
    spans.active = True
    t0 = time.perf_counter()
    while True:
        if prof is not None:
            prof.step(stream.i - w0, spans, sampler, pipe)
        stream.feed()
        if time.perf_counter() - t0 >= seconds:
            break
    pipe.block()
    t1 = time.perf_counter()
    sampler.active = spans.active = False
    if prof is not None:
        prof.step(traffic["trace_frames"], spans, sampler, pipe)
    n_window = stream.i - w0
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    res_end = torch.cuda.memory_reserved(dev) if on_card else 0
    log(f"window: {n_window} frames in {t1 - t0:.6f} s; memory_reserved "
        f"{reserved[-1]} at the start, {res_end} at the end")
    frames_per_s = n_window / (t1 - t0)

    # ---- what the window produced, copied off the program -----------------
    state = checks.capture(pipe, counts, sampler, world0, w0, n_window,
                           Stage.TRACKING.value)
    del pipe, stream, imu
    sampler.uninstall()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log("counts in the window: " + json.dumps(state["counts"]))
    if state["lost_frames"]:
        log(f"frames not TRACKING in the window (first 20): "
            f"{state['lost_frames']}; (frame, stage, tracked, keyframe) "
            f"before the first lost: {state.get('lost_context')}")
    log("set-up phases (s): " + json.dumps(
        {k: round(v, 6) for k, v in phases.items()}))

    if keep is not None:
        keep.update(state=state, config=config, traffic=traffic,
                    limits=cellf["limits"])
    numbers = checks.judge(state, config, traffic)
    correct = checks.verdict(numbers, cellf["limits"])
    found = forbidden_modules()
    if found:
        raise RuntimeError("loaded modules of JAX or the JAX package: "
                           + ", ".join(found))

    if trace:
        tr = prof.summary()
        ctx = dict(spans=spans.times, frames=n_window, trace=tr,
                   bytes=sampler.bytes, hbm_bytes_per_s=HBM_BYTES_PER_S)
        metrics = read_metrics(cellf["per_layer"], ctx)
    else:
        metrics = {"frames_per_s": {"value": frames_per_s,
                                    "unit": "frames/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    out = {
        "correct": correct,
        "attempted": n_window,
        "failed": state["counts"]["frames_lost"],
        "metrics": metrics,
        "device": device_info(dev, peak),
    }
    if trace:
        out["device"] |= {"busy_s": tr["busy_s"], "window_s": tr["window_s"]}
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": cellf["limits"][k]["max"]}
                     for k, v in numbers.items()}
    return out


def device_info(dev, peak: int) -> dict:
    import torch
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _set_cache_dirs()
    cell = load_cell(args.workload)["cell"]
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    log(f"correct: {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
