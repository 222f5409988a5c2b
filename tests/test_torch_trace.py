"""The port's tracer (``utils.perf.Tracer``) on the CPU.

``DevicePipelineVIO`` runs tests/test_torch_vio.py's scene and configuration
(160×120, FivePoint, a 5-state window; 33 frames: the bootstrap, tracking,
keyframes, backend calls and two marginalizations) twice, with its tracer
off and with it on; ``torch.profiler`` (CPU activities) covers the last
``N_PROFILED`` frames of both runs.

- Off: nothing is recorded, the profile holds no user annotation, and the
  pose trace equals the traced run's to the bit.
- On: one record a frame with one ``frame`` root; every span under its
  stated parent and inside it in time; the structure stage's span never
  (the VIO pipeline's budget is 0, so it launches nothing).
- The frame id is the pipeline's ``frame_count``: 1, 2, … one a frame.
- ``host_reads`` counts each ``host_read`` span (a tracking frame exactly
  1, a marginalizing frame 2, with eigh's read); ``host_wait_ns`` lies
  within their time; the backend's counters agree with its spans.
- Under the profiler every span of the profiled frames is a user
  annotation of the same name, in the same order and nesting, holding the
  tracer's interval (the profiler stamps before the tracer's start and
  after its end), its duration within 1 ms of the tracer's on 90% of the
  spans. A span whose thread was preempted between the two stamps is
  longer in the profile alone, by milliseconds when the tests run in six
  workers; hence the share. (The first annotation a
  profiler records carries ~1 ms of its own set-up, so the test opens
  one of its own, ``WARM``, first and leaves it out.)
- The sums a per-layer reading takes from a window of frames
  (``span_ms``, the counters): finite and positive for the recorded spans,
  empty for a span the window does not hold; ``mean_ms`` per span.
- ``Tracer`` alone: off it records nothing; a span outside a frame is a
  record of its own, with its counts; a span that raises is closed.
- The tracefile: ``run_euroc_mono --trace-dir`` (the host handler) writes
  ``sparse_img_align``, ``reproject``, ``pose_optimizer``,
  ``point_optimizer`` and ``frontend_time`` positive on every tracking
  frame, in the reference's schema.
"""

import csv
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
from svo_pro_universal_tpu_torch.runners import run_euroc_mono
from svo_pro_universal_tpu_torch.testing import asl
from svo_pro_universal_tpu_torch.utils import perf

from test_torch_euroc import MONO_PARAMS, write_calib
from test_torch_vio import _inputs, _port, vio_config
from torch_parity_utils import gt_pose, sequence

N_PROFILED = 8
WARM = "test_profiler_warm_up"
# each span's parents (utils.perf's table of spans)
PARENTS = {
    "upload": {"frame"}, "pyramid_creation": {"frame"},
    "tracking_step": {"frame", "reloc_step"},
    "sparse_img_align": {"tracking_step"}, "reproject": {"tracking_step"},
    "pose_optimizer": {"tracking_step"}, "point_optimizer": {"tracking_step"},
    "depth_filter": {"tracking_step"}, "kf_policy": {"tracking_step"},
    "keyframe_step": {"frame"}, "init_step": {"frame"}, "klt": {"init_step"},
    "ransac": {"init_step"}, "reloc_step": {"frame"},
    "backend_step": {"frame"}, "marginalize": {"backend_step"},
    "backend_absorb": {"backend_step"}, "window_solve": {"backend_step"},
    "align_buffer": {"backend_step"}, "backend_apply": {"backend_step"},
    "host_read": {"frame", "init_step", "reloc_step", "marginalize"},
}
STAGES = ("sparse_img_align", "reproject", "pose_optimizer", "depth_filter",
          "kf_policy")


def _annotations(prof) -> list:
    """(name, start ns, end ns) of the profile's user annotations, in the
    order they opened (a parent before a child that starts with it)."""
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.is_user_annotation() and e.name() != WARM]
    return sorted(ev, key=lambda x: (x[1], -x[2]))


def _run(trace: bool) -> dict:
    imu_stream, frames, cam_ts, _ = _inputs()
    pipe, imu = _port(vio_config())
    if trace:
        pipe.tracer.start()
    i_imu = 0
    first_profiled = len(frames) - N_PROFILED
    prof = profile(activities=[ProfilerActivity.CPU])
    for k, (img, ts) in enumerate(zip(frames, cam_ts)):
        while i_imu < len(imu_stream) and imu_stream[i_imu][0] <= ts:
            imu.add_measurement(*imu_stream[i_imu])
            i_imu += 1
        if k == first_profiled:
            prof.__enter__()
            with torch.profiler.record_function(WARM):
                pass
        pipe.add_image(img, ts)
    prof.__exit__(None, None, None)
    mats, meta = pipe.drain()
    return dict(pipe=pipe, mats=mats, meta=meta, n=len(frames),
                annotations=_annotations(prof))


@pytest.fixture(scope="module")
def runs():
    return {"off": _run(False), "on": _run(True)}


def _parent(f: perf.FrameTrace, s: list):
    return f.spans[s[1]][0] if s[1] >= 0 else None


def test_tracer_off_records_nothing_and_changes_nothing(runs):
    off, on = runs["off"], runs["on"]
    assert not off["pipe"].tracer.on
    assert off["pipe"].tracer.frames == [] and off["pipe"].tracer.totals == {}
    assert off["annotations"] == []
    assert np.array_equal(off["mats"], on["mats"])
    assert np.array_equal(off["meta"], on["meta"])
    stages = on["meta"][:, 0].astype(int)
    assert (stages[-20:] == Stage.TRACKING.value).all()


def test_spans_nest_under_their_parents(runs):
    frames = runs["on"]["pipe"].tracer.frames
    assert len(frames) == runs["on"]["n"]
    seen = set()
    for f in frames:
        assert f.spans[0][0] == "frame" and f.spans[0][1] == -1
        assert [s[0] for s in f.spans].count("frame") == 1
        for s in f.spans[1:]:
            parent = f.spans[s[1]]
            assert _parent(f, s) in PARENTS[s[0]], (f.frame_id, s[0])
            assert parent[2] <= s[2] <= s[3] <= parent[3]
            seen.add(s[0])
        assert f.spans[0][2] <= f.spans[0][3]
    assert seen == set(PARENTS) - {"reloc_step", "point_optimizer"}
    tracking = [f for f in frames if f.ns("tracking_step")]
    assert len(tracking) >= 20
    for f in tracking:
        assert [s[0] for s in f.spans if _parent(f, s) == "tracking_step"
                ] == list(STAGES)


def test_frame_ids_follow_frame_count(runs):
    pipe = runs["on"]["pipe"]
    ids = [f.frame_id for f in pipe.tracer.frames]
    assert ids == list(range(1, pipe.frame_count + 1))


def test_host_reads_count_every_read(runs):
    tr = runs["on"]["pipe"].tracer
    for f in tr.frames:
        reads = f.ns("host_read")
        assert f.counters["host_reads"] == len(reads) >= 1
        assert 0 < f.counters["host_wait_ns"] <= sum(reads)
        if f.ns("tracking_step"):
            assert len(reads) == 1 + len(f.ns("marginalize"))
        assert f.counters.get("backend_solves", 0) == len(
            f.ns("window_solve")) == len(f.ns("backend_step"))
        assert f.counters.get("keyframes", 0) == len(f.ns("keyframe_step"))
    assert len([f for f in tr.frames if f.ns("marginalize")]) == 2
    assert tr.totals["host_reads"] == sum(f.counters["host_reads"]
                                          for f in tr.frames)
    solves = tr.totals["backend_solves"]
    assert solves >= 6
    assert tr.totals["lm_iterations"] == 3 * solves
    assert 0 <= int(tr.totals["lm_voided"]) <= 3 * solves


def test_spans_are_the_profilers_annotations(runs):
    on = runs["on"]
    frames = on["pipe"].tracer.frames[-N_PROFILED:]
    spans = [(f, s) for f in frames for s in f.spans]
    ann = on["annotations"]
    assert [a[0] for a in ann] == [s[0] for _, s in spans]
    index = {id(s): i for i, (_, s) in enumerate(spans)}
    longer = []                     # ns the annotation outlasts the span
    for i, (f, s) in enumerate(spans):
        name, t0, t1 = ann[i]
        longer.append((t1 - t0) - (s[3] - s[2]))
        assert longer[-1] >= -100_000, (name, i, longer[-1], s[3] - s[2])
        if s[1] >= 0:
            p0, p1 = ann[index[id(f.spans[s[1]])]][1:]
            assert p0 <= t0 and t1 <= p1, (name, i)
    longer = np.asarray(longer)
    assert np.mean(longer <= 1_000_000) >= 0.9, (
        len(longer), np.median(longer), np.sort(longer)[-20:])


def test_window_sums_of_the_recorded_spans(runs):
    frames = runs["on"]["pipe"].tracer.frames
    window = [f for f in frames if f.frame_id > 12]
    for name in STAGES + ("tracking_step", "window_solve", "frame"):
        ms = perf.span_ms(window, name)
        assert ms and all(math.isfinite(v) and v > 0 for v in ms), name
    stages = sum(sum(perf.span_ms(window, n)) for n in STAGES)
    assert stages <= sum(perf.span_ms(window, "tracking_step"))
    assert sum(f.counters["host_reads"] for f in window) >= len(window)
    assert sum(f.counters["host_wait_ns"] for f in window) > 0
    boot = perf.span_ms(frames, "init_step")
    assert boot and all(v > 0 for v in boot)
    assert perf.span_ms(window, "init_step") == []
    assert perf.span_ms(window, "point_optimizer") == []
    means = perf.mean_ms(window)
    assert means["tracking_step"] == pytest.approx(
        np.mean(perf.span_ms(window, "tracking_step")))
    assert set(means) <= set(PARENTS) | {"frame"}


def test_tracer_alone():
    tr = perf.Tracer()
    with tr.frame(1):
        with tr.span("x"):
            tr.count("c")
    assert tr.frames == [] and tr.totals == {}
    tr.start()
    with tr.span("loose"):
        tr.count("c", 2)
    with pytest.raises(ValueError):
        with tr.frame(7):
            with tr.span("raises"):
                raise ValueError
    assert tr.read(torch.tensor([1.5, 2.0])) == [1.5, 2.0]
    loose, raised, read = tr.take()
    assert (loose.frame_id, [s[0] for s in loose.spans]) == (None, ["loose"])
    assert loose.counters == {"c": 2}
    assert [(s[0], s[1]) for s in raised.spans] == [("frame", -1),
                                                   ("raises", 0)]
    assert raised.frame_id == 7 and raised.spans[1][3] > 0
    assert [s[0] for s in read.spans] == ["host_read"]
    assert read.counters["host_reads"] == 1
    assert tr.frames == [] and tr.totals["c"] == 2


def test_tracefile_stage_columns_from_the_spans(tmp_path):
    n = 8
    frames = sequence(n)
    cam_ns = [asl.EUROC_T0_NS + k * 50_000_000 for k in range(n)]
    gts = [np.linalg.inv(gt_pose(k)) for k in range(n)]
    imu = [(asl.EUROC_T0_NS + k * 5_000_000, np.float32([0.0, 0.0, 0.0]),
            np.float32([0.0, 9.81, 0.0])) for k in range(10 * n)]
    asl.write_asl(str(tmp_path / "seq"), frames, cam_ns, gts, imu)
    write_calib(str(tmp_path / "calib.yaml"), imu=False)
    (tmp_path / "params.yaml").write_text(MONO_PARAMS)
    out = run_euroc_mono.main([
        str(tmp_path / "seq"), "--calib", str(tmp_path / "calib.yaml"),
        "--config", str(tmp_path / "params.yaml"),
        "--out", str(tmp_path / "traj.txt"), "--device", "cpu",
        "--png-decoder", "numpy", "--trace-dir", str(tmp_path / "trace")])
    with open(tmp_path / "trace" / "trace.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert list(rows[0]) == (
        [f"timer_{t}" for t in perf.FRONTEND_TIMERS]
        + list(perf.FRONTEND_LOGS))
    assert len(rows) == n and out.handler.tracer.frames == []
    tracking = [r for r, res in zip(rows, out.results)
                if res.stage == Stage.TRACKING]
    assert len(tracking) >= n - 1
    for r in tracking[1:]:
        for t in ("sparse_img_align", "reproject", "pose_optimizer",
                  "point_optimizer", "frontend_time"):
            assert float(r[f"timer_{t}"]) > 0, (t, r)
        assert float(r["timer_frontend_time"]) >= float(
            r["timer_sparse_img_align"])
    assert all(float(r["timer_local_ba"]) == 0 for r in rows)
