"""The port's one performance instrument: the ``Tracer`` (spans and counters
of each frame), and the reference's per-frame tracefile, which reads it.

``Tracer``: every pipeline and handler owns one (``.tracer``), off until a
caller starts it. Off, a span is one attribute test and a return: nothing
is recorded, no profiler annotation opened, nothing launched. On, each
frame's spans (name, parent, start and end on ``time.perf_counter_ns``)
and counters are kept in memory under the frame's id until the caller
reads them. While ``torch.profiler`` is active each span also opens a
``record_function`` of its name, so the program's spans stand on the
profiler's timeline, on the clock of the device activity. Span names
follow the reference's tracefile timers (``FRONTEND_TIMERS``) where one
exists.

``PerformanceMonitor``: the port's own copy of
``svo_pro_universal_tpu/utils/perf.py``; replaces vk::PerformanceMonitor
(reference: src/vikit/vikit_common/include/vikit/performance_monitor.h:
26-48; frontend timer/log registration frame_handler_base.cpp:89-120;
SVO_START_TIMER/SVO_STOP_TIMER/SVO_LOG macros). Writes the same per-frame
CSV layout so the reference's offline analyzers
(extra/svo_benchmarking/scripts/analyze_vio_timing.py,
tracefile_reader.py) parse it unchanged; ``timers_from`` fills its timers
from one frame of a ``Tracer``.
"""

from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from typing import Optional

import torch


class FrameTrace:
    """One frame's record: its id (the pipeline's ``frame_count``; None
    for spans opened outside a frame), its spans as ``[name, parent,
    start_ns, end_ns]`` in the order they opened (``parent`` the index of
    the enclosing span in ``spans``, -1 for the root) and its counters."""

    __slots__ = ("frame_id", "spans", "counters")

    def __init__(self, frame_id: Optional[int]):
        self.frame_id = frame_id
        self.spans: list[list] = []
        self.counters: dict = {}

    def ns(self, name: str) -> list[int]:
        """Durations (ns) of this frame's spans called ``name``."""
        return [s[3] - s[2] for s in self.spans if s[0] == name]


class _Off:
    """What a span of a tracer that is off enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "frame_id")

    def __init__(self, tracer: "Tracer", name: str,
                 frame_id: Optional[int] = None):
        self.tracer, self.name, self.frame_id = tracer, name, frame_id

    def __enter__(self):
        self.tracer._open(self.name, self.frame_id)

    def __exit__(self, *exc):
        self.tracer._close()
        return False


class Tracer:
    """Spans and counters of a pipeline's frames (module docstring).

    ``frame(frame_id)`` opens a frame's root span ``frame``; ``span(name)``
    a span inside whatever span is open (a span opened with none open
    starts a record of its own, with id None); ``count(name, v)`` adds to
    the open frame's counter and to ``totals``; ``read(x)`` is the one
    helper of the frame path's deliberate device→host reads. A record is
    appended to ``frames`` when its root span closes."""

    def __init__(self):
        self.on = False
        self.frames: list[FrameTrace] = []
        self.totals: dict = {}
        self._rec: Optional[FrameTrace] = None
        # open spans: (index in the record's spans, record_function or None)
        self._open_spans: list = []

    def start(self) -> "Tracer":
        self.on = True
        return self

    def take(self) -> list[FrameTrace]:
        """The frames recorded so far; the tracer keeps none of them."""
        out, self.frames = self.frames, []
        return out

    def span(self, name: str):
        if not self.on:
            return _OFF
        return _Span(self, name)

    def frame(self, frame_id: int):
        if not self.on:
            return _OFF
        return _Span(self, "frame", frame_id)

    def count(self, name: str, value=1) -> None:
        """Add ``value`` (a number, or a device tensor: a device add) to
        counter ``name``."""
        if not self.on:
            return
        if self._rec is not None:
            c = self._rec.counters
            c[name] = c.get(name, 0) + value
        self.totals[name] = self.totals.get(name, 0) + value

    def read(self, x):
        """A deliberate device→host read: ``x.tolist()`` of a tensor, or the
        result of ``x()``, a call that waits on the device. On, it is a
        ``host_read`` span, counts ``host_reads`` and adds the time it
        took to ``host_wait_ns``."""
        if not self.on:
            return x() if callable(x) else x.tolist()
        with _Span(self, "host_read"):
            t0 = time.perf_counter_ns()
            out = x() if callable(x) else x.tolist()
            self.count("host_wait_ns", time.perf_counter_ns() - t0)
            self.count("host_reads")
        return out

    def _open(self, name: str, frame_id: Optional[int]) -> None:
        if self._rec is None:
            self._rec = FrameTrace(frame_id)
        spans = self._rec.spans
        parent = self._open_spans[-1][0] if self._open_spans else -1
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        spans.append([name, parent, time.perf_counter_ns(), 0])
        self._open_spans.append((len(spans) - 1, rf))

    def _close(self) -> None:
        t1 = time.perf_counter_ns()
        i, rf = self._open_spans.pop()
        self._rec.spans[i][3] = t1
        if rf is not None:
            rf.__exit__(None, None, None)
        if not self._open_spans:
            self.frames.append(self._rec)
            self._rec = None


def traced(name: str):
    """A method whose every call is span ``name`` of ``self.tracer``."""
    def wrap(fn):
        @functools.wraps(fn)
        def method(self, *args, **kwargs):
            tracer = self.tracer
            if not tracer.on:
                return fn(self, *args, **kwargs)
            with _Span(tracer, name):
                return fn(self, *args, **kwargs)
        return method
    return wrap


def span_ms(frames: list[FrameTrace], name: str) -> list[float]:
    """Durations (ms) of every span ``name`` in ``frames``."""
    return [ns * 1e-6 for f in frames for ns in f.ns(name)]


def mean_ms(frames: list[FrameTrace]) -> dict:
    """{span name: mean ms a call} over ``frames``."""
    calls: dict = {}
    for f in frames:
        for name, _, t0, t1 in f.spans:
            n, t = calls.get(name, (0, 0))
            calls[name] = (n + 1, t + t1 - t0)
    return {name: t * 1e-6 / n for name, (n, t) in calls.items()}


class PerformanceMonitor:
    def __init__(self, trace_name: str = "trace",
                 trace_dir: Optional[str] = None):
        self.timers: dict[str, float] = {}
        self.logs: dict[str, float] = {}
        self._starts: dict[str, float] = {}
        self._order: list[str] = []
        self._file = None
        self._header_written = False
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            self._file = open(os.path.join(trace_dir,
                                           f"{trace_name}.csv"), "w")

    def init(self, name: str) -> None:
        key = f"timer_{name}"
        if key not in self._order:
            self._order.append(key)
        self.timers[name] = 0.0

    def add_log(self, name: str) -> None:
        if name not in self._order:
            self._order.append(name)
        self.logs[name] = 0.0

    def start_timer(self, name: str) -> None:
        if name not in self.timers:
            self.init(name)
        self._starts[name] = time.perf_counter()

    def stop_timer(self, name: str) -> None:
        t0 = self._starts.pop(name, None)
        if t0 is not None:
            self.timers[name] = time.perf_counter() - t0

    @contextmanager
    def timer(self, name: str):
        self.start_timer(name)
        try:
            yield
        finally:
            self.stop_timer(name)

    def timers_from(self, frame: FrameTrace) -> None:
        """Each ``FRONTEND_TIMERS`` timer (s) from one frame of a
        ``Tracer``: the sum of its spans of that name (``frontend_time``:
        the ``frame`` span), 0 for a timer the frame has no span of."""
        for name in FRONTEND_TIMERS:
            if name not in self.timers:
                self.init(name)
            span = "frame" if name == "frontend_time" else name
            self.timers[name] = sum(frame.ns(span)) * 1e-9

    def log(self, name: str, value) -> None:
        if name not in self.logs:
            self.add_log(name)
        self.logs[name] = float(value)

    def write_to_file(self) -> None:
        """One CSV row per frame (reference writeToFile)."""
        if self._file is None:
            return
        if not self._header_written:
            self._file.write(",".join(self._order) + "\n")
            self._header_written = True
        row = []
        for key in self._order:
            if key.startswith("timer_"):
                row.append(f"{self.timers.get(key[6:], 0.0):.6f}")
            else:
                row.append(f"{self.logs.get(key, 0.0):g}")
        self._file.write(",".join(row) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


# the frontend's standard timer/log set (frame_handler_base.cpp:93-118)
FRONTEND_TIMERS = (
    "pyramid_creation", "sparse_img_align", "reproject", "feature_align",
    "pose_optimizer", "point_optimizer", "local_ba", "frontend_time")
FRONTEND_LOGS = (
    "timestamp", "img_align_n_tracked", "repr_n_matches", "repr_n_trials",
    "sfba_n_edges_final", "sfba_thresh", "sfba_error_before",
    "sfba_error_after", "n_candidates", "dropout")


def make_frontend_monitor(trace_dir: Optional[str] = None
                          ) -> PerformanceMonitor:
    pm = PerformanceMonitor("trace", trace_dir)
    for t in FRONTEND_TIMERS:
        pm.init(t)
    for l in FRONTEND_LOGS:
        pm.add_log(l)
    return pm
