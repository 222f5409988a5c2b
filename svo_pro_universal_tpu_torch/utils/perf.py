"""Per-stage performance monitor with the reference's tracefile schema.

The port's own copy of ``svo_pro_universal_tpu/utils/perf.py``; replaces
vk::PerformanceMonitor (reference: src/vikit/vikit_common/include/
vikit/performance_monitor.h:26-48; frontend timer/log registration
frame_handler_base.cpp:89-120; SVO_START_TIMER/SVO_STOP_TIMER/SVO_LOG
macros). Writes the same per-frame CSV layout so the reference's offline
analyzers (extra/svo_benchmarking/scripts/analyze_vio_timing.py,
tracefile_reader.py) parse it unchanged.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional


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
