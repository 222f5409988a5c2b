"""The device trace of a ``--trace 1`` run and its reduction.

``torch.profiler`` (CPU and CUDA activities) runs over the window's first
``trace_frames`` frames; the harness's spans annotate the host side. The
raw kineto events are reduced in memory, nothing is written to disk:

- ``busy_s``: the union of the intervals in which a device activity
  (kernel, copy, set) ran; ``window_s``: the traced window's host-clock
  length, from the profiler's start to its stop after a synchronize;
- ``kernels``: launches and device seconds by kernel name;
- ``device_ops``: the ten kernel names with the most device time;
- ``idle_gaps``: the device's idle time between activities, summed by what
  the host was doing at the gap (the innermost harness span and the host
  operation under it), the ten largest.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Profiler:
    """Starts at window frame 0 and stops at frame ``n``."""

    def __init__(self, device, n: int):
        self.device = device
        self.n = n
        self.prof = None
        self.t0 = self.t1 = None
        self.frames = 0

    def step(self, i: int, spans, sampler, pipe) -> None:
        if i == 0 and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            spans.profiling = sampler.profiling = True
            self.t0 = time.perf_counter()
        elif i >= self.n and self.prof is not None and self.t1 is None:
            pipe.block()
            self.t1 = time.perf_counter()
            self.prof.__exit__(None, None, None)
            spans.profiling = sampler.profiling = False
            self.frames = i

    def summary(self) -> dict:
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            if e.is_user_annotation() and e.device_type() != \
                    torch.autograd.DeviceType.CPU:
                continue     # a span's projection onto the device timeline
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
            else:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             e.name(), e.is_user_annotation(),
                             e.start_thread_id()))
        kernels = defaultdict(lambda: [0, 0.0])
        for s, t, name in dev:
            if not name.startswith(("Memcpy", "Memset")):
                k = kernels[name]
                k[0] += 1
                k[1] += (t - s) * 1e-9
        busy, gaps = _busy_and_gaps(dev)
        return {
            "frames": self.frames,
            "window_s": self.t1 - self.t0,
            "busy_s": busy,
            "launches": sum(k[0] for k in kernels.values()),
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "device_ops": [[n[:64], v[1]] for n, v in sorted(
                kernels.items(), key=lambda kv: -kv[1][1])[:10]],
            "idle_gaps": _attribute(gaps, host)[:10],
        }


def _busy_and_gaps(dev: list) -> tuple[float, list]:
    """Union length (s) of the device intervals, and the gaps between
    them as (start, end) ns."""
    busy = 0
    gaps = []
    end = None
    for s, t, _ in sorted(dev):
        if end is None:
            busy += t - s
            end = t
        elif s > end:
            gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy * 1e-9, gaps


def _attribute(gaps: list, host: list) -> list:
    """Idle seconds summed by the host's work at each gap's midpoint, on
    the thread of the harness's spans: ``span/op`` for the innermost span
    and the innermost operation under it."""
    threads = [h[4] for h in host if h[3]]
    if not threads:
        threads = [h[4] for h in host]
    if not threads:
        return []
    main = max(set(threads), key=threads.count)
    hs = sorted((h for h in host if h[4] == main),
                key=lambda h: (h[0], -h[1]))
    totals = defaultdict(float)
    stack: list = []
    k = 0
    # one sweep: gaps in time order, host events pushed as they open and
    # popped once closed (events on one thread nest)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while k < len(hs) and hs[k][0] <= mid:
            while stack and stack[-1][1] < hs[k][0]:
                stack.pop()
            stack.append(hs[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        span = next((h[2] for h in reversed(stack) if h[3]), None)
        op = next((h[2] for h in reversed(stack) if not h[3]), None)
        label = f"{span or '_no_span_'}/{op or '_no_host_op_'}"
        totals[label] += (g1 - g0) * 1e-9
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]
