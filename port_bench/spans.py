"""The harness's instruments: spans around calls into the port's layers,
and the seeded sample of kernel calls that the correctness check reads.

Spans are the benchmark's own (the port has none yet): a wrapper on the
pipeline object records the host-clock duration of each call of a layer's
entry method, and, while the device trace is on, a profiler annotation of
the same name, so idle gaps can be told apart by what the host was doing.
They are installed only in a ``--trace 1`` run.

The call sample is installed in every run. It wraps the module functions
through which the port reaches its hand-written kernels
(``ops.cuda_tiles.extract_tiles`` / ``extract_tiles_ring`` and
``ops.cuda_align.align_level``) and the backend's window solve
(``backend.window_ba.optimize``, with the ``maybe_vi_align`` it calls
first); a call chosen by a seeded draw has its inputs and outputs copied as
the window runs (device copies queued on the stream, large sources into
pinned host buffers made at set-up), so the reference can judge them once
the window has closed.
"""

from __future__ import annotations

import random
import time
from collections import defaultdict

import torch


class Spans:
    """Host-clock durations (s) of wrapped method calls, by span name."""

    def __init__(self):
        self.times: dict[str, list[float]] = defaultdict(list)
        self.profiling = False
        self.active = False

    def wrap(self, obj, method: str, name: str | None = None,
             ran=None) -> None:
        """Wrap ``obj.method`` (an instance attribute shadows the class's).
        ``ran(args, out)`` says whether the call did the layer's work (a
        backend step that found nothing to do is not counted)."""
        fn = getattr(obj, method)
        label = name or method

        def timed(*a, **k):
            if not self.active:
                return fn(*a, **k)
            t0 = time.perf_counter()
            if self.profiling:
                with torch.profiler.record_function(label):
                    out = fn(*a, **k)
            else:
                out = fn(*a, **k)
            dt = time.perf_counter() - t0
            if ran is None or ran(a, out):
                self.times[label].append(dt)
            return out
        setattr(obj, method, timed)


def _copy(x):
    """A device copy of a tensor (tuples and NamedTuples element-wise)."""
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, tuple):
        items = [_copy(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if isinstance(x, list):
        return [_copy(v) for v in x]
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return x


def to_cpu(x):
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, tuple):
        items = [to_cpu(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if isinstance(x, list):
        return [to_cpu(v) for v in x]
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


def gather_bytes(n: int, R: int, T: int, ring: bool, idx_bytes: int) -> int:
    """Bytes a tile gather in centres mode must move: each tile read once
    and written once, the float32 centres and the level (and keyframe)
    indices in, the four int64 origin vectors out."""
    return 2 * n * R * T * 4 + n * (2 * 4 + idx_bytes * (1 + ring) + 4 * 8)


def align_bytes(cams, P: int) -> int:
    """Bytes one ``align_level`` launch must move: its tiles, Jacobians,
    templates, points, tile origins and extents, flags, camera parameters,
    state and prior in, the 12-float result out (each read once, however
    often the LM loop reads it again)."""
    n = sum(lc.xyz_ref.shape[0] for lc in cams)
    R, T = cams[0].tb.tiles.shape[-2:]
    C = len(cams)
    per_feature = R * T * 4 + P * P * 8 * 4 + P * P * 4 + 3 * 4 + 4 * 8 + 1
    return (n * per_feature + (4 if C > 1 else 0) * n + C * 16 * 4
            + 2 * 9 * 4 + 12 * 4)


class KernelSampler:
    """Copies of a seeded sample of the window's kernel calls, and (while
    ``profiling``) the bytes each launch must move, for the roofline
    readers."""

    def __init__(self, seed: int, plan: dict):
        """``plan[name] = (n, first)``: copy ``n`` of the window's first
        ``first`` calls of the entry point, chosen from ``seed``."""
        rng = random.Random(seed)
        self.caps = {k: n for k, (n, _) in plan.items()}
        self.picks = {k: set(rng.sample(range(first), min(n, first)))
                      for k, (n, first) in plan.items()}
        self.samples: dict[str, list] = defaultdict(list)
        self.calls: dict[str, int] = defaultdict(int)
        self.active = False
        self.profiling = False
        self.bytes: dict[str, list[int]] = defaultdict(list)
        self._pinned: dict[tuple, list] = defaultdict(list)
        self._undo: list = []
        # (name, shape, dtype) of the gather sources met before the window,
        # for which ``reserve`` makes host buffers
        self.shapes_seen: set = set()

    def reserve(self, name: str, shape, dtype, n: int, pin: bool) -> None:
        """Host buffers for ``n`` sampled sources of ``shape`` (pinned on a
        card run, made at set-up so the window allocates none)."""
        for _ in range(n):
            self._pinned[(name, tuple(shape), dtype)].append(
                torch.empty(shape, dtype=dtype, pin_memory=pin))

    def _source(self, name: str, src: torch.Tensor) -> torch.Tensor:
        key = (name, tuple(src.shape), src.dtype)
        pool = self._pinned.get(key)
        if src.device.type == "cuda" and pool:
            buf = pool.pop()
            buf.copy_(src, non_blocking=True)
            return buf
        return src.detach().clone()

    def _draw(self, name: str) -> bool:
        self.calls[name] += 1
        return self.calls[name] - 1 in self.picks.get(name, ())

    def install(self, cuda_tiles, cuda_align, window_ba=None) -> None:
        """Wrap the three kernel entry points of the port's modules, and
        the window solve where ``window_ba`` is given."""
        if window_ba is not None:
            self._wrap_solve(window_ba)
        for name, ring in (("extract_tiles", False),
                           ("extract_tiles_ring", True)):
            self._wrap_tiles(cuda_tiles, name, ring)
        fn = cuda_align.align_level

        def align_level(cams, state, opts, level, T_prior=None):
            if not self.active:
                return fn(cams, state, opts, level, T_prior)
            take = self._draw("align_level")
            if take:
                inputs = _copy(dict(
                    cams=[dict(intrinsics=lc.cam.intrinsics,
                               projection=int(lc.cam.projection),
                               distortion=int(lc.cam.distortion),
                               T_cam_body=lc.T_cam_body,
                               xyz_ref=lc.xyz_ref, ref_patch=lc.ref_patch,
                               jac=lc.jac, ok=lc.ok, tiles=lc.tb.tiles,
                               y0=lc.tb.y0, x0=lc.tb.x0, lh=lc.tb.lh,
                               lw=lc.tb.lw) for lc in cams],
                    state=state, T_prior=T_prior))
            out = fn(cams, state, opts, level, T_prior)
            if take:
                self.samples["align_level"].append(dict(
                    inputs, opts=dict(opts._asdict()), level=int(level),
                    out=_copy(out)))
            if self.profiling:
                self.bytes["align_level"].append(
                    align_bytes(cams, opts.patch_size))
            return out
        self._undo.append((cuda_align, "align_level", fn))
        cuda_align.align_level = align_level

    def _wrap_solve(self, wba) -> None:
        """A sampled ``optimize`` call keeps its input window, the window
        its LM loop starts from (``maybe_vi_align``'s output, where that
        ran), the window it returns and the cost it reports."""
        optimize, align = wba.optimize, wba.maybe_vi_align
        aligned: list = []

        def maybe_vi_align(w, opts):
            out = align(w, opts)
            if aligned:
                aligned[0] = _copy(out)
            return out

        def solve(w, T_cam_body, focal, opts=wba.BAOptions(), *a, **k):
            if not (self.active and self._draw("optimize")):
                return optimize(w, T_cam_body, focal, opts, *a, **k)
            inputs = _copy(dict(window=w, T_cam_body=T_cam_body,
                                focal=focal))
            aligned[:] = [None]
            try:
                out = optimize(w, T_cam_body, focal, opts, *a, **k)
            finally:
                start = aligned.pop() if aligned else None
            self.samples["optimize"].append(dict(
                inputs, start=start, opts=dict(opts._asdict()),
                out=_copy(out[0]), cost=_copy(out[1])))
            return out
        self._undo += [(wba, "optimize", optimize),
                       (wba, "maybe_vi_align", align)]
        wba.optimize, wba.maybe_vi_align = solve, maybe_vi_align

    def _wrap_tiles(self, mod, name: str, ring: bool) -> None:
        fn = getattr(mod, name)

        def gather(*args):
            src = args[0]
            if not self.active:
                self.shapes_seen.add((name, tuple(src.shape), src.dtype))
                return fn(*args)
            take = self._draw(name)
            if take:
                inputs = (self._source(name, src),
                          *[_copy(a) for a in args[1:]])
            out = fn(*args)
            if take:
                self.samples[name].append(dict(args=inputs, out=_copy(out)))
            if self.profiling:
                level, R, T = args[-4], args[-2], args[-1]
                n = level.shape[0]
                if n:
                    self.bytes[name].append(gather_bytes(
                        n, R, T, ring, level.element_size()))
            return out
        self._undo.append((mod, name, fn))
        setattr(mod, name, gather)

    def uninstall(self) -> None:
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo.clear()
