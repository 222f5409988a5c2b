"""The tile gathers at the shapes of the mono tracking step, of the
FivePoint bootstrap's KLT and of the stereo triangulation, and CUDA-event
timers: the inputs and calls that ``gather_bench.py`` times and
``chip_smoke.py`` holds against the plain versions, so both make the same
inputs from the same seed.

Imports only numpy and torch (``gather_bench.py`` loads it by its path, to
time a tree of the port that predates it); the port's modules under test
are passed in.
"""

from __future__ import annotations

import numpy as np
import torch

L, K, H, W = 5, 8, 480, 752       # levels, ring slots, EuRoC image
# (kernel, N, tile, where the mono tracking step cuts such tiles)
PATH_SHAPES = [
    ("gather_tiles", 360, 12, "sparse alignment, reference patches"),
    ("gather_tiles", 360, 24, "sparse alignment, current tiles"),
    ("gather_tiles", 384, 24, "reprojection, subpixel alignment"),
    ("gather_tiles", 768, 24, "depth filter, subpixel alignment"),
    ("gather_tiles", 768, 40, "depth filter, epipolar scan"),
    ("gather_tiles_ring", 384, 24, "reprojection, reference patches"),
    ("gather_tiles_ring", 768, 24, "depth filter, reference patches"),
    # the FivePoint bootstrap's KLT (patch 8): 14×14 template tiles and
    # 26×26 search tiles, at every level 0..4 (plain-load copy route: 14
    # and 26 are no multiples of 4)
    ("gather_tiles", 360, 14, "KLT reference border patches"),
    ("gather_tiles", 360, 26, "KLT search tiles"),
    # the stereo and array pipelines' keyframe triangulation: cam0's
    # reference tiles (24, as the alignment's) and the epipolar scan in
    # the secondary camera's pyramid
    ("gather_tiles", 360, 40, "stereo triangulation, epipolar scan"),
]


def cuda_ms(fn, reps: int = 20, samples: int = 15) -> float:
    """Median over ``samples`` of the mean CUDA-event time of ``reps``
    back-to-back calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def cold_ms(fn, samples: int = 15) -> float:
    """Median CUDA-event time of one call right after a 256 MB write (the
    write takes ~80 us, long enough for the host to queue the call behind
    it, so the events time the device)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sources(rng: np.random.Generator, dev) -> tuple:
    """A random padded pyramid [L, H, W] and keyframe ring [K, L, H, W]."""
    pyr = rng.uniform(0, 255, (L, H, W)).astype(np.float32)
    ring = rng.uniform(0, 255, (K, L, H, W)).astype(np.float32)
    return torch.as_tensor(pyr, device=dev), torch.as_tensor(ring, device=dev)


def centres(rng: np.random.Generator, n: int, dev) -> tuple:
    """int64 levels and ring slots in range, and float32 (y, x) centres
    inside each feature's level, stacked as the callers stack them."""
    lvl = rng.integers(0, L, n)
    cy = rng.uniform(0, 1, n) * (H >> lvl)
    cx = rng.uniform(0, 1, n) * (W >> lvl)
    kf = rng.integers(0, K, n)
    return (torch.as_tensor(lvl, device=dev), torch.as_tensor(kf, device=dev),
            torch.as_tensor(np.stack([cy, cx], -1).astype(np.float32),
                            device=dev))


def path_inputs(seed: int, dev) -> tuple:
    """(pyramid, ring, [(kernel, N, tile, where, level, slot, centres)]):
    the sources and, for each of ``PATH_SHAPES`` in order, its features,
    all drawn from one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    pyr, ring = sources(rng, dev)
    return pyr, ring, [(name, n, R, where, *centres(rng, n, dev))
                       for name, n, R, where in PATH_SHAPES]


def shape_calls(tl, ct, pyr, ring, name: str, R: int, lvl, kf, cyx
                ) -> tuple:
    """(the whole extract call, the origins-given gather) at one shape, as
    closures over the port modules ``tl`` (ops.tiles) and ``ct``
    (ops.cuda_tiles) of the tree under test."""
    if name == "gather_tiles_ring":
        def call():
            return tl.extract_tiles_ring(ring, kf, lvl, cyx, R, R)
        tb = call()

        def given():
            return ct.gather_tiles_ring(ring, kf, lvl, tb.y0, tb.x0, R, R)
    else:
        def call():
            return tl.extract_tiles(pyr, lvl, cyx, R, R)
        tb = call()

        def given():
            return ct.gather_tiles(pyr, lvl, tb.y0, tb.x0, R, R)
    return call, given
