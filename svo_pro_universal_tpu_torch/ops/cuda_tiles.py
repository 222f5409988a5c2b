"""Tile gathers: CUDA kernels 1 and 2 of the port, with their plain versions.

Counterpart of ``svo_pro_universal_tpu/ops/pallas_tiles.py`` (kernels
``gather_tiles`` :105-128 and ``gather_tiles_ring`` :131-152). Source:
``csrc/tiles.cu``, whose header notes what bounds the kernel on Hopper and
how it is laid out. The tiles are exact ``R×T`` windows at the caller's
origins, so the kernel and the plain version are bit-identical copies.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from svo_pro_universal_tpu_torch.ops import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

GATHER_TILES = _cuda.register(_cuda.Kernel(
    "gather_tiles", "tiles.cu", "svo_gather_tiles",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "svo_pro_universal_tpu/ops/pallas_tiles.py:105"))
GATHER_TILES_RING = _cuda.register(_cuda.Kernel(
    "gather_tiles_ring", "tiles.cu", "svo_gather_tiles_ring",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "svo_pro_universal_tpu/ops/pallas_tiles.py:131"))


def _window_index(y0, x0, R: int, T: int):
    dev = y0.device
    rows = y0.long()[:, None, None] + torch.arange(R, device=dev)[None, :,
                                                                   None]
    cols = x0.long()[:, None, None] + torch.arange(T, device=dev)[None, None,
                                                                   :]
    return rows, cols


def gather_tiles_plain(pyr3: torch.Tensor, level: torch.Tensor,
                       y0: torch.Tensor, x0: torch.Tensor, R: int, T: int
                       ) -> torch.Tensor:
    """[N, R, T] tiles of a padded [L, H, W] pyramid at per-feature
    (level, y0, x0) origins (pre-clipped in bounds)."""
    rows, cols = _window_index(y0, x0, R, T)
    return pyr3[level.long()[:, None, None], rows, cols]


def gather_tiles_ring_plain(ring4: torch.Tensor, kf: torch.Tensor,
                            level: torch.Tensor, y0: torch.Tensor,
                            x0: torch.Tensor, R: int, T: int
                            ) -> torch.Tensor:
    """Like :func:`gather_tiles_plain` from a [K, L, H, W] keyframe ring
    with a per-feature keyframe index."""
    rows, cols = _window_index(y0, x0, R, T)
    return ring4[kf.long()[:, None, None], level.long()[:, None, None],
                 rows, cols]


def _i64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64).contiguous()


def _check(name: str, src: torch.Tensor, ndim: int, idx) -> None:
    if src.dtype != torch.float32 or src.dim() != ndim:
        raise ValueError(f"{name}: expected float32 [{ndim}-D] source, got "
                         f"{src.dtype} {tuple(src.shape)}")
    n = idx[0].shape[0]
    for t in idx:
        if t.shape != (n,):
            raise ValueError(f"{name}: index shapes "
                             f"{[tuple(i.shape) for i in idx]}")


def gather_tiles(pyr3: torch.Tensor, level: torch.Tensor, y0: torch.Tensor,
                 x0: torch.Tensor, R: int, T: int) -> torch.Tensor:
    """[N, R, T] tiles from a padded [L, H, W] pyramid (kernel 1)."""
    _check("gather_tiles", pyr3, 3, (level, y0, x0))
    if pyr3.device.type == "cpu":
        return gather_tiles_plain(pyr3, level, y0, x0, R, T)
    if pyr3.device.type != "cuda":
        raise ValueError(f"gather_tiles: unsupported device {pyr3.device}")
    L, H, W = pyr3.shape
    n = level.shape[0]
    lvl, yy, xx = _i64(level), _i64(y0), _i64(x0)
    _cuda.check_cuda("gather_tiles", pyr3, lvl, yy, xx)
    out = torch.empty((n, R, T), dtype=torch.float32, device=pyr3.device)
    P = _cuda.ptr
    GATHER_TILES.launch(P(pyr3), P(lvl), P(yy), P(xx), P(out), n, L, H, W,
                        R, T)
    return out


def gather_tiles_ring(ring4: torch.Tensor, kf: torch.Tensor,
                      level: torch.Tensor, y0: torch.Tensor,
                      x0: torch.Tensor, R: int, T: int) -> torch.Tensor:
    """[N, R, T] tiles from a [K, L, H, W] keyframe ring (kernel 2)."""
    _check("gather_tiles_ring", ring4, 4, (kf, level, y0, x0))
    if ring4.device.type == "cpu":
        return gather_tiles_ring_plain(ring4, kf, level, y0, x0, R, T)
    if ring4.device.type != "cuda":
        raise ValueError(
            f"gather_tiles_ring: unsupported device {ring4.device}")
    _, L, H, W = ring4.shape
    n = level.shape[0]
    k, lvl, yy, xx = _i64(kf), _i64(level), _i64(y0), _i64(x0)
    _cuda.check_cuda("gather_tiles_ring", ring4, k, lvl, yy, xx)
    out = torch.empty((n, R, T), dtype=torch.float32, device=ring4.device)
    P = _cuda.ptr
    GATHER_TILES_RING.launch(P(ring4), P(k), P(lvl), P(yy), P(xx), P(out),
                             n, L, H, W, R, T)
    return out
