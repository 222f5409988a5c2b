"""Tile gathers: CUDA kernels 1 and 2 of the port, with their plain versions.

Counterpart of ``svo_pro_universal_tpu/ops/pallas_tiles.py`` (kernels
``gather_tiles`` :105-128 and ``gather_tiles_ring`` :131-152) and of the
origin arithmetic around them in ``svo_pro_universal_tpu/ops/tiles.py``
(``_tile_origin``, ``extract_tiles``, ``extract_tiles_ring``). Source:
``csrc/tiles.cu``, whose header notes what bounds the kernel on Hopper and
how it is laid out: on the card each call below is ONE kernel launch, which
computes the tile origins itself (centres mode) or takes them as given, and
copies with TMA where the shape allows it (``tma_route``) or with plain
loads otherwise. The tiles are exact ``R×T`` windows, so the kernel and the
plain version are bit-identical copies, origins included.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from svo_pro_universal_tpu_torch.ops import _cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# (indices..., centres, centre strides, origins out, tiles out, n, [K,] L, H,
# W, R, T, int64 mask) + stream
GATHER_TILES = _cuda.register(_cuda.Kernel(
    "gather_tiles", "tiles.cu", "svo_gather_tiles",
    [_P, _P, _P, _P, _P, _L, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "svo_pro_universal_tpu/ops/pallas_tiles.py:105"))
GATHER_TILES_RING = _cuda.register(_cuda.Kernel(
    "gather_tiles_ring", "tiles.cu", "svo_gather_tiles_ring",
    [_P, _P, _P, _P, _P, _P, _L, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     _I, _P],
    "svo_pro_universal_tpu/ops/pallas_tiles.py:131"))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def level_sizes(h: int, w: int, n_levels: int, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(heights [L], widths [L]) of the pyramid levels, built on the device
    (a host list copied to the card would synchronize the stream)."""
    lv = torch.arange(n_levels, device=device)
    return torch.full_like(lv, h) >> lv, torch.full_like(lv, w) >> lv


def tile_origins(cy, cx, level, R, T, h, w, n_levels):
    """(y0, x0, lh, lw, lvl) [N] int64 of R×T tiles centred on (cy, cx) in
    level coordinates: the operation order of the JAX ``_tile_origin``."""
    hs, ws = level_sizes(h, w, n_levels, cy.device)
    lvl = torch.clamp(level.long(), 0, n_levels - 1)
    lh, lw = hs[lvl], ws[lvl]
    y0 = torch.round(cy).long() - R // 2
    x0 = torch.round(cx).long() - T // 2
    # keep the slice inside the PADDED array; level extents are handled by
    # the sampling masks (zeros pad outside the level)
    y0 = torch.clamp(y0, 0, h - R)
    x0 = torch.clamp(x0, 0, w - T)
    return y0, x0, lh, lw, lvl


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


def extract_tiles_plain(pyr3: torch.Tensor, level: torch.Tensor,
                        center_yx: torch.Tensor, R: int, T: int):
    """(tiles [N, R, T], y0, x0, lh, lw) around ``center_yx`` ([N, 2] =
    (y, x) in level coordinates) at per-feature ``level``."""
    L, H, W = pyr3.shape
    y0, x0, lh, lw, lvl = tile_origins(
        center_yx[:, 0], center_yx[:, 1], level, R, T, H, W, L)
    return gather_tiles_plain(pyr3, lvl, y0, x0, R, T), y0, x0, lh, lw


def extract_tiles_ring_plain(ring4: torch.Tensor, kf: torch.Tensor,
                             level: torch.Tensor, center_yx: torch.Tensor,
                             R: int, T: int):
    """Like :func:`extract_tiles_plain` from a [K, L, H, W] keyframe ring,
    the keyframe index clipped to [0, K-1]."""
    K, L, H, W = ring4.shape
    y0, x0, lh, lw, lvl = tile_origins(
        center_yx[:, 0], center_yx[:, 1], level, R, T, H, W, L)
    kfc = torch.clamp(kf.long(), 0, K - 1)
    return (gather_tiles_ring_plain(ring4, kfc, lvl, y0, x0, R, T), y0, x0,
            lh, lw)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_INDEX_TYPES = (torch.int32, torch.int64)


def tma_route(src: torch.Tensor, R: int, T: int) -> bool:
    """Whether tiles of R×T from ``src`` (a CUDA tensor) take the TMA route
    of the kernel (else plain loads): a row pitch and a T that are multiples
    of 16 bytes and of 4 floats; decided in csrc/tiles.cu."""
    fn = _cuda.load("tiles.cu").svo_gather_route
    fn.argtypes = [_P, _I, _I, _I]
    fn.restype = _I
    return bool(fn(_cuda.ptr(src), src.shape[-1], R, T))


def _dispatch(name: str, src: torch.Tensor, ndim: int, R: int, T: int
              ) -> bool:
    """True for the kernel (CUDA source), False for the plain version."""
    if src.dtype != torch.float32 or src.dim() != ndim:
        raise ValueError(f"{name}: expected float32 [{ndim}-D] source, got "
                         f"{src.dtype} {tuple(src.shape)}")
    if not (1 <= R <= src.shape[-2] and 1 <= T <= src.shape[-1]):
        raise ValueError(f"{name}: {R}x{T} tiles from a "
                         f"{tuple(src.shape[-2:])} source")
    if src.device.type == "cpu":
        return False
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    return True


def _launch(kernel: _cuda.Kernel, src: torch.Tensor, kf, level, y0, x0,
            center_yx, R: int, T: int):
    """One launch of ``kernel`` (on a CUDA ``src``): the tiles, and the
    [4, N] int64 (y0, x0, lh, lw) in centres mode. Index vectors are passed
    as they are (int32 or int64, flagged per vector in ``wide``) and the
    centres by their strides, so nothing is cast or copied on the card."""
    n = level.shape[0]
    dev = src.device
    if not src.is_contiguous():
        raise ValueError(f"{kernel.name}: non-contiguous source")
    wide = 0
    ptrs = []
    for i, t in enumerate((kf, level, y0, x0)):
        if t is None:
            ptrs.append(None)
            continue
        if (t.shape != (n,) or t.dtype not in _INDEX_TYPES or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{kernel.name}: index {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"contiguous int32/int64 [{n}] on {dev}")
        wide |= (t.dtype == torch.int64) << i
        ptrs.append(t.data_ptr())
    out = torch.empty((n, R, T), dtype=torch.float32, device=dev)
    org = ctr = None
    cs0 = cs1 = 0
    if center_yx is not None:
        if (center_yx.dtype != torch.float32 or center_yx.shape != (n, 2)
                or center_yx.device != dev):
            raise ValueError(f"{kernel.name}: centres {center_yx.dtype} "
                             f"{tuple(center_yx.shape)} on "
                             f"{center_yx.device}, expected float32 [{n}, 2]")
        org = torch.empty((4, n), dtype=torch.int64, device=dev)
        ctr, (cs0, cs1) = center_yx.data_ptr(), center_yx.stride()
    if n:
        ring = ptrs[:1] if kf is not None else []
        kernel.launch(src.data_ptr(), *ring, *ptrs[1:], ctr, cs0, cs1,
                      org.data_ptr() if org is not None else None,
                      out.data_ptr(), n, *src.shape, R, T, wide)
    return out, org


def gather_tiles(pyr3: torch.Tensor, level: torch.Tensor, y0: torch.Tensor,
                 x0: torch.Tensor, R: int, T: int) -> torch.Tensor:
    """[N, R, T] tiles from a padded [L, H, W] pyramid at given origins
    (kernel 1, origins-given mode)."""
    if not _dispatch("gather_tiles", pyr3, 3, R, T):
        return gather_tiles_plain(pyr3, level, y0, x0, R, T)
    return _launch(GATHER_TILES, pyr3, None, level, y0, x0, None, R, T)[0]


def gather_tiles_ring(ring4: torch.Tensor, kf: torch.Tensor,
                      level: torch.Tensor, y0: torch.Tensor,
                      x0: torch.Tensor, R: int, T: int) -> torch.Tensor:
    """[N, R, T] tiles from a [K, L, H, W] keyframe ring at given origins
    (kernel 2, origins-given mode)."""
    if not _dispatch("gather_tiles_ring", ring4, 4, R, T):
        return gather_tiles_ring_plain(ring4, kf, level, y0, x0, R, T)
    return _launch(GATHER_TILES_RING, ring4, kf, level, y0, x0, None, R,
                   T)[0]


def extract_tiles(pyr3: torch.Tensor, level: torch.Tensor,
                  center_yx: torch.Tensor, R: int, T: int):
    """(tiles, y0, x0, lh, lw) of :func:`extract_tiles_plain`; on the card
    one launch of kernel 1 in centres mode."""
    if not _dispatch("extract_tiles", pyr3, 3, R, T):
        return extract_tiles_plain(pyr3, level, center_yx, R, T)
    out, org = _launch(GATHER_TILES, pyr3, None, level, None, None,
                       center_yx, R, T)
    return (out, *org.unbind())


def extract_tiles_ring(ring4: torch.Tensor, kf: torch.Tensor,
                       level: torch.Tensor, center_yx: torch.Tensor,
                       R: int, T: int):
    """(tiles, y0, x0, lh, lw) of :func:`extract_tiles_ring_plain`; on the
    card one launch of kernel 2 in centres mode."""
    if not _dispatch("extract_tiles_ring", ring4, 4, R, T):
        return extract_tiles_ring_plain(ring4, kf, level, center_yx, R, T)
    out, org = _launch(GATHER_TILES_RING, ring4, kf, level, None, None,
                       center_yx, R, T)
    return (out, *org.unbind())
