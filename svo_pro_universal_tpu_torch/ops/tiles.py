"""Tile-based image sampling: the path of every patch operation.

Counterpart of ``svo_pro_universal_tpu/ops/tiles.py``. Each feature cuts one
axis-aligned ``R×T`` tile around its position out of a padded [L, H, W]
pyramid (``extract_tiles``, CUDA kernel 1) or a [K, L, H, W] keyframe ring
(``extract_tiles_ring``, CUDA kernel 2); subpixel samples are then taken
inside the tiles as a batched bilinear form (``tile_bilinear``), and dense
patch scoring is a depthwise correlation (``zmssd_score_map``).

The tiles are the exact windows of the JAX package's CPU path (not the TPU's
(8, 128)-aligned supersets), so ``TileBatch`` origins and contents agree
with JAX-on-CPU bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from svo_pro_universal_tpu_torch.ops import cuda_tiles


class TileBatch(NamedTuple):
    """[N] axis-aligned tiles cut from per-feature pyramid levels."""
    tiles: torch.Tensor  # [N, R, T] float32
    y0: torch.Tensor     # [N] tile top in level coords
    x0: torch.Tensor     # [N] tile left in level coords
    lh: torch.Tensor     # [N] level height (valid image extent)
    lw: torch.Tensor     # [N] level width

    @property
    def shape_rt(self) -> tuple[int, int]:
        return self.tiles.shape[-2], self.tiles.shape[-1]


def extract_tiles(pyr3: torch.Tensor, level: torch.Tensor,
                  center_yx: torch.Tensor, R: int, T: int) -> TileBatch:
    """Cut [N, R, T] tiles around ``center_yx`` ([N, 2] = (y, x) in LEVEL
    coords) at per-feature ``level`` from a padded [L, H, W] pyramid (on the
    card one kernel launch, origins included)."""
    return TileBatch(*cuda_tiles.extract_tiles(pyr3, level, center_yx, R, T))


def extract_tiles_ring(ring4: torch.Tensor, kf: torch.Tensor,
                       level: torch.Tensor, center_yx: torch.Tensor,
                       R: int, T: int) -> TileBatch:
    """Same as :func:`extract_tiles` from a stacked keyframe-ring pyramid
    [K, L, H, W] with a per-feature keyframe index (clipped to [0, K-1])."""
    return TileBatch(*cuda_tiles.extract_tiles_ring(ring4, kf, level,
                                                    center_yx, R, T))


def crop_tiles(tb: TileBatch, y0: torch.Tensor, x0: torch.Tensor,
               R: int, T: int) -> TileBatch:
    """The exact (R, T) window at absolute per-feature (y0, x0) out of a
    larger TileBatch, as two one-hot selection products (JAX tiles.py:153;
    a window cell outside the tile is 0). The port's tiles are already
    exact, so no path of the port calls it."""
    Rp, Tp = tb.shape_rt
    if (Rp, Tp) == (R, T):
        return tb
    dev, dt = tb.tiles.device, tb.tiles.dtype
    dy = (y0 - tb.y0).long()[:, None, None]
    dx = (x0 - tb.x0).long()[:, None, None]
    Sy = (torch.arange(Rp, device=dev)[None, None, :]
          == dy + torch.arange(R, device=dev)[None, :, None]).to(dt)
    Sx = (torch.arange(Tp, device=dev)[None, None, :]
          == dx + torch.arange(T, device=dev)[None, :, None]).to(dt)
    out = torch.einsum("nrt,nct->nrc",
                       torch.einsum("nrh,nht->nrt", Sy, tb.tiles), Sx)
    return TileBatch(out, y0, x0, tb.lh, tb.lw)


def tile_bilinear(tb: TileBatch, ys: torch.Tensor, xs: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear-sample every tile at [N, S] LEVEL-coordinate positions.

    Returns (vals [N, S], inb [N, S]); ``inb`` requires the full 2×2 support
    inside both the tile and the level extent."""
    R, T = tb.shape_rt
    dt, dev = ys.dtype, ys.device
    ty = ys - tb.y0[:, None].to(dt)
    tx = xs - tb.x0[:, None].to(dt)
    ri = torch.arange(R, dtype=dt, device=dev)
    ci = torch.arange(T, dtype=dt, device=dev)
    Ry = torch.clamp(1.0 - torch.abs(ty[..., None] - ri), min=0.0)  # [N,S,R]
    Cx = torch.clamp(1.0 - torch.abs(tx[..., None] - ci), min=0.0)  # [N,S,T]
    tmp = torch.bmm(Ry, tb.tiles)
    vals = torch.sum(tmp * Cx, dim=-1)
    eps = 1e-6
    inb = ((ty >= 0) & (ty <= R - 1 + eps) & (tx >= 0) & (tx <= T - 1 + eps)
           & (ys >= 0) & (ys <= (tb.lh[:, None] - 1).to(dt) - eps)
           & (xs >= 0) & (xs <= (tb.lw[:, None] - 1).to(dt) - eps))
    return torch.where(inb, vals, 0.0), inb


def tile_bilinear_grad(tb: TileBatch, ys: torch.Tensor, xs: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """(val, d/dx, d/dy, inb) at [N, S] positions: central differences of
    the bilinear surface at ±0.5 px (cf. ``interp.bilinear_with_gradient``),
    zero where any of the five samples leaves its support."""
    val, inb = tile_bilinear(tb, ys, xs)
    vxp, ixp = tile_bilinear(tb, ys, xs + 0.5)
    vxm, ixm = tile_bilinear(tb, ys, xs - 0.5)
    vyp, iyp = tile_bilinear(tb, ys + 0.5, xs)
    vym, iym = tile_bilinear(tb, ys - 0.5, xs)
    allin = inb & ixp & ixm & iyp & iym
    return (torch.where(allin, val, 0.0), torch.where(allin, vxp - vxm, 0.0),
            torch.where(allin, vyp - vym, 0.0), allin)


def zmssd_score_map(tb: TileBatch, ref_patch: torch.Tensor, patch: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-mean SSD of ``ref_patch`` [N, patch²] against every integer patch
    position of each tile (reference patch_score.h ZMSSD::computeScore,
    evaluated densely). Returns (score [N, R-p+1, T-p+1], topleft_valid).

    The correlations are depthwise ``conv2d`` (groups=N). On the card that
    is cuDNN, whose default TF32 would flip argmin near-ties; the pipeline
    turns TF32 off for cuDNN and matmul when it is built.
    """
    n, area = ref_patch.shape
    R, T = tb.shape_rt
    p = patch
    refc = ref_patch - torch.mean(ref_patch, dim=-1, keepdim=True)
    refc2 = torch.sum(refc * refc, dim=-1)
    tiles = tb.tiles[None]
    ones = torch.ones((n, 1, p, p), dtype=tiles.dtype, device=tiles.device)
    corr = F.conv2d(tiles, refc.reshape(n, 1, p, p), groups=n)[0]
    s1 = F.conv2d(tiles, ones, groups=n)[0]
    s2 = F.conv2d(tiles * tiles, ones, groups=n)[0]
    score = s2 - s1 * s1 / float(area) - 2.0 * corr + refc2[:, None, None]
    Rp, Tp = R - p + 1, T - p + 1
    dev = tiles.device
    vy = tb.y0[:, None, None] + torch.arange(Rp, device=dev)[None, :, None]
    vx = tb.x0[:, None, None] + torch.arange(Tp, device=dev)[None, None, :]
    ok = ((vy + p <= tb.lh[:, None, None]) & (vx + p <= tb.lw[:, None, None]))
    return score, ok


def solve_psd_small(H: torch.Tensor, g: torch.Tensor, damping: float = 1e-8
                    ) -> torch.Tensor:
    """Batched (or single) [.., D, D] x = [.., D] solve by unrolled
    Cholesky, in the JAX package's operation order (D ≤ 8)."""
    D = H.shape[-1]
    if D > 8:
        return torch.linalg.solve(H, g[..., None])[..., 0]
    return cholesky_solve_small(cholesky_small(H, damping), g)


def cholesky_small(H: torch.Tensor, damping: float = 1e-8) -> list:
    """Lower Cholesky factor of ``H + damping·I`` as nested lists of
    [...] tensors (the factorization half of :func:`solve_psd_small`, so a
    solver whose H is fixed across iterations factors it once)."""
    D = H.shape[-1]
    H = H + damping * torch.eye(D, dtype=H.dtype, device=H.device)
    L = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    return L


def cholesky_solve_small(L: list, g: torch.Tensor) -> torch.Tensor:
    """x of L·Lᵀ·x = g for a factor from :func:`cholesky_small`."""
    D = len(L)
    y = [None] * D
    for i in range(D):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * D
    for i in reversed(range(D)):
        s = y[i]
        for k in range(i + 1, D):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
