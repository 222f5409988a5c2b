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
