"""Subpixel feature alignment: inverse-compositional LK, batched.

Counterpart of ``svo_pro_universal_tpu/ops/alignment.py`` (reference
feature_alignment namespace, src/svo_direct/src/feature_alignment.cpp —
align2D:204-331, align1D:31-202, alignPyr2D:761-900). Every entry point
takes [N]-batched features and runs a fixed number of Gauss-Newton
iterations with masked convergence, as the JAX package does.

The pyramidal tracker cuts one tile per feature per level (ops.tiles, the
``gather_tiles`` kernel on the card: 14×14 template tiles and 26×26 search
tiles at patch 8) and keeps all iterations inside it. ``align2d`` /
``align1d`` with an explicit image are the oracles of the tests.

State per feature is ``[u, v, mean_diff, alpha]``: position plus the affine
illumination offset/gain (residual ``cur - alpha·ref + mean_diff``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svo_pro_universal_tpu_torch.ops import tiles as tl
from svo_pro_universal_tpu_torch.ops.interp import bilinear, patch_offsets


class AlignResult(NamedTuple):
    px: torch.Tensor          # [N, 2] refined positions
    converged: torch.Tensor   # [N] bool
    mean_diff: torch.Tensor   # [N] illumination offset estimate
    alpha: torch.Tensor       # [N] illumination gain estimate


def patch_with_border_to_inner(border_patch: torch.Tensor, patch_size: int
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Split a [(P+2)²] patch-with-border into (inner [P²], dx [P²], dy
    [P²]): central differences with the 0.5 factor (reference
    align2D:230-240)."""
    p = patch_size
    b = border_patch.reshape(border_patch.shape[:-1] + (p + 2, p + 2))
    val = b[..., 1:-1, 1:-1]
    dx = 0.5 * (b[..., 1:-1, 2:] - b[..., 1:-1, :-2])
    dy = 0.5 * (b[..., 2:, 1:-1] - b[..., :-2, 1:-1])
    flat = border_patch.shape[:-1] + (p * p,)
    return val.reshape(flat), dx.reshape(flat), dy.reshape(flat)


def extract_patch_with_border(img: torch.Tensor, centers: torch.Tensor,
                              patch_size: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, (P+2)²] border patches of ``img`` around integer-floored
    ``centers``, and the in-bounds mask."""
    offs = patch_offsets(patch_size + 2, centers.dtype, centers.device)
    uv = torch.floor(centers)[:, None, :] + offs[None]
    vals, inb = bilinear(img, uv)
    return vals, torch.all(inb, dim=-1)


def extract_patch_with_border_tiles(
    pyr3: torch.Tensor, level: torch.Tensor, centers: torch.Tensor,
    patch_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tile-based [N, (P+2)²] border patches at per-feature ``level``
    (level coordinates): one (P+6)² tile per feature."""
    pwb = patch_size + 2
    offs = patch_offsets(pwb, centers.dtype, centers.device)
    uv = torch.floor(centers)[:, None, :] + offs[None]
    tile = pwb + 4
    tb = tl.extract_tiles(pyr3, level,
                          torch.stack([centers[:, 1], centers[:, 0]], -1),
                          tile, tile)
    vals, inb = tl.tile_bilinear(tb, uv[..., 1], uv[..., 0])
    return vals, torch.all(inb, dim=-1)


def _align_core(
    sample: Callable,          # (pos [N,S,2]) -> (vals [N,S], inb [N,S])
    ref_patch: torch.Tensor,   # [N, P²]
    jac: torch.Tensor,         # [N, P², 4] IC-LK Jacobian (e1, e2, offs, gain)
    e1: torch.Tensor,          # [N, 2] motion basis
    e2: torch.Tensor,          # [N, 2]
    px_init: torch.Tensor,     # [N, 2]
    n_iter: int,
    affine_est_offset: bool,
    affine_est_gain: bool,
    min_update_squared: float,
    valid: torch.Tensor,
) -> AlignResult:
    """``n_iter`` Gauss-Newton steps, every one applied only where the
    feature is in view and not yet converged (the JAX ``fori_loop``
    semantics). H is the same in every step, so it is factored once: the
    same operations as solving from H each step."""
    n, area = ref_patch.shape
    patch_size = int(round(area ** 0.5))
    dt, dev = px_init.dtype, px_init.device
    H = torch.einsum("npi,npj->nij", jac, jac)
    # constants built on the device (a host value copied to the card
    # would synchronize the stream)
    idx = torch.arange(4, device=dev)
    pinned = (((idx == 2) & (not affine_est_offset))
              | ((idx == 3) & (not affine_est_gain)))
    H = H + torch.diag(pinned.to(dt))
    # degenerate second basis (1D mode) → keep H invertible
    H = H + torch.diag_embed(torch.stack([
        torch.zeros_like(e2[:, 0]), (torch.sum(e2 * e2, -1) < 1e-8).to(dt),
        torch.zeros_like(e2[:, 0]), torch.zeros_like(e2[:, 0])], -1))
    chol = tl.cholesky_small(H, damping=1e-8)
    offs = patch_offsets(patch_size, dt, dev)
    estimated = (idx < 2) | ~pinned

    uv = px_init
    mean_diff = torch.zeros((n,), dtype=dt, device=dev)
    alpha = torch.ones((n,), dtype=dt, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(n_iter):
        pos = uv[:, None, :] + offs[None]
        cur, inb = sample(pos)
        ok = torch.all(inb, dim=-1) & valid
        res = cur - alpha[:, None] * ref_patch + mean_diff[:, None]
        jres = torch.where(estimated, -torch.einsum("np,npi->ni", res, jac),
                           0.0)
        upd = tl.cholesky_solve_small(chol, jres)
        apply = (ok & ~done)[:, None]
        duv = upd[:, 0:1] * e1 + upd[:, 1:2] * e2
        uv = uv + torch.where(apply, duv, 0.0)
        mean_diff = mean_diff + torch.where(apply[:, 0], upd[:, 2], 0.0)
        alpha = alpha + torch.where(apply[:, 0], upd[:, 3], 0.0)
        small = torch.sum(duv ** 2, dim=-1) < min_update_squared
        done = done | (small & ok) | ~ok

    pos = uv[:, None, :] + offs[None]
    _, inb = sample(pos)
    conv = (torch.all(inb, dim=-1) & valid
            & torch.all(torch.isfinite(uv), dim=-1))
    return AlignResult(uv, conv, mean_diff, alpha)


def _full_jac(ref_patch, ref_dx, ref_dy, e1, e2, affine_est_offset,
              affine_est_gain):
    j1 = e1[:, 0:1] * ref_dx + e1[:, 1:2] * ref_dy
    j2 = e2[:, 0:1] * ref_dx + e2[:, 1:2] * ref_dy
    zeros = torch.zeros_like(ref_patch)
    return torch.stack([
        j1, j2,
        torch.ones_like(ref_patch) if affine_est_offset else zeros,
        -ref_patch if affine_est_gain else zeros,
    ], dim=-1)


def _basis(n: int, px: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    eye = torch.eye(2, dtype=px.dtype, device=px.device)
    return eye[0].expand(n, 2), eye[1].expand(n, 2)


def align2d(cur_img: torch.Tensor, ref_patch: torch.Tensor,
            ref_dx: torch.Tensor, ref_dy: torch.Tensor,
            px_init: torch.Tensor, n_iter: int = 10,
            affine_est_offset: bool = True, affine_est_gain: bool = False,
            min_update_squared: float = 0.03 * 0.03,
            valid: torch.Tensor | None = None) -> AlignResult:
    """Batched align2D on one [h, w] image at the features' level
    (reference feature_alignment.cpp:204-331)."""
    n = ref_patch.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=px_init.device)
    e1, e2 = _basis(n, px_init)
    jac = _full_jac(ref_patch, ref_dx, ref_dy, e1, e2, affine_est_offset,
                    affine_est_gain)
    return _align_core(lambda pos: bilinear(cur_img, pos), ref_patch, jac,
                       e1, e2, px_init, n_iter, affine_est_offset,
                       affine_est_gain, min_update_squared, valid)


def align2d_tiles(pyr3: torch.Tensor, level: torch.Tensor,
                  ref_patch: torch.Tensor, ref_dx: torch.Tensor,
                  ref_dy: torch.Tensor, px_init: torch.Tensor,
                  n_iter: int = 10, tile: int = 24,
                  affine_est_offset: bool = True,
                  affine_est_gain: bool = False,
                  min_update_squared: float = 0.03 * 0.03,
                  valid: torch.Tensor | None = None) -> AlignResult:
    """align2d sampling inside one tile per feature, cut around
    ``px_init`` at per-feature ``level`` of a padded [L, H, W] pyramid."""
    n = ref_patch.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=px_init.device)
    e1, e2 = _basis(n, px_init)
    jac = _full_jac(ref_patch, ref_dx, ref_dy, e1, e2, affine_est_offset,
                    affine_est_gain)
    tb = tl.extract_tiles(pyr3, level,
                          torch.stack([px_init[:, 1], px_init[:, 0]], -1),
                          tile, tile)
    return _align_core(
        lambda pos: tl.tile_bilinear(tb, pos[..., 1], pos[..., 0]),
        ref_patch, jac, e1, e2, px_init, n_iter, affine_est_offset,
        affine_est_gain, min_update_squared, valid)


def align1d(cur_img: torch.Tensor, direction: torch.Tensor,
            ref_patch: torch.Tensor, ref_dx: torch.Tensor,
            ref_dy: torch.Tensor, px_init: torch.Tensor, n_iter: int = 10,
            affine_est_offset: bool = True, affine_est_gain: bool = False,
            min_update_squared: float = 0.03 * 0.03,
            valid: torch.Tensor | None = None) -> AlignResult:
    """Batched align1D: motion restricted to the unit ``direction`` [N, 2]
    (edgelets; reference feature_alignment.cpp:31-202)."""
    n = ref_patch.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=px_init.device)
    e1 = direction
    e2 = torch.zeros((n, 2), dtype=px_init.dtype, device=px_init.device)
    jac = _full_jac(ref_patch, ref_dx, ref_dy, e1, e2, affine_est_offset,
                    affine_est_gain)
    return _align_core(lambda pos: bilinear(cur_img, pos), ref_patch, jac,
                       e1, e2, px_init, n_iter, affine_est_offset,
                       affine_est_gain, min_update_squared, valid)


def align_pyr_2d(pyr_ref: torch.Tensor, pyr_cur: torch.Tensor,
                 px_ref: torch.Tensor, px_cur_init: torch.Tensor,
                 max_level: int = 4, min_level: int = 0,
                 patch_sizes: list | None = None, n_iter: int = 30,
                 min_update_squared: float = 1e-3,
                 valid: torch.Tensor | None = None) -> AlignResult:
    """Batched pyramidal KLT, translation only (reference alignPyr2DVec /
    alignPyr2D feature_alignment.cpp:718-900): coarse to fine, each level
    re-cuts the ref template from the ref pyramid and refines all N
    features at once; a level's result is kept where it converged."""
    n = px_ref.shape[0]
    dev = px_ref.device
    if patch_sizes is None:
        patch_sizes = [8] * (max_level + 1)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    uv = px_cur_init
    any_conv = torch.zeros((n,), dtype=torch.bool, device=dev)
    for level in range(max_level, min_level - 1, -1):
        scale = float(1 << level)
        p = patch_sizes[level]
        lvl = torch.full((n,), level, dtype=torch.long, device=dev)
        border, ok_ref = extract_patch_with_border_tiles(
            pyr_ref, lvl, px_ref / scale, p)
        patch, dx, dy = patch_with_border_to_inner(border, p)
        res = align2d_tiles(
            pyr_cur, lvl, patch, dx, dy, uv / scale, n_iter=n_iter,
            tile=p + 18, affine_est_offset=False, affine_est_gain=False,
            min_update_squared=min_update_squared / scale,
            valid=valid & ok_ref)
        uv = torch.where(res.converged[:, None], res.px * scale, uv)
        any_conv = any_conv | res.converged
    return AlignResult(uv, any_conv & valid,
                       torch.zeros((n,), device=dev),
                       torch.ones((n,), device=dev))
