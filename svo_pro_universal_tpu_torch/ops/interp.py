"""Bilinear interpolation (with the bilinear surface's gradient), per-level
samples of a flattened pyramid, patch offsets and patch extraction.

Counterpart of ``svo_pro_universal_tpu/ops/interp.py`` (reference: vikit
vision.h interpolateMat_8u). Coordinates are (u, v) = (x-col, y-row).
"""

from __future__ import annotations

import torch


def bilinear(img: torch.Tensor, uv: torch.Tensor, valid_pad: float = 0.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample img [h, w] at float coords uv [..., 2] → (value, in_bounds)."""
    h, w = img.shape
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    x0 = u0.long()
    y0 = v0.long()
    inb = (u >= 0) & (v >= 0) & (u <= w - 1 - 1e-6) & (v <= h - 1 - 1e-6)
    x0c = torch.clamp(x0, 0, w - 2)
    y0c = torch.clamp(y0, 0, h - 2)
    i00 = img[y0c, x0c]
    i01 = img[y0c, x0c + 1]
    i10 = img[y0c + 1, x0c]
    i11 = img[y0c + 1, x0c + 1]
    w00 = (1 - fu) * (1 - fv)
    w01 = fu * (1 - fv)
    w10 = (1 - fu) * fv
    w11 = fu * fv
    val = w00 * i00 + w01 * i01 + w10 * i10 + w11 * i11
    return torch.where(inb, val, valid_pad), inb


def bilinear_with_gradient(img: torch.Tensor, uv: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(value, d/du, d/dv) at uv [..., 2]: the central differences of the
    bilinear surface from the taps around the 2×2 support (zero outside a
    1-pixel border), in the JAX package's operation order."""
    h, w = img.shape
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    inb = (u >= 1) & (v >= 1) & (u <= w - 2) & (v <= h - 2)
    x0c = torch.clamp(u0.long(), 1, w - 3)
    y0c = torch.clamp(v0.long(), 1, h - 3)

    def tap(dy, dx):
        return img[y0c + dy, x0c + dx]

    i00, i01, i10, i11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    val = ((1 - fu) * (1 - fv) * i00 + fu * (1 - fv) * i01
           + (1 - fu) * fv * i10 + fu * fv * i11)
    im0, im1, ip0, ip1 = tap(0, -1), tap(1, -1), tap(0, 2), tap(1, 2)
    du = 0.5 * ((1 - fv) * ((1 - fu) * (i01 - im0) + fu * (ip0 - i00))
                + fv * ((1 - fu) * (i11 - im1) + fu * (ip1 - i10)))
    i_0m, i_1m, i_0p, i_1p = tap(-1, 0), tap(-1, 1), tap(2, 0), tap(2, 1)
    dv = 0.5 * ((1 - fu) * ((1 - fv) * (i10 - i_0m) + fv * (i_0p - i00))
                + fu * ((1 - fv) * (i11 - i_1m) + fv * (i_1p - i01)))
    return (torch.where(inb, val, 0.0), torch.where(inb, du, 0.0),
            torch.where(inb, dv, 0.0))


class FlatPyramid:
    """A pyramid (a list of [h, w] levels) flattened into one buffer, so
    that every element samples its own level in one gather."""

    def __init__(self, pyramid):
        dev = pyramid[0].device
        self.flat = torch.cat([lvl.reshape(-1) for lvl in pyramid])
        sizes = [lvl.shape for lvl in pyramid]
        offs = [0]
        for hh, ww in sizes[:-1]:
            offs.append(offs[-1] + hh * ww)
        self.widths = torch.tensor([ww for _, ww in sizes], device=dev)
        self.heights = torch.tensor([hh for hh, _ in sizes], device=dev)
        self.offsets = torch.tensor(offs, device=dev)


def pyr_bilinear(pyr: FlatPyramid, level: torch.Tensor, uv: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample at per-element ``level`` (level-local coords):
    (value, in_bounds)."""
    w = pyr.widths[level]
    h = pyr.heights[level]
    off = pyr.offsets[level]
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    x0 = torch.minimum(torch.clamp(u0.long(), min=0), w - 2)
    y0 = torch.minimum(torch.clamp(v0.long(), min=0), h - 2)
    inb = ((u >= 0) & (v >= 0) & (u <= (w - 1).to(u.dtype) - 1e-6)
           & (v <= (h - 1).to(v.dtype) - 1e-6))
    base = off + y0 * w + x0
    i00 = pyr.flat[base]
    i01 = pyr.flat[base + 1]
    i10 = pyr.flat[base + w]
    i11 = pyr.flat[base + w + 1]
    val = ((1 - fu) * (1 - fv) * i00 + fu * (1 - fv) * i01
           + (1 - fu) * fv * i10 + fu * fv * i11)
    return torch.where(inb, val, 0.0), inb


def pyr_nearest(pyr: FlatPyramid, level: torch.Tensor, xi: torch.Tensor,
                yi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer-coordinate sample at per-element ``level``."""
    w = pyr.widths[level]
    h = pyr.heights[level]
    off = pyr.offsets[level]
    inb = (xi >= 0) & (yi >= 0) & (xi < w) & (yi < h)
    idx = off + torch.minimum(torch.clamp(yi, min=0), h - 1) * w \
        + torch.minimum(torch.clamp(xi, min=0), w - 1)
    return torch.where(inb, pyr.flat[idx], 0.0), inb


def patch_offsets(patch_size: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """[P², 2] (du, dv) offsets centered on the patch, du, dv ∈ [-P/2, P/2)
    (the reference's top-left = px - P/2), du running fastest."""
    half = patch_size / 2.0
    r = torch.arange(patch_size, dtype=dtype, device=device) - half
    dv, du = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([du.reshape(-1), dv.reshape(-1)], dim=-1)


def extract_patches(img: torch.Tensor, centers: torch.Tensor,
                    patch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear P×P patches around ``centers`` [N, 2] (u, v): (patches
    [N, P²], all taps in bounds [N])."""
    offs = patch_offsets(patch_size, centers.dtype, centers.device)
    vals, inb = bilinear(img, centers[:, None, :] + offs[None, :, :])
    return vals, torch.all(inb, dim=-1)
