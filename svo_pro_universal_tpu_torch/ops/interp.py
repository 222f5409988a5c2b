"""Bilinear interpolation, patch offsets and patch extraction.

Counterpart of the parts of ``svo_pro_universal_tpu/ops/interp.py`` that the
mono tracking step and loop closing use (reference: vikit vision.h
interpolateMat_8u).
Coordinates are (u, v) = (x-col, y-row).
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
