"""Image pyramid construction (padded stack layout).

Counterpart of ``svo_pro_universal_tpu/ops/pyramid.py`` (reference
half-sampling pyramid, src/vikit/vikit_common/src/vision.cpp:19-93). The
whole pyramid is ONE padded [L, H, W] float32 tensor; level l occupies the
top-left (H>>l, W>>l) corner, zeros elsewhere. Intensities stay on the
uint8 scale [0, 255].
"""

from __future__ import annotations

import torch


def half_sample(img: torch.Tensor) -> torch.Tensor:
    """2×2 block mean; an odd trailing row/col is dropped."""
    h, w = img.shape[-2], img.shape[-1]
    h2, w2 = h // 2, w // 2
    x = img[..., : h2 * 2, : w2 * 2]
    x = x.reshape(*img.shape[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def build_pyramid(img: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Padded [L, H, W] pyramid on the image's device; level 0 is the
    input image."""
    h, w = img.shape
    out = torch.zeros((n_levels, h, w), dtype=torch.float32,
                      device=img.device)
    lvl = img.to(torch.float32)
    for level in range(n_levels):
        out[level, : lvl.shape[0], : lvl.shape[1]] = lvl
        if level + 1 < n_levels:
            lvl = half_sample(lvl)
    return out


def level_view(pyr3: torch.Tensor, level: int) -> torch.Tensor:
    """View of one level's valid extent."""
    _, h, w = pyr3.shape
    return pyr3[level, : h >> level, : w >> level]


def image_to_float(img, device=None) -> torch.Tensor:
    """uint8/float image → float32 [0, 255] on ``device``. A numpy uint8
    image is uploaded as uint8 and converted on the device."""
    arr = torch.as_tensor(img)
    return arr.to(device).to(torch.float32)
