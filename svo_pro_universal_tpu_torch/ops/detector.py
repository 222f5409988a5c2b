"""Feature detection: corner score maps (FAST-10, Shi-Tomasi, Sobel, Canny,
Huang-Mumford gradient, every pixel), Scharr-gradient edgelets, and the best
candidate per grid cell.

Counterpart of ``svo_pro_universal_tpu/ops/detector.py`` (reference
FastGradDetector / ShiTomasiDetector / ... src/svo_direct/src/
feature_detection.cpp, fillFeatures feature_detection_utils.cpp:118-142),
for every ``detector_type`` it accepts (``DETECTOR_TYPES``). The exact
FAST-10 score of every pixel is computed arithmetically (the largest
threshold for which a contiguous arc of 10 ring pixels is all brighter or
all darker than the center), and the best candidate per grid cell is a
dense block reduction whose ties go to the first pixel of the cell, as
``jnp.argmax`` decides them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from svo_pro_universal_tpu_torch.common.types import FeatureType
from svo_pro_universal_tpu_torch.ops.pyramid import level_view
from svo_pro_universal_tpu_torch.utils.indexing import topk_stable

# 16-pixel Bresenham circle of radius 3, in ring order (dx, dy).
FAST_RING = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
FAST_ARC = 10

# every detector_type of the JAX package (its detect_features)
DETECTOR_TYPES = ("fast", "grad", "fast_grad", "grid_grad", "shitomasi",
                  "shitomasi_grad", "sobel", "canny", "gradhm", "allpixels")


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], wrapping around (as jnp.roll)."""
    if dx == 0 and dy == 0:
        return img
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Exact FAST-10 corner score for every pixel; a 3px border scores 0."""
    ring = torch.stack([_shift2d(img, dx, dy) for dx, dy in FAST_RING])
    d = ring - img[None]

    def circ_min10(x):
        m2 = torch.minimum(x, torch.roll(x, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        return torch.minimum(m8, torch.roll(m2, -8, 0))

    bright = torch.amax(circ_min10(d), dim=0)
    dark = torch.amax(circ_min10(-d), dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    return torch.where(_inner(img, 3), score, 0.0)


def _inner(img: torch.Tensor, border: int) -> torch.Tensor:
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    return ((xx >= border) & (xx < w - border)
            & (yy >= border) & (yy < h - border))


def shitomasi_score_map(img: torch.Tensor, halfbox: int = 4
                        ) -> torch.Tensor:
    """Shi-Tomasi score (min eigenvalue of the structure tensor) per pixel:
    central differences and a (2·halfbox)² box sum by cumsum differences,
    in the JAX package's operation order (reference vk::shiTomasiScore)."""
    dx = 0.5 * (_shift2d(img, 1, 0) - _shift2d(img, -1, 0))
    dy = 0.5 * (_shift2d(img, 0, 1) - _shift2d(img, 0, -1))
    box = 2 * halfbox

    def boxsum(x):
        h, w = x.shape
        c = torch.cumsum(x, dim=0)
        c = torch.cat([c[box - 1:box], c[box:] - c[:-box]], dim=0)
        c = F.pad(c, (0, 0, 0, h - c.shape[0]))
        c2 = torch.cumsum(c, dim=1)
        c2 = torch.cat([c2[:, box - 1:box], c2[:, box:] - c2[:, :-box]],
                       dim=1)
        return F.pad(c2, (0, w - c2.shape[1]))

    dxx = boxsum(dx * dx)
    dyy = boxsum(dy * dy)
    dxy = boxsum(dx * dy)
    tr = dxx + dyy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * (dxx * dyy - dxy * dxy),
                                  min=0.0))
    score = 0.5 * (tr - disc) / (2.0 * box * box)
    # centre the box on its pixel; the border where it leaves the image is 0
    score = torch.roll(score, (halfbox, halfbox), (0, 1))
    return torch.where(_inner(img, halfbox + 1), score, 0.0)


def scharr_gradient(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scharr 3×3 derivative pair (dx, dy), as cv::Scharr with scale 1."""
    def s(dxo, dyo):
        return _shift2d(img, dxo, dyo)
    dx = (3.0 * (s(1, -1) - s(-1, -1)) + 10.0 * (s(1, 0) - s(-1, 0))
          + 3.0 * (s(1, 1) - s(-1, 1)))
    dy = (3.0 * (s(-1, 1) - s(-1, -1)) + 10.0 * (s(0, 1) - s(0, -1))
          + 3.0 * (s(1, 1) - s(1, -1)))
    return dx, dy


def sobel_gradient(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel 3×3 derivative pair (reference SobelDetector, cv::Sobel)."""
    def s(dxo, dyo):
        return _shift2d(img, dxo, dyo)
    dx = (s(1, -1) - s(-1, -1)) + 2.0 * (s(1, 0) - s(-1, 0)) \
        + (s(1, 1) - s(-1, 1))
    dy = (s(-1, 1) - s(-1, -1)) + 2.0 * (s(0, 1) - s(0, -1)) \
        + (s(1, 1) - s(1, -1))
    return dx, dy


def gradient_angle(dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """atan2(dy, dx) in float64, rounded to float32: torch's float32 atan2
    is an ulp off XLA's on many integer-image gradients (|dx| = |dy|)."""
    return torch.atan2(dy.double(), dx.double()).to(dx.dtype)


def canny_score_map(img: torch.Tensor, sigma_lo: float = 50.0,
                    sigma_hi: float = 150.0) -> torch.Tensor:
    """Canny-style edge score: Sobel magnitude where it is a maximum along
    its direction (4 bins), soft-gated between the two thresholds
    (reference CannyDetector, as the JAX package re-expresses it)."""
    dx, dy = sobel_gradient(img)
    mag = torch.sqrt(dx * dx + dy * dy)
    b = torch.round(gradient_angle(dy, dx) / (math.pi / 4.0)).to(
        torch.int32) % 4
    n0 = torch.stack([_shift2d(mag, 1, 0), _shift2d(mag, 1, 1),
                      _shift2d(mag, 0, 1), _shift2d(mag, -1, 1)])
    n1 = torch.stack([_shift2d(mag, -1, 0), _shift2d(mag, -1, -1),
                      _shift2d(mag, 0, -1), _shift2d(mag, 1, -1)])
    sel = b.long()[None]
    m0 = torch.gather(n0, 0, sel)[0]
    m1 = torch.gather(n1, 0, sel)[0]
    is_max = (mag >= m0) & (mag >= m1)
    gate = torch.clamp((mag - sigma_lo) / max(sigma_hi - sigma_lo, 1e-6),
                       0.0, 1.0)
    return torch.where(is_max, mag * gate, 0.0)


def grad_huang_mumford_score_map(img: torch.Tensor, alpha: float = 10.0
                                 ) -> torch.Tensor:
    """|∇I| with the Huang-Mumford saturation 255·(1 − exp(−α|∇I|/255))
    (reference GradientHuangMumfordDetector)."""
    dx = 0.5 * (_shift2d(img, 1, 0) - _shift2d(img, -1, 0)) / 255.0
    dy = 0.5 * (_shift2d(img, 0, 1) - _shift2d(img, 0, -1)) / 255.0
    mag = torch.sqrt(dx * dx + dy * dy)
    return 255.0 * (1.0 - torch.exp(-alpha * mag))


def score_maps(img: torch.Tensor, detector: str
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(score, gradient angle, candidate mask) of one pyramid level for a
    detector kind: fast | grad | shitomasi | sobel | canny | gradhm |
    allpixels."""
    if detector == "grad":
        dx, dy = scharr_gradient(img)
        score = torch.sqrt(dx * dx + dy * dy)
        return score, torch.atan2(dy, dx), score > 0.0
    if detector in ("sobel", "canny", "gradhm"):
        dx, dy = sobel_gradient(img)
        angle = gradient_angle(dy, dx)
        if detector == "sobel":
            score = torch.sqrt(dx * dx + dy * dy)
            return score, angle, nms_3x3(score)
        if detector == "canny":
            score = canny_score_map(img)
            return score, angle, score > 0.0
        score = grad_huang_mumford_score_map(img)
        return score, angle, nms_3x3(score)
    if detector == "allpixels":
        return (torch.ones_like(img), torch.zeros_like(img),
                torch.ones_like(img, dtype=torch.bool))
    if detector == "shitomasi":
        score = shitomasi_score_map(img)
    elif detector == "fast":
        score = fast_score_map(img)
    else:
        raise ValueError(f"unknown detector kind {detector!r}")
    return score, torch.zeros_like(score), nms_3x3(score)


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """3×3 non-max suppression mask (reference fast_nonmax_3x3)."""
    m = score
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if (dx, dy) != (0, 0):
                m = torch.maximum(m, _shift2d(score, dx, dy))
    return (score >= m) & (score > 0.0)


class CellCandidates(NamedTuple):
    """Per-cell winning candidate. All tensors [n_cells]."""
    px: torch.Tensor
    score: torch.Tensor
    level: torch.Tensor
    grad: torch.Tensor
    angle: torch.Tensor


def _per_cell_best(score_map, cand_mask, scale, cell_size, n_cols, n_cells):
    """Best (score, flat pixel index) per level-0 grid cell, by a dense
    block reduction of the zero-filled upsampled score map. Returns
    (cell_score [n_cells], cell_flat_idx [n_cells], -1 = none)."""
    h, w = score_map.shape
    dev = score_map.device
    n_rows = n_cells // n_cols
    s = torch.where(cand_mask, score_map, 0.0)
    if scale > 1:
        # zero-fill upsample: a candidate sits only at (y·scale, x·scale),
        # so it cannot straddle a cell boundary and win two cells
        s = s.repeat_interleave(scale, 0).repeat_interleave(scale, 1)
        keep = ((torch.arange(s.shape[0], device=dev) % scale == 0)[:, None]
                & (torch.arange(s.shape[1], device=dev) % scale == 0)[None])
        s = torch.where(keep, s, 0.0)
    hp, wp = n_rows * cell_size, n_cols * cell_size
    s = s[:hp, :wp]
    s = F.pad(s, (0, wp - s.shape[1], 0, hp - s.shape[0]))
    blocks = (s.reshape(n_rows, cell_size, n_cols, cell_size)
              .permute(0, 2, 1, 3).reshape(n_cells, cell_size * cell_size))
    seg = torch.amax(blocks, dim=1)
    arg = torch.argmax(blocks, dim=1)
    cells = torch.arange(n_cells, device=dev)
    cy0 = torch.div(cells, n_cols, rounding_mode="floor") * cell_size \
        + torch.div(arg, cell_size, rounding_mode="floor")
    cx0 = (cells % n_cols) * cell_size + arg % cell_size
    yl = torch.div(cy0, scale, rounding_mode="floor")
    xl = torch.div(cx0, scale, rounding_mode="floor")
    idx = torch.where(seg > 0.0, yl * w + xl, -1)
    return torch.clamp(seg, min=0.0), idx


def detect_cell_candidates(pyramid: torch.Tensor, cell_size: int,
                           n_cols: int, n_rows: int, min_level: int = 0,
                           max_level: int = 2, border: int = 8,
                           detector: str = "fast") -> CellCandidates:
    """One detection pass → best candidate per grid cell across levels.
    detector: a kind of :func:`score_maps`. 'grad' scans levels
    min_level+1.. and reports level-1, like the reference's
    edgeletDetector_V1."""
    dev = pyramid.device
    n_cells = n_rows * n_cols
    best_score = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    best_px = torch.zeros((n_cells, 2), dtype=torch.float32, device=dev)
    best_level = torch.zeros((n_cells,), dtype=torch.long, device=dev)
    best_angle = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    is_grad = detector == "grad"
    lo = (min_level + 1) if is_grad else min_level
    for level in range(lo, max_level + 1):
        img = level_view(pyramid, level)
        h, w = img.shape
        scale = 1 << level
        score_map, angle_map, nms = score_maps(img, detector)
        cand = nms & _inner(img, border)
        seg_score, seg_idx = _per_cell_best(
            score_map, cand, scale, cell_size, n_cols, n_cells)
        win_x = (seg_idx % w).to(torch.float32) * scale
        win_y = torch.div(seg_idx, w, rounding_mode="floor").to(
            torch.float32) * scale
        win_angle = angle_map.reshape(-1)[torch.clamp(seg_idx, 0, h * w - 1)]
        take = (seg_score > best_score) & (seg_idx >= 0)
        best_px = torch.where(take[:, None],
                              torch.stack([win_x, win_y], dim=-1), best_px)
        best_level = torch.where(take, level - 1 if is_grad else level,
                                 best_level)
        best_angle = torch.where(take, win_angle, best_angle)
        best_score = torch.where(take, seg_score, best_score)
    grad_dir = torch.stack([torch.cos(best_angle), torch.sin(best_angle)],
                           dim=-1)
    return CellCandidates(best_px, best_score, best_level, grad_dir,
                          best_angle)


class Detections(NamedTuple):
    """Fixed-capacity detection result ([K] slots, masked)."""
    px: torch.Tensor
    score: torch.Tensor
    level: torch.Tensor
    grad: torch.Tensor
    ftype: torch.Tensor
    valid: torch.Tensor


def detect_features(pyramid: torch.Tensor, occupied: torch.Tensor,
                    cell_size: int, n_cols: int, n_rows: int,
                    max_features: int, threshold_primary: float = 10.0,
                    threshold_secondary: float = 100.0,
                    threshold_shitomasi: float = 50.0,
                    min_level: int = 0, max_level: int = 2, border: int = 8,
                    detector_type: str = "fast_grad") -> Detections:
    """Corners (the kind ``detector_type`` names) and gradient edgelets per
    free cell, then the global top ``max_features`` (corners ranked above
    edgelets, then by score). A cell falls back to its edgelet only where
    no corner passed its threshold."""
    if detector_type not in DETECTOR_TYPES:
        raise ValueError(f"unknown detector_type {detector_type!r}; one of "
                         f"{DETECTOR_TYPES}")
    use_corners = detector_type not in ("grad", "grid_grad")
    use_grad = detector_type in ("grad", "fast_grad", "shitomasi_grad",
                                 "grid_grad")
    if "shitomasi" in detector_type:
        corner_kind, corner_thresh = "shitomasi", threshold_shitomasi
    elif detector_type in ("sobel", "canny", "gradhm"):
        corner_kind, corner_thresh = detector_type, threshold_primary
    elif detector_type == "allpixels":
        corner_kind, corner_thresh = "allpixels", 0.0
    else:
        corner_kind, corner_thresh = "fast", threshold_primary
    dev = pyramid.device
    n_cells = n_rows * n_cols
    zeros = CellCandidates(
        torch.zeros((n_cells, 2), device=dev),
        torch.zeros((n_cells,), device=dev),
        torch.zeros((n_cells,), dtype=torch.long, device=dev),
        torch.zeros((n_cells, 2), device=dev),
        torch.zeros((n_cells,), device=dev))
    corner = edge = zeros
    if use_corners:
        corner = detect_cell_candidates(pyramid, cell_size, n_cols, n_rows,
                                        min_level, max_level, border,
                                        corner_kind)
    if use_grad:
        edge = detect_cell_candidates(pyramid, cell_size, n_cols, n_rows,
                                      min_level, max_level, border, "grad")
    pick_corner = (corner.score > corner_thresh) & use_corners
    pick_edge = (~pick_corner) & (edge.score > threshold_secondary) \
        & use_grad
    valid = (pick_corner | pick_edge) & ~occupied

    px = torch.where(pick_edge[:, None], edge.px, corner.px)
    level = torch.where(pick_edge, edge.level, corner.level)
    grad = torch.where(pick_edge[:, None], edge.grad, corner.grad)
    raw_score = torch.where(pick_edge, edge.score, corner.score)
    rank_score = torch.where(
        valid, torch.where(pick_corner, raw_score + 1e6, raw_score),
        float("-inf"))
    ftype = torch.where(pick_edge, int(FeatureType.EDGELET_SEED),
                        int(FeatureType.CORNER_SEED))
    ftype = torch.where(valid, ftype, int(FeatureType.INVALID))

    k = min(max_features, n_cells)
    top_score, top_idx = topk_stable(rank_score, k)
    sel_valid = torch.isfinite(top_score)
    out_px = px[top_idx]
    out_level = level[top_idx]
    out_grad = grad[top_idx]
    out_ftype = torch.where(sel_valid, ftype[top_idx],
                            int(FeatureType.INVALID))
    out_raw = torch.where(sel_valid, raw_score[top_idx], 0.0)
    if k < max_features:
        pad = max_features - k

        def padded(x, v):
            return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), v,
                                             dtype=x.dtype, device=dev)])

        out_px = padded(out_px, 0.0)
        out_raw = padded(out_raw, 0.0)
        out_level = padded(out_level, 0)
        out_grad = padded(out_grad, 0.0)
        out_ftype = padded(out_ftype, int(FeatureType.INVALID))
        sel_valid = padded(sel_valid, False)
    return Detections(out_px, out_raw, out_level, out_grad, out_ftype,
                      sel_valid)
