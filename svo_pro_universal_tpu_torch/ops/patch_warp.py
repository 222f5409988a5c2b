"""Affine patch warping between views, batched.

Counterpart of ``svo_pro_universal_tpu/ops/patch_warp.py`` (reference
src/svo_direct/src/patch_warp.cpp — getWarpMatrixAffine:20-61,
getBestSearchLevel:99-111, warpAffine:113-160).
"""

from __future__ import annotations

import math

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops.interp import bilinear, patch_offsets
from svo_pro_universal_tpu_torch.utils.transform import SE3

_HALF_PATCH_WARP = 5  # finite-difference step in px (reference kHalfPatchSize)


def affine_warp_matrix(cam_ref: proj.Camera, cam_cur: proj.Camera,
                       px_ref: torch.Tensor, f_ref: torch.Tensor,
                       depth_ref: torch.Tensor, T_cur_ref: SE3,
                       level_ref: torch.Tensor) -> torch.Tensor:
    """A_cur_ref [N, 2, 2]: first-order pixel motion of the ref patch in cur,
    by finite differences of the projection chain at ±kHalfPatchSize px."""
    xyz_ref = f_ref * depth_ref[:, None]
    scale = (1 << level_ref).to(px_ref.dtype)[:, None]
    zero = torch.zeros_like(px_ref[:, 0])
    du = torch.stack([zero + _HALF_PATCH_WARP, zero], -1)
    dv = torch.flip(du, [1])
    f_du = proj.backproject(cam_ref, px_ref + du * scale)
    f_dv = proj.backproject(cam_ref, px_ref + dv * scale)
    if cam_ref.projection == proj.ProjectionModel.PINHOLE:
        z = xyz_ref[:, 2:3]
        xyz_du = f_du / f_du[:, 2:3] * z
        xyz_dv = f_dv / f_dv[:, 2:3] * z
    else:
        xyz_du = f_du * depth_ref[:, None]
        xyz_dv = f_dv * depth_ref[:, None]
    px_cur, _ = proj.project(cam_cur, T_cur_ref.apply(xyz_ref))
    px_du_cur, _ = proj.project(cam_cur, T_cur_ref.apply(xyz_du))
    px_dv_cur, _ = proj.project(cam_cur, T_cur_ref.apply(xyz_dv))
    col0 = (px_du_cur - px_cur) / _HALF_PATCH_WARP
    col1 = (px_dv_cur - px_cur) / _HALF_PATCH_WARP
    return torch.stack([col0, col1], dim=-1)


def det2(A: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 2, 2] matrices (the JAX 2×2 closed form)."""
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inverse2(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(inverse, det) of [N, 2, 2] matrices; a near-zero det is replaced by
    1e-8 so the inverse stays finite."""
    det = det2(A)
    safe = torch.where(torch.abs(det) > 1e-8, det, 1e-8)
    inv = torch.stack([
        torch.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
        torch.stack([-A[:, 1, 0], A[:, 0, 0]], -1),
    ], dim=1) / safe[:, None, None]
    return inv, det


def best_search_level(A_cur_ref: torch.Tensor, max_level: int
                      ) -> torch.Tensor:
    """Pyramid level in cur where the warped patch has area ≲ 3 px²
    (reference patch_warp.cpp:99-111)."""
    D = torch.abs(det2(A_cur_ref))
    lvl = torch.ceil(torch.log(torch.clamp(D, min=1e-12) / 3.0)
                     / math.log(4.0))
    return torch.clamp(torch.where(D > 3.0, lvl, 0.0), 0,
                       max_level).long()


def warp_patches(A_cur_ref: torch.Tensor, img_ref: torch.Tensor,
                 px_ref_pyr: torch.Tensor, search_level: torch.Tensor,
                 patch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Ref patches sampled with the inverse affine warp (reference
    warpAffine :113-160). Returns (patches [N, P²], ok [N])."""
    inv, det = inverse2(A_cur_ref)
    A_ref_cur = inv * (1 << search_level).to(inv.dtype)[:, None, None]
    offs = patch_offsets(patch_size, px_ref_pyr.dtype, px_ref_pyr.device)
    uv = (torch.einsum("nij,pj->npi", A_ref_cur, offs)
          + px_ref_pyr[:, None, :])
    vals, inb = bilinear(img_ref, uv)
    return vals, torch.all(inb, dim=-1) & (torch.abs(det) > 1e-8)


def zmssd(ref: torch.Tensor, cur: torch.Tensor, dim: int = -1
          ) -> torch.Tensor:
    """Zero-mean sum of squared differences between patch vectors
    (reference patch_score.h:44-226 — lower is better)."""
    r = ref - torch.mean(ref, dim=dim, keepdim=True)
    c = cur - torch.mean(cur, dim=dim, keepdim=True)
    return torch.sum((r - c) ** 2, dim=dim)
