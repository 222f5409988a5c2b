"""Structure-only refinement: per-landmark 3-parameter GN, batched.

Counterpart of ``svo_pro_universal_tpu/ops/structure_optimizer.py``
(reference Point::optimize, src/svo_common/include/svo/common/point.h:155,
called from frame_handler_base.cpp:779-826): [P] points × [O] padded
observations, all refined at once for a fixed number of iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_pro_universal_tpu_torch.ops.tiles import solve_psd_small
from svo_pro_universal_tpu_torch.utils.transform import SE3, quat_to_matrix


class StructureOptResult(NamedTuple):
    xyz: torch.Tensor      # [P, 3] refined positions
    chi2: torch.Tensor     # [P] final mean squared unit-plane error
    updated: torch.Tensor  # [P] bool


def optimize_points(xyz_world: torch.Tensor, f_obs: torch.Tensor,
                    T_cam_world: SE3, obs_mask: torch.Tensor,
                    point_mask: torch.Tensor, n_iter: int = 5
                    ) -> StructureOptResult:
    """Batched Point::optimize; keeps the old position if chi2 increases."""
    uv_meas = f_obs[..., 0:2] / torch.where(
        torch.abs(f_obs[..., 2:3]) > 1e-8, f_obs[..., 2:3], 1e-8)
    R_cw = quat_to_matrix(T_cam_world.q)       # [P, O, 3, 3]
    eye3 = torch.eye(3, dtype=xyz_world.dtype, device=xyz_world.device)

    def residuals(p):
        p_cam = torch.einsum("poij,pj->poi", R_cw, p) + T_cam_world.t
        z = p_cam[..., 2]
        zi = 1.0 / torch.where(torch.abs(z) > 1e-8, z, 1e-8)
        uv = p_cam[..., 0:2] * zi[..., None]
        e = uv_meas - uv
        one = torch.ones_like(zi)
        zero = torch.zeros_like(zi)
        J_up = torch.stack([
            torch.stack([one, zero, -uv[..., 0]], -1),
            torch.stack([zero, one, -uv[..., 1]], -1)], dim=-2)
        J = -zi[..., None, None] * torch.einsum("poij,pojk->poik", J_up,
                                                R_cw)
        return e, J, obs_mask & (z > 1e-6)

    def chi2_of(p):
        e, _, ok = residuals(p)
        w = ok.to(p.dtype)
        n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        return torch.sum(torch.sum(e * e, -1) * w, dim=-1) / n

    p = xyz_world
    chi0 = chi2_of(p)
    best_chi2, best_p = chi0, p
    for _ in range(n_iter):
        e, J, ok = residuals(p)
        w = ok.to(p.dtype)
        H = torch.einsum("poij,poik,po->pjk", J, J, w)
        g = -torch.einsum("poij,poi,po->pj", J, e, w)
        # damping + step cap: a 2-view point has a flat valley along its ray
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        H = H + (1e-3 * diag + 1e-8)[..., None] * eye3
        dx = solve_psd_small(H, g)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        max_step = 0.2 * torch.clamp(torch.linalg.norm(p, dim=-1), min=1e-3)
        dx_norm = torch.linalg.norm(dx, dim=-1)
        dx = dx * torch.clamp(max_step / torch.clamp(dx_norm, min=1e-12),
                              max=1.0)[:, None]
        p = p + dx
        c_new = chi2_of(p)
        improved = c_new < best_chi2
        best_p = torch.where(improved[:, None], p, best_p)
        best_chi2 = torch.where(improved, c_new, best_chi2)
    updated = point_mask & (best_chi2 <= chi0)
    out = torch.where(updated[:, None], best_p, xyz_world)
    return StructureOptResult(out, best_chi2, updated)
