"""Depth filter: recursive Bayesian inverse-depth estimation, batched.

Counterpart of ``svo_pro_universal_tpu/ops/depth_filter.py`` (reference
DepthFilter, src/svo_direct/src/depth_filter.cpp — updateSeed:367-499,
updateFilterVogiatzis:501-553, computeTau:580-597). Every seed is updated
against the current frame in one batch: visibility check → epipolar search
(ops.matcher) → Vogiatzis Beta×Gaussian update → convergence test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.common import seed as seed_mod
from svo_pro_universal_tpu_torch.common import types as ft
from svo_pro_universal_tpu_torch.ops import matcher as matcher_mod
from svo_pro_universal_tpu_torch.utils.transform import SE3


def compute_tau(T_ref_cur: SE3, f: torch.Tensor, z: torch.Tensor,
                px_error_angle: torch.Tensor) -> torch.Tensor:
    """Depth std from a one-pixel bearing-angle error (law of sines)."""
    t = torch.broadcast_to(T_ref_cur.t, f.shape)
    a = f * z[:, None] - t
    t_norm = torch.clamp(torch.linalg.norm(t, dim=-1), min=1e-9)
    a_norm = torch.clamp(torch.linalg.norm(a, dim=-1), min=1e-9)
    alpha = torch.acos(torch.clamp(torch.sum(f * t, -1) / t_norm, -1.0, 1.0))
    beta = torch.acos(torch.clamp(
        torch.sum(a * -t, -1) / (t_norm * a_norm), -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma_plus = torch.pi - alpha - beta_plus
    z_plus = t_norm * torch.sin(beta_plus) / torch.clamp(
        torch.sin(gamma_plus), min=1e-9)
    return z_plus - z


def update_vogiatzis(state: torch.Tensor, z: torch.Tensor,
                     tau2: torch.Tensor, mu_range: torch.Tensor,
                     apply: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Beta×Gaussian mixture update on inverse depth (state [N,4]); rows
    where ``apply`` is False pass through. Returns (new_state, diverged)."""
    mu, sigma2, a, b = state.unbind(-1)
    s2c = torch.clamp(sigma2, min=1e-12)
    t2c = torch.clamp(tau2, min=1e-12)
    norm_scale2 = torch.clamp(sigma2 + tau2, min=1e-12)
    s2 = 1.0 / (1.0 / s2c + 1.0 / t2c)
    m = s2 * (mu / s2c + z / t2c)
    uniform_x = 1.0 / mu_range
    norm_pdf = torch.exp(-0.5 * (z - mu) ** 2 / norm_scale2) / torch.sqrt(
        2.0 * torch.pi * norm_scale2)
    C1 = a / (a + b) * norm_pdf
    C2 = b / (a + b) * uniform_x
    Z = torch.clamp(C1 + C2, min=1e-30)
    C1, C2 = C1 / Z, C2 / Z
    f_ = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e_ = (C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0))
          + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0)))
    mu_new = C1 * m + C2 * mu
    sigma2_new = (C1 * (s2 + m * m) + C2 * (sigma2 + mu * mu)
                  - mu_new * mu_new)
    f_safe = torch.where(torch.abs(f_) > 1e-12, f_, 1e-12)
    denom = f_ - e_ / f_safe
    denom = torch.where(torch.abs(denom) > 1e-12, denom,
                        torch.where(denom < 0, -1e-12, 1e-12))
    a_new = (e_ - f_) / denom
    b_new = a_new * (1.0 - f_) / f_safe
    sigma2_new = torch.where(sigma2_new < 0.0, sigma2, sigma2_new)
    diverged = mu_new < 0.0
    mu_new = torch.where(diverged, 1.0, mu_new)
    ok = apply & torch.isfinite(mu_new) & torch.isfinite(sigma2_new)
    new_state = torch.stack([
        torch.where(ok, mu_new, mu), torch.where(ok, sigma2_new, sigma2),
        torch.where(ok, a_new, a), torch.where(ok, b_new, b)], dim=-1)
    return new_state, diverged & apply


class SeedUpdateResult(NamedTuple):
    seed_state: torch.Tensor   # [N, 4] updated
    ftype: torch.Tensor        # [N] updated feature types
    n_updated: torch.Tensor
    n_converged: torch.Tensor


def update_seeds(pyr_ref: torch.Tensor, pyr_cur: torch.Tensor,
                 cam_ref: proj.Camera, cam_cur: proj.Camera,
                 T_cur_ref: SE3, px_ref: torch.Tensor, f_ref: torch.Tensor,
                 grad_ref: torch.Tensor, level_ref: torch.Tensor,
                 ftype: torch.Tensor, seed_state: torch.Tensor,
                 seed_mu_range: torch.Tensor, max_search_level: int,
                 sigma2_convergence_threshold: float = 200.0,
                 matcher_opts: matcher_mod.MatcherOptions =
                 matcher_mod.MatcherOptions(),
                 ref_kf: torch.Tensor | None = None) -> SeedUpdateResult:
    """One batched DepthFilter::updateSeeds pass (Vogiatzis update with the
    convergence check, the configuration the tracking step runs)."""
    is_seed = ft.is_seed(ftype)
    active = is_seed & ~ft.is_converged_seed(ftype)

    # visibility pre-check at the current mean depth (reference :405-419)
    depth_est = 1.0 / torch.clamp(seed_state[:, 0], min=1e-12)
    px_vis, vis = proj.project(cam_cur, T_cur_ref.apply(
        f_ref * depth_est[:, None]))
    margin = 9.0
    vis = vis & (px_vis[:, 0] >= margin) & (px_vis[:, 1] >= margin) \
        & (px_vis[:, 0] < cam_cur.width - margin) \
        & (px_vis[:, 1] < cam_cur.height - margin)
    active = active & vis

    match = matcher_mod.find_epipolar_matches(
        pyr_ref, pyr_cur, cam_ref, cam_cur, T_cur_ref, px_ref, f_ref,
        grad_ref, ft.is_edgelet(ftype), level_ref, seed_state[:, 0],
        seed_mod.inv_min_depth(seed_state), seed_mod.inv_max_depth(seed_state),
        active, max_search_level, matcher_opts, ref_kf=ref_kf)

    # px_error_angle for one pixel of noise (reference :384-385)
    px_error_angle = torch.atan(1.0 / (2.0 * cam_cur.focal_length)) * 2.0
    tau = compute_tau(T_cur_ref.inverse(), f_ref, match.depth,
                      px_error_angle)
    z_inv = 1.0 / torch.clamp(match.depth, min=1e-12)
    tau2_inv = seed_mod.sigma2_from_depth_sigma(match.depth, tau)

    do_update = active & match.success
    new_state, diverged = update_vogiatzis(
        seed_state, z_inv, tau2_inv, seed_mu_range, do_update)
    # failures (not pre-filtered) accumulate outlier evidence (ref :446-453)
    failed = active & ~match.success & ~match.rejected
    b = new_state[:, 3:] + failed.to(new_state.dtype)[:, None]
    new_state = torch.cat([new_state[:, :3], b], dim=-1)
    converged = seed_mod.is_converged(
        new_state, seed_mu_range, sigma2_convergence_threshold) & do_update
    new_ftype = torch.where(converged, ft.seed_to_converged(ftype), ftype)
    new_ftype = torch.where(diverged, int(ft.FeatureType.OUTLIER), new_ftype)
    return SeedUpdateResult(new_state, new_ftype,
                            torch.sum(do_update.long()),
                            torch.sum(converged.long()))
