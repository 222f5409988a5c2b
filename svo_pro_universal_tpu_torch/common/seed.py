"""Depth-filter seed state: inverse-depth parametrization, batched.

Counterpart of ``svo_pro_universal_tpu/common/seed.py`` (reference:
src/svo_common/include/svo/common/seed.h:107-170). Per feature
``[inv_mu, sigma2, a, b]``: a Gaussian on inverse depth mixed with a Beta
inlier model (Vogiatzis).
"""

from __future__ import annotations

import torch

MU, SIGMA2, A, B = 0, 1, 2, 3


def make(depth_mean: torch.Tensor, depth_min: torch.Tensor) -> torch.Tensor:
    """Seed states from a mean scene depth and a min depth: mu = 1/mean,
    sigma2 = (1/min)²/36, a = b = 10."""
    mu = 1.0 / depth_mean
    mu_range = 1.0 / depth_min
    sigma2 = mu_range * mu_range / 36.0
    ones = torch.ones_like(mu)
    return torch.stack([mu, sigma2, 10.0 * ones, 10.0 * ones], dim=-1)


def depth(state: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(state[..., MU], min=1e-12)


def inv_depth(state: torch.Tensor) -> torch.Tensor:
    return state[..., MU]


def increase_outlier_probability(state: torch.Tensor) -> torch.Tensor:
    """One more outlier observation: b += 1."""
    return state + (torch.arange(state.shape[-1], device=state.device)
                    == B).to(state.dtype)


def inv_min_depth(state: torch.Tensor) -> torch.Tensor:
    return state[..., MU] + torch.sqrt(torch.clamp(state[..., SIGMA2],
                                                   min=0.0))


def inv_max_depth(state: torch.Tensor) -> torch.Tensor:
    return torch.clamp(
        state[..., MU] - torch.sqrt(torch.clamp(state[..., SIGMA2], min=0.0)),
        min=1e-8)


def is_converged(state: torch.Tensor, mu_range: torch.Tensor,
                 sigma2_convergence_threshold: float) -> torch.Tensor:
    thresh = mu_range / sigma2_convergence_threshold
    return state[..., SIGMA2] < thresh * thresh


def sigma2_from_depth_sigma(depth: torch.Tensor,
                            depth_sigma: torch.Tensor) -> torch.Tensor:
    sigma = 0.5 * (1.0 / torch.clamp(depth - depth_sigma, min=1e-12)
                   - 1.0 / (depth + depth_sigma))
    return sigma * sigma
