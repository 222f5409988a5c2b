"""Robust cost weight functions and scale estimators, batched.

Counterpart of ``svo_pro_universal_tpu/utils/robust.py`` (the reference's
vikit robust-cost toolbox, src/vikit/vikit_solver/include/vikit/solver/
robust_cost.h:11-85) as elementwise tensor ops with validity masks.
"""

from __future__ import annotations

import torch

TUKEY_B = 4.6851
HUBER_K = 1.345


def tukey_weight(x_norm: torch.Tensor, b: float = TUKEY_B) -> torch.Tensor:
    """Tukey biweight ω(x) = (1-(x/b)²)² for |x|<b else 0."""
    r = x_norm / b
    w = torch.square(1.0 - torch.square(r))
    return torch.where(torch.abs(r) < 1.0, w, 0.0)


def tukey_rho(x_norm: torch.Tensor, b: float = TUKEY_B) -> torch.Tensor:
    """Tukey loss ρ(x) = b²/6·(1−(1−(x/b)²)³) for |x|<b, else b²/6."""
    r2 = torch.square(x_norm / b)
    inner = 1.0 - torch.pow(1.0 - r2, 3)
    return (b * b / 6.0) * torch.where(r2 < 1.0, inner, 1.0)


def huber_weight(x_norm: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    ax = torch.abs(x_norm)
    return torch.where(ax <= k, 1.0, k / torch.clamp(ax, min=1e-12))


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """LOWER median of x[mask] over a padded 1-D array: sort with the masked
    entries pushed to the dtype's max and take index (n-1)//2. This is not
    ``torch.median``'s rule, and with no entry it returns the dtype's max."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, big)).values
    n = torch.sum(mask.long())
    idx = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0,
                      x.shape[0] - 1)
    return xs.index_select(0, idx.reshape(1)).squeeze(0)


def mad_scale(errors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median absolute deviation scale estimate: 1.48 * median(|e|)."""
    return 1.48 * masked_median(torch.abs(errors), mask)


def unit_scale(errors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The identity scale estimator: 1."""
    return torch.ones((), dtype=errors.dtype, device=errors.device)
