"""Feature taxonomy and shared predicates as integer-code tensors.

Counterpart of ``svo_pro_universal_tpu/common/types.py`` (reference:
src/svo_common/include/svo/common/types.h:60-140). Types live in integer
tensors so predicates are elementwise masks; INVALID marks empty slots.
"""

from __future__ import annotations

import enum

import torch


class FeatureType(enum.IntEnum):
    EDGELET_SEED = 0
    CORNER_SEED = 1
    MAP_POINT_SEED = 2
    EDGELET_SEED_CONVERGED = 3
    CORNER_SEED_CONVERGED = 4
    MAP_POINT_SEED_CONVERGED = 5
    EDGELET = 6
    CORNER = 7
    MAP_POINT = 8
    FIXED_LANDMARK = 9
    OUTLIER = 10
    INVALID = 11  # empty slot in padded arrays


F = FeatureType


def is_valid(t: torch.Tensor) -> torch.Tensor:
    return (t >= 0) & (t < F.INVALID) & (t != F.OUTLIER)


def is_seed(t: torch.Tensor) -> torch.Tensor:
    return (t >= 0) & (t < 6)


def is_corner_edgelet_seed(t: torch.Tensor) -> torch.Tensor:
    return ((t == F.EDGELET_SEED) | (t == F.CORNER_SEED)
            | (t == F.EDGELET_SEED_CONVERGED) | (t == F.CORNER_SEED_CONVERGED))


def is_converged_seed(t: torch.Tensor) -> torch.Tensor:
    return ((t == F.EDGELET_SEED_CONVERGED) | (t == F.CORNER_SEED_CONVERGED)
            | (t == F.MAP_POINT_SEED_CONVERGED))


def is_unconverged_seed(t: torch.Tensor) -> torch.Tensor:
    return ((t == F.EDGELET_SEED) | (t == F.CORNER_SEED)
            | (t == F.MAP_POINT_SEED))


def is_edgelet(t: torch.Tensor) -> torch.Tensor:
    return ((t == F.EDGELET) | (t == F.EDGELET_SEED)
            | (t == F.EDGELET_SEED_CONVERGED))


def seed_to_converged(t: torch.Tensor) -> torch.Tensor:
    """Seed type code → its converged variant (identity for non-seeds)."""
    return torch.where(is_unconverged_seed(t), t + 3, t)


def seed_to_landmark_type(t: torch.Tensor) -> torch.Tensor:
    """(converged) seed code → the corresponding landmark code."""
    base = torch.where(t >= 3, t - 3, t)
    mapped = torch.where(base == 0, int(F.EDGELET),
                         torch.where(base == 1, int(F.CORNER),
                                     int(F.MAP_POINT)))
    return torch.where(is_seed(t), mapped.to(t.dtype), t)
