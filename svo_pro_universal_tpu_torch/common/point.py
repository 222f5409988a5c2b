"""LandmarkPool: fixed-capacity global 3D point store.

Counterpart of ``svo_pro_universal_tpu/common/point.py`` (reference
``Point`` with its observation list, src/svo_common/include/svo/common/
point.h:66). Points live in a preallocated ``[MAX_POINTS]`` pool;
observations are (keyframe slot, feature index) pairs in a fixed
``[MAX_OBS]`` ring per point. Every write drops out-of-range rows, as the
JAX package's ``mode="drop"`` scatters do (utils.indexing).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_pro_universal_tpu_torch.utils.indexing import (
    add_drop, set_drop, set_drop_2d)


class LandmarkPool(NamedTuple):
    pos: torch.Tensor            # [P, 3] world position
    valid: torch.Tensor          # [P] bool
    ids: torch.Tensor            # [P] globally unique id (-1 free)
    obs_kf: torch.Tensor         # [P, MAX_OBS] keyframe ring slot (-1)
    obs_idx: torch.Tensor        # [P, MAX_OBS] feature index in that KF
    n_obs: torch.Tensor          # [P] observation count (saturating)
    n_failed_reproj: torch.Tensor     # [P]
    n_succeeded_reproj: torch.Tensor  # [P]
    last_structure_optim: torch.Tensor  # [P] ms stamp of last point GN
    fixed: torch.Tensor          # [P] bool: globally-optimized landmark
    cursor: torch.Tensor         # scalar: next allocation slot
    next_id: torch.Tensor        # scalar: next global id

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def max_obs(self) -> int:
        return self.obs_kf.shape[1]


def make_pool(max_points: int, max_obs: int, device=None) -> LandmarkPool:
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.long, device=device)

    return LandmarkPool(
        pos=torch.zeros((max_points, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((max_points,), dtype=torch.bool, device=device),
        ids=full((max_points,), -1),
        obs_kf=full((max_points, max_obs), -1),
        obs_idx=full((max_points, max_obs), -1),
        n_obs=full((max_points,), 0),
        n_failed_reproj=full((max_points,), 0),
        n_succeeded_reproj=full((max_points,), 0),
        last_structure_optim=full((max_points,), -1),
        fixed=torch.zeros((max_points,), dtype=torch.bool, device=device),
        cursor=full((), 0),
        next_id=full((), 0),
    )


def allocate(pool: LandmarkPool, positions: torch.Tensor,
             want: torch.Tensor) -> tuple[LandmarkPool, torch.Tensor]:
    """One pool slot per wanted row of ``positions`` [K, 3], taken in order
    from ``cursor`` and wrapping. Returns (pool, slot [K]; -1 where not
    allocated)."""
    order = torch.cumsum(want.long(), 0) - 1
    slot = (pool.cursor + order) % pool.capacity
    n_new = torch.sum(want.long())
    widx = torch.where(want, slot, pool.capacity)
    k = positions.shape[0]
    neg = torch.full((k, pool.max_obs), -1, dtype=torch.long,
                     device=positions.device)
    pool = pool._replace(
        pos=set_drop(pool.pos, widx, positions),
        valid=set_drop(pool.valid, widx, True),
        ids=set_drop(pool.ids, widx, pool.next_id + order),
        obs_kf=set_drop(pool.obs_kf, widx, neg),
        obs_idx=set_drop(pool.obs_idx, widx, neg),
        n_obs=set_drop(pool.n_obs, widx, 0),
        n_failed_reproj=set_drop(pool.n_failed_reproj, widx, 0),
        n_succeeded_reproj=set_drop(pool.n_succeeded_reproj, widx, 0),
        last_structure_optim=set_drop(pool.last_structure_optim, widx, -1),
        fixed=set_drop(pool.fixed, widx, False),
        cursor=(pool.cursor + n_new) % pool.capacity,
        next_id=pool.next_id + n_new,
    )
    return pool, torch.where(want, slot, -1)


def invalidate_keyframe_observations(pool: LandmarkPool, kf_slot,
                                     apply) -> LandmarkPool:
    """Drop every stored observation referencing ring slot ``kf_slot`` (run
    whenever a ring slot is evicted and reused; see the JAX package's
    docstring for why)."""
    stale = (pool.obs_kf == kf_slot) & apply
    return pool._replace(obs_kf=torch.where(stale, -1, pool.obs_kf))


def add_observations(pool: LandmarkPool, point_slot: torch.Tensor,
                     kf_slot: torch.Tensor, ft_idx: torch.Tensor,
                     mask: torch.Tensor, protect_first: int = 0
                     ) -> LandmarkPool:
    """Append (kf_slot, ft_idx) observations to points ``point_slot`` [K];
    the first ``protect_first`` observation slots are never overwritten."""
    n_obs_row = pool.n_obs[torch.where(mask, point_slot, 0)]
    if protect_first > 0:
        span = max(pool.max_obs - protect_first, 1)
        ring = torch.where(
            n_obs_row < pool.max_obs, n_obs_row % pool.max_obs,
            protect_first + (n_obs_row - protect_first) % span)
    else:
        ring = n_obs_row % pool.max_obs
    widx = torch.where(mask, point_slot, pool.capacity)
    kf_slot = torch.broadcast_to(torch.as_tensor(kf_slot), widx.shape)
    return pool._replace(
        obs_kf=set_drop_2d(pool.obs_kf, widx, ring, kf_slot),
        obs_idx=set_drop_2d(pool.obs_idx, widx, ring, ft_idx),
        n_obs=add_drop(pool.n_obs, widx, 1))
