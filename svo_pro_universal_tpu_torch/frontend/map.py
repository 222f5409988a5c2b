"""Keyframe ring: fixed-capacity stacked-FrameState map.

Counterpart of ``svo_pro_universal_tpu/frontend/map.py`` (reference Map,
src/svo/include/svo/map.h:19-115; furthest-keyframe eviction,
frame_handler_mono.cpp:235-250). Every FrameState leaf gains a leading
``[MAX_KFS]`` axis, plus a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_pro_universal_tpu_torch.common.frame import FrameState, frame_map
from svo_pro_universal_tpu_torch.utils.indexing import (
    set_drop, take0, topk_stable)
from svo_pro_universal_tpu_torch.utils.transform import SE3


class KeyframeRing(NamedTuple):
    frames: FrameState        # every leaf has a leading [K] axis
    valid: torch.Tensor       # [K] bool
    last_added: torch.Tensor  # slot of the most recent keyframe (-1)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


def make_ring(template: FrameState, max_kfs: int) -> KeyframeRing:
    frames = frame_map(
        lambda x: torch.zeros((max_kfs,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device), template)
    dev = template.px.device
    return KeyframeRing(frames,
                        torch.zeros((max_kfs,), dtype=torch.bool, device=dev),
                        torch.full((), -1, dtype=torch.long, device=dev))


def ring_frame(ring: KeyframeRing, slot: torch.Tensor) -> FrameState:
    """The frame stored in ``slot`` (a 0-dim tensor; no host read)."""
    return frame_map(lambda x: take0(x, slot), ring.frames)


def insert_keyframe(ring: KeyframeRing, frame: FrameState,
                    slot: torch.Tensor) -> KeyframeRing:
    """Write ``frame`` into ring slot ``slot`` (0-dim tensor), IN PLACE: the
    ring's buffers (8×5×480×752 f32 pyramids at EuRoC size) are updated,
    not copied. Callers hand over a ring no one else reads afterwards."""
    s = slot.reshape(1).long()

    def put(r, f):
        r.index_copy_(0, s, f.unsqueeze(0).to(r.dtype))
        return r

    frame_map(put, ring.frames, frame)
    ring.valid.index_fill_(0, s, True)
    return KeyframeRing(ring.frames, ring.valid, slot.reshape(()).long())


def _kf_distance(ring: KeyframeRing, cur_pos: torch.Tensor) -> torch.Tensor:
    kf_pos = ring.frames.T_cam_world.inverse().t
    return torch.linalg.norm(kf_pos - cur_pos[None], dim=-1)


def eviction_slot(ring: KeyframeRing, cur_pos_world: torch.Tensor
                  ) -> torch.Tensor:
    """First free slot, else the keyframe furthest from the camera."""
    free = ~ring.valid
    first_free = torch.argmax(free.to(torch.uint8))
    d = torch.where(ring.valid, _kf_distance(ring, cur_pos_world), -1.0)
    furthest = torch.argmax(d)
    return torch.where(torch.any(free), first_free, furthest)


def overlap_mask(ring: KeyframeRing, T_cur_world: SE3, n_closest: int
                 ) -> torch.Tensor:
    """[K] mask of the ``n_closest`` valid keyframes by camera distance
    (reference Map::getClosestNKeyframesWithOverlap map.h:92-104)."""
    d = torch.where(ring.valid,
                    _kf_distance(ring, T_cur_world.inverse().t),
                    float("inf"))
    k = ring.capacity
    _, idx = topk_stable(-d, min(n_closest, k))
    mask = set_drop(torch.zeros((k,), dtype=torch.bool, device=d.device),
                    idx, True)
    return mask & ring.valid


def closest_keyframe_slot(ring: KeyframeRing, T_cur_world: SE3
                          ) -> torch.Tensor:
    d = torch.where(ring.valid,
                    _kf_distance(ring, T_cur_world.inverse().t),
                    float("inf"))
    return torch.argmin(d)
