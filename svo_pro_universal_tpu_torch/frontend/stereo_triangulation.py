"""Stereo triangulation: epipolar-match cam0's features into a second camera
of the rig and triangulate with the calibrated extrinsic.

Counterpart of ``svo_pro_universal_tpu/frontend/stereo_triangulation.py``
(reference StereoTriangulation, stereo_triangulation.cpp:23-141; options
stereo_triangulation.h:12-20): one batched ``find_epipolar_matches`` call
over the configured inverse-depth range, so every depth is metric. Its scan
gathers cam0's reference tiles and cam1's scan tiles with the port's tile
kernels (``ops.cuda_tiles``) on the card.

``promote_seeds`` is the keyframe step of the device stereo and array
pipelines (JAX pipeline_stereo.py:108-131, pipeline_array.py:121-150): the
keyframe's fresh seeds matched against each secondary camera in turn, the
first camera that matches a feature giving its depth, and the matches
promoted to metric landmarks observed by the keyframe.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.common import types as ft
from svo_pro_universal_tpu_torch.common.frame import FrameState
from svo_pro_universal_tpu_torch.common.point import (
    LandmarkPool, add_observations, allocate)
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.map import (
    KeyframeRing, insert_keyframe)
from svo_pro_universal_tpu_torch.ops import matcher as matcher_mod
from svo_pro_universal_tpu_torch.utils.transform import SE3


class StereoTriangulationOptions(NamedTuple):
    mean_depth_inv: float = 1.0 / 3.0
    min_depth_inv: float = 1.0 / 0.25
    max_depth_inv: float = 1.0 / 50.0
    max_search_level: int = 2


class StereoMatches(NamedTuple):
    depth0: torch.Tensor     # [N] metric depth along cam0 bearings
    px1: torch.Tensor        # [N, 2] match position in cam1
    success: torch.Tensor    # [N]


def options_from_config(cfg: Config) -> StereoTriangulationOptions:
    """``cfg.stereo``'s depth range, searched up to the detector's top
    level (JAX pipeline_stereo.py:78-82)."""
    return StereoTriangulationOptions(
        mean_depth_inv=cfg.stereo.mean_depth_inv,
        min_depth_inv=cfg.stereo.min_depth_inv,
        max_depth_inv=cfg.stereo.max_depth_inv,
        max_search_level=cfg.detector.max_level)


def triangulate_pair(
    pyr0: torch.Tensor, pyr1: torch.Tensor, cam0: proj.Camera,
    cam1: proj.Camera, T_c1_c0: SE3, px0: torch.Tensor, f0: torch.Tensor,
    grad0: torch.Tensor, level0: torch.Tensor, ftype0: torch.Tensor,
    valid: torch.Tensor,
    opts: StereoTriangulationOptions = StereoTriangulationOptions(),
) -> StereoMatches:
    """Batched left→right epipolar matching and metric triangulation
    (stereo_triangulation.cpp:64-130): a match counts when its depth lies
    in (0.5 / min_depth_inv, 2 / max_depth_inv)."""
    n = px0.shape[0]

    def full(v: float) -> torch.Tensor:
        return torch.full((n,), v, dtype=torch.float32, device=px0.device)

    match = matcher_mod.find_epipolar_matches(
        pyr0, pyr1, cam0, cam1, T_c1_c0, px0, f0, grad0,
        ft.is_edgelet(ftype0), level0,
        d_estimate_inv=full(opts.mean_depth_inv),
        d_min_inv=full(opts.min_depth_inv),
        d_max_inv=full(opts.max_depth_inv),
        valid=valid, max_search_level=opts.max_search_level)
    ok = (match.success & (match.depth > 1.0 / opts.min_depth_inv * 0.5)
          & (match.depth < 1.0 / opts.max_depth_inv * 2.0))
    return StereoMatches(match.depth, match.px_cur, ok)


def promote_seeds(ring: KeyframeRing, pool: LandmarkPool, frame: FrameState,
                  pyrs: Sequence[torch.Tensor], cam0: proj.Camera,
                  cams: Sequence[proj.Camera], T_c_c0: Sequence[SE3],
                  opts: StereoTriangulationOptions
                  ) -> tuple[KeyframeRing, LandmarkPool, FrameState,
                             torch.Tensor]:
    """Promote the keyframe ``frame``'s own unconverged seeds to metric
    landmarks: each is matched against the secondary cameras ``cams`` (their
    pyramids ``pyrs``, extrinsics ``T_c_c0``) in order, a camera searching
    only the seeds no earlier camera matched. The new landmarks are observed
    by ring slot ``ring.last_added``, where the updated frame is written
    (in place). Returns (ring, pool, frame, number promoted)."""
    n = frame.max_fts
    dev = frame.px.device
    own_seed = (frame.valid_mask() & ft.is_unconverged_seed(frame.ftype)
                & (frame.seed_ref_kf < 0) & (frame.landmark_id < 0))
    depth = torch.zeros((n,), dtype=torch.float32, device=dev)
    got = torch.zeros((n,), dtype=torch.bool, device=dev)
    for pyr, cam, T in zip(pyrs, cams, T_c_c0):
        m = triangulate_pair(frame.pyramid, pyr, cam0, cam, T, frame.px,
                             frame.f, frame.grad, frame.level, frame.ftype,
                             own_seed & ~got, opts)
        take = m.success & own_seed & ~got
        depth = torch.where(take, m.depth0, depth)
        got = got | take
    xyz_w = frame.T_world_cam.apply(frame.f * depth[:, None])
    pool, slots = allocate(pool, xyz_w, got)
    slot_kf = ring.last_added
    pool = add_observations(pool, slots, slot_kf.expand(n),
                            torch.arange(n, device=dev), got)
    frame = frame._replace(
        landmark_id=torch.where(got, slots, frame.landmark_id),
        ftype=torch.where(got, ft.seed_to_landmark_type(
            ft.seed_to_converged(frame.ftype)), frame.ftype))
    ring = insert_keyframe(ring, frame, slot_kf)
    return ring, pool, frame, torch.sum(got.long())
