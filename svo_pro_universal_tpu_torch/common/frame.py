"""FrameState: fixed-capacity structure-of-arrays frame.

Counterpart of ``svo_pro_universal_tpu/common/frame.py`` (reference SoA
``Frame``, src/svo_common/include/svo/common/frame.h:30,62-73). Feature
arrays are ``[MAX_FTS]``-padded and empty slots carry
``FeatureType.INVALID``; the image pyramid is one padded ``[L, H, W]``
float32 tensor (ops.pyramid). Integer fields are int64 (torch's index type);
``convert`` maps them to and from the JAX package's int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svo_pro_universal_tpu_torch.common import types as ft
from svo_pro_universal_tpu_torch.common.types import FeatureType
from svo_pro_universal_tpu_torch.utils.transform import SE3


class FrameState(NamedTuple):
    frame_id: torch.Tensor      # i64 scalar
    timestamp: torch.Tensor     # f32 seconds relative to the session start
    T_cam_world: SE3            # camera-from-world (reference: T_f_w_)
    T_cam_body: SE3             # camera-from-IMU/body
    pyramid: torch.Tensor       # padded [L, H, W] float32
    px: torch.Tensor            # [N, 2] pixel coords at level 0
    f: torch.Tensor             # [N, 3] unit bearing vectors
    grad: torch.Tensor          # [N, 2] edgelet gradient direction (unit)
    score: torch.Tensor         # [N] detector score
    level: torch.Tensor         # [N] detection pyramid level
    ftype: torch.Tensor         # [N] FeatureType code
    track_id: torch.Tensor      # [N] (-1 = none)
    landmark_id: torch.Tensor   # [N] index into landmark pool (-1 = none)
    seed_ref_kf: torch.Tensor   # [N] keyframe ring slot owning the seed (-1)
    seed_ref_idx: torch.Tensor  # [N] feature index within that keyframe
    seed_state: torch.Tensor    # [N, 4] [inv_mu, sigma2, a, b]
    seed_mu_range: torch.Tensor  # f32 scalar: 1/depth_min at seed init
    is_keyframe: torch.Tensor   # bool scalar

    @property
    def max_fts(self) -> int:
        return self.px.shape[-2]

    @property
    def image(self) -> torch.Tensor:
        """Level 0 of the padded pyramid: the full-resolution image."""
        return self.pyramid[..., 0, :, :]

    @property
    def img_shape(self) -> tuple[int, int]:
        """(H, W) of the padded pyramid (its level 0)."""
        return tuple(self.pyramid.shape[-2:])

    def valid_mask(self) -> torch.Tensor:
        return ft.is_valid(self.ftype)

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid_mask().long())

    @property
    def T_world_cam(self) -> SE3:
        return self.T_cam_world.inverse()

    @property
    def T_body_world(self) -> SE3:
        """IMU/body-from-world (reference: T_imu_world)."""
        return self.T_cam_body.inverse().compose(self.T_cam_world)

    def pos(self) -> torch.Tensor:
        """Camera centre in world coordinates."""
        return self.T_world_cam.t

    def set_pose_cam_world(self, T_cam_world: SE3) -> "FrameState":
        return self._replace(T_cam_world=T_cam_world)

    def seed_pos_in_frame(self, idx) -> torch.Tensor:
        """Position (camera frame) of seed ``idx`` at its current mean
        depth (reference: frame.h getSeedPosInFrame)."""
        mu = torch.clamp(self.seed_state[idx, 0], min=1e-12)
        return self.f[idx] * (1.0 / mu)[..., None]


def frame_map(fn, *frames: FrameState) -> FrameState:
    """Apply ``fn`` leaf by leaf (SE3 leaves included) across frames."""
    out = []
    for name in FrameState._fields:
        vals = [getattr(fr, name) for fr in frames]
        if isinstance(vals[0], SE3):
            out.append(SE3(fn(*[v.q for v in vals]),
                           fn(*[v.t for v in vals])))
        else:
            out.append(fn(*vals))
    return FrameState(*out)


def make_empty_frame(pyramid: torch.Tensor, max_fts: int,
                     T_cam_world: SE3 | None = None,
                     T_cam_body: SE3 | None = None, frame_id: int = -1,
                     timestamp: float | torch.Tensor = 0.0) -> FrameState:
    """Allocate a frame with an empty (all-INVALID) feature store on the
    pyramid's device."""
    n = max_fts
    dev = pyramid.device
    f32 = torch.float32
    if T_cam_world is None:
        T_cam_world = SE3.identity(device=dev)
    if T_cam_body is None:
        T_cam_body = SE3.identity(device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.long, device=dev)

    return FrameState(
        frame_id=torch.full((), frame_id, dtype=torch.long, device=dev),
        timestamp=(timestamp.to(dev, f32) if isinstance(timestamp,
                                                         torch.Tensor)
                   else torch.full((), timestamp, dtype=f32, device=dev)),
        T_cam_world=T_cam_world,
        T_cam_body=T_cam_body,
        pyramid=pyramid,
        px=torch.zeros((n, 2), dtype=f32, device=dev),
        f=torch.zeros((n, 3), dtype=f32, device=dev),
        grad=torch.zeros((n, 2), dtype=f32, device=dev),
        score=torch.zeros((n,), dtype=f32, device=dev),
        level=full((n,), 0),
        ftype=full((n,), int(FeatureType.INVALID)),
        track_id=full((n,), -1),
        landmark_id=full((n,), -1),
        seed_ref_kf=full((n,), -1),
        seed_ref_idx=full((n,), -1),
        seed_state=torch.zeros((n, 4), dtype=f32, device=dev),
        seed_mu_range=torch.zeros((), dtype=f32, device=dev),
        is_keyframe=torch.zeros((), dtype=torch.bool, device=dev),
    )


def scene_depth_stats(frame: FrameState, points_w: torch.Tensor,
                      valid: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lower-median, min, max) scene depth of ``points_w`` seen from
    ``frame`` (reference: frame.cpp:388 getSceneDepth)."""
    z = frame.T_cam_world.apply(points_w)[..., 2]
    ok = valid & (z > 1e-6)
    big = 1e10
    z_for_min = torch.where(ok, z, big)
    z_for_max = torch.where(ok, z, -big)
    n = torch.sum(ok.long())
    z_sorted = torch.sort(z_for_min).values
    idx = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0,
                      z.shape[0] - 1)
    z_med = z_sorted.index_select(0, idx.reshape(1)).squeeze(0)
    return z_med, torch.min(z_for_min), torch.max(z_for_max)
