"""N-camera array VO on one device: ``DevicePipelineArray``.

Counterpart of ``svo_pro_universal_tpu/frontend/pipeline_array.py``
(reference FrameHandlerArray, frame_handler_array.cpp:38-204): the N-camera
form of the stereo pipeline (frontend.pipeline_stereo, whose
``RigPipelineBase`` it shares). cam0 tracks; at every keyframe its fresh
seeds are triangulated against each secondary camera in turn, the first
camera that matches a feature giving its metric depth. The world keeps the
current and previous pyramids of the secondary cameras stacked as
``[Nc−1, L, H, W]`` (``pyrs_cur``, ``pyrs_prev``). Each frame makes ONE
upload of the whole bundle.

As in the JAX device pipeline, the secondary cameras' alignment inputs are
dropped unless ``joint_alignment=True`` (see frontend.pipeline_stereo).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.pipeline_stereo import (
    RigPipelineBase)
from svo_pro_universal_tpu_torch.utils.transform import SE3


class WorldStateArray(NamedTuple):
    """WorldState + the secondary cameras' stacked pyramids."""
    stage: int
    ring: object
    pool: object
    last_frame: object
    init_ref: object
    init_px: torch.Tensor
    T_rel_prev: SE3
    depth_state: torch.Tensor
    frames_since_kf: int
    prev_n_tracked: int
    reloc_trials: int
    rng: torch.Generator
    trace_q: torch.Tensor
    trace_t: torch.Tensor
    trace_meta: np.ndarray
    trace_ptr: int
    # --- array extras ---
    pyrs_cur: torch.Tensor       # [Nc-1, L, H, W] secondary pyramids (now)
    pyrs_prev: torch.Tensor      # the previous frame's


class DevicePipelineArray(RigPipelineBase):
    """N-camera VO with metric scale from the first frame, on the card
    unless ``device`` says otherwise."""

    def __init__(self, cfg: Config, cams: Sequence[proj.Camera],
                 T_body_cams: Sequence[SE3], seed: int = 0,
                 trace_capacity: int = 8192, joint_alignment: bool = False,
                 device=None):
        if len(cams) < 2 or len(cams) != len(T_body_cams):
            raise ValueError("an array needs ≥ 2 cameras, each with its "
                             "T_body_cam")
        self._n_cams = len(cams)
        super().__init__(cfg, cams, T_body_cams, seed, trace_capacity,
                         joint_alignment, device)

    @property
    def n_cams(self) -> int:
        return self._n_cams

    @property
    def cams(self) -> list:
        return [self.cam] + self._sec_cams

    def _make_world(self) -> WorldStateArray:
        base = super()._make_world()
        stk = torch.stack([base.last_frame.pyramid] * (self.n_cams - 1))
        return WorldStateArray(*base, pyrs_cur=stk, pyrs_prev=stk)

    def _secondary_pyramids(self, world):
        return list(world.pyrs_prev), list(world.pyrs_cur)

    def _shift_in(self, world, pyrs):
        return world._replace(pyrs_prev=world.pyrs_cur,
                              pyrs_cur=torch.stack(pyrs))

    def _triangulate_bundle(self, ring, pool, frame, pyrs):
        """Promote fresh seeds to metric landmarks against every secondary
        camera; the first camera that matches a feature wins. Returns
        (ring, pool, frame, n promoted)."""
        return self._triangulate(ring, pool, frame, list(pyrs))

    def _keyframe_landmarks(self, ring, pool, frame, world):
        return self._triangulate_bundle(ring, pool, frame, world.pyrs_cur)

    def add_image_bundle(self, imgs, timestamp: float) -> None:
        """Feed one image per camera (uint8 [H, W] each, cam0 first)."""
        if len(imgs) != self.n_cams:
            raise ValueError(f"{len(imgs)} images for {self.n_cams} cameras")
        self._add_images(imgs, timestamp)
