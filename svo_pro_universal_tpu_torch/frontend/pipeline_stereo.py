"""Stereo VO on one device: ``DevicePipelineStereo``.

Counterpart of ``svo_pro_universal_tpu/frontend/pipeline_stereo.py``
(reference FrameHandlerStereo, frame_handler_stereo.cpp:66-213, and
StereoTriangulation): the first frame with enough stereo-triangulated
landmarks goes straight to TRACKING with metric scale, cam0 tracks, and
every keyframe's fresh seeds are triangulated against cam1.

Each frame makes ONE upload, both images (uint8) in one pinned buffer; cam1's
pyramid is built on the device and kept, with the previous frame's, in the
world (``pyr1_cur``, ``pyr1_prev``). The motion prior is the
constant-velocity model ``T_rel_prev``: the stereo VO takes no IMU.

Joint alignment. The JAX device pipeline builds cam1's alignment input
(``_device_align_extra``) but inherits the mono ``_extra_align_inputs``,
which drops it: it aligns on cam0 alone. The port mirrors that by default.
``joint_alignment=True`` aligns on both cameras, with cam1's input built as
the host ``FrameHandlerStereo._extra_align_inputs`` builds it (JAX
frame_handler.py:1184-1206): cam0's feature points projected into cam1 at
the last frame's pose, against cam1's previous and current pyramids.

``RigPipelineBase`` holds what this pipeline shares with the N-camera
``DevicePipelineArray`` (frontend.pipeline_array): the one-frame bootstrap,
the keyframe triangulation, joint alignment and the stacked upload.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.common.frame import make_empty_frame
from svo_pro_universal_tpu_torch.common.point import LandmarkPool
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend import stereo_triangulation as st
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    Stage, resolve_device, secondary_align_inputs)
from svo_pro_universal_tpu_torch.frontend.map import insert_keyframe
from svo_pro_universal_tpu_torch.frontend.pipeline import (
    DevicePipelineMono, _zeroed)
from svo_pro_universal_tpu_torch.ops.pyramid import (
    build_pyramid, image_to_float)
from svo_pro_universal_tpu_torch.utils.transform import SE3


class WorldStateStereo(NamedTuple):
    """WorldState + cam1's pyramids of this frame and the previous one."""
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
    # --- stereo extras ---
    pyr1_cur: torch.Tensor       # [L, H, W] cam1's pyramid of this frame
    pyr1_prev: torch.Tensor      # cam1's pyramid of the previous frame


def se3_to(T: SE3, device) -> SE3:
    return SE3(T.q.to(device), T.t.to(device))


class RigPipelineBase(DevicePipelineMono):
    """The branches the stereo and array pipelines share: cam0 tracks, the
    secondary cameras triangulate the keyframes' seeds (one-frame metric
    bootstrap) and, with ``joint_alignment``, join the sparse alignment.
    A subclass names where its world keeps the secondary pyramids
    (``_secondary_pyramids``, ``_shift_in``) and which method triangulates
    a keyframe (``_keyframe_landmarks``)."""

    def __init__(self, cfg: Config, cams: Sequence[proj.Camera],
                 T_body_cams: Sequence[SE3], seed: int, trace_capacity: int,
                 joint_alignment: bool, device):
        if any(c.height != cams[0].height or c.width != cams[0].width
               for c in cams):
            raise ValueError("the stacked upload needs equal resolutions")
        # _make_world (run by the parent's constructor) may read these
        dev = resolve_device(device)
        self._sec_cams = [c.to(dev) for c in cams[1:]]
        T0 = T_body_cams[0]
        self._sec_T = [se3_to(T.inverse().compose(T0), dev)
                       for T in T_body_cams[1:]]          # T_ci_c0
        self.joint_alignment = joint_alignment
        super().__init__(cfg, cams[0], T_cam_body=T0.inverse(), seed=seed,
                         trace_capacity=trace_capacity, sync=False,
                         device=dev)
        self._st_opts = st.options_from_config(cfg)

    def _secondary_pyramids(self, world) -> tuple[list, list]:
        """(previous, current) pyramid of each secondary camera."""
        raise NotImplementedError

    def _shift_in(self, world, pyrs: list):
        """The world with ``pyrs`` as the secondary cameras' current
        pyramids and their current ones as the previous."""
        raise NotImplementedError

    def _keyframe_landmarks(self, ring, pool, frame, world):
        """(ring, pool, frame, n) of the keyframe ``frame``'s seeds
        triangulated against the world's current secondary pyramids."""
        raise NotImplementedError

    def _triangulate(self, ring, pool, frame, pyrs: list):
        return st.promote_seeds(ring, pool, frame, pyrs, self.cam,
                                self._sec_cams, self._sec_T, self._st_opts)

    # ------------------------------------------------------------------
    def _device_align_extra(self, world):
        prev, cur = self._secondary_pyramids(world)
        return dict(pyr_last=prev, pyr_cur=cur)

    def _extra_align_inputs(self, ring, pool, last_frame, extra):
        if not self.joint_alignment or extra is None:
            return []
        return secondary_align_inputs(
            ring, pool, last_frame, self.T_cam_body, self._sec_cams,
            self._sec_T, extra["pyr_last"], extra["pyr_cur"])

    # ------------------------------------------------------------------
    # stage branches
    # ------------------------------------------------------------------
    def _branch_first_frame(self, world, frame, ts, T_prior_rel):
        """Bootstrap from one frame (frame_handler_stereo.cpp
        processFirstFrame): detect seeds, write the frame to ring slot 0,
        triangulate; TRACKING with metric scale when enough landmarks
        stick, else the map is emptied and the next frame tries again."""
        cfg = self.cfg
        dev = self.device
        frame, n_new_t = self._detect_into_frame(frame, world.depth_state)
        frame = frame._replace(
            is_keyframe=torch.ones((), dtype=torch.bool, device=dev))
        world = world._replace(ring=insert_keyframe(
            world.ring, frame, torch.zeros((), dtype=torch.long, device=dev)))
        ring, pool, fr, n_lm_t = self._keyframe_landmarks(
            world.ring, world.pool, frame, world)
        n_new, n_lm = (int(v) for v in self.tracer.read(torch.stack(
            [n_new_t, n_lm_t])))                      # the frame's one read
        enough = (n_new >= cfg.init.init_min_features
                  and n_lm >= cfg.init.init_min_inliers)
        if enough:
            world = world._replace(
                stage=Stage.TRACKING.value, ring=ring, pool=pool,
                last_frame=fr, T_rel_prev=SE3.identity(device=dev),
                frames_since_kf=0)
        else:
            world = world._replace(
                ring=_zeroed(world.ring),
                pool=LandmarkPool(*[torch.zeros_like(x) for x in world.pool]),
                last_frame=frame)
        return world, n_lm, enough

    def _branch_init(self, world, frame, ts, T_prior_rel):
        # a calibrated rig never needs the monocular two-view bootstrap
        return self._branch_first_frame(world, frame, ts, T_prior_rel)

    def _branch_tracking(self, world, frame, ts, T_prior_rel):
        """Mono tracking; a new keyframe's seeds are then triangulated."""
        world, n_tracked, is_kf = super()._branch_tracking(
            world, frame, ts, T_prior_rel)
        if is_kf and world.stage == Stage.TRACKING.value:
            ring, pool, fr, _ = self._keyframe_landmarks(
                world.ring, world.pool, world.last_frame, world)
            world = world._replace(ring=ring, pool=pool, last_frame=fr)
        return world, n_tracked, is_kf

    # ------------------------------------------------------------------
    def _new_frame(self, world, imgs: torch.Tensor, ts: float):
        """The world with the secondary pyramids of ``imgs`` [Nc, H, W]
        (on the device) shifted in, and cam0's empty frame."""
        pyrs = [build_pyramid(image_to_float(im, self.device), self.n_levels)
                for im in imgs[1:]]
        pyr0 = build_pyramid(image_to_float(imgs[0], self.device),
                             self.n_levels)
        return self._shift_in(world, pyrs), make_empty_frame(
            pyr0, self.max_fts, T_cam_body=self.T_cam_body, timestamp=ts)

    def _add_images(self, imgs, timestamp: float) -> None:
        """One upload of the rig's images (uint8 [H, W] each), one pass
        through the state machine with the constant-velocity prior."""
        imgs_d, _ = self._upload(np.stack([np.asarray(im) for im in imgs]),
                                 np.zeros(0, np.float32))
        # session-relative, float32 as the JAX package carries it
        ts = float(np.float32(self._rel_ts(timestamp)))
        world, frame = self._new_frame(self.world, imgs_d, ts)
        self.world, _, _ = self._run_state_machine(world, frame, ts,
                                                   world.T_rel_prev)
        self._last_ts = timestamp


class DevicePipelineStereo(RigPipelineBase):
    """Stereo VO with metric scale from the first frame, on the card unless
    ``device`` says otherwise."""

    def __init__(self, cfg: Config, cam0: proj.Camera, cam1: proj.Camera,
                 T_body_cam0: SE3, T_body_cam1: SE3, seed: int = 0,
                 trace_capacity: int = 8192, joint_alignment: bool = False,
                 device=None):
        super().__init__(cfg, [cam0, cam1], [T_body_cam0, T_body_cam1],
                         seed, trace_capacity, joint_alignment, device)

    @property
    def cam1(self) -> proj.Camera:
        return self._sec_cams[0]

    def _make_world(self) -> WorldStateStereo:
        base = super()._make_world()
        zpyr = base.last_frame.pyramid
        return WorldStateStereo(*base, pyr1_cur=zpyr, pyr1_prev=zpyr)

    def _secondary_pyramids(self, world):
        return [world.pyr1_prev], [world.pyr1_cur]

    def _shift_in(self, world, pyrs):
        return world._replace(pyr1_prev=world.pyr1_cur, pyr1_cur=pyrs[0])

    def _stereo_triangulate(self, ring, pool, frame, pyr1):
        """Promote this keyframe's fresh seeds to metric landmarks through
        the calibrated pair. Returns (ring, pool, frame, n promoted)."""
        return self._triangulate(ring, pool, frame, [pyr1])

    def _keyframe_landmarks(self, ring, pool, frame, world):
        return self._stereo_triangulate(ring, pool, frame, world.pyr1_cur)

    def add_image_pair(self, img0, img1, timestamp: float) -> None:
        """Feed one stereo pair (uint8 [H, W] each)."""
        self.frame_count += 1
        self._add_images((img0, img1), timestamp)
