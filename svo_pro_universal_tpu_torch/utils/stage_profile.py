"""Per-stage device time of the frontend's tracking step.

Counterpart of ``svo_pro_universal_tpu/utils/stage_profile.py``. The JAX
package times each stage as the marginal cost of K iterations of one jitted
``fori_loop``; here each stage (the same ``StagePrograms._stage_*`` methods
the tracking step is made of) is launched K times and timed with CUDA events
around each launch, after one warm-up call, and the mean is reported. On
the CPU there is no device time to take: a caller passes its own
``timer`` (the tests stub it). Stage names follow the reference's tracefile schema
(``utils.perf.FRONTEND_TIMERS``).

``roofline_summary`` bounds the image-touching stages by the bytes of the
pyramid they must read once, at the memory rate of one NVIDIA H100 SXM
(80 GB HBM3, 3.35 TB/s, NVIDIA's data sheet, at its 700 W limit).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from svo_pro_universal_tpu_torch.frontend.frame_handler import copied_ring
from svo_pro_universal_tpu_torch.frontend.map import overlap_mask
from svo_pro_universal_tpu_torch.ops.pyramid import build_pyramid, level_view
from svo_pro_universal_tpu_torch.utils.transform import SE3, se3_exp

# NVIDIA H100 SXM (80 GB HBM3) data-sheet peaks at its 700 W power limit
H100_HBM_BYTES_PER_S = 3.35e12
ROOFLINE_CARD = "NVIDIA H100 SXM 80GB HBM3, data sheet, 700 W"

Timer = Callable[[Callable[[], object], int], float]


def cuda_event_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean ms of ``fn`` on the card: one warm-up call, then CUDA events
    around each of ``reps`` calls, one synchronization at the end."""
    fn()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def profile_frontend(handler, ring, pool, frame, depth_scalars,
                     reps: int = 16, timer: Optional[Timer] = None) -> dict:
    """{stage: ms per call} of the mono tracking step at its real shapes.

    ``handler`` is a ``FrameHandlerMono`` (or a subclass, or a device
    pipeline); ring / pool / frame a live (or representative) state on its
    device, which no stage changes (the keyframe step, which writes its
    ring in place, runs on a copy of the ring made inside the timed
    call)."""
    if timer is None:
        if frame.pyramid.device.type != "cuda":
            raise ValueError("profile_frontend times the card; pass timer= "
                             "for a state on another device")
        timer = cuda_event_ms
    pyr = frame.pyramid
    T_cur = frame.T_cam_world
    ov = overlap_mask(ring, T_cur, handler.cfg.reprojector.max_n_kfs)
    img = level_view(pyr, 0)
    T_prior = SE3.identity(device=pyr.device).compose(se3_exp(torch.full(
        (6,), 1e-3, device=pyr.device)))
    stages = {
        "pyramid_creation": lambda: build_pyramid(img, handler.n_levels),
        "sparse_img_align": lambda: handler._stage_align(
            ring, pool, frame, pyr, T_prior),
        "reproject": lambda: handler._stage_reproject(ring, pool, frame,
                                                      T_cur, ov),
        "pose_optimizer": lambda: handler._stage_pose(ring, pool, frame),
        "point_optimizer": lambda: handler._stage_structure(ring, pool,
                                                            frame),
        "depth_filter": lambda: handler._stage_seeds(ring, pyr, T_cur,
                                                     depth_scalars, ov),
        "keyframe_step": lambda: handler._keyframe_step(
            copied_ring(ring), pool, frame, depth_scalars),
        "frontend_time": lambda: handler._tracking_step(
            ring, pool, frame, frame, SE3.identity(device=pyr.device),
            depth_scalars),
    }
    return {name: timer(fn, reps) for name, fn in stages.items()}


def roofline_summary(stage_ms: dict, height: int, width: int,
                     n_levels: int) -> dict:
    """For the image-touching stages: the least time (ms) to move the
    pyramid bytes they need once at the H100's memory rate, and the stage's
    time over it (1.0 = at the roof)."""
    pyr_bytes = sum((height >> lv) * (width >> lv) * 4
                    for lv in range(n_levels))
    img_bytes = height * width * 4
    floors = {"pyramid_creation": img_bytes + pyr_bytes,
              "sparse_img_align": pyr_bytes}
    out = {}
    for name, nbytes in floors.items():
        if name in stage_ms:
            floor_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
            out[name] = dict(floor_ms=floor_ms, card=ROOFLINE_CARD,
                             x_from_roof=stage_ms[name] / max(floor_ms,
                                                              1e-12))
    return out
