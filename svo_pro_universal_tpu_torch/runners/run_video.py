"""Mono VO over a video file or a webcam (counterpart of the reference's
video_mono.cpp / webcam.cpp, and of examples/run_video.py), through
OpenCV's capture, which ``opencv_frames`` alone imports.

    python -m svo_pro_universal_tpu_torch.runners.run_video \
        <video-file | camera-index> --calib rig.yaml [--config params.yaml] \
        [--out traj.txt] [--max-frames N] [--device cuda]
"""

from __future__ import annotations

import sys
import time
from typing import Iterator

import numpy as np

from svo_pro_universal_tpu_torch.cameras.rig import load_rig_yaml
from svo_pro_universal_tpu_torch.config import load_config
from svo_pro_universal_tpu_torch.evaluation import save_trajectory_tum
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono)
from svo_pro_universal_tpu_torch.runners import common


def opencv_frames(source: str) -> tuple[Iterator[np.ndarray], float]:
    """(uint8 gray frames, frames per second) of a video file or a webcam
    index, through cv2.VideoCapture."""
    import cv2
    cap = cv2.VideoCapture(int(source) if source.isdigit() else source)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {source}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0

    def frames():
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        finally:
            cap.release()

    return frames(), fps


def main(argv=None, on_handler=None, capture=opencv_frames
         ) -> common.RunResult:
    """``capture(source) -> (frames, fps)`` gives the frames; by default
    OpenCV's capture."""
    ap = common.parser(__doc__, None, "svo_torch_traj.txt", source="source",
                       source_help="video path or integer webcam index",
                       png=False, eval_=False)
    args = ap.parse_args(argv)

    rig = load_rig_yaml(args.calib)
    cfg = load_config(args.config)
    handler = FrameHandlerMono(cfg, rig.cameras[0],
                               T_cam_body=rig.T_cam_body(0),
                               device=args.device)
    if on_handler is not None:
        on_handler(handler)
    frames, fps = capture(args.source)
    stamps, poses, results = [], [], []
    progress = common.Progress(every=30)
    t_start = time.perf_counter()
    for k, gray in enumerate(frames):
        if args.max_frames and k >= args.max_frames:
            break
        ts = k / fps
        res = handler.add_image(gray, ts)
        stamps.append(ts)
        poses.append(res.T_world_cam)
        results.append(res)
        progress(len(results), res)
    loop_s = time.perf_counter() - t_start
    save_trajectory_tum(args.out, stamps, poses)
    print(f"saved {len(poses)} poses to {args.out}")
    return common.RunResult(stamps, poses, results, handler, "none", 0.0,
                            loop_s, args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
