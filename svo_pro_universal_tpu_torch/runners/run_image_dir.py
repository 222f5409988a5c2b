"""Mono VO over a directory of images (counterpart of the reference's
image_mono.cpp + dataset/image.hpp, and of examples/run_image_dir.py).
PNG and binary PGM images, in file-name order, at ``--fps``.

    python -m svo_pro_universal_tpu_torch.runners.run_image_dir <dir> \
        --calib rig.yaml [--config params.yaml] [--fps 20] [--out traj.txt] \
        [--max-frames N] [--device cuda] [--png-decoder native|numpy]
"""

from __future__ import annotations

import glob
import os
import sys
import time

from svo_pro_universal_tpu_torch import native_loader
from svo_pro_universal_tpu_torch.cameras.rig import load_rig_yaml
from svo_pro_universal_tpu_torch.config import load_config
from svo_pro_universal_tpu_torch.datasets.euroc import read_image
from svo_pro_universal_tpu_torch.evaluation import save_trajectory_tum
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerMono)
from svo_pro_universal_tpu_torch.runners import common


def main(argv=None, on_handler=None) -> common.RunResult:
    ap = common.parser(__doc__, None, "svo_torch_traj.txt",
                       source="directory", eval_=False)
    ap.add_argument("--fps", type=float, default=20.0)
    args = ap.parse_args(argv)

    rig = load_rig_yaml(args.calib)
    cfg = load_config(args.config)
    handler = FrameHandlerMono(cfg, rig.cameras[0],
                               T_cam_body=rig.T_cam_body(0),
                               device=args.device)
    if on_handler is not None:
        on_handler(handler)
    decode = native_loader.decoder(args.png_decoder)
    print(f"png decoder: {args.png_decoder}", flush=True)
    paths = sorted(p for e in ("*.png", "*.pgm")
                   for p in glob.glob(os.path.join(args.directory, e)))
    if args.max_frames:
        paths = paths[: args.max_frames]
    print(f"{len(paths)} images")

    stamps, poses, results = [], [], []
    read_s = 0.0
    progress = common.Progress()
    t_start = time.perf_counter()
    for k, path in enumerate(paths):
        r0 = time.perf_counter()
        img = read_image(path, decode)
        read_s += time.perf_counter() - r0
        ts = k / args.fps
        res = handler.add_image(img, ts)
        stamps.append(ts)
        poses.append(res.T_world_cam)
        results.append(res)
        progress(len(results), res)
    loop_s = time.perf_counter() - t_start
    save_trajectory_tum(args.out, stamps, poses)
    print(f"saved {len(poses)} poses to {args.out}")
    return common.RunResult(stamps, poses, results, handler,
                            args.png_decoder, read_s, loop_s, args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
