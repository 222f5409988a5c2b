"""EuRoC stereo VO runner (counterpart of the reference's stereo example and
of examples/run_euroc_stereo.py): cam0 and cam1 pairs through
``FrameHandlerStereo``.

    python -m svo_pro_universal_tpu_torch.runners.run_euroc_stereo <dataset> \
        [--calib examples/param/euroc_stereo.yaml] [--config params.yaml] \
        [--out traj.txt] [--max-frames N] [--eval] [--device cuda] \
        [--png-decoder native|numpy]
"""

from __future__ import annotations

import sys
import time

from svo_pro_universal_tpu_torch.cameras.rig import load_rig_yaml
from svo_pro_universal_tpu_torch.config import load_config
from svo_pro_universal_tpu_torch.datasets.euroc import EurocDataset
from svo_pro_universal_tpu_torch.evaluation import save_trajectory_tum
from svo_pro_universal_tpu_torch.frontend.frame_handler import (
    FrameHandlerStereo)
from svo_pro_universal_tpu_torch.runners import common


def main(argv=None, on_handler=None) -> common.RunResult:
    ap = common.parser(__doc__, "euroc_stereo.yaml",
                       "svo_torch_traj_stereo.txt")
    args = ap.parse_args(argv)

    rig = load_rig_yaml(args.calib)
    cfg = load_config(args.config, overrides={"pipeline_is_stereo": True})
    handler = FrameHandlerStereo(cfg, rig.cameras[0], rig.cameras[1],
                                 rig.T_body_cam[0], rig.T_body_cam[1],
                                 device=args.device)
    if on_handler is not None:
        on_handler(handler)
    ds = EurocDataset(args.dataset, png_decoder=args.png_decoder)
    print(f"png decoder: {args.png_decoder}", flush=True)

    stamps, poses, results = [], [], []
    read_s = 0.0
    progress = common.Progress()
    t_start = time.perf_counter()
    for ev in ds.synced_stream(use_cam1=True):
        if ev[0] != "image":
            continue
        s0, s1 = ev[1], ev[2]
        r0 = time.perf_counter()
        img0, img1 = s0.load_u8(), s1.load_u8()
        read_s += time.perf_counter() - r0
        res = handler.add_image_pair(img0, img1, s0.timestamp)
        stamps.append(s0.timestamp)
        poses.append(res.T_world_cam)
        results.append(res)
        progress(len(results), res)
        if args.max_frames and len(results) >= args.max_frames:
            break
    loop_s = time.perf_counter() - t_start

    save_trajectory_tum(args.out, stamps, poses)
    print(f"saved {len(poses)} poses to {args.out}")
    out = common.RunResult(stamps, poses, results, handler,
                           args.png_decoder, read_s, loop_s, args.out)
    if args.eval:
        out.summary = common.ate_line(ds, stamps, poses, "se3")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
