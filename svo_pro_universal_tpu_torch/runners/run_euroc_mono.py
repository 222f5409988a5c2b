"""EuRoC mono VO runner (counterpart of the reference's euroc_mono.cpp and of
examples/run_euroc_mono.py).

    python -m svo_pro_universal_tpu_torch.runners.run_euroc_mono <dataset> \
        [--calib examples/param/euroc_mono.yaml] \
        [--config examples/param/pinhole.yaml] [--out traj.txt] \
        [--max-frames N] [--eval] [--trace-dir DIR] [--device cuda] \
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
    FrameHandlerMono)
from svo_pro_universal_tpu_torch.runners import common
from svo_pro_universal_tpu_torch.utils.perf import make_frontend_monitor

# the handler's stats that fill the reference's tracefile logs
TRACE_LOGS = (("img_align_n_tracked", "align_fts"),
              ("repr_n_matches", "reproj_matches"),
              ("sfba_error_before", "pose_err_before"),
              ("sfba_error_after", "pose_err_after"),
              ("sfba_n_edges_final", "n_inliers"))


def main(argv=None, on_handler=None) -> common.RunResult:
    ap = common.parser(__doc__, "euroc_mono.yaml", "svo_torch_traj.txt")
    ap.add_argument("--trace-dir", default=None,
                    help="write a per-frame tracefile CSV in the "
                         "reference's schema (its timing analyzers read "
                         "it), its timers from the handler's tracer")
    args = ap.parse_args(argv)

    rig = load_rig_yaml(args.calib)
    cfg = load_config(args.config)
    handler = FrameHandlerMono(cfg, rig.cameras[0],
                               T_cam_body=rig.T_cam_body(0),
                               device=args.device)
    if on_handler is not None:
        on_handler(handler)
    pm = make_frontend_monitor(args.trace_dir) if args.trace_dir else None
    if pm:
        handler.tracer.start()
    ds = EurocDataset(args.dataset, png_decoder=args.png_decoder)
    print(f"png decoder: {args.png_decoder}", flush=True)

    stamps, poses, results = [], [], []
    read_s = 0.0
    progress = common.Progress()
    t_start = time.perf_counter()
    for ev in ds.synced_stream():
        if ev[0] != "image":
            continue
        sample = ev[1]
        r0 = time.perf_counter()
        img = sample.load_u8()
        read_s += time.perf_counter() - r0
        res = handler.add_image(img, sample.timestamp)
        if pm:
            pm.timers_from(handler.tracer.take()[-1])
            pm.log("timestamp", sample.timestamp)
            for log, key in TRACE_LOGS:
                pm.log(log, handler.stats.get(key, 0))
            pm.write_to_file()
        stamps.append(sample.timestamp)
        poses.append(res.T_world_cam)
        results.append(res)
        progress(len(results), res)
        if args.max_frames and len(results) >= args.max_frames:
            break
    loop_s = time.perf_counter() - t_start
    if pm:
        pm.close()

    save_trajectory_tum(args.out, stamps, poses)
    print(f"saved {len(poses)} poses to {args.out}")
    out = common.RunResult(stamps, poses, results, handler,
                           args.png_decoder, read_s, loop_s, args.out)
    if args.eval:
        out.summary = common.ate_line(ds, stamps, poses, "sim3")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
