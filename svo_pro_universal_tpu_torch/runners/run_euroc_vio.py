"""EuRoC mono VIO runner: IMU priors and the sliding-window backend
(counterpart of the reference's euroc_mono_imu.cpp with its ceres backend,
and of examples/run_euroc_vio.py).

    python -m svo_pro_universal_tpu_torch.runners.run_euroc_vio <dataset> \
        [--calib examples/param/euroc_mono.yaml] [--config params.yaml] \
        [--out traj.txt] [--max-frames N] [--eval] [--results-dir DIR] \
        [--device-pipeline] [--device cuda] [--png-decoder native|numpy]

``--device-pipeline`` runs ``DevicePipelineVIO`` (one read at the end)
instead of the host ``FrameHandlerVIO``; ``--results-dir`` writes the
rpg_trajectory_evaluation layout and its ATE summary
(``evaluation.write_rpg_results``).
"""

from __future__ import annotations

import sys
import time

from svo_pro_universal_tpu_torch.cameras.rig import load_rig_yaml
from svo_pro_universal_tpu_torch.config import load_config
from svo_pro_universal_tpu_torch.datasets.euroc import EurocDataset
from svo_pro_universal_tpu_torch.evaluation import (
    save_trajectory_tum, write_rpg_results)
from svo_pro_universal_tpu_torch.frontend.frame_handler import FrameHandlerVIO
from svo_pro_universal_tpu_torch.frontend.imu_handler import ImuHandler
from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
    DevicePipelineVIO)
from svo_pro_universal_tpu_torch.runners import common


def main(argv=None, on_handler=None, cfg=None) -> common.RunResult:
    """``cfg`` (a ``Config``) replaces ``--config`` for callers in-process
    whose settings have no key in the parameter files."""
    ap = common.parser(__doc__, "euroc_mono.yaml", "svo_torch_traj_vio.txt")
    ap.add_argument("--results-dir", default=None,
                    help="write the rpg_trajectory_evaluation results "
                         "layout (stamped_traj_estimate.txt, "
                         "stamped_groundtruth.txt, eval_cfg.yaml, "
                         "ate_summary.yaml) to this directory")
    ap.add_argument("--device-pipeline", action="store_true",
                    help="the on-device VIO pipeline (DevicePipelineVIO): "
                         "no read per frame, the trajectory read at the end")
    args = ap.parse_args(argv)

    rig = load_rig_yaml(args.calib)
    if cfg is None:
        cfg = load_config(args.config)
    imu = ImuHandler(rig.imu_params, rig.imu_init)
    kind = DevicePipelineVIO if args.device_pipeline else FrameHandlerVIO
    handler = kind(cfg, rig.cameras[0], T_cam_body=rig.T_cam_body(0),
                   imu_handler=imu, imu_params=rig.imu_params,
                   device=args.device)
    if on_handler is not None:
        on_handler(handler)
    ds = EurocDataset(args.dataset, png_decoder=args.png_decoder)
    print(f"png decoder: {args.png_decoder}", flush=True)

    stamps, poses, results = [], [], []
    read_s = 0.0
    progress = common.Progress()
    t_start = time.perf_counter()
    for ev in ds.synced_stream():
        if ev[0] == "imu":
            m = ev[1]
            imu.add_measurement(m.timestamp, m.gyro, m.acc)
            continue
        sample = ev[1]
        r0 = time.perf_counter()
        img = sample.load_u8()
        read_s += time.perf_counter() - r0
        res = handler.add_image(img, sample.timestamp)
        stamps.append(sample.timestamp)
        results.append(res)
        if res is not None:
            poses.append(res.T_world_cam)
        progress(len(stamps), res)
        if args.max_frames and len(stamps) >= args.max_frames:
            break
    meta = None
    if args.device_pipeline:
        mats, meta = handler.drain()
        poses = list(mats)
        results = [None] * len(stamps)
    loop_s = time.perf_counter() - t_start
    print(f"{len(stamps)} frames at {len(stamps) / loop_s:.1f} fps "
          f"({kind.__name__})")

    save_trajectory_tum(args.out, stamps, poses)
    print(f"saved {len(poses)} poses to {args.out}")
    out = common.RunResult(stamps, poses, results, handler,
                           args.png_decoder, read_s, loop_s, args.out,
                           meta=meta)
    if args.results_dir:
        out.summary = write_rpg_results(
            args.results_dir, stamps, poses, ds.ground_truth(),
            align_type="sim3",
            extra_files={"experiment.yaml": args.config,
                         "calib.yaml": args.calib})
        print(f"results written to {args.results_dir}")
        for k, v in out.summary.items():
            print(f"  {k}: {v}")
    elif args.eval:
        out.summary = common.ate_line(ds, stamps, poses, "sim3")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
