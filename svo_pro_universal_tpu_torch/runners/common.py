"""What the runners share: the command line, loading the rig and the
parameters, progress lines, and the trajectory's evaluation.

Every runner runs on the card unless ``--device`` names another device
(``frame_handler.resolve_device``), reads PNGs with the decoder
``--png-decoder`` names (printed once), and has a ``main(argv=None,
on_handler=None)`` that can be called in-process: ``on_handler`` receives
the handler once it is built, and ``main`` returns a ``RunResult``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np

from svo_pro_universal_tpu_torch import native_loader
from svo_pro_universal_tpu_torch.evaluation import associate, ate_rmse

PARAM_DIR = Path(__file__).resolve().parents[2] / "examples" / "param"


@dataclass
class RunResult:
    """What a runner produced: the frames' stamps and 4×4 T_world_cam
    poses, each frame's ``FrameResult`` (None for the device pipeline,
    whose stages are in ``meta``), the handler, the PNG decoder, the
    seconds spent reading images and in the whole loop, and the
    evaluation (ATE or the results summary) when asked for."""
    stamps: list
    poses: list
    results: list
    handler: Any
    png_decoder: str
    read_s: float
    loop_s: float
    out: str
    summary: dict = field(default_factory=dict)
    meta: Optional[np.ndarray] = None


def parser(doc: str, calib: Optional[str], out_name: str,
           source: str = "dataset", source_help: Optional[str] = None,
           png: bool = True, eval_: bool = True) -> argparse.ArgumentParser:
    """The runners' shared options: the positional ``source``, ``--calib``
    (``calib`` under examples/param by default; None: required),
    ``--config``, ``--out``, ``--max-frames``, ``--device``, and for a
    runner that reads PNGs ``--png-decoder`` (``png``), for one with ground
    truth ``--eval`` (``eval_``)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument(source, help=source_help)
    if calib is None:
        ap.add_argument("--calib", required=True)
    else:
        ap.add_argument("--calib", default=str(PARAM_DIR / calib))
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  out_name))
    ap.add_argument("--max-frames", type=int, default=0)
    if eval_:
        ap.add_argument("--eval", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline (default: the card)")
    if png:
        ap.add_argument("--png-decoder", default="native",
                        choices=native_loader.DECODERS,
                        help="native: native/png_decode.cc built with g++ "
                             "-lz; numpy: the plain decoder on the stdlib's "
                             "zlib")
    return ap


class Progress:
    """A line every ``every`` frames: stage, tracked count, frames/s."""

    def __init__(self, every: int = 50):
        self.every = every
        self.t0 = time.perf_counter()

    def __call__(self, n: int, res) -> None:
        if n % self.every == 0 and res is not None:
            fps = n / (time.perf_counter() - self.t0)
            print(f"frame {n} stage={res.stage.name} "
                  f"tracked={res.n_tracked} fps={fps:.1f}", flush=True)


def ate_line(ds, stamps, poses, align: str) -> dict:
    """ATE of ``poses`` against the dataset's ground truth (``--eval``)."""
    gt = ds.ground_truth()
    ts_gt = np.asarray([g.timestamp for g in gt])
    p_gt = np.stack([g.p for g in gt])
    ie, ig = associate(np.asarray(stamps), ts_gt)
    est = np.stack([np.asarray(poses[i])[:3, 3] for i in ie])
    rmse, a = ate_rmse(est, p_gt[ig], align=align)
    print(f"ATE RMSE ({align}-aligned): {rmse:.4f} m  scale={a.s:.3f}")
    return {f"ate_rmse_{align}_m": rmse, "scale": float(a.s)}
