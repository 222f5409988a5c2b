"""Repeated runs of ``chip_smoke.py``'s ``vio`` phase for one or more trees
of the PyTorch/CUDA port, on one NVIDIA card.

    python3 vio_ab.py --roots DIR [DIR ...] [--order 0,1,1,0,0,1] [--out DIR]

Each entry of ``--order`` runs, in a process of its own, the ``vio_phase``
of the ``chip_smoke.py`` found in ``--roots[i]`` (bench.py's
mono_vio_degraded_imagery configuration, 140 frames at 752×480), with that
tree's kernels built from its own sources. Its torch.profiler window is
skipped (it times nothing the A/B compares); everything else, gates
included, runs as in chip_smoke. The pose trace of each run's timed
pipeline is saved, and the summary says, for each tree, whether its runs
agree to the bit and their largest position difference. Prints each run's
``vio`` line, then one summary JSON line with the card's nvidia-smi name
and power limit. Imports nothing of JAX.

To compare a commit with its parent, unpack the parent into a git-ignored
directory (``git archive``) and alternate: ``--roots _archive/parent .
--order 0,1,1,0,0,1``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np


def run_one(root: Path, save: Path) -> None:
    """One ``vio_phase`` of ``root``'s chip_smoke in this process; the first
    drained pose trace (the timed run's) goes to ``save``."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        cs.fail("vio_ab needs a card")
    cs._cuda.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # root's own package: sys.path put it first
    from svo_pro_universal_tpu_torch.frontend.pipeline_vio import (
        DevicePipelineVIO)
    drains = []
    drain = DevicePipelineVIO.drain

    def keep(self):
        out = drain(self)
        drains.append(out[0])
        return out
    DevicePipelineVIO.drain = keep
    cs.profile_run = lambda run, run_sync, n: {"skipped": True}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cs.vio_phase(smi)
    np.save(save, drains[0])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+", type=Path)
    ap.add_argument("--order", default="0")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the runs' pose traces (default: a "
                    "temporary one)")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run is not None:
        run_one(args.run.resolve(), args.save)
        return
    if args.out is None:
        tmp = tempfile.TemporaryDirectory()
        args.out = Path(tmp.name)
    args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    for k, i in enumerate(int(x) for x in args.order.split(",")):
        root = args.roots[i].resolve()
        save = args.out / f"run{k}_root{i}.npy"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--run",
             str(root), "--save", str(save)], capture_output=True,
            text=True, timeout=1800)
        lines = [json.loads(x) for x in proc.stdout.splitlines()
                 if x.startswith("{")]
        vio = next((x for x in lines if x.get("phase") == "vio"), None)
        print(json.dumps({"run": k, "root": str(args.roots[i]),
                          "rc": proc.returncode, "vio": vio}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
        runs.append((i, save if proc.returncode == 0 else None, vio))
    summary = {}
    for i, root in enumerate(args.roots):
        mine = [(s, v) for j, s, v in runs if j == i]
        mats = [np.load(s) for s, _ in mine if s is not None]
        diff = max((float(np.abs(m[:, :3, 3] - mats[0][:, :3, 3]).max())
                    for m in mats[1:]), default=0.0)
        keys = ("fps_overall", "fps_steady", "ate_m", "ate_se3_m",
                "scale_error", "backend_lm_voided_share", "n_tracking")
        summary[str(root)] = {
            "runs": len(mine), "ok": len(mats),
            "bit_identical": len(mats) > 1 and all(
                np.array_equal(m, mats[0]) for m in mats[1:]),
            "max_pos_diff_m": diff,
            "backend_step_ms": [v["stage_ms_per_call"].get("step_program")
                                for _, v in mine if v],
            **{k: [v.get(k) for _, v in mine if v] for k in keys}}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"summary": summary, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
