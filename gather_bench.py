"""Tile-gather timings at the shapes of the mono tracking step, of the
FivePoint bootstrap's KLT and of the stereo triangulation, for one tree of the PyTorch/CUDA port, on one
NVIDIA card.

    python3 gather_bench.py [--root DIR]

Imports ``svo_pro_universal_tpu_torch`` from DIR (default: the directory of
this file), so one run on the card can time two commits: unpack the other
into a directory and pass it. For each of the ten (kernel, N, tile) shapes
of the main path (``PATH_SHAPES`` of
``svo_pro_universal_tpu_torch/testing/gather_shapes.py``, which makes the
inputs and holds the timers) it measures, by CUDA events:

- ``call_ms``: the whole ``ops.tiles.extract_tiles`` / ``extract_tiles_ring``
  call (centres in, ``TileBatch`` out), as the path makes it;
- ``given_ms``: ``ops.cuda_tiles.gather_tiles`` / ``gather_tiles_ring`` with
  the origins given (the TPU kernels' own signature);
- from torch.profiler around one call, ``kernels_one_call``, and over 20
  calls: ``kernels_per_call`` (every CUDA kernel and copy the call
  launches), ``call_device_ms`` (their device time per call) and
  ``device_ms``, the device time per launch of the gather kernel itself
  (``given_device_ms`` for the origins-given call);
- for the ring: ``cold_call_ms`` and ``cold_given_ms``, one call after a
  256 MB write has flushed the 50 MB L2, as the path finds the 58 MB ring.

Times are medians of 15 samples (each the mean of 20 back-to-back calls
when warm). Prints one JSON line with the card's nvidia-smi name and power
limit. ``chip_smoke.py`` runs it as a subprocess, so that no profiler
session runs in the process that times the slice.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch


def profile_calls(fn, reps: int = 20, tries: int = 3) -> dict:
    """CUDA kernels (and copies) per call and the device ms per launch of
    the gather kernel (any kernel named gather_tiles*) from torch.profiler
    over ``reps`` calls, after a warm-up call. Every call launches exactly
    one gather kernel, so a trace that holds fewer lost events: it is taken
    again, up to ``tries`` times (``complete`` says whether one was whole)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        gather = [e for e in device if "gather_tiles" in e.key]
        count = sum(e.count for e in gather)
        if count == reps:
            break
    return {"kernels_per_call": sum(e.count for e in device) / reps,
            "complete": count == reps,
            "call_device_ms": sum(e.self_device_time_total for e in device)
            / 1e3 / reps,
            "device_ms": (sum(e.self_device_time_total for e in gather)
                          / 1e3 / count if count else None),
            "gather_kernels": sorted({re.search(r"gather_tiles\w*(<\w+>)?",
                                                e.key).group(0)
                                      for e in gather})}


def measure(gs, tl, ct, seed: int = 0) -> list[dict]:
    pyr, ring, shapes = gs.path_inputs(seed, torch.device("cuda"))
    rows = []
    for name, n, R, where, lvl, kf, cyx in shapes:
        call, given = gs.shape_calls(tl, ct, pyr, ring, name, R, lvl, kf,
                                     cyx)
        row = dict(name=name, n=n, tile=[R, R], where=where,
                   call_ms=gs.cuda_ms(call), given_ms=gs.cuda_ms(given),
                   kernels_one_call=profile_calls(call, reps=1)[
                       "kernels_per_call"],
                   **profile_calls(call),
                   given_device_ms=profile_calls(given)["device_ms"])
        if name == "gather_tiles_ring":
            row |= dict(cold_call_ms=gs.cold_ms(call),
                        cold_given_ms=gs.cold_ms(given))
        rows.append(row)
    return rows


def load_shapes():
    """``testing/gather_shapes.py`` of this file's tree, loaded by its
    path: the tree under test takes the package's name, and may predate
    the module."""
    path = (Path(__file__).resolve().parent / "svo_pro_universal_tpu_torch"
            / "testing" / "gather_shapes.py")
    spec = importlib.util.spec_from_file_location("gather_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="tree whose svo_pro_universal_tpu_torch to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gather_bench: torch.cuda.is_available() is False")
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from svo_pro_universal_tpu_torch.ops import _cuda
    from svo_pro_universal_tpu_torch.ops import cuda_tiles as ct
    from svo_pro_universal_tpu_torch.ops import tiles as tl
    if not str(Path(ct.__file__).resolve()).startswith(root):
        sys.exit(f"gather_bench: imported {ct.__file__}, not from {root}")
    _cuda.build_all()
    print(json.dumps({"gather_bench": root, "card": card_line(),
                      "shapes": measure(load_shapes(), tl, ct)}),
          flush=True)


if __name__ == "__main__":
    main()
