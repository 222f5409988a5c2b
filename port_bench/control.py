"""Readings that set the limits: the program's numbers beside its control's
and beside the faults the check has to catch, over many seeds in one
process. The benchmark's own runs never run this.

    python3 -m port_bench.control --workload euroc_mono_vio.laps \\
        --seeds 11,12,13 --seconds 20 [--fault tf32|frozen_step|...]

For each seed it runs the cell's set-up and window (``run.run_cell``) and
prints one JSON line: the numbers the program gives, and the numbers of
the control, the reference run in TF32 standing in the program's place
for the kernel and backend checks (``checks.judge(control=True)``).
``--fault tf32`` runs the program itself with TF32 switched on (its own
lower-precision path: the flags the port switches off at construction);
the other faults break the timed path underneath (``FAULTS``).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def _frozen_step(pipe) -> None:
    """A step that returns its state unchanged: the frame is taken and
    nothing of the world moves."""
    pipe.step = lambda world, img, ts, prior=None: (world, 0, False)
    return None


def _half_batch(pipe) -> None:
    """Sparse alignment over half the features: the second half's flags
    cleared, the cost a mean over the rest."""
    from svo_pro_universal_tpu_torch.ops import cuda_align
    fn = cuda_align.align_level

    def half(cams, state, opts, level, T_prior=None):
        cut = []
        for lc in cams:
            n = lc.ok.shape[0]
            ok = lc.ok & (torch.arange(n, device=lc.ok.device) < n // 2)
            cut.append(lc._replace(ok=ok))
        return fn(cut, state, opts, level, T_prior)
    cuda_align.align_level = half
    return lambda: setattr(cuda_align, "align_level", fn)


def _frozen_solve(pipe) -> None:
    """A window solve that returns its input window unchanged, with the
    cost of that window."""
    from svo_pro_universal_tpu_torch.backend import window_ba as wba
    fn = wba.optimize

    def frozen(w, T_cam_body, focal, opts=wba.BAOptions(), *a, **k):
        cost = wba.system_chi2(w, T_cam_body, focal, opts)
        return w, cost, torch.zeros((), dtype=torch.long,
                                    device=w.q.device)
    wba.optimize = frozen
    return lambda: setattr(wba, "optimize", fn)


def _frozen_align(pipe) -> None:
    """Each level of sparse alignment returns its input state (the kernel
    run with no iteration, so it reports that state's cost)."""
    from svo_pro_universal_tpu_torch.ops import cuda_align
    fn = cuda_align.align_level

    def frozen(cams, state, opts, level, T_prior=None):
        return fn(cams, state, opts._replace(max_iter=0), level, T_prior)
    cuda_align.align_level = frozen
    return lambda: setattr(cuda_align, "align_level", fn)


def _tiles_altered(pipe) -> None:
    """A gathered tile altered where it is produced (its first value +1)."""
    from svo_pro_universal_tpu_torch.ops import cuda_tiles
    fn = cuda_tiles.extract_tiles

    def altered(*args):
        out = fn(*args)
        tiles = out[0].clone()
        if tiles.numel():
            tiles.view(-1)[0] += 1.0
        return (tiles, *out[1:])
    cuda_tiles.extract_tiles = altered
    return lambda: setattr(cuda_tiles, "extract_tiles", fn)


def _pose_altered(pipe) -> None:
    """Each frame's pose altered where it is written: its position moved
    0.5 m along x, y or z in turn, the sign flipping every three frames."""
    fn = pipe._run_state_machine

    def altered(world, frame, ts, prior):
        world, n, kf = fn(world, frame, ts, prior)
        p = min(world.trace_ptr, pipe.trace_capacity) - 1
        world.trace_t[p, p % 3] += 0.5 if (p // 3) % 2 else -0.5
        return world, n, kf
    pipe._run_state_machine = altered
    return None


def _tf32_on(pipe) -> None:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    def undo():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return undo


# each breaks the timed path as the window opens and returns what undoes it
# (None where the broken pipeline is thrown away with the run)
FAULTS = {"frozen_step": _frozen_step, "frozen_solve": _frozen_solve,
          "frozen_align": _frozen_align, "half_batch": _half_batch,
          "tiles_altered": _tiles_altered, "pose_altered": _pose_altered,
          "tf32": _tf32_on}


def fault_hook(name: str | None, undo: list):
    """``run_cell``'s ``fault`` argument for a fault's name; what undoes
    it is appended to ``undo``."""
    if name is None:
        return None

    def hook(pipe, sampler):
        fn = FAULTS[name](pipe)
        if fn is not None:
            undo.append(fn)
    return hook


def main(argv=None) -> int:
    from port_bench import checks, run
    p = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run._set_cache_dirs()
    for seed in [int(s) for s in args.seeds.split(",")]:
        keep: dict = {}
        undo: list = []
        try:
            out = run.run_cell(args.workload, seed, args.seconds, False,
                               device=args.device,
                               fault=fault_hook(args.fault, undo), keep=keep)
        finally:
            for fn in undo:
                fn()
        ctrl = checks.judge(keep["state"], keep["config"], keep["traffic"],
                            control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "correct": out["correct"],
            "frames_per_s": out["metrics"]["frames_per_s"]["value"],
            "counts": keep["state"]["counts"],
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": ctrl,
            "control_correct": checks.verdict(ctrl, keep["limits"])}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
