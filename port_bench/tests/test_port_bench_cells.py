"""Each cell run on the CPU, past the harness's look for a card: set-up,
window, capture and check, at the cell's image size and a short window on
laps of half the length (the CPU takes about a second a frame). Then the
same run with the timed path broken underneath, once for each fault the
cells can have, and the check must come out false. Slow: about two
minutes a run."""

import math

import pytest

from port_bench import checks, control, run

SMALL = {"trajectory": {"kind": "loop", "period_frames": 32,
                        "radius_m": 0.35},
         "warmup": {"min_laps": 2, "max_laps": 4},
         "samples": {"extract_tiles": [3, 27], "extract_tiles_ring": [2, 6],
                     "align_level": [4, 9], "optimize": [1, 1]},
         "trace_frames": 2}
CELLS = ["euroc_mono_vio.laps"]


def small_run(workload, seed, trace=False, fault=None, seconds=8.0):
    keep, undo = {}, []
    try:
        out = run.run_cell(workload, seed, seconds, trace, device="cpu",
                           overrides=SMALL,
                           fault=control.fault_hook(fault, undo), keep=keep)
    finally:
        for fn in undo:
            fn()
    return out, keep


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(workload):
    out, keep = small_run(workload, 2 ** 31 + 17, trace=True)
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"] and all(math.isfinite(c["value"])
                                 for c in out["checks"].values())
    assert out["correct"], out["checks"]
    # the control: the reference in TF32 in the program's place fails
    ctrl = checks.judge(keep["state"], keep["config"], keep["traffic"],
                        control=True)
    assert not checks.verdict(ctrl, keep["limits"])
    assert "frame_ms_p50" in out["metrics"]


@pytest.mark.parametrize("fault", ["frozen_step", "frozen_solve",
                                   "frozen_align", "half_batch",
                                   "tiles_altered", "pose_altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    out, _ = small_run("euroc_mono_vio.laps", 99, fault=fault, seconds=10.0)
    assert out["correct"] is False, (fault, out["checks"])
