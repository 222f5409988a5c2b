"""The port's benchmark (``svo_pro_universal_tpu_torch.bench``) on the CPU.

- ``main`` with ``--device cpu`` at a few frames (10 VIO frames, 4 warm-up;
  8 SLAM frames, 4 warm-up; one call a stage and a BA solve): the one JSON
  line parses and carries every key; the VIO run is TRACKING on fewer than
  90% of its 6 timed frames, so ``value`` and ``fps_steady_state`` are 0,
  as bench.py:250 defines them; no CUDA kernel is launched on the CPU.
- On fixed traces (TRACKING throughout, and lost on 30% of the timed
  frames) the line's throughput, ATE, scale and path fields equal those of
  bench.py's formulas (bench.py:241-278, 336-344) computed with the JAX
  package's ``ate_rmse``, to the bit after bench.py's rounding.
"""

import json

import numpy as np
import pytest

from svo_pro_universal_tpu.evaluation import ate_rmse as jax_ate_rmse
from svo_pro_universal_tpu_torch import bench
from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
from svo_pro_universal_tpu_torch.testing import synthetic as syn

CPU_ARGS = ["--device", "cpu", "--frames", "10", "--warmup", "4",
            "--slam-frames", "8", "--slam-warmup", "4", "--ba-reps", "1"]
TRACKING = Stage.TRACKING.value


def test_bench_line_on_the_cpu(capsys):
    out = bench.main(CPU_ARGS)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert bench.missing_keys(line, bench.parse_args(CPU_ARGS)) == []
    assert (line["card"], line["device"]) == ("cpu", "cpu")
    n_timed = 10 - 4
    assert line["n_tracking"] < bench.TRACKING_SHARE * n_timed
    assert line["value"] == line["fps_steady_state"] == 0.0
    assert line["vs_baseline"] == 0.0
    assert len(line["fps_chunks"]) == 3 and min(line["fps_chunks"]) > 0
    assert line["feed_batch"] == bench.FEED_BATCH
    for run in ("vio", "slam"):
        assert set(line["launches"][run].values()) == {0}
    assert line["slam"]["n_tracking"] <= 8 - 4
    # the tracer's spans of the run: its bootstrap and tracking frames
    assert set(line["stages_ms"]) >= {"frame", "init_step", "tracking_step",
                                      "sparse_img_align", "pose_optimizer",
                                      "depth_filter"}
    assert min(line["stages_ms"].values()) > 0
    assert line["ba_solve_ms"] > 0
    assert line["dcn_comms"]["state_dim"] == 32 * 15
    assert line["opt_in"].keys() == {"zupt_require_rest"}


def _bench_py_fields(mats, meta, poses, warmup, chunk_fps, dt):
    """bench.py's own formulas (bench.py:241-278) with JAX's ate_rmse."""
    n_timed = len(meta) - warmup
    stages = meta[warmup:, 0].astype(int)
    n_tracking = int((stages == TRACKING).sum())
    fps_overall = n_timed / dt if n_tracking >= 0.9 * n_timed else 0.0
    fps_steady = max(chunk_fps) if n_tracking >= 0.9 * n_timed else 0.0
    out = {"value": round(fps_overall, 2),
           "vs_baseline": round(fps_overall / 20.0, 3),
           "fps_steady_state": round(fps_steady, 2),
           "fps_chunks": [round(f, 1) for f in chunk_fps],
           "n_tracking": n_tracking}
    first_track = int(np.argmax(meta[:, 0].astype(int) == TRACKING))
    gt = np.stack([np.linalg.inv(p)[:3, 3] for p in poses[first_track:]])
    ep = mats[first_track:, :3, 3]
    rmse_sim3, a3 = jax_ate_rmse(ep, gt, align="sim3")
    rmse_se3, _ = jax_ate_rmse(ep, gt, align="se3")
    out["ate_m"] = round(float(rmse_sim3), 4)
    out["ate_se3_m"] = round(float(rmse_se3), 4)
    out["scale_error"] = round(abs(float(a3.s) - 1.0), 4)
    out["traj_len_m"] = round(float(np.linalg.norm(np.diff(gt, axis=0),
                                                   axis=-1).sum()), 2)
    return out


@pytest.mark.parametrize("lost_share", [0.0, 0.3])
def test_bench_fields_follow_bench_py(lost_share):
    rng = np.random.default_rng(3)
    n, warmup = 40, 8
    poses = [syn.se3_exp_np(syn.bench_twist(float(t))) for t in range(n)]
    mats = np.stack([np.linalg.inv(T) for T in poses])
    mats[:, :3, 3] = 1.13 * mats[:, :3, 3] + rng.normal(0, 2e-3, (n, 3))
    meta = np.zeros((n, 4), np.float32)
    meta[:, 0] = TRACKING
    meta[:3, 0] = Stage.INITIALIZING.value
    lost = rng.choice(np.arange(warmup, n), int(lost_share * (n - warmup)),
                      replace=False)
    meta[lost, 0] = Stage.RELOCALIZING.value
    chunk_fps = [2.8731, 3.1049, 2.9377]
    dt = (n - warmup) / 2.9612
    want = _bench_py_fields(mats, meta, poses, warmup, chunk_fps, dt)
    got = (bench.vio_fields(meta, warmup, chunk_fps, dt, 8)
           | bench.trajectory_fields(mats, meta, poses, se3=True))
    assert {k: got[k] for k in want} == want
    assert (want["value"] == 0.0) == (lost_share > 0.1)
    slam = bench.trajectory_fields(mats, meta, poses, se3=False)
    assert slam == {k: want[k] for k in ("ate_m", "traj_len_m")}
