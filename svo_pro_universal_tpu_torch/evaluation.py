"""Trajectory evaluation: Umeyama SE3/Sim3 alignment, ATE and relative
errors, timestamp association, TUM trajectory files and the
rpg_trajectory_evaluation results layout, in numpy.

The port's own copy of ``svo_pro_universal_tpu/evaluation.py`` (the
external rpg_trajectory_evaluation toolbox the reference's benchmarking
harness relies on; alignment as vikit_py align_trajectory.py — Umeyama).
The TUM writer takes each quaternion from the port's
``utils.transform.matrix_to_quat`` in float32 and writes the same text as
the JAX package's; the results' YAML documents go through
``utils.yaml_lite``.
"""

from __future__ import annotations

from typing import NamedTuple

import os
import shutil

import numpy as np
import torch

from svo_pro_universal_tpu_torch.utils import yaml_lite
from svo_pro_universal_tpu_torch.utils.transform import matrix_to_quat


class AlignmentResult(NamedTuple):
    s: float
    R: np.ndarray     # [3, 3]
    t: np.ndarray     # [3]


def umeyama_alignment(est: np.ndarray, gt: np.ndarray,
                      with_scale: bool = True) -> AlignmentResult:
    """Least-squares similarity aligning est → gt. est, gt: [N, 3]."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    C = g.T @ e / est.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (e ** 2).sum() / est.shape[0]
    s = (float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
         if with_scale else 1.0)
    return AlignmentResult(s, R, mu_g - s * R @ mu_e)


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, align: str = "sim3"
             ) -> tuple[float, AlignmentResult]:
    """Absolute trajectory error after alignment: 'sim3' (mono, scale
    free), 'se3' (metric), or 'none'."""
    if align == "none":
        a = AlignmentResult(1.0, np.eye(3), np.zeros(3))
    else:
        a = umeyama_alignment(est_pos, gt_pos, with_scale=(align == "sim3"))
    est_aligned = (a.s * (a.R @ est_pos.T)).T + a.t
    err = np.linalg.norm(est_aligned - gt_pos, axis=-1)
    return float(np.sqrt((err ** 2).mean())), a


def relative_errors(est_pos: np.ndarray, gt_pos: np.ndarray,
                    delta: int = 10, align: str = "se3") -> np.ndarray:
    """End-point error of every ``delta``-frame sub-trajectory, each first
    aligned to the ground truth over its own span (se3, or sim3 for mono),
    as rpg_trajectory_evaluation's compute_trajectory_errors does."""
    n = len(est_pos) - delta
    if n <= 0:
        return np.zeros((0,))
    errs = np.empty((n,))
    for i in range(n):
        e = est_pos[i:i + delta + 1]
        g = gt_pos[i:i + delta + 1]
        a = umeyama_alignment(e, g, with_scale=align == "sim3")
        errs[i] = np.linalg.norm(a.s * (a.R @ e[-1]) + a.t - g[-1])
    return errs


def associate(ts_est: np.ndarray, ts_gt: np.ndarray, max_dt: float = 0.02
              ) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association: index arrays (est, gt)."""
    idx_gt = np.clip(np.searchsorted(ts_gt, ts_est), 1, len(ts_gt) - 1)
    left = ts_gt[idx_gt - 1]
    right = ts_gt[idx_gt]
    pick = np.where(np.abs(ts_est - left) < np.abs(ts_est - right),
                    idx_gt - 1, idx_gt)
    ok = np.abs(ts_gt[pick] - ts_est) <= max_dt
    return np.nonzero(ok)[0], pick[ok]


def save_trajectory_tum(path: str, timestamps, poses) -> None:
    """poses: 4×4 T_world_cam each. One line a pose: t x y z qx qy qz qw."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            T = np.asarray(T)
            q = matrix_to_quat(torch.as_tensor(
                np.asarray(T[:3, :3], np.float32))).numpy()
            p = T[:3, 3]
            f.write(f"{ts:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def load_trajectory_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(timestamps [N], positions [N, 3]) of a TUM trajectory file."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4]


def write_rpg_results(results_dir: str, stamps, poses, gt_samples,
                      align_type: str = "posyaw", align_num_frames: int = -1,
                      extra_files: dict | None = None) -> dict:
    """The rpg_trajectory_evaluation results layout in one call
    (stamped_traj_estimate.txt, stamped_groundtruth.txt, eval_cfg.yaml, as
    the reference's extra/svo_benchmarking/scripts/benchmark.py:180-199
    writes them) plus an in-repo summary, ate_summary.yaml: Sim3 and SE3
    ATE, the Sim3 scale, the path length and the median 10- and 30-frame
    relative errors. ``gt_samples``: objects with .timestamp, .p [3] and
    .q [4] (wxyz), as ``EurocDataset.ground_truth()`` gives them. Returns
    the summary."""
    os.makedirs(results_dir, exist_ok=True)
    save_trajectory_tum(os.path.join(results_dir,
                                     "stamped_traj_estimate.txt"),
                        stamps, poses)
    with open(os.path.join(results_dir, "stamped_groundtruth.txt"),
              "w") as f:
        for g in gt_samples:
            f.write(f"{g.timestamp:.9f} {g.p[0]:.6f} {g.p[1]:.6f} "
                    f"{g.p[2]:.6f} {g.q[1]:.6f} {g.q[2]:.6f} "
                    f"{g.q[3]:.6f} {g.q[0]:.6f}\n")
    yaml_lite.dump_file(os.path.join(results_dir, "eval_cfg.yaml"),
                        {"align_type": align_type,
                         "align_num_frames": align_num_frames})
    for name, src in (extra_files or {}).items():
        if src and os.path.isfile(src):
            shutil.copyfile(src, os.path.join(results_dir, name))

    summary: dict = {"n_frames": len(stamps)}
    try:
        ts_gt = np.asarray([g.timestamp for g in gt_samples])
        p_gt = np.stack([g.p for g in gt_samples])
        ie, ig = associate(np.asarray(stamps, np.float64), ts_gt)
        est_pos = np.stack([np.asarray(poses[i])[:3, 3] for i in ie])
        gt_pos = p_gt[ig]
        for align in ("sim3", "se3"):
            rmse, a = ate_rmse(est_pos, gt_pos, align=align)
            summary[f"ate_rmse_{align}_m"] = float(rmse)
            if align == "sim3":
                summary["scale"] = float(a.s)
        summary["traj_length_m"] = float(np.linalg.norm(
            np.diff(gt_pos, axis=0), axis=-1).sum())
        for delta in (10, 30):
            if len(est_pos) > delta + 1:
                errs = relative_errors(est_pos, gt_pos, delta=delta,
                                       align="sim3")
                if errs.size:
                    summary[f"rpe_{delta}f_median_m"] = float(
                        np.median(errs))
    except Exception as e:        # too little ground-truth overlap etc.
        summary["eval_error"] = str(e)[:200]
    yaml_lite.dump_file(os.path.join(results_dir, "ate_summary.yaml"),
                        summary)
    return summary
