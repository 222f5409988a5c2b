"""Trajectory evaluation: Umeyama SE3/Sim3 alignment and ATE, in numpy.

The port's own copy of ``ate_rmse`` of ``svo_pro_universal_tpu/evaluation.py``
(the external rpg_trajectory_evaluation toolbox's alignment, vikit_py
align_trajectory.py — Umeyama), which imports JAX elsewhere in its module.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
