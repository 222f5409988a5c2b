"""Shared helpers of the port's parity tests (tests/test_torch_*.py): JAX
trees to numpy dicts, the slice configuration, and the synthetic sequence
both implementations are fed."""

import dataclasses

import numpy as np
import torch

from svo_pro_universal_tpu.config import Config as JaxConfig
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.testing import synthetic as syn

# tier-1 runs several pytest workers on one machine
torch.set_num_threads(2)


def to_dict(tree):
    """JAX NamedTuple tree → nested dict of numpy arrays (convert's input)."""
    if hasattr(tree, "_fields"):
        return {k: to_dict(v) for k, v in zip(tree._fields, tree)}
    return np.asarray(tree)


def camera_dict(cam):
    return dict(projection=int(cam.projection),
                distortion=int(cam.distortion),
                intrinsics=np.asarray(cam.intrinsics),
                dist_params=np.asarray(cam.dist_params),
                width=cam.width, height=cam.height, label=cam.label)


def slice_config() -> JaxConfig:
    """The 160×120 mono test config of tests/test_pipeline_mono.py:46-72,
    with OneShot initialization at the plane's depth."""
    cfg = JaxConfig()
    cfg.capacity.max_fts = 256
    cfg.capacity.max_kfs = 6
    cfg.capacity.max_points = 1024
    cfg.n_pyr_levels = 4
    cfg.detector.cell_size = 10
    cfg.detector.threshold_primary = 5.0
    cfg.init.init_method = "OneShot"
    cfg.init.init_min_features = 40
    cfg.depth_filter.seed_convergence_sigma2_thresh = 30.0
    cfg.init.expected_avg_depth = float(syn.PLANE_Z)
    cfg.base.quality_min_fts = 15
    cfg.base.kfselect_numkfs_lower_thresh = 40
    cfg.base.kfselect_numkfs_upper_thresh = 120
    cfg.base.kfselect_min_disparity = 12.0
    cfg.base.kfselect_min_dist_metric = 0.05
    cfg.base.kfselect_min_angle = 6.0
    cfg.reprojector.max_n_features_per_frame = 180
    cfg.reprojector.cell_size = 10
    cfg.img_align.max_level = 2
    cfg.img_align.min_level = 0
    return cfg


def port_config(cfg: JaxConfig):
    return convert.config(dataclasses.asdict(cfg))


def gt_pose(t: int) -> np.ndarray:
    """T_cam_world of frame t: a sideways drift with a small wobble."""
    return syn.pose(0.025 * t, 0.012 * np.sin(t * 0.3), 0.004 * t,
                    0.002 * np.sin(t * 0.2), 0.0003 * t, 0.001 * t)


def sequence(n_frames: int) -> list:
    """uint8 views of the textured plane at 2 m, one per frame."""
    ref = syn.textured_image()
    return [np.clip(np.rint(syn.render_plane_view(ref, gt_pose(t))), 0,
                    255).astype(np.uint8) for t in range(n_frames)]


def rotation_angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
