"""Typed configuration tree + YAML loader (the port's own copy).

One typed config tree replacing the reference's 8 plain option structs filled
field-by-field in its factory (reference: src/svo/src/svo_factory.cpp:107-309;
structs: frame_handler_base.h:39-212, feature_detection_types.h:49,
depth_filter.h:27, reprojector.h:26, initialization.h:37,
stereo_triangulation.h:12, imu_handler.h:49). The YAML key names are the
reference's (examples/param/pinhole.yaml), so its parameter files load as-is.

Field for field the same tree as ``svo_pro_universal_tpu/config.py``, so a
config converts between the two packages by ``dataclasses.asdict``
(``convert.config_from_dict``). A `CapacityOptions` block fixes all static
shapes (max features / keyframes / landmarks / seeds per frame): the state
is fixed-capacity and padded. PyYAML is imported only by the loader.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

from svo_pro_universal_tpu_torch.utils import yaml_lite


@dataclass
class CapacityOptions:
    """Static-shape capacities (TPU-specific; no reference equivalent)."""
    max_fts: int = 256           # feature slots per frame (padded SoA)
    max_kfs: int = 10            # keyframe ring size
    max_points: int = 4096       # landmark pool size
    max_obs_per_point: int = 16  # observation slots per landmark
    grid_cells: int = 1024       # occupancy grid cell capacity
    epi_samples: int = 32        # fixed epipolar-scan budget per seed
    pyramid_levels: int = 5      # allocated pyramid levels (>= n_pyr_levels)
    max_seed_updates: int = 768  # seeds updated per frame (compacted)


@dataclass
class BaseOptions:
    """reference: frame_handler_base.h:39-212."""
    max_n_kfs: int = 10
    use_imu: bool = False
    trace_dir: str = "/tmp/svo_tpu"
    trace_statistics: bool = False
    quality_min_fts: int = 50
    quality_max_fts_drop: int = 40
    relocalization_max_trials: int = 50
    poseoptim_prior_lambda: float = 0.0
    poseoptim_using_unit_sphere: bool = False
    poseoptim_thresh: float = 2.0
    img_align_prior_lambda_rot: float = 0.0
    img_align_prior_lambda_trans: float = 0.0
    structure_optimization_max_pts: int = 20
    init_map_scale: float = 1.0
    kfselect_criterion: str = "FORWARD"   # or DOWNLOOKING
    kfselect_min_dist: float = 0.12
    kfselect_numkfs_upper_thresh: int = 120
    kfselect_numkfs_lower_thresh: int = 70
    kfselect_min_dist_metric: float = 0.01
    kfselect_min_angle: float = 20.0
    kfselect_min_disparity: float = 40.0
    kfselect_min_num_frames_between_kfs: int = 2
    kfselect_backend_max_time_sec: float = 3.0
    update_seeds_with_old_keyframes: bool = False
    use_async_reprojectors: bool = False
    max_seeds_ratio: float = 3.0
    use_threaded_depthfilter: bool = True
    backend_scale_stable_thresh: float = 0.02


@dataclass
class DetectorOptions:
    """reference: feature_detection_types.h:49."""
    cell_size: int = 30                   # YAML: grid_size
    max_level: int = 2                    # n_pyr_levels - 1
    threshold_primary: float = 10.0       # FAST threshold
    threshold_secondary: float = 100.0    # edgelet gradient threshold
    threshold_shitomasi: float = 50.0
    detector_type: str = "fast_grad"      # fast | grad | fast_grad | shitomasi | ...
    use_edgelets: bool = True


@dataclass
class DepthFilterOptions:
    """reference: depth_filter.h:27."""
    max_search_level: int = 2
    use_threaded_depthfilter: bool = True
    seed_convergence_sigma2_thresh: float = 200.0
    mappoint_convergence_sigma2_thresh: float = 500.0
    scan_epi_unit_sphere: bool = False
    affine_est_offset: bool = True
    affine_est_gain: bool = False
    max_n_seeds_per_frame: int = 500      # max_fts * max_seeds_ratio in reference
    max_map_seeds_per_frame: int = 200
    extra_map_points: bool = False
    update_3d_points: bool = False


@dataclass
class SparseImgAlignOptions:
    """reference: sparse_img_align_base.h:49-83 + factory keys img_align_*."""
    max_level: int = 4
    min_level: int = 2
    patch_size: int = 4
    robustification: bool = False
    use_distortion_jacobian: bool = False
    estimate_illumination_gain: bool = False
    estimate_illumination_offset: bool = False
    prior_lambda_rot: float = 0.0
    prior_lambda_trans: float = 0.0
    max_iter: int = 10


@dataclass
class ReprojectorOptions:
    """reference: reprojector.h:26."""
    max_n_kfs: int = 5
    max_n_features_per_frame: int = 160   # max_fts
    cell_size: int = 30
    reproject_unconverged_seeds: bool = True
    max_unconverged_seeds_ratio: float = -1.0
    min_required_features: int = 50
    seed_sigma2_thresh: float = 200.0
    affine_est_offset: bool = True
    affine_est_gain: bool = False
    max_fixed_landmarks: int = 50
    fixed_lm_grid_size: int = 50
    use_kfs_from_global_map: bool = False
    max_n_global_kfs: int = 20


@dataclass
class InitializationOptions:
    """reference: initialization.h:37."""
    init_method: str = "FivePoint"   # Homography|TwoPoint|FivePoint|OneShot|Stereo
    init_min_features: int = 100
    init_min_tracked: int = 50
    init_min_inliers: int = 40
    init_min_disparity: float = 50.0
    init_min_features_factor: float = 2.0
    reproj_error_thresh: float = 2.0
    init_disparity_pivot_ratio: float = 0.5
    expected_avg_depth: float = 1.0       # map_scale


@dataclass
class StereoTriangulationOptions:
    """reference: stereo_triangulation.h:12."""
    triangulate_n_features: int = 120
    max_depth_inv: float = 1.0 / 50.0
    min_depth_inv: float = 1.0
    mean_depth_inv: float = 1.0 / 3.0


@dataclass
class ImuHandlerOptions:
    """reference: imu_handler.h:49."""
    temporal_stationary_check: bool = False
    temporal_window_length_sec: float = 0.5
    stationary_acc_sigma_thresh: float = 0.1
    stationary_gyr_sigma_thresh: float = 6e-2


@dataclass
class PoseOptimizerOptions:
    max_iter: int = 10
    reproj_thresh: float = 2.0
    error_type: str = "unit_plane"   # unit_plane | image_plane | bearing_diff
    prior_lambda: float = 0.0


@dataclass
class FeatureTrackerOptions:
    """reference: feature_tracking_types.h + factory klt_* keys."""
    klt_max_level: int = 4
    klt_min_level: int = 0
    klt_patch_size: int = 8
    klt_max_iter: int = 30
    klt_min_update_squared: float = 1e-4


@dataclass
class BackendOptions:
    """Sliding-window BA (reference: ceres_backend_interface.hpp:21-58 +
    the backend knobs exposed through the ROS factory,
    extra/svo_ros/src/ceres_backend_factory.cpp:18-86)."""
    num_keyframes: int = 5
    num_imu_frames: int = 3
    max_iterations: int = 3
    marginalize: bool = True
    # temporal (non-keyframe) backend states: insert a window state
    # whenever the newest one is older than this, keyframe or not — the
    # reference's window is num_keyframes KFs PLUS num_imu_frames
    # per-frame temporal states (ceres_backend_interface.hpp:21-58), so
    # its IMU factors span ≲0.1 s; a keyframes-only window leaves factor
    # gaps of 0.5–2.5 s (measured r5) that break preintegration validity
    # (max_imu_dt_between_kfs) and starve the VI alignment of factors
    temporal_state_max_dt: float = 0.3
    # no IMU factor across a longer gap (stale velocities / truncation)
    max_imu_dt_between_kfs: float = 0.6
    # observation ingestion gate: a frontend feature must reproject its
    # landmark within this many px to enter the window (reference:
    # outlier_rejection_px_threshold, ceres_backend_factory.cpp:81)
    ingest_gate_px: float = 5.0
    # scale-stability gate on applying backend pose corrections to the
    # frontend (reference: frame_handler_base.cpp:256-310)
    max_pose_correction: float = 0.5
    # zero-motion (ZUPT) detection thresholds + prior sigma (reference:
    # backend_use_zero_motion_detection / zero_motion_sigma,
    # ceres_backend_factory.cpp:18-26,75)
    use_zero_motion_detection: bool = True
    zupt_gyro_thresh: float = 0.015      # rad/s incl. mean
    zupt_acc_thresh: float = 0.12        # m/s² deviation from mean
    zupt_sigma_v: float = 0.02           # m/s
    # port only, off by default: the zero-velocity prior also needs the
    # frontend's velocity within 3 σ of rest. A window solve that steps its
    # states (the JAX package's float32 solve voids them on bench.py's
    # scene) is dragged by the prior on a smoothly moving camera, whose
    # noise-free IMU reads as stationary (ROADMAP, deliberate divergences)
    zupt_require_rest: bool = False
    # window capacities (device-resident backend pools)
    max_landmarks: int = 256
    max_obs_per_kf: int = 120
    # common-mode scale correction: the (metric) backend solution may
    # disagree with the mono frontend map by a global scale (wrong init
    # depth prior / IMU scale drift); when enabled the correction step
    # extracts that common mode and applies it to the WHOLE frontend map
    # instead of letting a flat displacement gate block convergence
    # (reference behavior: backend-driven scale stabilization,
    # frame_handler_base.cpp:256-310; VERDICT r3 item 3)
    scale_correction: bool = True
    max_scale_step: float = 1.15         # per-keyframe scale step bound
    min_scale_support: int = 12          # landmarks needed to trust s
    scale_deadband: float = 0.003        # |log s_raw| below this: no-op
    scale_damping: float = 0.5           # transfer s_raw^γ per keyframe
    # scale transfer requires the window's scale to be OBSERVABLE:
    # relative std of the closed-form VI-alignment β below this
    scale_obs_max_rel_std: float = 0.15
    # feedback only applies when the post-solve cost per observation is
    # sane (reference: skip_optimization_when_tracking_bad,
    # ceres_backend_factory.cpp:84-86)
    max_chi2_per_obs: float = 200.0
    # drop the IMU factor when consecutive keyframes are further apart
    # than this (a relocalization outage leaves velocities stale and the
    # preintegration truncated — measured chi2 5e4 on one such factor)
    max_imu_dt_between_kfs: float = 0.6


@dataclass
class Config:
    pipeline_is_stereo: bool = False
    n_pyr_levels: int = 3
    capacity: CapacityOptions = field(default_factory=CapacityOptions)
    base: BaseOptions = field(default_factory=BaseOptions)
    detector: DetectorOptions = field(default_factory=DetectorOptions)
    depth_filter: DepthFilterOptions = field(default_factory=DepthFilterOptions)
    img_align: SparseImgAlignOptions = field(default_factory=SparseImgAlignOptions)
    reprojector: ReprojectorOptions = field(default_factory=ReprojectorOptions)
    init: InitializationOptions = field(default_factory=InitializationOptions)
    stereo: StereoTriangulationOptions = field(default_factory=StereoTriangulationOptions)
    imu: ImuHandlerOptions = field(default_factory=ImuHandlerOptions)
    pose_optimizer: PoseOptimizerOptions = field(default_factory=PoseOptimizerOptions)
    tracker: FeatureTrackerOptions = field(default_factory=FeatureTrackerOptions)
    backend: BackendOptions = field(default_factory=BackendOptions)


# map of reference YAML key → (section attr, field, cast)
_KEY_MAP: dict[str, tuple[str, str]] = {
    "pipeline_is_stereo": ("", "pipeline_is_stereo"),
    "n_pyr_levels": ("", "n_pyr_levels"),
    "max_fts": ("capacity", "max_fts"),
    "max_n_kfs": ("base", "max_n_kfs"),
    "use_imu": ("base", "use_imu"),
    "trace_dir": ("base", "trace_dir"),
    "trace_statistics": ("base", "trace_statistics"),
    "quality_min_fts": ("base", "quality_min_fts"),
    "quality_max_drop_fts": ("base", "quality_max_fts_drop"),
    "relocalization_max_trials": ("base", "relocalization_max_trials"),
    "poseoptim_prior_lambda": ("base", "poseoptim_prior_lambda"),
    "poseoptim_using_unit_sphere": ("base", "poseoptim_using_unit_sphere"),
    "poseoptim_thresh": ("base", "poseoptim_thresh"),
    "img_align_prior_lambda_rot": ("base", "img_align_prior_lambda_rot"),
    "img_align_prior_lambda_trans": ("base", "img_align_prior_lambda_trans"),
    "structure_optimization_max_pts": ("base", "structure_optimization_max_pts"),
    "map_scale": ("base", "init_map_scale"),
    "kfselect_criterion": ("base", "kfselect_criterion"),
    "kfselect_min_dist": ("base", "kfselect_min_dist"),
    "kfselect_numkfs_upper_thresh": ("base", "kfselect_numkfs_upper_thresh"),
    "kfselect_numkfs_lower_thresh": ("base", "kfselect_numkfs_lower_thresh"),
    "kfselect_min_dist_metric": ("base", "kfselect_min_dist_metric"),
    "kfselect_min_angle": ("base", "kfselect_min_angle"),
    "kfselect_min_disparity": ("base", "kfselect_min_disparity"),
    "kfselect_min_num_frames_between_kfs": ("base", "kfselect_min_num_frames_between_kfs"),
    "kfselect_backend_max_time_sec": ("base", "kfselect_backend_max_time_sec"),
    "update_seeds_with_old_keyframes": ("base", "update_seeds_with_old_keyframes"),
    "use_async_reprojectors": ("base", "use_async_reprojectors"),
    "max_seeds_ratio": ("base", "max_seeds_ratio"),
    "use_threaded_depthfilter": ("base", "use_threaded_depthfilter"),
    "backend_scale_stable_thresh": ("base", "backend_scale_stable_thresh"),
    # ceres backend knobs (reference: ceres_backend_factory.cpp:18-86)
    "ceres_num_iterations": ("backend", "max_iterations"),
    "ceres_num_imu_frames": ("backend", "num_imu_frames"),
    "ceres_marginalize": ("backend", "marginalize"),
    "outlier_rejection_px_threshold": ("backend", "ingest_gate_px"),
    "backend_use_zero_motion_detection":
        ("backend", "use_zero_motion_detection"),
    "zero_motion_sigma": ("backend", "zupt_sigma_v"),
    "grid_size": ("detector", "cell_size"),
    "detector_threshold_primary": ("detector", "threshold_primary"),
    "detector_threshold_secondary": ("detector", "threshold_secondary"),
    "detector_threshold_shitomasi": ("detector", "threshold_shitomasi"),
    "use_edgelets": ("detector", "use_edgelets"),
    "seed_convergence_sigma2_thresh": ("depth_filter", "seed_convergence_sigma2_thresh"),
    "mappoint_convergence_sigma2_thresh": ("depth_filter", "mappoint_convergence_sigma2_thresh"),
    "scan_epi_unit_sphere": ("depth_filter", "scan_epi_unit_sphere"),
    "depth_filter_affine_est_offset": ("depth_filter", "affine_est_offset"),
    "depth_filter_affine_est_gain": ("depth_filter", "affine_est_gain"),
    "depth_filter_extra_map_points": ("depth_filter", "extra_map_points"),
    "img_align_max_level": ("img_align", "max_level"),
    "img_align_min_level": ("img_align", "min_level"),
    "img_align_robustification": ("img_align", "robustification"),
    "img_align_use_distortion_jacobian": ("img_align", "use_distortion_jacobian"),
    "img_align_est_illumination_gain": ("img_align", "estimate_illumination_gain"),
    "img_align_est_illumination_offset": ("img_align", "estimate_illumination_offset"),
    "reprojector_max_n_kfs": ("reprojector", "max_n_kfs"),
    "reproject_unconverged_seeds": ("reprojector", "reproject_unconverged_seeds"),
    "max_unconverged_seeds_ratio": ("reprojector", "max_unconverged_seeds_ratio"),
    "quality_min_fts_reproj": ("reprojector", "min_required_features"),
    "reprojector_affine_est_offset": ("reprojector", "affine_est_offset"),
    "reprojector_affine_est_gain": ("reprojector", "affine_est_gain"),
    "reprojector_max_fixed_landmarks": ("reprojector", "max_fixed_landmarks"),
    "reprojector_fixed_lm_grid_size": ("reprojector", "fixed_lm_grid_size"),
    "reprojector_use_kfs_from_global_map": ("reprojector", "use_kfs_from_global_map"),
    "reprojector_max_n_global_kfs": ("reprojector", "max_n_global_kfs"),
    "init_method": ("init", "init_method"),
    "init_min_features": ("init", "init_min_features"),
    "init_min_tracked": ("init", "init_min_tracked"),
    "init_min_inliers": ("init", "init_min_inliers"),
    "init_min_disparity": ("init", "init_min_disparity"),
    "init_min_features_factor": ("init", "init_min_features_factor"),
    "init_disparity_pivot_ratio": ("init", "init_disparity_pivot_ratio"),
    "reproj_err_thresh": ("init", "reproj_error_thresh"),
    "max_depth_inv": ("stereo", "max_depth_inv"),
    "min_depth_inv": ("stereo", "min_depth_inv"),
    "mean_depth_inv": ("stereo", "mean_depth_inv"),
    "temporal_stationary_check": ("imu", "temporal_stationary_check"),
    "temporal_window_length_sec": ("imu", "temporal_window_length_sec"),
    "stationary_acc_sigma_thresh": ("imu", "stationary_acc_sigma_thresh"),
    "stationary_gyr_sigma_thresh": ("imu", "stationary_gyr_sigma_thresh"),
    "klt_max_level": ("tracker", "klt_max_level"),
    "klt_min_level": ("tracker", "klt_min_level"),
}


def _cast_like(cur: Any, val: Any) -> Any:
    if isinstance(cur, bool):
        if isinstance(val, str):
            return val.strip().lower() in ("true", "1", "yes", "on")
        return bool(val)
    if isinstance(cur, int) and not isinstance(cur, bool):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    return val


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Build a Config from a reference-format parameter YAML plus overrides.

    Unknown keys are kept in no section but do not error (matching the
    reference's default-if-absent parsing, svo_factory.cpp:107-309).
    """
    cfg = Config()
    doc: dict[str, Any] = {}
    if path is not None:
        doc = yaml_lite.load_file(path) or {}
    if overrides:
        doc.update(overrides)

    for key, val in doc.items():
        loc = _KEY_MAP.get(key)
        if loc is None:
            continue
        section, attr = loc
        target = cfg if section == "" else getattr(cfg, section)
        setattr(target, attr, _cast_like(getattr(target, attr), val))

    # derived values, mirroring factory wiring
    cfg.detector.max_level = cfg.n_pyr_levels - 1
    cfg.reprojector.max_n_features_per_frame = cfg.capacity.max_fts
    cfg.reprojector.seed_sigma2_thresh = cfg.depth_filter.seed_convergence_sigma2_thresh
    cfg.depth_filter.max_n_seeds_per_frame = int(
        cfg.capacity.max_fts * cfg.base.max_seeds_ratio)
    cfg.capacity.max_kfs = max(cfg.capacity.max_kfs, cfg.base.max_n_kfs)
    cfg.capacity.pyramid_levels = max(
        cfg.capacity.pyramid_levels, cfg.img_align.max_level + 1, cfg.n_pyr_levels)
    return cfg


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
