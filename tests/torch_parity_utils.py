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


def rig_config():
    """The stereo and array tests' config (tests/test_device_pipeline_
    stereo.py:22-27): tests/test_pipeline_mono.py's, stereo depth range
    0.5–10 m around 2 m."""
    from test_pipeline_mono import make_config
    cfg = make_config()
    cfg.pipeline_is_stereo = True
    cfg.stereo.mean_depth_inv = 1.0 / 2.0
    cfg.stereo.min_depth_inv = 1.0 / 0.5
    cfg.stereo.max_depth_inv = 1.0 / 10.0
    return cfg


def uint8_views(imgs) -> list:
    """Rendered views as the uint8 frames both implementations are fed."""
    return [np.clip(np.rint(np.asarray(im)), 0, 255).astype(np.uint8)
            for im in imgs]


def jax_trace_pose(worlds, k) -> np.ndarray:
    """4×4 T_world_cam that the JAX run traced at frame k."""
    jw = worlds[k + 1]
    return convert.SE3(*(torch.from_numpy(np.array(jw[f][k]))
                         for f in ("trace_q", "trace_t"))).as_matrix().numpy()


def pose_gap(pipe, worlds, k) -> tuple[float, float]:
    """(position gap m, rotation gap °) of the port's frame k to JAX's."""
    T = pipe.world.last_frame.T_world_cam.as_matrix().numpy()
    Tj = jax_trace_pose(worlds, k)
    return (float(np.linalg.norm(T[:3, 3] - Tj[:3, 3])),
            rotation_angle_deg(T[:3, :3], Tj[:3, :3]))


def new_own_landmarks(frame, pool, next_id_before) -> int:
    """Landmarks of ``frame`` (a dict of numpy arrays) created from its own
    seeds in this step: the stereo/array triangulation's promotions (a
    keyframe step's upgraded seeds belong to older keyframes)."""
    lid = np.asarray(frame["landmark_id"])
    ok = (lid >= 0) & (np.asarray(frame["seed_ref_kf"]) < 0)
    ids = np.asarray(pool["ids"])[np.clip(lid, 0, None)]
    ftype = np.asarray(frame["ftype"])
    return int(np.sum(ok & (ids >= next_id_before) & (ftype >= 0)
                      & (ftype < 11) & (ftype != 10)))


def unaligned_ate(mats: np.ndarray, cam_poses_world_pos: np.ndarray
                  ) -> tuple[float, float]:
    """(metric ATE without alignment, path length) of estimated T_world_cam
    ``mats`` [N,4,4] against ground-truth positions [N,3], both taken
    relative to their first frame (tests/test_device_pipeline_stereo.py)."""
    gt_rel = cam_poses_world_pos - cam_poses_world_pos[0]
    est_rel = mats[:, :3, 3] - mats[0, :3, 3]
    ate = float(np.sqrt(np.mean(np.sum((gt_rel - est_rel) ** 2, axis=-1))))
    path = float(np.linalg.norm(np.diff(cam_poses_world_pos, axis=0),
                                axis=-1).sum())
    return ate, path


def assert_tree_equal(a, b) -> None:
    """``convert.to_numpy`` output ``a`` equals the JAX dict ``b``: arrays of
    the same dtype and values, host scalars of the same value."""
    if isinstance(b, dict):
        for k in b:
            assert_tree_equal(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    if b.ndim == 0:
        assert a == b
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _tree(v):
    """A JAX handler attribute as convert's input: NamedTuples as dicts,
    arrays as numpy, lists and dicts kept, None and host scalars as they
    are."""
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if hasattr(v, "_fields"):
        return to_dict(v)
    if isinstance(v, (list, tuple)):
        return [_tree(x) for x in v]
    if isinstance(v, dict):
        return dict(v)
    return np.asarray(v)


_HOST_KEYS = ("ring", "pool", "last_frame", "T_rel_prev", "depth_median",
              "depth_min", "_depth_state", "frames_since_kf", "frame_count",
              "reloc_trials", "_prev_n_tracked", "_last_ts",
              "_init_ref_frame", "_init_ref_px", "_init_ref_valid",
              "_init_px_guess", "rng_key", "_pyr1", "_pyr1_last",
              "_pyr_others", "_pyr_others_last", "_last_backend_chi2",
              "graph", "_pgo_n", "_pgo_c", "_kf_poses", "_uid2slot",
              "n_loops_closed")


def jax_host_state(h) -> dict:
    """A JAX host handler's state as the dict ``convert.host_*`` reads:
    its attributes by name (those it has), the stage as its value, and the
    backend, loop closer and global map as dicts of theirs."""
    d = {k: _tree(getattr(h, k)) for k in _HOST_KEYS if hasattr(h, k)}
    d["stage"] = h.stage.value
    be = getattr(h, "backend", None)
    if be is not None:
        d["backend"] = {"state": to_dict(be.state),
                        "n_states": be.n_states, "_ts": list(be._ts)}
    if hasattr(h, "loop_closer"):
        lc = h.loop_closer
        d["loop_closer"] = {"snapshots": [to_dict(s) for s in lc.snapshots],
                            "kf_ids": list(lc.kf_ids),
                            "_n_added": lc._n_added,
                            "n_evicted": lc.n_evicted,
                            "_desc_matrix": np.asarray(lc._desc_matrix)}
    if getattr(h, "global_map", None) is not None:
        d["global_map"] = jax_map_state(h.global_map)
    return d


def jax_map_state(g) -> dict:
    """A JAX GlobalMap's or BackendInterface's state as convert reads it."""
    d = {k: _tree(getattr(g, k)) for k in (
        "window", "n_states", "kf_ids", "kf_ts", "lid2slot", "slot2lid",
        "_lm_cursor", "_obs_cursor", "_since_opt") if hasattr(g, k)}
    return d
