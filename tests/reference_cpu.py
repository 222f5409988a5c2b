"""The JAX package on the CPU on chip_smoke.py's inputs: the reference's own
numbers for the port's `vio` and `slam` phases, where the card cannot run
JAX.

    JAX_PLATFORMS=cpu python tests/reference_cpu.py vio [--solve float64]
        [--no-zupt]
    JAX_PLATFORMS=cpu python tests/reference_cpu.py slam
    JAX_PLATFORMS=cpu python tests/reference_cpu.py stepwise
    JAX_PLATFORMS=cpu python tests/reference_cpu.py {stereo,stereo_vio}
        [--solve float64] [--no-zupt] [--frames N] [--structure-pts N]
    JAX_PLATFORMS=cpu python tests/reference_cpu.py {host_vio,host_slam}
        [--solve float64] [--no-zupt] [--epoch] [--frames N] [--port]
    JAX_PLATFORMS=cpu python tests/reference_cpu.py euroc_mono [--frames N]

`vio`: bench.py's mono_vio_degraded_imagery configuration on its degraded
sphere scene (140 frames, degrade seed 7), fed one frame at a time; prints
one JSON line with TRACKING over the 120 timed frames, Sim3 and SE3 ATE,
the scale error, and the share of window LM iterations whose state step
was all zeros (the float32 solve's non-finite step, zeroed). `--solve
float64` evaluates JAX's `solve_schur` in float64 (a host callback, the
value its code specifies, as the port's default solve); `--no-zupt` turns
the zero-velocity prior off.

`slam`: bench.py's SLAM section (the same configuration plus its
SlamOptions on the closed loop, 160 frames, degrade seed 11); prints
`slam_stats()`, TRACKING over the 144 timed frames and Sim3 ATE.

`stepwise`: the `slam` run, and before each frame its world converted into
the port's `DevicePipelineSLAM` on the CPU (JAX's RANSAC noise injected on
init frames, the port's window solve with `void_on_single_view`, JAX's
zero-velocity prior), both stepped on the frame; prints one JSON line per
frame (stage, keyframe, tracked count, pose gap, pose-graph nodes, the
verification counts, and for a keyframe its snapshot row against JAX's)
and a summary line.

`stereo`, `stereo_vio`: the JAX device stereo pipelines on chip_smoke's
stereo input (the EuRoC rig of examples/param/euroc_stereo.yaml, body at
cam0; bench.py's scene seen by both cameras, degrade seeds 7 and 8; the
stereo VIO with bench.py's IMU), in chip_smoke's ``stereo_config``; prints
one JSON line per frame (stage, tracked count, keyframe, window states,
the position's distance to the ground truth, both relative to the first
frame) and a summary line: TRACKING over the timed frames, metric
unaligned and SE3 ATE, the zero-step share. `--structure-pts` sets the
per-frame structure stage's point budget (JAX's stereo VIO keeps
`cfg.base.structure_optimization_max_pts`, 20; JAX's mono device VIO sets
0).

`host_vio`, `host_slam`: the JAX package's host handlers on the inputs of
chip_smoke's `host_vio` and `host_slam` phases: `FrameHandlerVIO` on the
`vio` input (the IMU fed through `add_imu_measurement`), and
`FrameHandlerSLAM` (mono, no IMU, `LoopClosingOptions` of
`slam_options()`, the default `GlobalMapOptions`) on the `slam` input;
one JSON line a frame (stage, tracked count, keyframe, backend chi2 or the
pose-graph node count) and a summary line: TRACKING over the timed frames,
Sim3 ATE, backend calls and the zero-step share, or loops, pose-graph
nodes, global-map states, fixed landmarks. `--frames N` runs `host_vio`
on the input's first N frames (chip_smoke's `host_vio` and `euroc` phases
take 80). `--port` runs the port's `FrameHandlerVIO` on the CPU instead,
as chip_smoke's `host_vio` phase builds it (its float64 window solve), in
the same loop: the two packages side by side on one input.

`--epoch` feeds the host handlers EuRoC-epoch stamps (the sequence's
times plus 1403636579.763555584 s, the IMU's too), as the EuRoC runners
do: where the package keeps absolute stamps in float32, they resolve 128 s
there.

`euroc_mono`: the JAX host `FrameHandlerMono` with
examples/param/pinhole.yaml (FivePoint) on the first N (default 60) frames
of the `vio` input at EuRoC-epoch stamps, the runner's loop of chip_smoke's
`euroc_mono` phase; one JSON line a frame and a summary line (TRACKING over
the frames after the 20-frame warm-up, relocalizations, Sim3 ATE of the
tracked frames).

The configuration and the scene come from chip_smoke.py and the port's
`testing.synthetic` (numpy frames rendered on the CPU). A full-width run
takes about a minute (vio) or three (slam) on 8 CPU cores and a few GB.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from svo_pro_universal_tpu.backend import window_ba as jwba  # noqa: E402
from svo_pro_universal_tpu.backend import device_interface as jdi  # noqa
from svo_pro_universal_tpu.cameras.projections import Camera  # noqa: E402
from svo_pro_universal_tpu.cameras.rig import ImuParams  # noqa: E402
from svo_pro_universal_tpu.config import Config  # noqa: E402
from svo_pro_universal_tpu.evaluation import ate_rmse  # noqa: E402
from svo_pro_universal_tpu.frontend.imu_handler import ImuHandler  # noqa
from svo_pro_universal_tpu.frontend.pipeline_slam import (  # noqa: E402
    DevicePipelineSLAM, SlamOptions)
from svo_pro_universal_tpu.frontend.pipeline_vio import (  # noqa: E402
    DevicePipelineVIO)
from svo_pro_universal_tpu_torch.testing import synthetic as syn  # noqa

TRACKING = 3
STEPS = {"iterations": 0, "zero": 0}


def jax_config() -> Config:
    """chip_smoke.vio_config() (bench.py:159-184) as a JAX Config, without
    the port's opt-in fields."""
    pcfg = cs.vio_config()
    cfg = Config()
    for name in ("capacity", "detector", "init", "depth_filter", "base",
                 "reprojector", "backend"):
        sec = getattr(cfg, name)
        for k, v in dataclasses.asdict(getattr(pcfg, name)).items():
            if hasattr(sec, k):
                setattr(sec, k, v)
    cfg.n_pyr_levels = pcfg.n_pyr_levels
    return cfg


def _count(dx_p):
    STEPS["iterations"] += 1
    STEPS["zero"] += int(not np.any(np.asarray(dx_p)))


def _solve_float64(Hpp, bp, U, Hll, bl, mu, lm_valid):
    """JAX's solve_schur (backend/window_ba.py:400-423) in float64."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    Hpp, bp, U, Hll, bl, mu, lv = map(f, (Hpp, bp, U, Hll, bl, mu,
                                          lm_valid))
    inv = np.linalg.inv(Hll + mu * np.eye(3)[None]) * lv[:, None, None]
    S = Hpp - np.einsum("lia,lab,ljb->ij", U, inv, U)
    b = bp - np.einsum("lia,lab,lb->i", U, inv, bl)
    S = S + mu * np.diag(np.maximum(np.diag(S), 1.0))
    dx = np.linalg.solve(S, b)
    dl = np.einsum("lab,lb->la", inv, bl - np.einsum("lia,i->la", U, dx))
    return (np.where(np.isfinite(dx), dx, 0.0).astype(np.float32),
            np.where(np.isfinite(dl), dl, 0.0).astype(np.float32))


def patch_solve(precision: str) -> None:
    orig = jwba.solve_schur

    def solve(Hpp, bp, U, Hll, bl, mu, lm_valid, axis_name=None):
        if precision == "float64":
            dx_p, dl = jax.pure_callback(
                _solve_float64,
                (jax.ShapeDtypeStruct(bp.shape, jnp.float32),
                 jax.ShapeDtypeStruct(bl.shape, jnp.float32)),
                Hpp, bp, U, Hll, bl, mu, lm_valid)
        else:
            dx_p, dl = orig(Hpp, bp, U, Hll, bl, mu, lm_valid, axis_name)
        jax.debug.callback(_count, dx_p)
        return dx_p, dl
    jwba.solve_schur = solve


def feed(h, imu, frames, imu_meas) -> None:
    i = 0
    for t, img in enumerate(frames):
        ts = t * syn.CAM_DT
        while i < len(imu_meas) and imu_meas[i][0] <= ts:
            imu.add_measurement(*imu_meas[i])
            i += 1
        h.add_image(np.asarray(img), ts)


def accuracy(h, poses, warmup: int) -> dict:
    mats, meta = h.drain()
    st = meta[:, 0].astype(int)
    tr = st == TRACKING
    first = int(np.argmax(tr))
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])[first:]
    a3, al = ate_rmse(mats[first:, :3, 3], gt, align="sim3")
    a6, _ = ate_rmse(mats[first:, :3, 3], gt, align="se3")
    return {"n_tracking": int(tr[warmup:].sum()),
            "n_timed": len(st) - warmup, "first_tracking_frame": first,
            "ate_m": float(a3), "ate_se3_m": float(a6),
            "scale_error": abs(float(al.s) - 1.0),
            "traj_len_m": float(np.linalg.norm(np.diff(gt, axis=0),
                                               axis=-1).sum())}


def jax_rig():
    """chip_smoke's EuRoC stereo rig as JAX cameras and T_body_cam."""
    from svo_pro_universal_tpu.utils.transform import SE3
    tcams, Tb = syn.euroc_stereo_rig()
    cams = [Camera(c.projection, c.distortion, c.intrinsics.numpy(),
                   c.dist_params.numpy(), c.width, c.height, c.label)
            for c in tcams]
    Ts = []
    for T in Tb:
        p = cs.se3_of(T)
        Ts.append(SE3(jnp.asarray(p.q.numpy()), jnp.asarray(p.t.numpy())))
    return tcams, Tb, cams, Ts


def stereo(phase: str, n: int, structure_pts: int | None) -> dict:
    """The JAX stereo (VIO) pipeline on chip_smoke's stereo input, one JSON
    line a frame; returns the summary."""
    from svo_pro_universal_tpu.frontend.pipeline_stereo import (
        DevicePipelineStereo)
    from svo_pro_universal_tpu.frontend.pipeline_stereo_vio import (
        DevicePipelineStereoVIO)
    tcams, Tb, cams, Ts = jax_rig()
    poses, views, imu_meas = syn.rig_sequence(n, tcams, Tb, cs.STEREO_SEEDS)
    cfg = jax_config()
    pcfg = cs.stereo_config()
    cfg.pipeline_is_stereo = True
    cfg.base.kfselect_numkfs_upper_thresh = (
        pcfg.base.kfselect_numkfs_upper_thresh)
    if structure_pts is not None:
        cfg.base.structure_optimization_max_pts = structure_pts
    imu = ImuHandler(ImuParams())
    if phase == "stereo_vio":
        h = DevicePipelineStereoVIO(cfg, cams[0], cams[1], Ts[0], Ts[1],
                                    imu_handler=imu, imu_params=ImuParams(),
                                    trace_capacity=n + 1)
    else:
        h = DevicePipelineStereo(cfg, cams[0], cams[1], Ts[0], Ts[1],
                                 trace_capacity=n + 1)
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    i = 0
    for t in range(n):
        ts = t * syn.CAM_DT
        while i < len(imu_meas) and imu_meas[i][0] <= ts:
            imu.add_measurement(*imu_meas[i])
            i += 1
        h.add_image_pair(np.asarray(views[t][0]), np.asarray(views[t][1]),
                         ts)
        w = h.world
        m = np.asarray(w.trace_meta)[t]
        pos = np.asarray(w.trace_t)[t]
        rec = {"k": t, "stage": int(m[0]), "n_tracked": int(m[1]),
               "kf": int(m[2]),
               "err_m": float(np.linalg.norm(pos - (gt[t] - gt[0])))}
        if phase == "stereo_vio":
            rec["backend_k"] = int(w.backend_k)
        print(json.dumps(rec), flush=True)
    mats, meta = h.drain()
    st = meta[:, 0].astype(int)
    first = int(np.argmax(st == TRACKING))
    est = mats[first:, :3, 3]
    g = gt[first:]
    warmup = cs.RIG_WARMUP
    return {"n_tracking": int((st[warmup:] == TRACKING).sum()),
            "n_timed": n - warmup, "first_tracking_frame": first,
            "keyframes_after_first": int(meta[1:, 2].sum()),
            "ate_unaligned_m": cs.unaligned_ate(est, g),
            "ate_se3_m": float(ate_rmse(est, g, align="se3")[0]),
            "traj_len_m": float(np.linalg.norm(np.diff(g, axis=0),
                                               axis=-1).sum())}


def stepwise(cam, imu) -> None:
    import torch
    from svo_pro_universal_tpu_torch import convert
    from svo_pro_universal_tpu_torch.cameras.projections import (
        Camera as TCamera)
    from test_torch_init import _JaxNoise, init_noise_of
    from torch_parity_utils import rotation_angle_deg, to_dict
    n = syn.LOOP_FRAMES
    so = cs.slam_options()
    _, frames, imu_meas = syn.bench_sequence(
        n, syn.LOOP_DEGRADE_SEED, "cpu", twist_fn=syn.loop_twist)
    frames = [np.asarray(f) for f in frames]
    h = DevicePipelineSLAM(jax_config(), cam, imu_handler=imu,
                           imu_params=ImuParams(), trace_capacity=n + 1,
                           slam_opts=SlamOptions(**so._asdict()))
    cfg = cs.vio_config()
    cfg.backend.zupt_require_rest = False
    run = cs.VioRun(TCamera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W,
                                    syn.BENCH_H), cfg, imu_meas, "cpu", n,
                    slam_opts=so)
    pipe = run.pipe
    pipe.backend.opts = pipe.backend.opts._replace(void_on_single_view=True)
    jw = {}
    noise = _JaxNoise(pipe, lambda k: init_noise_of(jw, pipe.max_fts))
    recs, i = [], 0
    for k in range(n):
        ts = k * syn.CAM_DT
        while i < len(imu_meas) and imu_meas[i][0] <= ts:
            imu.add_measurement(*imu_meas[i])
            run.imu.add_measurement(*imu_meas[i])
            i += 1
        jw0 = to_dict(h.world)
        jw.clear()
        jw.update(jw0)
        noise.frame = k
        pipe.world = convert.world_slam(jw0, "cpu")
        h.add_image(frames[k], ts)
        pipe.add_image(frames[k], ts)
        jw1, w = to_dict(h.world), pipe.world
        m, jm = w.trace_meta[w.trace_ptr - 1], np.asarray(jw1["trace_meta"])[k]
        Tj = convert.SE3(*(torch.from_numpy(np.array(jw1[f][k]))
                           for f in ("trace_q", "trace_t"))).as_matrix()
        T = w.last_frame.T_world_cam.as_matrix()
        rec = {"k": k, "stage": [w.stage, int(jw1["stage"])],
               "kf": [int(m[2]), int(jm[2])], "n_tracked": [int(m[1]),
                                                           int(jm[1])],
               "gap_m": float(torch.linalg.norm(T[:3, 3] - Tj[:3, 3])),
               "angle_deg": rotation_angle_deg(T[:3, :3].numpy(),
                                               Tj[:3, :3].numpy()),
               "pgo_n": [w.pgo_n, int(jw1["pgo_n"])],
               "n_loops": [w.n_loops, int(jw1["n_loops"])],
               "lc_diag": [w.lc_diag[:4].tolist(),
                           np.asarray(jw1["lc_diag"])[:4].tolist()]}
        if int(jw1["lc_n"]) > int(jw0["lc_n"]):
            r = (int(jw1["lc_n"]) - 1) % so.max_db_keyframes
            rec |= {"snap_px_gap": float(np.abs(
                w.lc_px[r].numpy() - jw1["lc_px"][r]).max()),
                "snap_depth_gap": float(np.abs(
                    w.lc_depth[r].numpy() - jw1["lc_depth"][r]).max()),
                "snap_valid_equal": bool(np.array_equal(
                    w.lc_fvalid[r].numpy(), jw1["lc_fvalid"][r])),
                "descriptor_cos": float(w.lc_desc[r].numpy()
                                        @ jw1["lc_desc"][r])}
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    boot = next(r["k"] for r in recs if r["stage"][1] == TRACKING)
    same = all(r[f][0] == r[f][1] for r in recs
               for f in ("stage", "kf", "pgo_n", "n_loops", "lc_diag"))
    kf = [r for r in recs if "descriptor_cos" in r]
    print(json.dumps({
        "summary": "stepwise", "frames": n, "bootstrap_frame": boot,
        "stage_kf_nodes_loops_verification_equal": same,
        "n_tracked_max_diff": max(abs(r["n_tracked"][0] - r["n_tracked"][1])
                                  for r in recs),
        "bootstrap_gap_m": recs[boot]["gap_m"],
        "gap_m_max_after": max(r["gap_m"] for r in recs[boot + 1:]),
        "angle_deg_max_after": max(r["angle_deg"] for r in recs[boot + 1:]),
        "verifications": [[r["k"]] + r["lc_diag"][1] for r in recs
                          if r["lc_diag"][1][0] > (recs[r["k"] - 1]["lc_diag"]
                                                   [1][0] if r["k"] else 0)],
        "keyframes": len(kf),
        "snap_px_gap_max": max(r["snap_px_gap"] for r in kf),
        "snap_depth_gap_max": max(r["snap_depth_gap"] for r in kf),
        "snap_valid_equal": all(r["snap_valid_equal"] for r in kf),
        "descriptor_cos_min": min(r["descriptor_cos"] for r in kf)}),
        flush=True)


def _num(x):
    return None if x is None else float(x)


def host(phase: str, cam, imu, t0: float = 0.0, n: int | None = None,
         port: bool = False) -> dict:
    """The JAX host handler of ``phase`` (``port``: the port's, for
    ``host_vio``) on chip_smoke's input (``host_vio`` on its first ``n``
    frames, all by default), one JSON line a frame, its stamps offset by
    ``t0``; returns the summary."""
    from svo_pro_universal_tpu.backend.loop_closing import LoopClosingOptions
    from svo_pro_universal_tpu.frontend.frame_handler import FrameHandlerVIO
    from svo_pro_universal_tpu.frontend.slam import FrameHandlerSLAM
    if phase == "host_vio":
        n, warmup = n or cs.VIO_FRAMES, cs.VIO_WARMUP
        poses, frames, imu_meas = syn.bench_sequence(n, 7, "cpu")
        h = (cs.host_vio_run(cs.Camera.pinhole(*syn.BENCH_INTRINSICS,
                                               syn.BENCH_W, syn.BENCH_H),
                             cs.vio_config(), [], "cpu").h if port
             else FrameHandlerVIO(jax_config(), cam, imu_handler=imu,
                                  imu_params=ImuParams()))
    else:
        n, warmup = syn.LOOP_FRAMES, cs.SLAM_WARMUP
        poses, frames, imu_meas = syn.bench_sequence(
            n, syn.LOOP_DEGRADE_SEED, "cpu", twist_fn=syn.loop_twist)
        so = cs.slam_options()
        h = FrameHandlerSLAM(jax_config(), cam, lc_opts=LoopClosingOptions(
            min_temporal_gap=so.min_temporal_gap,
            min_similarity=so.min_similarity, min_inliers=so.min_inliers))
        imu_meas = []
    i, mats, stages, n_kf = 0, [], [], 0
    for t in range(n):
        ts = t * syn.CAM_DT
        while i < len(imu_meas) and imu_meas[i][0] <= ts:
            tm, g, a = imu_meas[i]
            h.add_imu_measurement(t0 + tm, g, a)
            i += 1
        res = h.add_image(np.asarray(frames[t]), t0 + ts)
        mats.append(np.asarray(res.T_world_cam))
        stages.append(res.stage.value)
        n_kf += int(res.is_keyframe and t > 0)
        rec = {"k": t, "stage": res.stage.value, "n_tracked": res.n_tracked,
               "kf": int(res.is_keyframe)}
        if phase == "host_vio":
            rec |= {"backend_k": h.backend.n_states,
                    "backend_chi2": _num(h.stats.get("backend_chi2"))}
        else:
            rec |= {"pgo_n": h._pgo_n, "loops": h.n_loops_closed}
        print(json.dumps(rec), flush=True)
    mats, st = np.stack(mats), np.asarray(stages)
    first = int(np.argmax(st == TRACKING))
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])[first:]
    a3, al = ate_rmse(mats[first:, :3, 3], gt, align="sim3")
    out = {"n_tracking": int((st[warmup:] == TRACKING).sum()),
           "n_timed": n - warmup, "first_tracking_frame": first,
           "keyframes_after_first": n_kf, "ate_m": float(a3),
           "scale_error": abs(float(al.s) - 1.0),
           "traj_len_m": float(np.linalg.norm(np.diff(gt, axis=0),
                                              axis=-1).sum())}
    if phase == "host_vio":
        out |= {"backend_states": h.backend.n_states,
                "backend_chi2": _num(h.stats.get("backend_chi2"))}
    else:
        gm = h.global_map
        out |= {"n_loops_closed": h.n_loops_closed, "pgo_nodes": h._pgo_n,
                "gm_states": len(gm),
                "gm_landmarks": int(np.asarray(gm.window.lm_valid).sum()),
                "fixed_landmarks": int(np.asarray(h.pool.fixed).sum())}
    return out


def euroc_mono(n: int, cam) -> dict:
    """The JAX FrameHandlerMono with examples/param/pinhole.yaml on the
    first ``n`` frames of the vio input at EuRoC-epoch stamps."""
    from svo_pro_universal_tpu.config import load_config
    from svo_pro_universal_tpu.frontend.frame_handler import FrameHandlerMono
    poses, frames, _ = syn.bench_sequence(n, 7, "cpu")
    root = Path(__file__).resolve().parents[1]
    h = FrameHandlerMono(load_config(str(root / "examples" / "param"
                                         / "pinhole.yaml")), cam)
    t0 = cs.EUROC_T0_NS * 1e-9
    stages, mats, relocs = [], [], 0
    for t in range(n):
        res = h.add_image(np.asarray(frames[t]), t0 + t * syn.CAM_DT)
        stages.append(res.stage.value)
        mats.append(np.asarray(res.T_world_cam))
        relocs += int(res.stage.name == "RELOCALIZING")
        print(json.dumps({"k": t, "stage": res.stage.value,
                          "n_tracked": res.n_tracked,
                          "kf": int(res.is_keyframe)}), flush=True)
    st = np.asarray(stages)
    tr = np.nonzero(st == TRACKING)[0]
    out = {"frames": n, "n_tracking_after_warmup": int(
        (st[cs.EUROC_WARMUP:] == TRACKING).sum()),
        "first_tracking_frame": int(tr[0]) if len(tr) else -1,
        "relocalizing_frames": relocs}
    if len(tr) > 3:
        gt = np.stack([np.linalg.inv(poses[k])[:3, 3] for k in tr])
        out["ate_m_tracked"] = float(ate_rmse(
            np.stack([mats[k][:3, 3] for k in tr]), gt, align="sim3")[0])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=("vio", "slam", "stepwise", "stereo",
                                      "stereo_vio", "host_vio", "host_slam",
                                      "euroc_mono"))
    ap.add_argument("--epoch", action="store_true",
                    help="EuRoC-epoch stamps for the host handlers")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--structure-pts", type=int, default=None)
    ap.add_argument("--solve", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--no-zupt", action="store_true")
    ap.add_argument("--port", action="store_true",
                    help="host_vio: the port's handler on the CPU")
    args = ap.parse_args()
    patch_solve(args.solve)
    if args.no_zupt:
        init = jdi.DeviceBackend.__init__

        def no_zupt(self, *a, **k):
            init(self, *a, **k)
            self.use_zupt = False
        jdi.DeviceBackend.__init__ = no_zupt
    cam = Camera.pinhole(*syn.BENCH_INTRINSICS, syn.BENCH_W, syn.BENCH_H)
    imu = ImuHandler(ImuParams())
    t0 = time.time()
    if args.phase == "stepwise":
        stepwise(cam, imu)
        return
    if args.phase == "euroc_mono":
        n = args.frames or cs.EUROC_MONO_FRAMES
        print(json.dumps({"phase": "euroc_mono", **euroc_mono(n, cam),
                          "seconds": time.time() - t0}), flush=True)
        return
    if args.phase in ("stereo", "stereo_vio", "host_vio", "host_slam"):
        t_epoch = cs.EUROC_T0_NS * 1e-9 if args.epoch else 0.0
        out = (host(args.phase, cam, imu, t_epoch, args.frames, args.port)
               if args.phase.startswith("host")
               else stereo(args.phase, args.frames or cs.RIG_FRAMES,
                           args.structure_pts))
        print(json.dumps({
            "phase": args.phase, "solve": args.solve,
            "zupt": not args.no_zupt, "structure_pts": args.structure_pts,
            "epoch_stamps": args.epoch, "package": ("port" if args.port
                                                    else "jax"),
            **out,
            "lm_iterations": STEPS["iterations"],
            "lm_zero_step_share": STEPS["zero"] / max(STEPS["iterations"],
                                                      1),
            "seconds": time.time() - t0}), flush=True)
        return
    if args.phase == "vio":
        n, warmup = cs.VIO_FRAMES, cs.VIO_WARMUP
        poses, frames, imu_meas = syn.bench_sequence(n, 7, "cpu")
        h = DevicePipelineVIO(jax_config(), cam, imu_handler=imu,
                              imu_params=ImuParams(), trace_capacity=n + 1)
    else:
        n, warmup = syn.LOOP_FRAMES, cs.SLAM_WARMUP
        poses, frames, imu_meas = syn.bench_sequence(
            n, syn.LOOP_DEGRADE_SEED, "cpu", twist_fn=syn.loop_twist)
        so = SlamOptions(**cs.slam_options()._asdict())
        h = DevicePipelineSLAM(jax_config(), cam, imu_handler=imu,
                               imu_params=ImuParams(), trace_capacity=n + 1,
                               slam_opts=so)
    feed(h, imu, frames, imu_meas)
    out = {"phase": args.phase, "solve": args.solve,
           "zupt": not args.no_zupt, **accuracy(h, poses, warmup),
           "lm_iterations": STEPS["iterations"],
           "lm_zero_step_share": STEPS["zero"] / max(STEPS["iterations"], 1),
           "seconds": time.time() - t0}
    if args.phase == "slam":
        out |= h.slam_stats()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
