"""Rank programs that drive the sharded paths, for the tests and the card.

Each step runs inside a rank started by ``parallel.mesh.launch`` (on the
CPU with gloo, or on the card), builds its mesh, calls a sharded entry
point, and returns what the caller compares with a one-device run, on the
CPU: results, wall ms, this rank's kernel launches (``_cuda.KERNELS``) and
collective bytes (``parallel.mesh.COMM_BYTES``) of the step alone. With
``repeats`` a step runs again in the same ranks, for a bit-for-bit
comparison. ``run_steps(device, steps)`` runs a list of steps in order, so
one spawn serves them all.

``global_map_feed`` is tests/test_global_map_dcn.py's keyframe feed.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from svo_pro_universal_tpu_torch.backend.global_map import GlobalMap
from svo_pro_universal_tpu_torch.ops import _cuda
from svo_pro_universal_tpu_torch.parallel import mesh as mesh_mod
from svo_pro_universal_tpu_torch.parallel import dryrun
from svo_pro_universal_tpu_torch.parallel.sharded_ba import (
    distributed_optimize, partition_observations)
from svo_pro_universal_tpu_torch.parallel.sharded_ops import (
    distributed_align, distributed_seed_update)
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, quat_conjugate, quat_rotate, so3_exp)


def make_mesh(shape: tuple, device) -> mesh_mod.Mesh:
    """A 1-D ``(f,)`` mesh for a 1-tuple, else ``(h, f)``."""
    if len(shape) == 1:
        return mesh_mod.make_mesh(shape[0], device=device)
    return mesh_mod.make_mesh_2d(*shape, device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(device, fn):
    """(fn(), {wall_ms, launches, comm_bytes, comm_calls}) of one call."""
    _sync(device)
    _cuda.reset_counts()
    mesh_mod.reset_comm_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, dict(
        wall_ms=(time.perf_counter() - t0) * 1e3,
        launches={k.name: k.launches for k in _cuda.KERNELS},
        comm_bytes=dict(mesh_mod.COMM_BYTES),
        comm_calls=dict(mesh_mod.COMM_CALLS))


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple):
        return type(x)(*(_cpu(v) for v in x))
    return x


def _fused_evaluate_device_ms(device, fn) -> dict:
    """torch.profiler over ``fn()``: the fused_evaluate entry's launches
    (its partials kernel) and device ms a launch (partials + reduce)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    n, t = 0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "fused_evaluate_partials" in e.key:
            n += e.count
            t += e.self_device_time_total
        elif "fused_evaluate_reduce" in e.key:
            t += e.self_device_time_total
    return dict(launches=n, device_ms_per_launch=t / 1e3 / n if n else None)


def align_step(device, shape, inp, state0, opts, repeats=1,
               profile=False) -> list[dict]:
    """``distributed_align`` ``repeats`` times: each run's pose, alpha,
    beta, chi2, n_tracked, iterations and counts; with ``profile`` (on the
    card) every rank runs once more, rank 0 under torch.profiler: its
    fused_evaluate device ms a launch."""
    mesh = make_mesh(shape, device)
    runs = []
    for _ in range(repeats):
        (st, stats), info = _timed(device, lambda: distributed_align(
            inp, state0, opts, mesh))
        runs.append(dict(q=_cpu(st.T_icur_iref.q), t=_cpu(st.T_icur_iref.t),
                         alpha=_cpu(st.alpha), beta=_cpu(st.beta),
                         chi2=_cpu(stats.chi2),
                         n_tracked=_cpu(stats.n_tracked),
                         iters=_cpu(stats.n_iter_total), **info))
    if profile:
        def again():
            return distributed_align(inp, state0, opts, mesh)
        if dist.get_rank() == 0:
            runs[-1]["profile"] = _fused_evaluate_device_ms(device, again)
        else:
            again()
            _sync(device)
    return runs


def seeds_step(device, shape, args, kwargs) -> dict:
    """``distributed_seed_update(*args, mesh, **kwargs)``: the whole seed
    state, types and counters."""
    mesh = make_mesh(shape, device)
    res, info = _timed(device, lambda: distributed_seed_update(
        *args, mesh=mesh, **kwargs))
    return dict(seed_state=_cpu(res.seed_state), ftype=_cpu(res.ftype),
                n_updated=int(res.n_updated), n_converged=int(res.n_converged),
                **info)


def ba_step(device, shape, w, T_cam_body, focal, opts, axes=("f",),
            repeats=1) -> list[dict]:
    """``distributed_optimize`` of a partitioned window ``repeats`` times:
    the states, landmarks, cost, voided iterations and counts."""
    mesh = make_mesh(shape, device)
    runs = []
    for _ in range(repeats):
        (wo, chi2, n_void), info = _timed(device, lambda: distributed_optimize(
            w, T_cam_body, focal, mesh, opts, axes))
        runs.append(dict(q=_cpu(wo.q), p=_cpu(wo.p), v=_cpu(wo.v),
                         lm_pos=_cpu(wo.lm_pos), lm_valid=_cpu(wo.lm_valid),
                         chi2=float(chi2), n_void=int(n_void), **info))
    return runs


def global_map_feed(gm, rng: np.random.Generator, lm: np.ndarray,
                    n_kf: int = 10):
    """tests/test_global_map_dcn.py's ``_feed``: ``n_kf`` keyframes moving
    0.15 m a step in x with noisy poses (σ 0.03 m) observing the landmarks
    ``lm`` in front of them (noisy positions, σ 0.02 m). Returns (the last
    solve's chi2, true positions [n_kf, 3])."""
    chi2 = None
    true_p = []
    for k in range(n_kf):
        tw = torch.tensor([0.15 * k, 0.05 * np.sin(k), 0.02 * k,
                           0.0, 0.02 * k, 0.01 * k], dtype=torch.float32)
        T_w_b = SE3(so3_exp(tw[3:]), tw[:3])
        true_p.append(T_w_b.t.numpy().copy())
        dp = (rng.normal(0, 0.03, 3).astype(np.float32)
              if k > 0 else np.zeros(3, np.float32))
        T_cam_world = SE3(T_w_b.q, T_w_b.t + torch.as_tensor(dp)).inverse()
        pb = quat_rotate(quat_conjugate(T_w_b.q),
                         torch.as_tensor(lm) - T_w_b.t[None])
        f = (pb / torch.linalg.norm(pb, dim=-1, keepdim=True)).numpy()
        lids = np.where((pb[:, 2] > 0.3).numpy(), np.arange(len(lm)), -1)
        lm_noisy = lm + rng.normal(0, 0.02, lm.shape).astype(np.float32)
        out = gm.add_keyframe(k, T_cam_world, lids, f, lm_noisy)
        chi2 = out if out is not None else chi2
    return chi2, np.stack(true_p)


def global_map_step(device, shape, opts, lm, n_kf, axes=None,
                    probe_shards=None, spread_slots=False) -> dict:
    """A ``GlobalMap`` (on the mesh when ``shape`` is given, else on one
    device; ``spread_slots`` as its option) fed ``n_kf`` keyframes, then
    ``force_optimize``: poses, landmarks by id, chi2, ``last_dropped_obs``
    and its warnings (the feed of test_global_map_dcn.py: focal 300, seed
    11). With ``probe_shards``, also the rows ``partition_observations``
    would drop from the final window over that many shards."""
    mesh = None if shape is None else make_mesh(shape, device)
    gm = GlobalMap(300.0, SE3.identity(), opts, mesh=mesh, mesh_axes=axes,
                   device=device, spread_slots=spread_slots)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (_, true_p), feed = _timed(device, lambda: global_map_feed(
            gm, np.random.default_rng(11), lm, n_kf))
        chi2, info = _timed(device, gm.force_optimize)
    poses, kf_ids = gm.keyframe_poses()
    ids, pos = gm.optimized_landmarks()
    probe = (None if probe_shards is None else
             partition_observations(gm.window, probe_shards)[1])
    return dict(poses=poses, kf_ids=kf_ids, lm_ids=ids, lm_pos=pos,
                chi2=chi2, true_p=true_p,
                last_dropped_obs=gm.last_dropped_obs,
                drop_warnings=[str(w.message) for w in caught
                               if "dropped" in str(w.message)],
                probe_dropped=probe, feed_wall_ms=feed["wall_ms"], **info)


def global_map_slots_step(device, shape, opts, lm, n_kf, shards, axes=None,
                          spread_slots=False) -> dict:
    """A ``GlobalMap`` on the mesh (``spread_slots`` as its option) fed
    ``n_kf`` keyframes of ``global_map_feed``, with no solve when
    ``opts.optimize_every`` > ``n_kf``: its slot of each landmark id, and
    the rows ``partition_observations`` drops from its window over
    ``shards`` shards."""
    gm = GlobalMap(300.0, SE3.identity(), opts,
                   mesh=make_mesh(shape, device), mesh_axes=axes,
                   device=device, spread_slots=spread_slots)
    global_map_feed(gm, np.random.default_rng(11), lm, n_kf)
    return dict(lid2slot=dict(gm.lid2slot),
                dropped=partition_observations(gm.window, shards)[1])


def dryrun_step(device, n) -> dict:
    """``parallel.dryrun``'s steps in these ranks."""
    out, info = _timed(device, lambda: dryrun.dryrun_steps(n, device))
    return dict(result=out, **info)


STEPS = {"align": align_step, "seeds": seeds_step, "ba": ba_step,
         "global_map": global_map_step,
         "global_map_slots": global_map_slots_step, "dryrun": dryrun_step}


def run_steps(device, steps: list) -> dict:
    """Run ``[(name, kwargs), ...]`` in order in this rank, on ``device``
    (None: the rank's card, ``mesh.rank_device``); returns
    ``{name: result}`` (a name repeated gets ``name#2``, ...). TF32 is
    off, as in chip_smoke.py (a TF32 depthwise conv2d moves the seed
    update's ZMSSD argmin)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh_mod.rank_device(device)
    out = {}
    for name, kwargs in steps:
        key = name
        k = 2
        while key in out:
            key = f"{name}#{k}"
            k += 1
        out[key] = STEPS[name](device, **kwargs)
    return out
