"""What decides ``correct``: the numbers the reference reads off a run, and
their limits.

``capture`` copies off the program, once the window has closed, what the
numbers need: the pose trace, the backend window and the sampled kernel
calls and window solves. ``judge`` works out each number
with the plain reference (``reference.py``) and the scene's ground truth
(``scene.py``); ``verdict`` holds each to ``limits/<workload>.json``.

With ``control=True`` the kernel and backend-cost numbers are worked out
with the reference, run in TF32 (the precision just below the
configuration's), standing in the program's place: the control that the
limits must fail. The reference has no window solve of its own, so
``backend_kept`` stays the program's there.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import reference as ref
from port_bench import scene
from port_bench.spans import to_cpu


def _cpu(x):
    return x.detach().cpu() if torch.is_tensor(x) else x


def capture(pipe, counts, sampler, world0: dict, w0: int, n_window: int,
            tracking: int) -> dict:
    """The program's outputs and state that the checks read, on the host
    (``tracking`` is the port's code of the TRACKING stage)."""
    w = pipe.world
    mats, meta = pipe.drain()
    be = pipe.backend
    win = w.backend.window
    st = dict(
        w0=w0, n_window=n_window, trace0=world0["trace_ptr"],
        tracking=tracking,
        trace_ptr=w.trace_ptr, mats=mats, meta=meta,
        window={k: _cpu(getattr(win, k)) for k in (
            "q", "p", "state_valid", "lm_pos", "lm_valid", "obs_state",
            "obs_lm", "obs_f", "obs_valid")},
        backend_chi2=float(w.backend_chi2), backend_k=w.backend_k,
        T_cam_body=(_cpu(be.T_cam_body.q), _cpu(be.T_cam_body.t)),
        focal=float(be.focal), pixel_sigma=float(be.opts.pixel_sigma),
        huber=float(be.opts.huber_reproj),
        backend_frames=list(counts.backend_frames),
        samples=to_cpu(dict(sampler.samples)),
        calls=dict(sampler.calls))
    is_kf = meta[world0["trace_ptr"]:, 2] > 0.5
    stages = meta[world0["trace_ptr"]:, 0].astype(int)
    st["counts"] = dict(
        frames=n_window, keyframes=int(is_kf.sum()),
        backend_calls=len(counts.backend_frames) - world0["backend_calls"],
        frames_lost=int((stages != tracking).sum()),
        kernel_calls=dict(sampler.calls),
        kernel_samples={k: len(v) for k, v in sampler.samples.items()})
    lost = np.flatnonzero(stages[:n_window] != tracking) + w0
    st["lost_frames"] = lost[:20].tolist()
    if len(lost):
        # (frame, stage, tracked, keyframe) around the first frame lost
        i = int(lost[0]) - w0 + world0["trace_ptr"]
        rows = meta[max(i - 6, 0):i + 3]
        st["lost_context"] = [[int(lost[0]) - (i - max(i - 6, 0)) + k,
                               *[int(v) for v in row[:3]]]
                              for k, row in enumerate(rows)]
    return st


def _centres(T_cam_world: np.ndarray) -> np.ndarray:
    return np.linalg.inv(T_cam_world)[:, :3, 3]


def judge(st: dict, config: dict, traffic: dict,
          control: bool = False) -> dict:
    """Every number of the cell (None where there was nothing to read)."""
    rnd = ref.tf32 if control else None
    w0, n = st["w0"], st["n_window"]
    t0 = st["trace0"]
    out = {"trace_gap": abs((st["trace_ptr"] - t0) - n)}
    mats = st["mats"][t0:t0 + n]
    meta = st["meta"][t0:t0 + n]
    # a frame with no trace entry counts as lost
    tracked = int((meta[:, 0].astype(int) == st["tracking"]).sum())
    out["lost_share"] = 1.0 - tracked / n if n else 1.0
    gt = _centres(scene.poses(traffic, np.arange(w0, w0 + len(mats))))
    est = mats[:, :3, 3].astype(np.float64)
    out["ate_mm"] = (ref.ate(est, gt)[0] * 1e3
                     if len(est) >= 3 and np.all(np.isfinite(mats)) else None)

    win = st["window"]
    chi2_ref = ref.window_visual_chi2(win, st["T_cam_body"], st["focal"],
                                      st["pixel_sigma"], st["huber"])
    chi2_prog = (ref.window_visual_chi2(win, st["T_cam_body"], st["focal"],
                                        st["pixel_sigma"], st["huber"],
                                        rnd) if control
                 else st["backend_chi2"])
    out["backend_chi2_gap"] = (abs(chi2_prog - chi2_ref)
                               / max(abs(chi2_ref), 1e-300)
                               if np.isfinite(chi2_prog) else float("inf"))

    sm = st["samples"]
    gs = [(s, False) for s in sm.get("extract_tiles", [])] + \
         [(s, True) for s in sm.get("extract_tiles_ring", [])]
    out["gather_mismatches"] = (sum(
        ref.gather_mismatches(s, ring, rnd or ref._identity)
        for s, ring in gs) if gs else None)
    al = sm.get("align_level", [])
    out["align_chi2_gap"] = (max(ref.align_gap(s, rnd) for s in al)
                             if al else None)
    out["align_shortfall"] = (max(ref.align_shortfall(s, rnd) for s in al)
                              if al else None)
    sol = sm.get("optimize", [])
    out["backend_kept"] = ref.solve_kept(sol) if sol else None
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """True when every limited number was read and is within its limit."""
    for name, lim in limits.items():
        v = numbers.get(name)
        if v is None or not np.isfinite(v) or v > lim["max"]:
            return False
    return True
