"""Map checkpoint and restore, and the map as a YAML document.

Counterpart of ``svo_pro_universal_tpu/io.py`` (the reference only dumps
keyframes and points to YAML, src/svo/src/io.cpp:22-198 saveMap/loadMap).
``save_state`` writes a host handler's device state (keyframe ring,
landmark pool, last frame, depth state) and its host scalars as one NPZ in
the JAX package's layout: the leaves of ``ring``, ``pool`` and
``last_frame`` in field order as ``ring.i`` / ``pool.i`` / ``last_frame.i``
(an ``SE3`` is its ``q`` then its ``t``), ``_depth_state`` and the JSON
``__meta__``, with the JAX package's dtypes (int32 ids and counters, bool
masks, float32 values). So a checkpoint of either package restores into
the other. The port adds what a resumed run needs to continue exactly as
the uninterrupted one: the constant-velocity prior (``T_rel_prev.0/.1``),
the RANSAC generator's state (``_rng_state``) and, in the meta,
``last_ts``, ``prev_n_tracked`` and ``reloc_trials``; the JAX package
ignores them, and a JAX checkpoint leaves them as the handler had them.

A checkpoint holds the frontend only: a ``FrameHandlerVIO``'s window
backend and a handler in the middle of its two-view initialization (its
first keyframe's KLT tracks) are not in it, as in the JAX package.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from svo_pro_universal_tpu_torch.utils import yaml_lite
from svo_pro_universal_tpu_torch.utils.transform import SE3

STATE_PARTS = ("ring", "pool", "last_frame")


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a (named) tuple tree in field order."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(template, values: list):
    """A tree shaped as ``template`` from its leaves (consumed in order)."""
    if isinstance(template, tuple):
        parts = [unflatten(v, values) for v in template]
        return type(template)(*parts) if hasattr(template, "_fields") \
            else tuple(parts)
    return values.pop(0)


def _to_saved(x: torch.Tensor) -> np.ndarray:
    """A leaf in the JAX package's dtype (int64 → int32)."""
    a = x.detach().cpu().numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _restored(a: np.ndarray, like: torch.Tensor, name: str) -> torch.Tensor:
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {name} has shape {a.shape}, the "
                         f"handler's {tuple(like.shape)}: capacities differ")
    return torch.from_numpy(np.array(a)).to(like.device, like.dtype)


def save_state(path: str, handler) -> None:
    """Snapshot a host handler's device state and host scalars."""
    arrays: dict[str, Any] = {}
    for name in STATE_PARTS:
        obj = getattr(handler, name)
        if obj is None:
            continue
        for i, leaf in enumerate(leaves(obj)):
            arrays[f"{name}.{i}"] = _to_saved(leaf)
    arrays["_depth_state"] = _to_saved(handler._depth_state)
    arrays["T_rel_prev.0"] = _to_saved(handler.T_rel_prev.q)
    arrays["T_rel_prev.1"] = _to_saved(handler.T_rel_prev.t)
    arrays["_rng_state"] = handler.rng.get_state().numpy()
    meta = dict(
        stage=handler.stage.name,
        frame_count=handler.frame_count,
        frames_since_kf=handler.frames_since_kf,
        depth_median=handler.depth_median,
        depth_min=handler.depth_min,
        last_ts=handler._last_ts,
        prev_n_tracked=handler._prev_n_tracked,
        reloc_trials=handler.reloc_trials,
    )
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_state(path: str, handler) -> None:
    """Restore a snapshot (of either package) into a handler with the same
    capacities."""
    from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    if handler.last_frame is None and "last_frame.0" in data:
        # a template frame with the right structure and shapes
        handler.last_frame = handler._make_frame(
            np.zeros((handler.cam.height, handler.cam.width), np.uint8),
            0.0, frame_id=meta["frame_count"])
    for name in STATE_PARTS:
        obj = getattr(handler, name)
        if obj is None or f"{name}.0" not in data:
            continue
        tmpl = leaves(obj)
        values = [_restored(data[f"{name}.{i}"], like, f"{name}.{i}")
                  for i, like in enumerate(tmpl)]
        setattr(handler, name, unflatten(obj, values))
    handler._depth_state = _restored(data["_depth_state"],
                                     handler._depth_state, "_depth_state")
    handler.stage = Stage[meta["stage"]]
    handler.frame_count = meta["frame_count"]
    handler.frames_since_kf = meta["frames_since_kf"]
    handler.depth_median = meta["depth_median"]
    handler.depth_min = meta["depth_min"]
    if "T_rel_prev.0" in data:
        T = handler.T_rel_prev
        handler.T_rel_prev = SE3(
            _restored(data["T_rel_prev.0"], T.q, "T_rel_prev.0"),
            _restored(data["T_rel_prev.1"], T.t, "T_rel_prev.1"))
    if "_rng_state" in data:
        handler.rng.set_state(torch.from_numpy(np.array(data["_rng_state"])))
    for key, attr in (("last_ts", "_last_ts"),
                      ("prev_n_tracked", "_prev_n_tracked"),
                      ("reloc_trials", "reloc_trials")):
        if key in meta:
            setattr(handler, attr, meta[key])


def export_map_yaml(path: str, handler) -> None:
    """Keyframe poses and valid landmarks as a YAML document (the
    reference's saveMap shape, io.cpp:22-100): ``keyframes`` (slot,
    frame_id, q_cam_world, t_cam_world) and ``points`` (id, pos)."""
    ring, pool = handler.ring, handler.pool
    valid = ring.valid.cpu().numpy()
    q = ring.frames.T_cam_world.q.cpu().numpy()
    t = ring.frames.T_cam_world.t.cpu().numpy()
    fid = ring.frames.frame_id.cpu().numpy()
    kfs = [dict(slot=int(k), frame_id=int(fid[k]),
                q_cam_world=[float(v) for v in q[k]],
                t_cam_world=[float(v) for v in t[k]])
           for k in range(ring.capacity) if valid[k]]
    pv = pool.valid.cpu().numpy()
    pos = pool.pos.cpu().numpy()
    ids = pool.ids.cpu().numpy()
    pts = [dict(id=int(ids[i]), pos=[float(v) for v in pos[i]])
           for i in np.nonzero(pv)[0]]
    yaml_lite.dump_file(path, dict(keyframes=kfs, points=pts))
