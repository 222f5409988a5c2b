"""State carried between the JAX package and the port.

The JAX package's state is a tree of NamedTuples of arrays. Given as nested
dicts of numpy arrays keyed by the JAX field names (an SE3 is
``{"q": ..., "t": ...}``, a Camera is its constructor fields, a Config is
``dataclasses.asdict``), these functions build the port's objects on a
device, and ``to_numpy`` turns the port's objects back into such dicts. This
is what lets a test start both implementations from the same world state.

Integer arrays become int64 tensors here and int32 arrays on the way back
(the JAX package's index type); floats are float32. The JAX world's PRNG
key has no counterpart: the port's world carries a seeded CPU
``torch.Generator`` instead, and tests that need the JAX draws inject the
JAX noise (frontend.initialization). Host-side counters of the port (stage,
window and buffer counts, keyframe clocks) are Python scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend.device_interface import (
    DeviceBackendState)
from svo_pro_universal_tpu_torch.backend.imu_factor import PreintFactor
from svo_pro_universal_tpu_torch.backend.pgo import PoseGraph
from svo_pro_universal_tpu_torch.backend.window_ba import Window
from svo_pro_universal_tpu_torch.cameras.projections import Camera
from svo_pro_universal_tpu_torch.cameras.rig import ImuParams
from svo_pro_universal_tpu_torch.common.frame import FrameState
from svo_pro_universal_tpu_torch.common.point import LandmarkPool
from svo_pro_universal_tpu_torch.config import Config
from svo_pro_universal_tpu_torch.frontend.map import KeyframeRing
from svo_pro_universal_tpu_torch.frontend.pipeline import WorldState
from svo_pro_universal_tpu_torch.frontend.pipeline_array import (
    WorldStateArray)
from svo_pro_universal_tpu_torch.frontend.pipeline_slam import (
    SlamOptions, WorldStateSLAM)
from svo_pro_universal_tpu_torch.frontend.pipeline_stereo import (
    WorldStateStereo)
from svo_pro_universal_tpu_torch.frontend.pipeline_stereo_vio import (
    WorldStateStereoVIO)
from svo_pro_universal_tpu_torch.frontend.pipeline_vio import WorldStateVIO
from svo_pro_universal_tpu_torch.utils.transform import SE3


def tensor(a, device=None) -> torch.Tensor:
    """numpy → tensor: integers to int64, floats to float32, bools kept."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        t = torch.from_numpy(a.copy())
    elif np.issubdtype(a.dtype, np.integer):
        t = torch.from_numpy(a.astype(np.int64))
    else:
        t = torch.from_numpy(a.astype(np.float32))
    return t.to(device)


def se3(d: Mapping, device=None) -> SE3:
    return SE3(tensor(d["q"], device), tensor(d["t"], device))


def camera(d: Mapping, device=None) -> Camera:
    return Camera(int(d["projection"]), int(d["distortion"]),
                  np.array(d["intrinsics"], np.float32),
                  np.array(d["dist_params"], np.float32),
                  int(d["width"]), int(d["height"]), d.get("label", "cam"),
                  device=device)


def config(d: Mapping) -> Config:
    """A Config with the field values of ``dataclasses.asdict(jax_cfg)``."""
    cfg = Config()
    for name, val in d.items():
        cur = getattr(cfg, name)
        if dataclasses.is_dataclass(cur):
            for k, v in val.items():
                setattr(cur, k, v)
        else:
            setattr(cfg, name, val)
    return cfg


def frame(d: Mapping, device=None) -> FrameState:
    return FrameState(**{
        k: se3(d[k], device) if k in ("T_cam_world", "T_cam_body")
        else tensor(d[k], device) for k in FrameState._fields})


def ring(d: Mapping, device=None) -> KeyframeRing:
    return KeyframeRing(frame(d["frames"], device),
                        tensor(d["valid"], device),
                        tensor(d["last_added"], device))


def pool(d: Mapping, device=None) -> LandmarkPool:
    return LandmarkPool(**{k: tensor(d[k], device)
                           for k in LandmarkPool._fields})


def world(d: Mapping, device=None, seed: int = 0) -> WorldState:
    """A port WorldState from a JAX ``WorldState`` dict; the RANSAC
    generator is seeded with ``seed``."""
    return WorldState(
        stage=int(d["stage"]),
        ring=ring(d["ring"], device),
        pool=pool(d["pool"], device),
        last_frame=frame(d["last_frame"], device),
        init_ref=frame(d["init_ref"], device),
        init_px=tensor(d["init_px"], device),
        T_rel_prev=se3(d["T_rel_prev"], device),
        depth_state=tensor(d["depth_state"], device),
        frames_since_kf=int(d["frames_since_kf"]),
        prev_n_tracked=int(d["prev_n_tracked"]),
        reloc_trials=int(d["reloc_trials"]),
        rng=torch.Generator().manual_seed(seed),
        trace_q=tensor(d["trace_q"], device),
        trace_t=tensor(d["trace_t"], device),
        trace_meta=np.asarray(d["trace_meta"], np.float32).copy(),
        trace_ptr=int(d["trace_ptr"]))


def preint_factor(d: Mapping, device=None) -> PreintFactor:
    return PreintFactor(**{k: tensor(d[k], device)
                           for k in PreintFactor._fields})


def window(d: Mapping, device=None) -> Window:
    """A port backend Window from a JAX ``Window`` dict."""
    return Window(**{k: preint_factor(d[k], device) if k == "imu"
                     else tensor(d[k], device) for k in Window._fields})


def imu_params(d: Mapping) -> ImuParams:
    return ImuParams(**{k: d[k] for k in ImuParams.__dataclass_fields__})


def backend_state(d: Mapping, device=None) -> DeviceBackendState:
    """A port DeviceBackendState from a JAX one: the buffer count and clock
    become host scalars (the port branches on them on the host)."""
    host = {"abuf_n": int, "next_age": int,
            "abuf_last_ts": np.float32}
    out = {}
    for k in DeviceBackendState._fields:
        if k == "window":
            out[k] = window(d[k], device)
        elif k == "abuf_imu":
            out[k] = preint_factor(d[k], device)
        elif k in host:
            out[k] = host[k](np.asarray(d[k]))
        else:
            out[k] = tensor(d[k], device)
    return DeviceBackendState(**out)


def _vio_extras(d: Mapping, device) -> dict:
    """The VIO fields of a JAX world dict (WorldStateVIO's names)."""
    return dict(backend=backend_state(d["backend"], device),
                backend_k=int(d["backend_k"]),
                last_kf_ts=np.float32(d["last_kf_ts"]),
                imu_packed=tensor(d["imu_packed"], device),
                backend_chi2=tensor(d["backend_chi2"], device))


def world_vio(d: Mapping, device=None, seed: int = 0) -> WorldStateVIO:
    """A port WorldStateVIO from a JAX ``WorldStateVIO`` dict."""
    return WorldStateVIO(*world(d, device, seed), **_vio_extras(d, device))


def world_stereo(d: Mapping, device=None, seed: int = 0) -> WorldStateStereo:
    """A port WorldStateStereo from a JAX ``WorldStateStereo`` dict."""
    return WorldStateStereo(*world(d, device, seed),
                            pyr1_cur=tensor(d["pyr1_cur"], device),
                            pyr1_prev=tensor(d["pyr1_prev"], device))


def world_stereo_vio(d: Mapping, device=None, seed: int = 0
                     ) -> WorldStateStereoVIO:
    """A port WorldStateStereoVIO from a JAX ``WorldStateStereoVIO``
    dict."""
    return WorldStateStereoVIO(*world_stereo(d, device, seed),
                               **_vio_extras(d, device))


def world_array(d: Mapping, device=None, seed: int = 0) -> WorldStateArray:
    """A port WorldStateArray from a JAX ``WorldStateArray`` dict."""
    return WorldStateArray(*world(d, device, seed),
                           pyrs_cur=tensor(d["pyrs_cur"], device),
                           pyrs_prev=tensor(d["pyrs_prev"], device))


def pose_graph(d: Mapping, device=None) -> PoseGraph:
    return PoseGraph(**{k: tensor(d[k], device) for k in PoseGraph._fields})


def slam_options(d: Mapping) -> SlamOptions:
    """SlamOptions from the JAX package's (as a dict: ``_asdict()``)."""
    return SlamOptions(**{k: tuple(v) if isinstance(v, (list, tuple))
                          else v for k, v in d.items()})


def world_slam(d: Mapping, device=None, seed: int = 0) -> WorldStateSLAM:
    """A port WorldStateSLAM from a JAX ``WorldStateSLAM`` dict: the
    database, node and constraint counters and the loop count become host
    integers."""
    host = ("lc_n", "pgo_n", "pgo_c", "n_loops")
    extra = {}
    for k in WorldStateSLAM._fields[len(WorldStateVIO._fields):]:
        if k == "pgo":
            extra[k] = pose_graph(d[k], device)
        elif k in host:
            extra[k] = int(d[k])
        else:
            extra[k] = tensor(d[k], device)
    return WorldStateSLAM(*world_vio(d, device, seed), **extra)


def to_numpy(obj: Any) -> Any:
    """Port object → nested dict of numpy arrays under the JAX field names
    (integer tensors as int32)."""
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().numpy()
        return a.astype(np.int32) if a.dtype == np.int64 else a
    if isinstance(obj, Camera):
        return dict(projection=int(obj.projection),
                    distortion=int(obj.distortion),
                    intrinsics=to_numpy(obj.intrinsics),
                    dist_params=to_numpy(obj.dist_params),
                    width=obj.width, height=obj.height, label=obj.label)
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if isinstance(obj, torch.Generator):
        return None
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in zip(obj._fields, obj)}
    return obj


# ---------------------------------------------------------------------------
# the host handlers' state: the JAX handler's attributes, as numpy, written
# into a port handler (of the same configuration) on its device
# ---------------------------------------------------------------------------

def _opt(fn, v, device):
    return None if v is None else fn(v, device)


def host_mono(h, d: Mapping) -> None:
    """Write a JAX ``FrameHandlerMono``'s state (``d``: its attributes by
    name, arrays as numpy, NamedTuples as dicts, the stage as its value)
    into the port handler ``h``: ring, pool, last frame, motion model,
    depth scalars, stage and counters, and the initialization references.
    The RANSAC generator is left as it is."""
    from svo_pro_universal_tpu_torch.frontend.frame_handler import Stage
    dev = h.device
    h.ring = ring(d["ring"], dev)
    h.pool = pool(d["pool"], dev)
    h.last_frame = _opt(frame, d["last_frame"], dev)
    h.T_rel_prev = se3(d["T_rel_prev"], dev)
    h.depth_median = float(d["depth_median"])
    h.depth_min = float(d["depth_min"])
    h._depth_state = tensor(d["_depth_state"], dev)
    h.stage = Stage(int(d["stage"]))
    for k in ("frames_since_kf", "frame_count", "reloc_trials"):
        setattr(h, k, int(d[k]))
    for k in ("_prev_n_tracked",):
        setattr(h, k, None if d.get(k) is None else int(d[k]))
    h._last_ts = None if d.get("_last_ts") is None else float(d["_last_ts"])
    h._init_ref_frame = _opt(frame, d.get("_init_ref_frame"), dev)
    for k in ("_init_ref_px", "_init_ref_valid", "_init_px_guess"):
        setattr(h, k, _opt(tensor, d.get(k), dev))


def host_vio(h, d: Mapping) -> None:
    """``host_mono`` plus the device backend: its state, window count and
    keyframe times, and the last chi2."""
    host_mono(h, d)
    b = d["backend"]
    h.backend.state = backend_state(b["state"], h.device)
    h.backend.n_states = int(b["n_states"])
    h.backend._ts = [float(t) for t in b["_ts"]]
    c = d.get("_last_backend_chi2")
    h._last_backend_chi2 = None if c is None else float(c)


def host_stereo(h, d: Mapping) -> None:
    """``host_mono`` plus cam1's current and previous pyramids (JAX
    ``_pyr1``, ``_pyr1_last``)."""
    host_mono(h, d)
    h._pyrs_cur = (None if d.get("_pyr1") is None
                   else [tensor(d["_pyr1"], h.device)])
    h._pyrs_last = (None if d.get("_pyr1_last") is None
                    else [tensor(d["_pyr1_last"], h.device)])


def host_array(h, d: Mapping) -> None:
    """``host_mono`` plus the secondary cameras' pyramids (JAX
    ``_pyr_others``, ``_pyr_others_last``)."""
    host_mono(h, d)
    for src, dst in (("_pyr_others", "_pyrs_cur"),
                     ("_pyr_others_last", "_pyrs_last")):
        v = d.get(src)
        setattr(h, dst, None if v is None
                else [tensor(p, h.device) for p in v])


def _id_dict(v: Mapping) -> dict:
    return {int(k): int(x) for k, x in v.items()}


def backend_interface(b, d: Mapping) -> None:
    """A JAX ``BackendInterface``'s window, counts, keyframe times,
    id↔slot dicts and cursors into the port's ``b``."""
    b.window = window(d["window"], b.device)
    b.n_states = int(d["n_states"])
    b.kf_ts = [float(t) for t in d["kf_ts"]]
    b.lid2slot = _id_dict(d["lid2slot"])
    b.slot2lid = _id_dict(d["slot2lid"])
    b._lm_cursor = int(d["_lm_cursor"])
    b._obs_cursor = int(d["_obs_cursor"])


def global_map(g, d: Mapping) -> None:
    """A JAX ``GlobalMap``'s window, counts, keyframe ids, id↔slot dicts
    and cursors into the port's ``g``."""
    g.window = window(d["window"], g.device)
    g.n_states = int(d["n_states"])
    g.kf_ids = [int(k) for k in d["kf_ids"]]
    g.lid2slot = _id_dict(d["lid2slot"])
    g.slot2lid = _id_dict(d["slot2lid"])
    g._lm_cursor = int(d["_lm_cursor"])
    g._obs_cursor = int(d["_obs_cursor"])
    g._since_opt = int(d["_since_opt"])


def loop_closer(lc, d: Mapping) -> None:
    """A JAX ``LoopClosing``'s database (snapshots, keyframe ids, the
    descriptor matrix and counters) into the port's ``lc``."""
    from svo_pro_universal_tpu_torch.backend.loop_closing import (
        KeyframeSnapshot)
    dev = lc.device
    lc.snapshots = [KeyframeSnapshot(**{k: tensor(s[k], dev)
                                        for k in KeyframeSnapshot._fields})
                    for s in d["snapshots"]]
    lc.kf_ids = [int(k) for k in d["kf_ids"]]
    lc._n_added = int(d["_n_added"])
    lc.n_evicted = int(d["n_evicted"])
    lc._desc_matrix = tensor(d["_desc_matrix"], dev)


def host_slam(h, d: Mapping) -> None:
    """``host_mono`` plus the SLAM state: the pose graph and its node and
    constraint counts, the node poses, the unique-id → pool-slot map, the
    loop count, the loop closer's database and the global map."""
    host_mono(h, d)
    dev = h.device
    h.graph = pose_graph(d["graph"], dev)
    h._pgo_n = int(d["_pgo_n"])
    h._pgo_c = int(d["_pgo_c"])
    h._kf_poses = [se3(T, dev) for T in d["_kf_poses"]]
    h._uid2slot = _id_dict(d["_uid2slot"])
    h.n_loops_closed = int(d["n_loops_closed"])
    loop_closer(h.loop_closer, d["loop_closer"])
    if h.global_map is not None:
        global_map(h.global_map, d["global_map"])
