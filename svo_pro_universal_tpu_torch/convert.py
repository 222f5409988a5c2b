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
from svo_pro_universal_tpu_torch.frontend.pipeline_slam import (
    SlamOptions, WorldStateSLAM)
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


def world_vio(d: Mapping, device=None, seed: int = 0) -> WorldStateVIO:
    """A port WorldStateVIO from a JAX ``WorldStateVIO`` dict."""
    base = world(d, device, seed)
    return WorldStateVIO(
        *base, backend=backend_state(d["backend"], device),
        backend_k=int(d["backend_k"]),
        last_kf_ts=np.float32(d["last_kf_ts"]),
        imu_packed=tensor(d["imu_packed"], device),
        backend_chi2=tensor(d["backend_chi2"], device))


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
