"""Feature-sharded frontend programs: alignment and the seed update.

Counterpart of ``svo_pro_universal_tpu/parallel/sharded_ops.py`` (reference
depth-filter worker thread depth_filter.h:83-177, per-camera std::async
reprojectors frame_handler_base.cpp:681-695). Every rank calls these with
the same whole inputs; each works on its contiguous slice of the features
(``mesh.shard``), and the results come back whole on every rank, as the
JAX package's ``out_specs`` return global arrays:

- ``distributed_align``: each rank sums its features' 8×8 photometric
  normal system per evaluate and one all-reduce makes it global
  (``sparse_img_align.run`` with the mesh); every rank solves the same
  system and carries the same pose.
- ``distributed_seed_update``: each rank updates its seeds against the
  replicated current frame; the seed state and types are all-gathered, the
  counters all-reduced.
"""

from __future__ import annotations

import torch

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops import depth_filter as df_mod
from svo_pro_universal_tpu_torch.ops import matcher as matcher_mod
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.parallel.mesh import (
    FEATURE_AXIS, Mesh, shard)
from svo_pro_universal_tpu_torch.utils.transform import SE3


def _on(x, device):
    """``x`` (a tensor, a camera, or NamedTuples of them) on ``device``."""
    if isinstance(x, tuple):
        return type(x)(*(_on(v, device) for v in x))
    return x.to(device)


def distributed_align(inp: sia.CameraInput, state0: sia.AlignState,
                      opts: sia.SparseImgAlignOptions, mesh: Mesh
                      ) -> tuple[sia.AlignState, sia.AlignStats]:
    """Sparse image alignment with ``px_ref``, ``f_ref``, ``depth_ref`` and
    ``valid`` sharded over ``f``; the pyramids, camera and ``T_cam_body``
    replicated. The result is the same on every rank."""
    dev = mesh.device
    axes = (FEATURE_AXIS,)
    local = sia.CameraInput(
        pyr_ref=inp.pyr_ref.to(dev), pyr_cur=inp.pyr_cur.to(dev),
        px_ref=shard(inp.px_ref, mesh, axes),
        f_ref=shard(inp.f_ref, mesh, axes),
        depth_ref=shard(inp.depth_ref, mesh, axes),
        valid=shard(inp.valid, mesh, axes),
        T_cam_body=_on(inp.T_cam_body, dev), cam=_on(inp.cam, dev))
    return sia.run([local], _on(state0, dev), opts, mesh=mesh, axes=axes)


def distributed_seed_update(
    ring_pyramid: torch.Tensor,      # padded [L,H,W] anchor pyramid
    cur_pyramid: torch.Tensor,
    cam: proj.Camera,
    T_cur_ref: SE3,
    px_ref: torch.Tensor,
    f_ref: torch.Tensor,
    grad_ref: torch.Tensor,
    level_ref: torch.Tensor,
    ftype: torch.Tensor,
    seed_state: torch.Tensor,
    seed_mu_range: torch.Tensor,
    mesh: Mesh,
    max_search_level: int = 2,
    sigma2_convergence_threshold: float = 200.0,
) -> df_mod.SeedUpdateResult:
    """Depth-filter update with the seeds sharded over ``f`` (the
    reference's depth-filter worker thread), through ``update_seeds`` with
    ``MatcherOptions(max_epi_search_steps=32)`` as JAX sharded_ops.py:139-148
    runs it. Returns the whole seed state and types, and the summed
    counters, on every rank."""
    dev = mesh.device
    axes = (FEATURE_AXIS,)
    cam = _on(cam, dev)
    res = df_mod.update_seeds(
        ring_pyramid.to(dev), cur_pyramid.to(dev), cam, cam,
        _on(T_cur_ref, dev), *(shard(x, mesh, axes) for x in (
            px_ref, f_ref, grad_ref, level_ref, ftype, seed_state)),
        torch.as_tensor(seed_mu_range).to(dev),
        max_search_level=max_search_level,
        sigma2_convergence_threshold=sigma2_convergence_threshold,
        matcher_opts=matcher_mod.MatcherOptions(max_epi_search_steps=32))
    counts = mesh.all_reduce(torch.stack([res.n_updated, res.n_converged]),
                             axes)
    return df_mod.SeedUpdateResult(
        mesh.all_gather(res.seed_state, axes),
        mesh.all_gather(res.ftype, axes), counts[0], counts[1])
