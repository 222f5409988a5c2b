"""The device mesh of the distributed paths, on ``torch.distributed``.

Counterpart of ``svo_pro_universal_tpu/parallel/mesh.py``. The JAX package
shards one program over a ``jax.sharding.Mesh`` with named axes: features
and seeds over ``f``, map blocks over ``h`` (hosts) × ``f``. Here each mesh
position is one process (a rank); a ``Mesh`` names the axes of the world
process group, gives this rank's coordinates, and holds one sub-group for
every proper subset of the axes, so a collective can span ``(h,)`` alone.

The backend is chosen when the ranks start (:func:`launch`) and printed:
``nccl`` when every rank has a card of its own, ``gloo`` when ranks share a
card or run on the CPU (NCCL refuses two ranks on one device; gloo takes
CUDA tensors and stages them through host memory). A failed initialization
raises; no other backend is tried.

Every collective goes through :func:`collective`, which counts the bytes it
reduces (the input) or gathers (the output) in ``COMM_BYTES``: the traffic
of a distributed solve is measured, not assumed.
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

FEATURE_AXIS = "f"
HOST_AXIS = "h"       # the inter-host axis: map-block partitioning

COMM_BYTES = {"all_reduce": 0, "all_gather": 0}
COMM_CALLS = {"all_reduce": 0, "all_gather": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_comm_counts() -> None:
    for k in COMM_BYTES:
        COMM_BYTES[k] = 0
        COMM_CALLS[k] = 0


def collective(kind: str, x: torch.Tensor, group, op: str = "sum"
               ) -> torch.Tensor:
    """The one entry to the process group's collectives.

    ``all_reduce`` returns the reduction (``op`` "sum" or "max") of ``x``
    over ``group``; ``all_gather`` returns the group's ``x`` concatenated
    along dim 0 in group-rank order. ``x`` is not modified. Booleans travel
    as uint8. Counts the bytes reduced or gathered."""
    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    if kind == "all_reduce":
        out = src.clone()
        dist.all_reduce(out, op=_OPS[op], group=group)
        nbytes = src.numel() * src.element_size()
    elif kind == "all_gather":
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=0)
        nbytes = out.numel() * out.element_size()
    else:
        raise ValueError(f"unknown collective {kind!r}")
    COMM_BYTES[kind] += nbytes
    COMM_CALLS[kind] += 1
    return out.to(torch.bool) if is_bool else out


class Mesh:
    """Named axes over the world process group (row-major: the last axis
    varies fastest over the ranks) and this rank's device."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int],
                 device: torch.device):
        world = dist.get_world_size()
        if int(np.prod(axis_sizes)) != world:
            raise ValueError(f"mesh {tuple(axis_sizes)} needs "
                             f"{int(np.prod(axis_sizes))} ranks, the process "
                             f"group has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, tuple(axis_sizes)))))
        # every rank creates every sub-group in the same order
        self._groups: dict[tuple, object] = {}
        sizes = tuple(axis_sizes)
        for k in range(1, len(self.axis_names)):
            for axes in itertools.combinations(self.axis_names, k):
                for ranks in self._subgroup_ranks(axes, sizes):
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def _subgroup_ranks(self, axes: tuple, sizes: tuple) -> list[list[int]]:
        """The rank lists of the sub-groups spanning ``axes``: one per
        coordinate of the other axes, each in ascending rank order."""
        grid = np.arange(int(np.prod(sizes))).reshape(sizes)
        span = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(len(sizes)) if i not in span]
        moved = np.transpose(grid, rest + span).reshape(
            -1, int(np.prod([sizes[i] for i in span])))
        return [sorted(int(r) for r in row) for row in moved]

    def _axes(self, axes: Sequence[str]) -> tuple:
        axes = tuple(axes)
        if [a for a in self.axis_names if a in axes] != list(axes) or \
                len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's flat shard index over ``axes``, row-major (JAX
        sharded_ba.py:279-282)."""
        flat = 0
        for a in self._axes(axes):
            flat = flat * self.shape[a] + self.coords[a]
        return flat

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (the world for all of them)."""
        axes = self._axes(axes)
        return (dist.group.WORLD if len(axes) == len(self.axis_names)
                else self._groups[axes])

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        if self.size(axes) == 1:
            return x
        return collective("all_reduce", x, self.group(axes), op)

    def all_gather(self, x: torch.Tensor, axes: Sequence[str]
                   ) -> torch.Tensor:
        if self.size(axes) == 1:
            return x
        return collective("all_gather", x, self.group(axes))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(local rank % cards)`` unless ``device``
    names one (``"cpu"`` for the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run the ranks "
                           "on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A 1-D mesh over ``f`` spanning the world group."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{world} ranks")
    return Mesh((FEATURE_AXIS,), (n,), rank_device(device))


def make_mesh_2d(n_hosts: int, per_host: int | None = None,
                 device=None) -> Mesh:
    """A [host × chip] mesh over ``(h, f)``. On one machine the host axis
    folds the local ranks into virtual hosts with the same program."""
    world = dist.get_world_size()
    if per_host is None:
        per_host = world // n_hosts
    if per_host < 1 or n_hosts * per_host > world:
        raise ValueError(
            f"make_mesh_2d({n_hosts}, {per_host}): needs "
            f"{n_hosts * max(per_host, 1)} devices, have {world}")
    if n_hosts * per_host != world:
        raise ValueError(f"make_mesh_2d({n_hosts}, {per_host}): the process "
                         f"group has {world} ranks")
    return Mesh((HOST_AXIS, FEATURE_AXIS), (n_hosts, per_host),
                rank_device(device))


def shard(x: torch.Tensor, mesh: Mesh,
          axes: Sequence[str] = (FEATURE_AXIS,)) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s rows over ``axes``, on the
    mesh's device."""
    n = mesh.size(axes)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    per = x.shape[0] // n
    d = mesh.index(axes)
    return x[d * per:(d + 1) * per].to(mesh.device)


def choose_backend(n_ranks: int, device=None) -> str:
    """``nccl`` when every rank gets a card of its own, else ``gloo``."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and torch.cuda.is_available() and \
            torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, n: int, store_path: str, backend: str, out_dir: str,
               fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    store = dist.FileStore(store_path, n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(n: int, fn: Callable, *args, device=None) -> list:
    """Run ``fn(*args)`` on ``n`` ranks (``torch.multiprocessing`` spawn),
    each in an initialized world group, and return their results in rank
    order. ``fn`` is a module-level function; it builds its mesh with
    :func:`make_mesh` / :func:`make_mesh_2d` (giving ``device``). The
    ranks meet through a ``FileStore`` in a fresh temporary directory (no
    port to contend for). A rank that raises or dies makes this raise."""
    backend = choose_backend(n, device)
    where = "the CPU" if device is not None and \
        torch.device(device).type == "cpu" else \
        f"{torch.cuda.device_count()} card(s)"
    print(f"parallel.mesh.launch: {n} ranks on {where}, backend {backend}",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="svo_mesh_")
    try:
        mp.spawn(_rank_main, args=(n, os.path.join(tmp, "store"), backend,
                                   tmp, fn, args),
                 nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
