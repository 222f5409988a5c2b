"""Index helpers that reproduce JAX's scatter, top-k and segment semantics.

Every site of the JAX package that writes with ``.at[...].set(...,
mode="drop")``, ranks with ``lax.top_k`` / a stable ``argsort``, or reduces
with ``jax.ops.segment_max`` goes through one of these, so the port makes
the same discrete choices on the CPU and on the card:

- ``set_drop``: out-of-range rows are dropped (``index_put_`` would raise on
  the CPU and fault asynchronously on CUDA). The write goes through one
  scratch row that is sliced away. Negative indices wrap once, as JAX
  normalizes them. Among duplicate targets the LAST write wins, which is
  what XLA's sequential CPU scatter does; on CUDA ``index_put_`` leaves
  duplicates unordered, so the losers are sent to the scratch row first.
- ``topk_stable``: ``lax.top_k`` returns the lower index first among equal
  keys; ``torch.topk`` promises no order on CUDA, so a stable descending
  sort is used instead.
- ``segment_max``: ``scatter_reduce("amax", include_self=False)`` over a
  pre-filled output (−inf for floats, −1 for integers).
- ``segment_sum``: a float sum in an order fixed by the inputs (CUDA's
  ``index_add_`` accumulates with atomics in a varying order).
"""

from __future__ import annotations

import torch


def _targets(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx, n), ok


def _values(v, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v`` broadcast to the written rows, made on the device (a Python
    scalar copied from the host would synchronize the stream)."""
    if not isinstance(v, torch.Tensor):
        v = torch.full((), v, dtype=x.dtype, device=x.device)
    return v.to(x.dtype).expand((idx.shape[0],) + tuple(x.shape[1:]))


def take0(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor without a host read (plain
    indexing with a 0-dim CUDA tensor reads it back to the host)."""
    return x.index_select(0, i.reshape(1).long()).squeeze(0)


def set_drop(x: torch.Tensor, idx: torch.Tensor, v) -> torch.Tensor:
    """Functional ``x.at[idx].set(v, mode="drop")`` over the leading axis."""
    n = x.shape[0]
    idx = idx.reshape(-1).long()
    tgt, ok = _targets(idx, n)
    pos = torch.arange(idx.shape[0], device=x.device)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=x.device)
    last = last.scatter_reduce(0, tgt, pos, "amax", include_self=True)
    tgt = torch.where(ok & (last[tgt] == pos), tgt, n)
    buf = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    buf.index_put_((tgt,), _values(v, x, idx))
    return buf[:n]


def add_drop(x: torch.Tensor, idx: torch.Tensor, v) -> torch.Tensor:
    """Functional ``x.at[idx].add(v, mode="drop")`` over the leading axis."""
    n = x.shape[0]
    idx = idx.reshape(-1).long()
    tgt, _ = _targets(idx, n)
    buf = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    buf.index_put_((tgt,), _values(v, x, idx), accumulate=True)
    return buf[:n]


def set_drop_2d(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                v) -> torch.Tensor:
    """``x.at[i, j].set(v, mode="drop")`` for a 2-D leading index."""
    n0, n1 = x.shape[0], x.shape[1]
    i = i.long()
    j = j.long()
    i = torch.where(i < 0, i + n0, i)
    j = torch.where(j < 0, j + n1, j)
    ok = (i >= 0) & (i < n0) & (j >= 0) & (j < n1)
    flat = torch.where(ok, i * n1 + j, n0 * n1)
    out = set_drop(x.reshape((n0 * n1,) + tuple(x.shape[2:])), flat, v)
    return out.reshape(x.shape)


def topk_stable(key: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on a 1-D key: descending, lower index first on ties."""
    vals, idx = torch.sort(key, descending=True, stable=True)
    return vals[:k], idx[:k]


def argsort_stable(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort (``jnp.argsort``)."""
    if key.dtype == torch.bool:
        key = key.to(torch.int8)
    return torch.sort(key, stable=True).indices


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int
                ) -> torch.Tensor:
    """``jax.ops.segment_sum(data, seg, num_segments)`` over the leading
    axis (out-of-range segments drop) in an order fixed by the inputs alone.

    ``index_add_`` on CUDA sums floats with atomics, in an order that
    changes from run to run. Here the rows are sorted stably by segment,
    so each segment's rows stay in index order, and an inclusive segmented
    scan (Hillis–Steele: log2(N) rounds of one shifted add) leaves each
    segment's sum on its last row. The additions are the same on every
    device, so the CPU and the card give the same bits; a non-finite row
    reaches only its own segment. Integers sum exactly in any order and
    take ``index_add_``."""
    n = num_segments
    seg = seg.reshape(-1).long()
    seg = torch.where((seg >= 0) & (seg < n), seg, n)
    out = torch.zeros((n + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    if not data.is_floating_point():
        return out.index_add_(0, seg, data)[:n]
    s, order = torch.sort(seg, stable=True)
    d = data.index_select(0, order)
    trail = (1,) * (d.dim() - 1)
    k = 1
    while k < d.shape[0]:
        same = (s[k:] == s[:-k]).reshape((-1,) + trail)
        d = torch.cat([d[:k], d[k:] + torch.where(same, d[:-k], 0.0)])
        k *= 2
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    out.index_put_((torch.where(last, s, n),), d)
    return out[:n]


def segment_max(data: torch.Tensor, seg: torch.Tensor, num_segments: int,
                ) -> torch.Tensor:
    """``jax.ops.segment_max`` for in-range ``seg``; empty segments hold −inf
    (floats) or −1 (integers)."""
    fill = float("-inf") if data.is_floating_point() else -1
    out = torch.full((num_segments,), fill, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, seg.long(), data, "amax", include_self=False)
