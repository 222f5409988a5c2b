"""Pose-graph optimization: LM over SE(3) keyframe poses with relative
constraints.

Counterpart of ``svo_pro_universal_tpu/backend/pgo.py`` (reference
src/svo_pgo/include/svo/pgo/pgo.h:25-70 — SE(3) nodes, sequential and loop
relative constraints; pose_graph_3d_error_term.h). The graph is fixed-shape
tensors; the residuals r = log(T_meas⁻¹ · T_i⁻¹ · T_j) are batched, their
Jacobians come from ``torch.func.jacfwd`` through the retraction under
``vmap``, and the Hessian is assembled as an [N, N] grid of 6×6 blocks with
one segment sum (``utils.indexing.segment_sum``, in an order fixed by the
inputs), then solved densely. The accept/reject and damping of each LM
iteration are selected on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from svo_pro_universal_tpu_torch.utils.indexing import segment_sum
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, quat_identity, quat_normalize, se3_exp, se3_log)

PDOF = 6


class PoseGraph(NamedTuple):
    q: torch.Tensor           # [N, 4] T_world_i rotation
    t: torch.Tensor           # [N, 3]
    node_valid: torch.Tensor  # [N]
    # constraints: measured relative pose T_ij = T_i⁻¹ · T_j
    c_i: torch.Tensor         # [C]
    c_j: torch.Tensor         # [C]
    c_q: torch.Tensor         # [C, 4]
    c_t: torch.Tensor         # [C, 3]
    c_weight_rot: torch.Tensor    # [C]
    c_weight_trans: torch.Tensor  # [C]
    c_valid: torch.Tensor     # [C]

    @property
    def N(self) -> int:
        return self.q.shape[0]

    @property
    def C(self) -> int:
        return self.c_i.shape[0]


def make_graph(max_nodes: int, max_constraints: int,
               device=None) -> PoseGraph:
    N, C = max_nodes, max_constraints
    unit = quat_identity(device=device)
    return PoseGraph(
        q=unit.expand(N, 4).clone(),
        t=torch.zeros((N, 3), device=device),
        node_valid=torch.zeros((N,), dtype=torch.bool, device=device),
        c_i=torch.zeros((C,), dtype=torch.long, device=device),
        c_j=torch.zeros((C,), dtype=torch.long, device=device),
        c_q=unit.expand(C, 4).clone(),
        c_t=torch.zeros((C, 3), device=device),
        c_weight_rot=torch.ones((C,), device=device),
        c_weight_trans=torch.ones((C,), device=device),
        c_valid=torch.zeros((C,), dtype=torch.bool, device=device))


def put(x: torch.Tensor, slot: int, v) -> torch.Tensor:
    """``x.at[slot].set(v)`` for a host ``slot`` (a tensor or a Python
    scalar ``v``; neither reads the device)."""
    x = x.clone()
    x[slot] = v
    return x


def add_constraint(g: PoseGraph, slot: int, i, j, T_ij: SE3,
                   weight_rot=1.0, weight_trans=1.0) -> PoseGraph:
    """Constraint ``slot`` (host) := T_i⁻¹·T_j measured as ``T_ij``."""
    return g._replace(
        c_i=put(g.c_i, slot, i), c_j=put(g.c_j, slot, j),
        c_q=put(g.c_q, slot, T_ij.q), c_t=put(g.c_t, slot, T_ij.t),
        c_weight_rot=put(g.c_weight_rot, slot, weight_rot),
        c_weight_trans=put(g.c_weight_trans, slot, weight_trans),
        c_valid=put(g.c_valid, slot, True))


def _residual_one(qi, ti, qj, tj, qm, tm, dxi, dxj):
    """r = log(T_m⁻¹ · T_i⁻¹ · T_j) with retraction T ← T·exp(dx)."""
    Ti = SE3(qi, ti).compose(se3_exp(dxi))
    Tj = SE3(qj, tj).compose(se3_exp(dxj))
    Tm = SE3(qm, tm)
    return se3_log(Tm.inverse().compose(Ti.inverse().compose(Tj)))


def _terms(g: PoseGraph):
    """(the residuals' arguments at dx = 0, the [C, 6] residual weights)."""
    N, C = g.N, g.C
    i = torch.clamp(g.c_i, 0, N - 1)
    j = torch.clamp(g.c_j, 0, N - 1)
    z = torch.zeros((C, PDOF), dtype=g.t.dtype, device=g.t.device)
    args = (g.q[i], g.t[i], g.q[j], g.t[j], g.c_q, g.c_t, z, z)
    wvec = torch.cat([g.c_weight_trans[:, None].expand(C, 3),
                      g.c_weight_rot[:, None].expand(C, 3)], dim=-1)
    ok = g.c_valid & g.node_valid[i] & g.node_valid[j]
    return args, wvec * ok[:, None], ok, i, j


def graph_chi2(g: PoseGraph) -> torch.Tensor:
    """Σ w·r² of the graph (the cost :func:`optimize` compares)."""
    args, w, _, _, _ = _terms(g)
    r = _residual_one(*args)
    return torch.sum(w * r * r)


def _build(g: PoseGraph, fixed_node: int):
    """(H [6N, 6N], b [6N]) of the Gauss-Newton system."""
    N = g.N
    D = N * PDOF
    args, w, ok, i, j = _terms(g)
    r = _residual_one(*args)
    J_i, J_j = vmap(jacfwd(_residual_one, argnums=(6, 7)))(*args)
    Jwi = J_i * w[:, :, None]
    Jwj = J_j * w[:, :, None]
    Hii = torch.einsum("cri,crj->cij", Jwi, J_i)
    Hij = torch.einsum("cri,crj->cij", Jwi, J_j)
    Hji = torch.einsum("cri,crj->cij", Jwj, J_i)
    Hjj = torch.einsum("cri,crj->cij", Jwj, J_j)
    bi = -torch.einsum("cri,cr->ci", Jwi, r)
    bj = -torch.einsum("cri,cr->ci", Jwj, r)

    # one segment sum over the [N, N] block grid
    drop = N * N
    keys = torch.cat([torch.where(ok, i * N + i, drop),
                      torch.where(ok, i * N + j, drop),
                      torch.where(ok, j * N + i, drop),
                      torch.where(ok, j * N + j, drop)])
    Hgrid = segment_sum(torch.cat([Hii, Hij, Hji, Hjj]), keys, N * N)
    H = Hgrid.reshape(N, N, PDOF, PDOF).transpose(1, 2).reshape(D, D)
    bkeys = torch.cat([torch.where(ok, i, N), torch.where(ok, j, N)])
    b = segment_sum(torch.cat([bi, bj]), bkeys, N).reshape(D)

    # gauge + dead nodes
    node = torch.arange(N, device=g.t.device)
    diag = ((node == fixed_node) * 1e10
            + (~g.node_valid).to(g.t.dtype))[:, None].expand(N, PDOF)
    return H + torch.diag(diag.reshape(D)), b


def _retract(g: PoseGraph, dx: torch.Tensor) -> PoseGraph:
    T = SE3(g.q, g.t).compose(se3_exp(dx.reshape(g.N, PDOF)))
    return g._replace(q=quat_normalize(T.q), t=T.t)


def optimize(g: PoseGraph, max_iter: int = 20, fixed_node: int = 0,
             mu_init: float = 1e-6) -> tuple[PoseGraph, torch.Tensor]:
    """LM over all poses; ``fixed_node`` holds the gauge (reference
    pgo.h: first pose fixed). Returns (graph, cost)."""
    dev = g.t.device
    mu = torch.full((), mu_init, device=dev)
    best = graph_chi2(g)
    for _ in range(max_iter):
        H, b = _build(g, fixed_node)
        Hd = H + mu * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
        dx = torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0]
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        cand = _retract(g, dx)
        c2n = graph_chi2(cand)
        ok = c2n < best
        g = PoseGraph(*[torch.where(ok, a, x) for a, x in zip(cand, g)])
        best = torch.where(ok, c2n, best)
        mu = torch.clamp(torch.where(ok, mu * 0.3, mu * 8.0), 1e-9, 1e6)
    return g, best
