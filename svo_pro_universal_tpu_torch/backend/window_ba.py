"""Sliding-window visual-inertial bundle adjustment.

Counterpart of ``svo_pro_universal_tpu/backend/window_ba.py`` (reference
OKVIS-style Ceres backend, extra/svo_ceres_backend/src/estimator.cpp —
addStates:141, optimize:1151, applyMarginalizationStrategy:632;
ceres_backend_interface.hpp:21-58: 3 iterations, a window of 5 keyframes).
The whole window is one fixed-shape NamedTuple of tensors:

- states [S]: T_world_body (q, p) + velocity + gyro/acc bias (15 dof)
- landmarks [L]: world points (3 dof), Schur-complemented every solve
- reprojection factors [No]: (state, landmark, bearing) triplets
- IMU factors [S-1]: preintegration residuals (backend.imu_factor), their
  Jacobians by ``torch.func.jacfwd`` through the retraction
- marginalization prior: dense (H0, b0) on the stacked state vector at a
  stored linearization point (reference marginalization_error.hpp:325)

One LM iteration: batched residuals/Jacobians → segment sums (in an order
fixed by the inputs: ``utils.indexing.segment_sum``) → Schur complement
S = Hpp − U·Hll⁻¹·Uᵀ → dense [S·15] solve → landmark back-substitution; the
solve in float64 (the float32 system is assembled as in JAX). Inverses and
solves use the ``_ex`` forms, which do not read LAPACK/cuSOLVER's info back
to the host; ``eigh`` of the marginal has no such form and synchronizes
once per marginalization.

With a mesh (``parallel.mesh.Mesh``) and ``lm_offset`` the solve is
landmark-sharded, as the JAX package's ``axis_name`` / ``lm_offset``: this
rank holds the landmark slots ``[lm_offset, lm_offset + L)`` and their
observation rows (observations of other shards drop out), the state-block
system and the reduced camera-camera Schur system are all-reduced over the
mesh's ``axes``, and the dense state solve runs the same on every rank.
Marginalization stays single-device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from svo_pro_universal_tpu_torch.backend import imu_factor as imu_mod
from svo_pro_universal_tpu_torch.parallel.mesh import FEATURE_AXIS
from svo_pro_universal_tpu_torch.utils.indexing import segment_sum, set_drop
from svo_pro_universal_tpu_torch.utils.transform import (
    SE3, quat_conjugate, quat_multiply, quat_normalize, quat_to_matrix, skew,
    so3_exp, so3_log)

DOF = 15  # per-state: [δp(3), δθ(3), δv(3), δbg(3), δba(3)]


class BAOptions(NamedTuple):
    max_iter: int = 3
    pixel_sigma: float = 1.0          # reprojection noise (px)
    huber_reproj: float = 2.5         # huber threshold (whitened units)
    mu_init: float = 1e-4
    mu_floor: float = 1e-6            # keeps weak VIO directions bounded
    fix_first_pose: bool = True
    gravity: tuple = (0.0, 0.0, -9.81)
    # absolute priors anchoring the weakly observable directions
    # (reference imu_calibration.h:85-117)
    gyr_bias_prior_sigma: float = 0.05
    acc_bias_prior_sigma: float = 0.5
    # closed-form visual-inertial alignment before the LM iterations (see
    # vi_alignment)
    vi_alignment: bool = True
    vi_align_min_factors: int = 2
    vi_align_max_residual: float = 0.5   # mean-square row residual gate
    vi_align_max_sigma: float = 0.03     # relative α precision required
    # void the whole LM state step while a landmark has fewer than two
    # window views. JAX's float32 solve voids it where float32 rounding
    # makes such a block's inverse non-finite; the tests that hold the port
    # to JAX's float32 runs set this to reproduce those voids
    void_on_single_view: bool = False


class Window(NamedTuple):
    # states
    q: torch.Tensor           # [S, 4] T_world_body rotation
    p: torch.Tensor           # [S, 3] position
    v: torch.Tensor           # [S, 3]
    bg: torch.Tensor          # [S, 3]
    ba: torch.Tensor          # [S, 3]
    state_valid: torch.Tensor  # [S]
    # landmarks
    lm_pos: torch.Tensor      # [L, 3]
    lm_valid: torch.Tensor    # [L]
    # reprojection observations
    obs_state: torch.Tensor   # [No]
    obs_lm: torch.Tensor      # [No]
    obs_f: torch.Tensor       # [No, 3] measured unit bearing (camera frame)
    obs_valid: torch.Tensor   # [No]
    # IMU factors between consecutive states
    imu: imu_mod.PreintFactor  # leading dim [S-1]
    imu_info: torch.Tensor    # [S-1, 15, 15]
    imu_valid: torch.Tensor   # [S-1]
    # zero-motion (ZUPT) prior weight per state: 1/σ_v² when stationary
    zupt: torch.Tensor        # [S]
    # marginalization prior (dense, at linearization point x0)
    H_prior: torch.Tensor     # [S·15, S·15]
    b_prior: torch.Tensor     # [S·15]
    q0: torch.Tensor          # [S, 4] linearization point
    p0: torch.Tensor
    v0: torch.Tensor
    bg0: torch.Tensor
    ba0: torch.Tensor
    has_prior: torch.Tensor   # bool scalar (data-dependent: a rescale drops it)
    # VI-alignment diagnostics
    align_n: torch.Tensor     # applications
    align_log: torch.Tensor   # Σ log α applied
    align_min_rel: torch.Tensor  # best (smallest) rel_std seen

    @property
    def S(self) -> int:
        return self.q.shape[0]

    @property
    def L(self) -> int:
        return self.lm_pos.shape[0]


def tree_map(fn, *trees):
    """``fn`` leaf by leaf over (nested) NamedTuples of tensors."""
    t0 = trees[0]
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*[tree_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)


def tree_where(cond: torch.Tensor, a, b):
    """Leafwise ``torch.where(cond, a, b)`` for a 0-dim ``cond``."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def _unit_q(n: int, device) -> torch.Tensor:
    return (torch.arange(4, device=device) == 0).to(torch.float32).expand(
        n, 4).clone()


def empty_factors(n: int, device=None) -> imu_mod.PreintFactor:
    """[n] identity preintegration factors (unit covariance)."""
    z3 = torch.zeros((n, 3, 3), device=device)
    z = torch.zeros((n, 3), device=device)
    return imu_mod.PreintFactor(
        delta_q=_unit_q(n, device), delta_v=z, delta_p=z.clone(),
        dt=torch.zeros((n,), device=device), J_q_bg=z3, J_v_bg=z3.clone(),
        J_v_ba=z3.clone(), J_p_bg=z3.clone(), J_p_ba=z3.clone(),
        bias_gyr=z.clone(), bias_acc=z.clone(),
        cov=torch.eye(9, device=device).expand(n, 9, 9).clone())


def make_window(max_states: int, max_landmarks: int, max_obs: int,
                device=None) -> Window:
    S, L, No = max_states, max_landmarks, max_obs

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Window(
        q=_unit_q(S, device), p=z(S, 3), v=z(S, 3), bg=z(S, 3), ba=z(S, 3),
        state_valid=z(S, dtype=torch.bool),
        lm_pos=z(L, 3), lm_valid=z(L, dtype=torch.bool),
        obs_state=z(No, dtype=torch.long), obs_lm=z(No, dtype=torch.long),
        obs_f=z(No, 3), obs_valid=z(No, dtype=torch.bool),
        imu=empty_factors(S - 1, device),
        imu_info=torch.eye(15, device=device).expand(S - 1, 15, 15).clone(),
        imu_valid=z(S - 1, dtype=torch.bool), zupt=z(S),
        H_prior=z(S * DOF, S * DOF), b_prior=z(S * DOF),
        q0=_unit_q(S, device), p0=z(S, 3), v0=z(S, 3), bg0=z(S, 3),
        ba0=z(S, 3), has_prior=z(dtype=torch.bool),
        align_n=z(dtype=torch.long), align_log=z(),
        align_min_rel=torch.full((), float("inf"), device=device))


# ---------------------------------------------------------------------------
# local coordinates
# ---------------------------------------------------------------------------

def retract_states(w: Window, dx: torch.Tensor) -> Window:
    """x ⊞ dx with dx [S·15]: p+=δp, q←q·Exp(δθ), v/bg/ba += δ."""
    d = dx.reshape(w.S, DOF)
    q = quat_normalize(quat_multiply(w.q, so3_exp(d[:, 3:6])))
    return w._replace(q=q, p=w.p + d[:, 0:3], v=w.v + d[:, 6:9],
                      bg=w.bg + d[:, 9:12], ba=w.ba + d[:, 12:15])


def local_coords(w: Window) -> torch.Tensor:
    """x ⊖ x0 as [S·15] (for the marginalization prior)."""
    dphi = so3_log(quat_multiply(quat_conjugate(w.q0), w.q))
    d = torch.cat([w.p - w.p0, dphi, w.v - w.v0, w.bg - w.bg0,
                   w.ba - w.ba0], dim=-1)
    return d.reshape(-1)


# ---------------------------------------------------------------------------
# system assembly
# ---------------------------------------------------------------------------

def _reproj_terms(w: Window, T_cam_body: SE3, focal, opts: BAOptions,
                  lm_offset: int = 0):
    """Batched unit-plane reprojection residuals + Jacobians:
    (e [No,2], J_s [No,2,15], J_l [No,2,3], wgt [No], valid [No]).
    ``lm_offset`` maps global landmark ids to this shard's slots;
    observations of other shards drop out (JAX window_ba.py:175-185)."""
    s = torch.clamp(w.obs_state, 0, w.S - 1)
    l_local = w.obs_lm - lm_offset
    l = torch.clamp(l_local, 0, w.L - 1)
    own = (l_local >= 0) & (l_local < w.L)
    q_s, p_s, X = w.q[s], w.p[s], w.lm_pos[l]
    R_bw = quat_to_matrix(quat_conjugate(q_s))            # [No,3,3]
    p_b = torch.einsum("nij,nj->ni", R_bw, X - p_s)
    R_cb = quat_to_matrix(T_cam_body.q)
    p_c = torch.einsum("ij,nj->ni", R_cb, p_b) + T_cam_body.t
    z = p_c[:, 2]
    zi = 1.0 / torch.where(torch.abs(z) > 1e-8, z, 1e-8)
    uv = p_c[:, 0:2] * zi[:, None]
    uv_meas = w.obs_f[:, 0:2] / torch.where(
        torch.abs(w.obs_f[:, 2:3]) > 1e-8, w.obs_f[:, 2:3], 1e-8)
    e = uv_meas - uv

    one, zero = torch.ones_like(zi), torch.zeros_like(zi)
    J_uv = torch.stack([torch.stack([one, zero, -uv[:, 0]], -1),
                        torch.stack([zero, one, -uv[:, 1]], -1)], -2)
    J_uv = J_uv * zi[:, None, None]                         # d uv / d p_c
    J_pc = torch.einsum("nij,jk->nik", J_uv, R_cb)          # d uv / d p_b
    # residual e = meas − uv  →  J = −d uv/d param
    J_dp = torch.einsum("nij,njk->nik", J_pc, -R_bw)        # d p_b/d δp
    J_dphi = torch.einsum("nij,njk->nik", J_pc, skew(p_b))  # d p_b/d δθ
    J_lm = torch.einsum("nij,njk->nik", J_pc, R_bw)         # d p_b/d X
    zeros9 = torch.zeros(J_dp.shape[:-1] + (9,), dtype=e.dtype,
                         device=e.device)
    J_s = -torch.cat([J_dp, J_dphi, zeros9], dim=-1)        # [No,2,15]
    J_l = -J_lm

    valid = (w.obs_valid & own & w.state_valid[s] & w.lm_valid[l]
             & (z > 1e-6))
    sigma = opts.pixel_sigma / focal
    ew = torch.linalg.norm(e, dim=-1) / sigma
    huber = torch.where(ew <= opts.huber_reproj, 1.0,
                        opts.huber_reproj / torch.clamp(ew, min=1e-12))
    wgt = torch.where(valid, huber / (sigma * sigma), 0.0)
    return e, J_s, J_l, wgt, valid


def _imu_args(w: Window):
    i = torch.arange(w.S - 1, device=w.q.device)
    j = i + 1
    z = torch.zeros((w.S - 1, DOF), dtype=w.q.dtype, device=w.q.device)
    return (w.imu, w.q[i], w.p[i], w.v[i], w.bg[i], w.ba[i],
            w.q[j], w.p[j], w.v[j], w.bg[j], w.ba[j], z, z)


def _imu_res(gravity: torch.Tensor):
    def res_one(factor, q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, bg_j,
                ba_j, dxi, dxj):
        def ret(q, p, v, bg, ba, d):
            return (quat_normalize(quat_multiply(q, so3_exp(d[..., 3:6]))),
                    p + d[..., 0:3], v + d[..., 6:9], bg + d[..., 9:12],
                    ba + d[..., 12:15])
        qi, pi, vi, bgi, bai = ret(q_i, p_i, v_i, bg_i, ba_i, dxi)
        qj, pj, vj, bgj, baj = ret(q_j, p_j, v_j, bg_j, ba_j, dxj)
        return imu_mod.imu_residual(factor, qi, pi, vi, bgi, bai,
                                    qj, pj, vj, bgj, baj, gravity)
    return res_one


def _gravity(opts: BAOptions, ref: torch.Tensor) -> torch.Tensor:
    """``opts.gravity`` as a tensor filled on ``ref``'s device (a host
    tensor copied to the card would synchronize)."""
    return torch.stack([torch.full((), float(g), dtype=ref.dtype,
                                   device=ref.device) for g in opts.gravity])


def _imu_residuals(w: Window, opts: BAOptions) -> torch.Tensor:
    """[S-1, 15] IMU residuals at the current states (no Jacobians)."""
    r = _imu_res(_gravity(opts, w.q))(*_imu_args(w))
    return torch.where(torch.isfinite(r), r, 0.0)


def _imu_terms(w: Window, opts: BAOptions):
    """IMU residuals + Jacobians by jacfwd through the retraction:
    (r [S-1,15], J_i [S-1,15,15], J_j [S-1,15,15])."""
    res_one = _imu_res(_gravity(opts, w.q))
    args = _imu_args(w)
    r = res_one(*args)
    J_i, J_j = vmap(jacfwd(res_one, argnums=(11, 12)))(*args)
    # disabled factors are zero-weighted, but 0·NaN = NaN — sanitize
    r = torch.where(torch.isfinite(r), r, 0.0)
    J_i = torch.where(torch.isfinite(J_i), J_i, 0.0)
    J_j = torch.where(torch.isfinite(J_j), J_j, 0.0)
    return r, J_i, J_j


def _assemble_reproj(w: Window, T_cam_body: SE3, focal, opts: BAOptions,
                     lm_offset: int = 0):
    """Reprojection-factor normal system: (Hpp, bp, U, Hll, bl, chi2)."""
    S, L = w.S, w.L
    D = S * DOF
    e, J_s, J_l, wgt, rvalid = _reproj_terms(w, T_cam_body, focal, opts,
                                             lm_offset)
    s_idx = torch.clamp(w.obs_state, 0, S - 1)
    l_idx = torch.clamp(w.obs_lm - lm_offset, 0, L - 1)
    s_seg = torch.where(rvalid, s_idx, S)
    l_seg = torch.where(rvalid, l_idx, L)

    Hss = torch.einsum("nri,nrj,n->nij", J_s, J_s, wgt)     # [No,15,15]
    Hsl = torch.einsum("nri,nrj,n->nij", J_s, J_l, wgt)     # [No,15,3]
    Hll_o = torch.einsum("nri,nrj,n->nij", J_l, J_l, wgt)   # [No,3,3]
    bs_o = -torch.einsum("nri,nr,n->ni", J_s, e, wgt)       # [No,15]
    bl_o = -torch.einsum("nri,nr,n->ni", J_l, e, wgt)       # [No,3]

    Hpp = torch.block_diag(*segment_sum(Hss, s_seg, S).unbind(0))
    bp = segment_sum(bs_o, s_seg, S).reshape(D)
    # landmark-state coupling: U[l] is [S·15, 3] with the [15,3] block of
    # state s at rows s·15..
    key = torch.where(rvalid, l_idx * S + s_idx, L * S)
    U = segment_sum(Hsl, key, L * S).reshape(L, S * DOF, 3)
    Hll = segment_sum(Hll_o, l_seg, L)
    bl = segment_sum(bl_o, l_seg, L)
    chi2 = torch.sum(torch.sum(e * e, -1) * wgt)
    return Hpp, bp, U, Hll, bl, chi2


def _priors(w: Window, opts: BAOptions):
    """The dense-prior, gauge, bias and ZUPT terms: (H [D,D] to add, b [D]
    to add, chi2 to add)."""
    S = w.S
    D = S * DOF
    dev = w.q.device
    delta = local_coords(w)
    hp = w.has_prior.to(w.q.dtype)
    H = hp * w.H_prior
    b = hp * (w.b_prior - w.H_prior @ delta)
    chi2 = torch.where(w.has_prior, delta @ w.H_prior @ delta
                       - 2.0 * w.b_prior @ delta, 0.0)
    col = torch.arange(DOF, device=dev)
    # dead states pinned
    diag = torch.repeat_interleave((~w.state_valid).to(w.q.dtype), DOF)
    if opts.fix_first_pose:
        diag = diag + ((torch.arange(D, device=dev) < 6)
                       * (1e8 * (~w.has_prior).to(w.q.dtype)))
    # weak absolute bias priors toward zero (accel-bias↔tilt degeneracy)
    bias_w = (torch.where((col >= 9) & (col < 12),
                          1.0 / opts.gyr_bias_prior_sigma ** 2, 0.0)
              + torch.where(col >= 12,
                            1.0 / opts.acc_bias_prior_sigma ** 2, 0.0))
    bias_w = (bias_w[None] * w.state_valid[:, None]).reshape(D)
    x_bias = torch.cat([torch.zeros((S, 9), device=dev), w.bg, w.ba],
                       dim=-1).reshape(D)
    # zero-motion (ZUPT) priors: pull v → 0 for states flagged stationary
    zw = (((col >= 6) & (col < 9))[None]
          * (w.zupt * w.state_valid)[:, None]).reshape(D)
    x_v = torch.cat([torch.zeros((S, 6), device=dev), w.v,
                     torch.zeros((S, 6), device=dev)], dim=-1).reshape(D)
    H = H + torch.diag(diag) + torch.diag(bias_w) + torch.diag(zw)
    b = b - bias_w * x_bias - zw * x_v
    chi2 = (chi2 + torch.sum(bias_w * x_bias * x_bias)
            + torch.sum(zw * x_v * x_v))
    return H, b, chi2


def build_system(w: Window, T_cam_body: SE3, focal, opts: BAOptions,
                 mesh=None, axes=(FEATURE_AXIS,), lm_offset: int = 0):
    """(Hpp [D,D], bp [D], U [L,D,3], Hll [L,3,3], bl [L,3], chi2).

    With ``mesh`` the reprojection part of Hpp, bp and chi2 is all-reduced
    over ``axes`` (one float32 collective); the landmark blocks U, Hll, bl
    stay on their shard."""
    S, L = w.S, w.L
    D = S * DOF
    Hpp, bp, U, Hll, bl, chi2 = _assemble_reproj(w, T_cam_body, focal, opts,
                                                 lm_offset)
    if mesh is not None:
        red = mesh.all_reduce(torch.cat([Hpp.reshape(-1), bp,
                                         chi2.reshape(1)]), axes)
        Hpp, bp, chi2 = red[:D * D].view(D, D), red[D * D:-1], red[-1]

    # ---- IMU factors ---------------------------------------------------
    r_imu, J_i, J_j = _imu_terms(w, opts)
    ivalid = w.imu_valid & w.state_valid[:-1] & w.state_valid[1:]
    info = w.imu_info * ivalid[:, None, None]
    JtWJ_ii = torch.einsum("nri,nrc,ncj->nij", J_i, info, J_i)
    JtWJ_ij = torch.einsum("nri,nrc,ncj->nij", J_i, info, J_j)
    JtWJ_jj = torch.einsum("nri,nrc,ncj->nij", J_j, info, J_j)
    bW_i = -torch.einsum("nri,nrc,nc->ni", J_i, info, r_imu)
    bW_j = -torch.einsum("nri,nrc,nc->ni", J_j, info, r_imu)
    Hpp = Hpp.clone()
    bp = bp.clone()
    for k in range(S - 1):
        r0, r1 = k * DOF, (k + 1) * DOF
        Hpp[r0:r1, r0:r1] += JtWJ_ii[k]
        Hpp[r0:r1, r1:r1 + DOF] += JtWJ_ij[k]
        Hpp[r1:r1 + DOF, r0:r1] += JtWJ_ij[k].T
        Hpp[r1:r1 + DOF, r1:r1 + DOF] += JtWJ_jj[k]
        bp[r0:r1] += bW_i[k]
        bp[r1:r1 + DOF] += bW_j[k]
    chi2 = chi2 + torch.sum(torch.einsum("nr,nrc,nc->n", r_imu, info, r_imu))

    # ---- marginalization prior, gauge, bias and ZUPT priors ------------
    H_add, b_add, chi2_add = _priors(w, opts)
    Hpp = Hpp + H_add
    bp = bp + b_add
    chi2 = chi2 + chi2_add
    lm_reg = torch.where(w.lm_valid, 0.0, 1.0)
    eye3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    Hll = Hll + eye3[None] * (1e-6 + lm_reg[:, None, None])
    return Hpp, bp, U, Hll, bl, chi2


def system_chi2(w: Window, T_cam_body: SE3, focal, opts: BAOptions,
                mesh=None, axes=(FEATURE_AXIS,), lm_offset: int = 0
                ) -> torch.Tensor:
    """The chi2 of :func:`build_system` without building the system (the
    JAX package lets XLA drop the unused Jacobians; eagerly they are not
    computed). With ``mesh`` the reprojection chi2 is all-reduced."""
    e, _, _, wgt, _ = _reproj_terms(w, T_cam_body, focal, opts, lm_offset)
    chi2 = torch.sum(torch.sum(e * e, -1) * wgt)
    if mesh is not None:
        chi2 = mesh.all_reduce(chi2.reshape(1), axes)[0]
    r_imu = _imu_residuals(w, opts)
    ivalid = w.imu_valid & w.state_valid[:-1] & w.state_valid[1:]
    info = w.imu_info * ivalid[:, None, None]
    chi2 = chi2 + torch.sum(torch.einsum("nr,nrc,nc->n", r_imu, info, r_imu))
    return chi2 + _priors(w, opts)[2]


def single_view_landmarks(w: Window, T_cam_body: SE3, focal,
                          opts: BAOptions, lm_offset: int = 0
                          ) -> torch.Tensor:
    """[L] valid landmarks with fewer than two valid window views."""
    valid = _reproj_terms(w, T_cam_body, focal, opts, lm_offset)[4]
    lm = torch.clamp(w.obs_lm - lm_offset, 0, w.L - 1)
    views = segment_sum(valid.long(), torch.where(valid, lm, w.L), w.L)
    return w.lm_valid & (views < 2)


def solve_schur(Hpp, bp, U, Hll, bl, mu, lm_valid, single_view=None,
                mesh=None, axes=(FEATURE_AXIS,)):
    """Schur complement over the landmark blocks + dense state solve, in
    float64 from the float32 system; returns float32 (dx_p, dl).

    Each damped block ``Hll + (1e-6 + mu)·I`` (the 1e-6 is added by
    :func:`build_system`) is inverted, as JAX's ``solve_schur`` does, and
    only non-finite entries of the steps are zeroed (JAX
    window_ba.py:400-423). In float32 that reduction cancels (cond ~1e7
    with the marginal prior): two float32 implementations disagree by more
    than the step. ``single_view`` [L] (``BAOptions.void_on_single_view``)
    marks valid landmarks seen from fewer than two window states: when any
    is set the whole state step is voided and those landmarks take no
    update; the others still take theirs. Returns (dx_p, dl, voided): the
    last is True when the state step was voided or had a non-finite
    entry zeroed.

    With ``mesh`` each rank reduces its own landmark blocks and one
    all-reduce over ``axes`` sums S_red, b_red and the count of single-view
    landmarks, so every rank voids the same step. The port's reduction is
    float64, so that collective is float64 where JAX's psum
    (window_ba.py:409-411) is float32."""
    f64 = torch.float64
    Hpp, bp, U, Hll, bl = (x.to(f64) for x in (Hpp, bp, U, Hll, bl))
    mu = torch.as_tensor(mu, dtype=f64, device=Hll.device)
    eye3 = torch.eye(3, dtype=f64, device=Hll.device)
    Hll_inv = torch.linalg.inv_ex(Hll + mu * eye3[None])[0]
    Hll_inv = Hll_inv * lm_valid[:, None, None]
    void = torch.zeros((), dtype=torch.bool, device=Hll.device)
    if single_view is not None:
        Hll_inv = torch.where(single_view[:, None, None], 0.0, Hll_inv)
    S_red = torch.einsum("lia,lab,ljb->ij", U, Hll_inv, U)
    b_red = torch.einsum("lia,lab,lb->i", U, Hll_inv, bl)
    n_single = (torch.sum(single_view.to(f64)).reshape(1)
                if single_view is not None else S_red.new_zeros((0,)))
    if mesh is not None:
        D = S_red.shape[0]
        red = mesh.all_reduce(torch.cat([S_red.reshape(-1), b_red,
                                         n_single]), axes)
        S_red, b_red, n_single = (red[:D * D].view(D, D),
                                  red[D * D:D * D + D], red[D * D + D:])
    if single_view is not None:
        void = n_single[0] > 0
    S_mat = Hpp - S_red
    b_schur = bp - b_red
    S_d = S_mat + mu * torch.diag(torch.clamp(torch.diagonal(S_mat),
                                              min=1.0))
    dx_p = torch.linalg.solve_ex(S_d, b_schur[:, None])[0][:, 0]
    finite = torch.isfinite(dx_p)
    dx_p = torch.where(finite & ~void, dx_p, 0.0)
    dl = torch.einsum("lab,lb->la", Hll_inv,
                      bl - torch.einsum("lia,i->la", U, dx_p))
    dl = torch.where(torch.isfinite(dl), dl, 0.0)
    return (dx_p.to(torch.float32), dl.to(torch.float32),
            void | ~torch.all(finite))


def vi_alignment(w: Window, opts: BAOptions):
    """Closed-form monocular visual-inertial alignment in the unbiased
    β = 1/α form (JAX window_ba.py:426-468, VINS-Mono §V-B): returns
    (alpha, v_est [S,3], constrained [S], ok, rel_std)."""
    valid = (w.imu_valid & w.state_valid[:-1] & w.state_valid[1:]
             & (w.imu.dt > 1e-4))
    return alignment_solve(w.q, w.p, w.imu.delta_p, w.imu.delta_v,
                           w.imu.dt, valid, opts)


def alignment_solve(q, p, delta_p, delta_v, dt_f, valid, opts: BAOptions):
    """β-form closed-form VI alignment over S states and S-1 consecutive
    preintegration factors:

        (p_j − p_i) = β·rhs_p + u_i·Δt,    0 = β·rhs_v + u_i − u_j

    with rhs_p = ½gΔt² + R_i·Δp, rhs_v = gΔt + R_i·Δv, u = v/α. Shared by
    the in-window alignment and the long-horizon buffer of
    ``device_interface.DeviceBackend``."""
    S = q.shape[0]
    nvar = 1 + 3 * S
    nf = S - 1
    dev, f32 = q.device, q.dtype
    g = _gravity(opts, q)
    R_i = quat_to_matrix(q[:nf])                           # [nf,3,3]
    dp = p[1:] - p[:nf]                                    # [nf,3]
    dt = dt_f
    rhs_p = (0.5 * g[None] * (dt * dt)[:, None]
             + torch.einsum("nij,nj->ni", R_i, delta_p))
    rhs_v = g[None] * dt[:, None] + torch.einsum("nij,nj->ni", R_i, delta_v)

    m = valid.to(f32)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    A = torch.zeros((nf, 6, nvar), dtype=f32, device=dev)
    for k in range(nf):
        c = 1 + 3 * k
        A[k, 0:3, 0] = rhs_p[k]               # position rows
        A[k, 0:3, c:c + 3] = eye3 * dt[k]
        A[k, 3:6, 0] = rhs_v[k]               # velocity rows
        A[k, 3:6, c:c + 3] = eye3
        A[k, 3:6, c + 3:c + 6] = -eye3
    A = (A * m[:, None, None]).reshape(-1, nvar)
    b = (torch.cat([dp, torch.zeros_like(dp)], -1) * m[:, None]).reshape(-1)
    n_fac = torch.sum(valid.long())
    # damp the velocity blocks of untouched states; β essentially undamped
    damp = torch.where(torch.arange(nvar, device=dev) == 0, 1e-9, 1e-6)
    AtA = A.T @ A + torch.diag(damp.to(f32))
    AtA_inv = torch.linalg.inv_ex(AtA)[0]
    x = AtA_inv @ (A.T @ b)
    beta = x[0]
    alpha = 1.0 / torch.where(torch.abs(beta) > 1e-8, beta, 1e-8)
    v_est = x[1:].reshape(S, 3) * alpha        # u = v/α → v = α·u
    resid = A @ x - b
    ms_res = torch.sum(resid * resid) / torch.clamp(6.0 * n_fac.to(f32),
                                                    min=1.0)
    std_beta = torch.sqrt(torch.clamp(ms_res, min=1e-12)
                          * torch.clamp(AtA_inv[0, 0], min=0.0))
    rel_std = std_beta / torch.clamp(torch.abs(beta), min=1e-6)
    ok = ((n_fac >= opts.vi_align_min_factors)
          & torch.isfinite(alpha) & (alpha > 0.2) & (alpha < 5.0)
          & (ms_res < opts.vi_align_max_residual)
          & (rel_std < opts.vi_align_max_sigma))
    none = torch.zeros((1,), dtype=torch.bool, device=dev)
    constrained = torch.cat([valid, none]) | torch.cat([none, valid])
    return alpha, v_est, constrained, ok, rel_std


def maybe_vi_align(w: Window, opts: BAOptions) -> Window:
    """Apply the closed-form alignment as a similarity about state 0
    (positions, landmarks; velocities replaced by the solved metric ones),
    dropping the marginalization prior (JAX window_ba.py:546-598); the
    application is selected on the device."""
    alpha, v_est, constrained, ok, rel_std = vi_alignment(w, opts)
    w = w._replace(align_min_rel=torch.minimum(w.align_min_rel, rel_std))
    cap = torch.where(w.has_prior, math.log(1.25), math.log(5.0))
    log_a = torch.log(torch.clamp(alpha, min=1e-6))
    alpha_app = torch.exp(torch.clamp(log_a, -cap, cap))
    c = w.p[0]
    sv = (w.state_valid & constrained)[:, None]
    v_new = torch.where(sv, v_est * (alpha_app / alpha), alpha_app * w.v)
    p_new = c[None] + alpha_app * (w.p - c[None])
    applied = w._replace(
        p=p_new, v=v_new,
        lm_pos=c[None] + alpha_app * (w.lm_pos - c[None]),
        H_prior=torch.zeros_like(w.H_prior),
        b_prior=torch.zeros_like(w.b_prior),
        q0=w.q, p0=p_new, v0=v_new, bg0=w.bg, ba0=w.ba,
        has_prior=torch.zeros_like(w.has_prior),
        align_n=w.align_n + 1,
        align_log=w.align_log + torch.log(alpha_app))
    deadband = torch.where(w.has_prior, 0.03, 0.01)
    do = ok & (torch.abs(log_a) > deadband)
    return tree_where(do, applied, w)


def optimize(w: Window, T_cam_body: SE3, focal,
             opts: BAOptions = BAOptions(), mesh=None,
             axes=(FEATURE_AXIS,), lm_offset: int = 0
             ) -> tuple[Window, torch.Tensor, torch.Tensor]:
    """LM iterations with keep-best (reference: 3 iterations a frame,
    ceres_backend_interface.hpp:29). Every accept/reject and damping
    update is selected on the device. Returns (window, cost, the number of
    iterations whose state step :func:`solve_schur` voided or zeroed in
    part). With ``mesh`` this rank holds landmark slots from ``lm_offset``
    on (``parallel.sharded_ba.distributed_optimize``); the states, cost and
    voided count come out the same on every rank."""
    shard = dict(mesh=mesh, axes=axes, lm_offset=lm_offset)
    if opts.vi_alignment:
        w = maybe_vi_align(w, opts)
    mu = torch.full((), opts.mu_init, dtype=w.q.dtype, device=w.q.device)
    best = system_chi2(w, T_cam_body, focal, opts, **shard)
    n_void = torch.zeros((), dtype=torch.long, device=w.q.device)
    for _ in range(opts.max_iter):
        Hpp, bp, U, Hll, bl, _ = build_system(w, T_cam_body, focal, opts,
                                              **shard)
        single = (single_view_landmarks(w, T_cam_body, focal, opts,
                                        lm_offset)
                  if opts.void_on_single_view else None)
        dx_p, dl, void = solve_schur(Hpp, bp, U, Hll, bl, mu, w.lm_valid,
                                     single, mesh, axes)
        n_void = n_void + void.long()
        cand = retract_states(w, dx_p)
        cand = cand._replace(lm_pos=w.lm_pos + dl * w.lm_valid[:, None])
        c2_new = system_chi2(cand, T_cam_body, focal, opts, **shard)
        ok = c2_new < best
        w = tree_where(ok, cand, w)
        best = torch.where(ok, c2_new, best)
        mu = torch.clamp(torch.where(ok, mu * 0.3, mu * 8.0),
                         opts.mu_floor, 1e6)
    return w, best, n_void


def marginalize_oldest(w: Window, T_cam_body: SE3, focal,
                       opts: BAOptions = BAOptions()) -> Window:
    """Slide the window: absorb state 0 into the dense prior, shift the
    states down (reference applyMarginalizationStrategy estimator.cpp:632,
    marginalization_error.hpp:67-329). The IMU factor 0→1, the existing
    prior and the reprojection information of landmarks that lose their
    multi-view support (< 2 remaining observations, which are absorbed and
    removed) are linearized before state 0 is Schur-complemented out."""
    S, L = w.S, w.L
    D = S * DOF
    dev, f32 = w.q.device, w.q.dtype

    # ---- classify landmarks touched by state 0 ------------------------
    lm_c = torch.clamp(w.obs_lm, 0, L - 1)
    valid_obs = (w.obs_valid & w.lm_valid[lm_c]
                 & w.state_valid[torch.clamp(w.obs_state, 0, S - 1)])
    obs0 = valid_obs & (w.obs_state == 0)
    obs_rest = valid_obs & (w.obs_state >= 1)
    has_obs0 = set_drop(torch.zeros((L,), dtype=torch.bool, device=dev),
                        torch.where(obs0, lm_c, L), True)
    n_rest = segment_sum(obs_rest.long(), torch.where(obs_rest, lm_c, L), L)
    absorb = w.lm_valid & has_obs0 & (n_rest < 2)

    # ---- linearize the absorbed landmarks' full observation sets ------
    wm = w._replace(obs_valid=valid_obs & absorb[lm_c])
    Hpp_v, bp_v, U_v, Hll_v, bl_v, _ = _assemble_reproj(
        wm, T_cam_body, focal, opts)
    # Schur out the (block-diagonal) landmark blocks, damped RELATIVE to
    # each block's scale; inactive blocks get a unit diagonal
    diag_max = torch.amax(torch.diagonal(Hll_v, dim1=-2, dim2=-1), dim=-1)
    lam = (1e-4 * torch.clamp(diag_max, min=1e-3)
           + torch.where(absorb, 0.0, 1.0))
    eye3 = torch.eye(3, dtype=f32, device=dev)
    Hll_inv = (torch.linalg.inv_ex(Hll_v + eye3[None] * lam[:, None, None])[0]
               * absorb[:, None, None])
    Hll_inv = torch.where(torch.isfinite(Hll_inv), Hll_inv, 0.0)
    H01 = Hpp_v - torch.einsum("lia,lab,ljb->ij", U_v, Hll_inv, U_v)
    b01 = bp_v - torch.einsum("lia,lab,lb->i", U_v, Hll_inv, bl_v)

    # ---- IMU factor 0→1 at the current estimate -----------------------
    r_imu, J_i, J_j = _imu_terms(w, opts)
    info0 = w.imu_info[0] * w.imu_valid[0].to(f32)
    Ji, Jj = J_i[0], J_j[0]
    H01 = H01.clone()
    b01 = b01.clone()
    H01[0:DOF, 0:DOF] += Ji.T @ info0 @ Ji
    H01[0:DOF, DOF:2 * DOF] += Ji.T @ info0 @ Jj
    H01[DOF:2 * DOF, 0:DOF] += Jj.T @ info0 @ Ji
    H01[DOF:2 * DOF, DOF:2 * DOF] += Jj.T @ info0 @ Jj
    b01[0:DOF] += -Ji.T @ info0 @ r_imu[0]
    b01[DOF:2 * DOF] += -Jj.T @ info0 @ r_imu[0]

    delta = local_coords(w)
    hp = w.has_prior.to(f32)
    H_tot = H01 + hp * w.H_prior
    b_tot = b01 + hp * (w.b_prior - w.H_prior @ delta)
    # keep the old gauge information on state 0's pose
    gauge = ((torch.arange(D, device=dev) < 6)
             * torch.where(w.has_prior, 0.0, 1e6))
    H_tot = H_tot + torch.diag(gauge)

    # Schur-complement out block 0
    H00 = H_tot[0:DOF, 0:DOF] + torch.eye(DOF, dtype=f32, device=dev) * 1e-8
    H0k = H_tot[0:DOF, DOF:]
    Hk0 = H_tot[DOF:, 0:DOF]
    Hkk = H_tot[DOF:, DOF:]
    H00_inv = torch.linalg.inv_ex(H00)[0]
    H_marg = Hkk - Hk0 @ H00_inv @ H0k
    b_marg = b_tot[DOF:] - Hk0 @ H00_inv @ b_tot[0:DOF]
    # symmetrize + clamp ONLY the negative modes Schur roundoff produces
    # (reference marginalization_error.hpp:329); eigh reads its info back.
    # In float64: LAPACK's float32 syevd fails to converge on some of these
    # marginals (cond ~1e7) once the window's states step
    H_marg = 0.5 * (H_marg + H_marg.T)
    eigval, eigvec = torch.linalg.eigh(H_marg.to(torch.float64))
    eigval = torch.clamp(eigval, min=0.0)
    H_marg = ((eigvec * eigval[None]) @ eigvec.T).to(f32)

    # shift into a [D,D] prior on the shifted states (last slot fresh)
    H_new = torch.zeros((D, D), dtype=f32, device=dev)
    H_new[:D - DOF, :D - DOF] = H_marg
    b_new = torch.cat([b_marg, torch.zeros(DOF, dtype=f32, device=dev)])

    def shift(x):
        return torch.cat([x[1:], x[-1:]], dim=0)

    none = torch.zeros((1,), dtype=torch.bool, device=dev)
    return w._replace(
        q=shift(w.q), p=shift(w.p), v=shift(w.v), bg=shift(w.bg),
        ba=shift(w.ba),
        state_valid=torch.cat([w.state_valid[1:], none]),
        obs_state=w.obs_state - 1,
        obs_valid=w.obs_valid & (w.obs_state >= 1) & ~absorb[lm_c],
        lm_valid=w.lm_valid & ~absorb,
        zupt=shift(w.zupt),
        imu=tree_map(shift, w.imu),
        imu_info=shift(w.imu_info),
        imu_valid=torch.cat([w.imu_valid[1:], none]),
        H_prior=H_new, b_prior=b_new,
        q0=shift(w.q), p0=shift(w.p), v0=shift(w.v),
        bg0=shift(w.bg), ba0=shift(w.ba),
        has_prior=torch.ones_like(w.has_prior))
