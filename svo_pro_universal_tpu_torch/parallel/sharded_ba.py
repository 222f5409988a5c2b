"""Landmark-sharded sliding-window BA over the mesh.

Counterpart of ``svo_pro_universal_tpu/parallel/sharded_ba.py`` (SURVEY.md
§2.3; the reference's 2-thread Ceres solve, ceres_backend_interface.hpp:29).
Each rank owns a contiguous block of landmark slots and the observation
rows of those landmarks; the state-block system and the reduced
camera-camera Schur system are all-reduced once each per LM iteration
(``window_ba`` with the mesh); the small dense state solve runs the same on
every rank. Landmark blocks never move until the result is gathered.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.parallel.mesh import FEATURE_AXIS, Mesh
from svo_pro_universal_tpu_torch.utils.transform import SE3


def partition_observations(w: wba.Window, n_shards: int
                           ) -> tuple[wba.Window, int]:
    """Reorder observation rows so each row sits in its landmark owner's
    shard slice (host numpy, vectorized; JAX sharded_ba.py:27-69). Shard d
    owns landmark slots [d·L/n, (d+1)·L/n) and rows [d·No/n, (d+1)·No/n).

    Returns (partitioned window, n_dropped): rows that overflow their
    shard's slice, or name a landmark outside [0, L), are dropped and
    counted. A caller must surface a non-zero count: the distributed solve
    would otherwise use fewer residuals than the single-device one."""
    L, No = w.L, w.obs_state.shape[0]
    if L % n_shards or No % n_shards:
        raise ValueError(f"L={L} and No={No} must split over {n_shards}")
    per_lm = L // n_shards
    per_obs = No // n_shards
    obs_lm = w.obs_lm.cpu().numpy()
    obs_valid = w.obs_valid.cpu().numpy()

    idx = np.nonzero(obs_valid)[0]
    d = obs_lm[idx] // per_lm
    in_range = (d >= 0) & (d < n_shards)
    idx, d = idx[in_range], d[in_range]
    # stable group-by shard: position within each shard's run
    order = np.argsort(d, kind="stable")
    idx_s, d_s = idx[order], d[order]
    starts = np.searchsorted(d_s, np.arange(n_shards))
    pos = np.arange(len(d_s)) - starts[d_s]
    keep = pos < per_obs
    n_dropped = int((~keep).sum()) + int((~in_range).sum())
    src = idx_s[keep]
    dst = d_s[keep] * per_obs + pos[keep]

    def scatter(x: torch.Tensor) -> torch.Tensor:
        a = x.cpu().numpy()
        out = np.zeros_like(a)
        out[dst] = a[src]
        return torch.from_numpy(out).to(x.device)

    new_valid = np.zeros(No, dtype=bool)
    new_valid[dst] = True
    return w._replace(
        obs_state=scatter(w.obs_state), obs_lm=scatter(w.obs_lm),
        obs_f=scatter(w.obs_f),
        obs_valid=torch.from_numpy(new_valid).to(w.obs_valid.device)
    ), n_dropped


def comms_volume_per_solve(S: int, n_iter: int,
                           void_on_single_view: bool = False) -> dict:
    """The bytes one distributed window solve all-reduces, per rank, as
    ``window_ba.optimize`` with a mesh issues them:

    - per LM iteration: Hpp [D, D], bp [D] and chi2 in float32
      (``build_system``), S_red [D, D], b_red [D] in float64 — the port's
      Schur reduction is float64 — plus one float64 count of single-view
      landmarks with ``void_on_single_view`` (``solve_schur``), and the
      candidate's float32 chi2 (``system_chi2``);
    - once before the loop: the initial float32 chi2.

    JAX's figure (sharded_ba.py:72-89) is ``2·(D² + D)·4`` bytes an
    iteration, float32 throughout, times ``n_iter + 1``. The gathers that
    return the landmarks (``distributed_optimize``) are not counted here.
    """
    D = S * wba.DOF
    per_iter = ((D * D + D + 1) * 4 + (D * D + D + int(void_on_single_view))
                * 8 + 4)
    return dict(bytes_per_iter=per_iter,
                bytes_per_solve=per_iter * n_iter + 4, state_dim=D,
                jax_float32_bytes_per_solve=2 * (D * D + D) * 4
                * (n_iter + 1))


def distributed_optimize(w: wba.Window, T_cam_body: SE3, focal, mesh: Mesh,
                         opts: wba.BAOptions = wba.BAOptions(),
                         axes: Sequence[str] = (FEATURE_AXIS,)
                         ) -> tuple[wba.Window, torch.Tensor, torch.Tensor]:
    """``window_ba.optimize`` with landmarks and observations sharded over
    ``axes`` of ``mesh``. ``w`` is whole on every rank and partitioned by
    ``partition_observations(w, n)``, n the product of the axes' sizes.
    Rank d of the axes takes landmark rows [d·L/n, (d+1)·L/n) and
    observation rows [d·No/n, (d+1)·No/n), solves with ``lm_offset =
    d·L/n``, and the landmarks are all-gathered: the returned window is
    whole on every rank. With a 2-D mesh and ``axes = (h, f)`` the landmark
    blocks stay host-local and only the reduced systems cross hosts.
    Returns (window, cost, voided iterations) as ``optimize``."""
    n = mesh.size(axes)
    d = mesh.index(axes)
    if w.L % n or w.obs_state.shape[0] % n:
        raise ValueError(f"the window (L={w.L}, No={w.obs_state.shape[0]}) "
                         f"does not split over {n} shards")
    w = wba.tree_map(lambda x: x.to(mesh.device), w)
    L_local = w.L // n
    per_obs = w.obs_state.shape[0] // n
    lm = slice(d * L_local, (d + 1) * L_local)
    ob = slice(d * per_obs, (d + 1) * per_obs)
    local = w._replace(
        lm_pos=w.lm_pos[lm], lm_valid=w.lm_valid[lm],
        obs_state=w.obs_state[ob], obs_lm=w.obs_lm[ob], obs_f=w.obs_f[ob],
        obs_valid=w.obs_valid[ob])
    T_cam_body = SE3(T_cam_body.q.to(mesh.device),
                     T_cam_body.t.to(mesh.device))
    out, chi2, n_void = wba.optimize(
        local, T_cam_body, torch.as_tensor(focal).to(mesh.device), opts,
        mesh=mesh, axes=axes, lm_offset=d * L_local)
    lm_all = mesh.all_gather(torch.cat(
        [out.lm_pos, out.lm_valid[:, None].to(out.lm_pos.dtype)], dim=1),
        axes)
    return out._replace(
        lm_pos=lm_all[:, :3].contiguous(), lm_valid=lm_all[:, 3] > 0.5,
        obs_state=w.obs_state, obs_lm=w.obs_lm, obs_f=w.obs_f,
        obs_valid=w.obs_valid), chi2, n_void
