"""Edge-based depth utilities: multi-scale reliable-edge detection and
photometric 1-dof depth refinement.

Counterpart of ``svo_pro_universal_tpu/ops/edge_depth.py``:

- ``detect_edges``: Elder-Zucker local scale control (reference
  src/svo_direct/src/elder_zucker.cpp detectEdges:12-150) as whole-image
  programs per pyramid level (Scharr gradient, directional magnitude
  thresholded by the sensor-noise critical value c1, the steered second
  derivative thresholded by c2) and one finest-reliable-level selection. It
  returns the signed cascaded second derivative, as the JAX package does
  (see its note on the divergence from the reference's edge map).
- ``refine_depth_photometric``: the reference's 1-dof GN ``DepthEstimator``
  (src/svo_direct/include/svo/direct/depth_estimation.h:20-70) for all
  features at once: d(pixel)/d(depth) is a forward-mode derivative
  (``torch.func.jvp``) of the camera projection, and the 8×8 patches are
  sampled in 24×24 tiles cut by ``ops.tiles.extract_tiles`` — on the card
  the ``gather_tiles`` kernel, one launch per GN iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from svo_pro_universal_tpu_torch.cameras import projections as proj
from svo_pro_universal_tpu_torch.ops import tiles as tl
from svo_pro_universal_tpu_torch.ops.pyramid import level_view
from svo_pro_universal_tpu_torch.utils.transform import SE3

_PI = 3.14159265358979323846264


def _f32(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def _gauss3(img: torch.Tensor) -> torch.Tensor:
    """Separable 3×3 binomial blur (edge-replicated)."""
    k0, k1, k2 = 0.25, 0.5, 0.25
    p = F.pad(img[None, None], (0, 0, 1, 1), mode="replicate")[0, 0]
    v = p[:-2] * k0 + p[1:-1] * k1 + p[2:] * k2
    p = F.pad(v[None, None], (1, 1, 0, 0), mode="replicate")[0, 0]
    return p[:, :-2] * k0 + p[:, 1:-1] * k1 + p[:, 2:] * k2


def _scharr(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scharr x/y derivatives with OpenCV weights (3, 10, 3)."""
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    vsm = 3.0 * p[:-2, :] + 10.0 * p[1:-1, :] + 3.0 * p[2:, :]
    dx = vsm[:, 2:] - vsm[:, :-2]
    hsm = 3.0 * p[:, :-2] + 10.0 * p[:, 1:-1] + 3.0 * p[:, 2:]
    dy = hsm[2:, :] - hsm[:-2, :]
    return dx, dy


def _upsample(x: torch.Tensor, rep: int, H0: int, W0: int) -> torch.Tensor:
    """Nearest-neighbour upsample by ``rep`` onto the level-0 grid."""
    x = x.repeat_interleave(rep, 0).repeat_interleave(rep, 1)[:H0, :W0]
    return F.pad(x, (0, W0 - x.shape[1], 0, H0 - x.shape[0]))


class EdgeMap(NamedTuple):
    edge: torch.Tensor    # [H, W] steered 2nd-derivative response (0 = none)
    level: torch.Tensor   # [H, W] finest reliable pyramid level
    angle: torch.Tensor   # [H, W] gradient direction at the chosen scale


def detect_edges(pyr3: torch.Tensor, sigma: float = 5.0,
                 alpha_p: float = 2e-7) -> EdgeMap:
    """Reliable multi-scale edges with per-pixel finest-scale selection on
    a padded [L, H, W] pyramid; levels 0..L-2 take part
    (elder_zucker.cpp:21). ``sigma`` is the sensor noise, ``alpha_p`` the
    false-positive rate of both critical thresholds. The thresholds are
    float32 values computed as the JAX package computes them."""
    dev = pyr3.device
    n_use = max(1, pyr3.shape[0] - 1)
    H0, W0 = pyr3.shape[1:]
    sq2pi = torch.sqrt(_f32(2.0 * _PI, dev))
    log_a = torch.sqrt(-2.0 * torch.log(_f32(alpha_p, dev)))
    sq_pi3 = torch.sqrt(_f32(_PI / 3.0, dev))
    erf_a = torch.special.erfinv(_f32(1.0 - alpha_p, dev))
    angles, logs = [], []
    for L in range(n_use):
        img = _gauss3(level_view(pyr3, L))
        dx, dy = _scharr(img)
        scale = float(L + 1)
        s1 = sigma / (2.0 * sq2pi * scale * scale)
        c1 = s1 * log_a
        ang = torch.atan2(dy, dx)
        mag = torch.cos(ang) * dx + torch.sin(ang) * dy
        rel = torch.abs(mag) >= c1
        dxdx, dxy_a = _scharr(dx)
        dyx_b, dydy = _scharr(dy)
        dxdy = 0.5 * (dxy_a + dyx_b)
        dxdx = _gauss3(dxdx)
        dydy = _gauss3(dydy)
        dxdy = _gauss3(dxdy)
        s2 = sigma / (4.0 * sq_pi3 * scale ** 3)
        c2 = math.sqrt(2.0) * s2 * erf_a
        ca = torch.cos(ang)
        sa = torch.sin(ang)
        lg = ca * ca * dxdx + sa * sa * dydy - 2.0 * ca * sa * dxdy
        lg = torch.where((torch.abs(lg) < c2) | ~rel, 0.0, lg)
        ang = torch.where(rel, ang, 0.0)
        angles.append(_upsample(ang, 1 << L, H0, W0))
        logs.append(_upsample(lg, 1 << L, H0, W0))
    angs = torch.stack(angles)
    lgs = torch.stack(logs)
    hit = lgs != 0.0
    lev = torch.argmax(hit.to(torch.uint8), dim=0)
    any_hit = torch.any(hit, dim=0)
    take = torch.gather(lgs, 0, lev[None])[0]
    take_a = torch.gather(angs, 0, lev[None])[0]
    return EdgeMap(edge=torch.where(any_hit, take, 0.0),
                   level=torch.where(any_hit, lev, 0),
                   angle=torch.where(any_hit, take_a, 0.0))


# ---------------------------------------------------------------------------
# photometric depth refinement (reference DepthEstimator)
# ---------------------------------------------------------------------------

HALF_PATCH = 4
PATCH = 2 * HALF_PATCH            # reference kPatchSize depth_estimation.h:28
TILE = 24


class DepthRefineResult(NamedTuple):
    depth: torch.Tensor      # [N] refined depth along the ref bearing
    cost: torch.Tensor       # [N] final mean photometric error (abs)
    converged: torch.Tensor  # [N] bool


def refine_depth_photometric(pyr_cur: torch.Tensor, cam: proj.Camera,
                             T_cur_ref: SE3, f_ref: torch.Tensor,
                             ref_patch: torch.Tensor,
                             depth_init: torch.Tensor, level: torch.Tensor,
                             valid: torch.Tensor, n_iter: int = 10,
                             max_cost: float = 20.0) -> DepthRefineResult:
    """Batched 1-dof GN on the patch photometric error against depth, a
    fixed ``n_iter`` iterations for every feature at once (no host read).

    pyr_cur [L, H, W]; f_ref [N, 3] unit bearings in the ref frame;
    ref_patch [N, 64] reference patches at ``level``; depth_init [N];
    level [N] sampling level in cur; valid [N]."""
    dev = f_ref.device
    n = f_ref.shape[0]
    scale = (torch.ones_like(level) << level).to(torch.float32)
    r = torch.arange(PATCH, dtype=torch.float32, device=dev) \
        - (HALF_PATCH - 0.5)
    ov, ou = torch.meshgrid(r, r, indexing="ij")
    poffs = torch.stack([ou.reshape(-1), ov.reshape(-1)], -1)  # [P², 2]

    def uv_of_depth(d):
        p_cur = T_cur_ref.apply(f_ref * d[:, None])
        uv, ok = proj.project(cam, p_cur)
        return uv, ok & (p_cur[:, 2] > 1e-6)

    d = best_d = depth_init
    best_cost = torch.full((n,), float("inf"), device=dev)
    for _ in range(n_iter):
        uv, ok = uv_of_depth(d)
        duv = torch.func.jvp(lambda dd: uv_of_depth(dd)[0], (d,),
                             (torch.ones_like(d),))[1]     # [N, 2] px/depth
        uv_l = uv / scale[:, None]
        duv_l = duv / scale[:, None]
        cyx = torch.stack([uv_l[:, 1], uv_l[:, 0]], -1)
        tb = tl.extract_tiles(pyr_cur, level, cyx, TILE, TILE)
        pts = uv_l[:, None, :] + poffs[None]
        vals, gx, gy, inb = tl.tile_bilinear_grad(tb, pts[..., 1],
                                                  pts[..., 0])
        res = vals - ref_patch
        J = gx * duv_l[:, 0:1] + gy * duv_l[:, 1:2]
        m = (inb & ok[:, None] & valid[:, None]).to(torch.float32)
        Hd = torch.sum(J * J * m, -1)
        g = torch.sum(J * res * m, -1)
        # a patch mostly off the image is never photometrically confirmed:
        # at least half of it must be in view, else the cost is +inf
        npx_raw = torch.sum(m, -1)
        npx = torch.clamp(npx_raw, min=1.0)
        cost = torch.where(npx_raw >= PATCH * PATCH / 2,
                           torch.sum(torch.abs(res) * m, -1) / npx,
                           float("inf"))
        improved = cost < best_cost
        best_d = torch.where(improved, d, best_d)
        best_cost = torch.where(improved, cost, best_cost)
        step = -g / torch.clamp(Hd, min=1e-8)
        lim = 0.2 * torch.abs(d)
        step = torch.minimum(torch.maximum(step, -lim), lim)
        d = torch.where(ok & (Hd > 1e-8), d + step, d)
    conv = valid & torch.isfinite(best_cost) & (best_cost < max_cost)
    return DepthRefineResult(depth=best_d, cost=best_cost, converged=conv)
