"""Entry points for a single-device forward step and a multi-rank dry run.

The port's counterpart of the repo root's ``__graft_entry__.py``:

- ``entry()``: (fn, example_args) of the sparse-image-alignment forward
  step, the flagship compute path;
- ``dryrun_multichip(n)``: starts ``n`` ranks (``parallel.mesh.launch``)
  and runs one step of each sharded program on tiny shapes: the
  feature-parallel alignment (all-reduced normal system), the
  embarrassingly parallel seed update, the landmark-sharded window BA, and
  on an even ``n`` the same BA over a 2-D [host × chip] mesh with axes
  ``(h, f)``.

Both run on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.cameras.projections import (
    Camera, backproject)
from svo_pro_universal_tpu_torch.common import seed as seed_mod
from svo_pro_universal_tpu_torch.common.types import FeatureType
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.ops.pyramid import build_pyramid
from svo_pro_universal_tpu_torch.parallel import mesh as mesh_mod
from svo_pro_universal_tpu_torch.parallel.sharded_ba import (
    distributed_optimize, partition_observations)
from svo_pro_universal_tpu_torch.parallel.sharded_ops import (
    distributed_align, distributed_seed_update)
from svo_pro_universal_tpu_torch.utils.transform import SE3


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu'")
    return dev


def synthetic_inputs(h: int = 96, w: int = 128, n_feat: int = 64,
                     n_levels: int = 3, device=None
                     ) -> tuple[sia.CameraInput, Camera]:
    """``__graft_entry__._synthetic_inputs``: a smooth texture and its copy
    rolled 2 px in x, an 8×8 feature grid at depth 2, a pinhole camera."""
    dev = _device(device)
    cam = Camera.pinhole(120.0, 120.0, w / 2, h / 2, w, h, device=dev)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (120 + 40 * np.sin(x / 7) * np.cos(y / 5)
           + 25 * np.sin((x + y) / 11)).astype(np.float32)
    img2 = np.roll(img, 2, axis=1)
    uu, vv = np.meshgrid(np.linspace(12, w - 12, 8),
                         np.linspace(12, h - 12, 8))
    px = torch.as_tensor(np.stack([uu.ravel(), vv.ravel()], -1)[:n_feat]
                         .astype(np.float32), device=dev)
    n = px.shape[0]
    inp = sia.CameraInput(
        pyr_ref=build_pyramid(torch.as_tensor(img, device=dev), n_levels),
        pyr_cur=build_pyramid(torch.as_tensor(img2, device=dev), n_levels),
        px_ref=px, f_ref=backproject(cam, px),
        depth_ref=torch.full((n,), 2.0, device=dev),
        valid=torch.ones((n,), dtype=torch.bool, device=dev),
        T_cam_body=SE3.identity(device=dev), cam=cam)
    return inp, cam


def entry(device=None):
    """(fn, example_args): the sparse-image-alignment forward step."""
    inp, _ = synthetic_inputs(device=device)
    opts = sia.SparseImgAlignOptions(max_level=2, min_level=0, max_iter=5)

    def forward(inp, state):
        return sia.run([inp], state, opts)

    return forward, (inp, sia.make_state(device=inp.px_ref.device))


def dryrun_window(n_shards: int) -> wba.Window:
    """The dry run's window: 3 states 0.1 m apart in x, 8·n landmarks in
    a box ahead, every landmark seen by every state, capacity 16·n rows."""
    L, No = 8 * n_shards, 16 * n_shards
    w = wba.make_window(3, L, No)
    lm = np.random.default_rng(0).uniform(
        [-1, -1, 2], [1, 1, 4], (L, 3)).astype(np.float32)
    obs_s, obs_l, obs_f = [], [], []
    for s in range(3):
        for li in range(L):
            d = lm[li] - np.array([0.1 * s, 0, 0], np.float32)
            obs_s.append(s)
            obs_l.append(li)
            obs_f.append(d / np.linalg.norm(d))
    k = min(len(obs_s), No)
    p = w.p.clone()
    p[1, 0], p[2, 0] = 0.1, 0.2
    obs_state, obs_lm = w.obs_state.clone(), w.obs_lm.clone()
    obs_fs, obs_valid = w.obs_f.clone(), w.obs_valid.clone()
    obs_state[:k] = torch.as_tensor(obs_s[:k])
    obs_lm[:k] = torch.as_tensor(obs_l[:k])
    obs_fs[:k] = torch.as_tensor(np.stack(obs_f[:k]))
    obs_valid[:k] = True
    return w._replace(
        state_valid=torch.arange(3) < 3, p=p, lm_pos=torch.as_tensor(lm),
        lm_valid=torch.ones((L,), dtype=torch.bool), obs_state=obs_state,
        obs_lm=obs_lm, obs_f=obs_fs, obs_valid=obs_valid)


def dryrun_steps(n: int, device) -> dict:
    """The dry run's steps inside one of ``n`` initialized ranks; returns
    this rank's pose, costs and counts, on the CPU."""
    mesh = mesh_mod.make_mesh(n, device=device)
    n_feat = max(8 * n, 16)
    n_feat -= n_feat % n
    inp, cam = synthetic_inputs(h=48, w=64, n_feat=n_feat, device="cpu")
    opts = sia.SparseImgAlignOptions(max_level=1, min_level=0, max_iter=3)
    state, stats = distributed_align(inp, sia.make_state(), opts, mesh)

    nf = inp.px_ref.shape[0]
    seeds = seed_mod.make(torch.full((nf,), 2.0), torch.full((nf,), 0.5))
    ftype = torch.full((nf,), int(FeatureType.CORNER_SEED), dtype=torch.long)
    res = distributed_seed_update(
        inp.pyr_ref, inp.pyr_cur, cam,
        SE3(torch.tensor([1.0, 0, 0, 0]), torch.tensor([0.05, 0.0, 0.0])),
        inp.px_ref, inp.f_ref, torch.zeros((nf, 2)),
        torch.zeros((nf,), dtype=torch.long), ftype, seeds,
        torch.tensor(2.0), mesh, max_search_level=1)

    wp, _ = partition_observations(dryrun_window(n), n)
    focal = torch.tensor(120.0)
    w1, chi2, _ = distributed_optimize(wp, SE3.identity(), focal, mesh,
                                       wba.BAOptions(max_iter=2))
    out = dict(t=state.T_icur_iref.t.cpu(), chi2_align=stats.chi2.cpu(),
               n_updated=res.n_updated.cpu(), chi2_ba=chi2.cpu(),
               p=w1.p.cpu())
    if n >= 2 and n % 2 == 0:
        mesh2 = mesh_mod.make_mesh_2d(2, n // 2, device=device)
        w2, chi2_2, _ = distributed_optimize(
            wp, SE3.identity(), focal, mesh2, wba.BAOptions(max_iter=2),
            axes=(mesh_mod.HOST_AXIS, mesh_mod.FEATURE_AXIS))
        out |= dict(chi2_ba_2d=chi2_2.cpu(), p_2d=w2.p.cpu())
    return out


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """One step of every sharded program on ``n_devices`` ranks; returns
    each rank's results (pose, costs, counts), on the CPU."""
    return mesh_mod.launch(n_devices, dryrun_steps, n_devices, device,
                           device=device)
