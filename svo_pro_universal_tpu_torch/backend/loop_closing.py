"""Loop closing: place recognition, geometric verification and the
pose-graph constraint.

Counterpart of ``svo_pro_universal_tpu/backend/loop_closing.py`` (reference
extra/svo_online_loopclosing/src/loop_closing.cpp — runPROnLatestKeyframe:
76-140, geometricVerification:238, relative-scale retrieval:303-339). The
design is the JAX package's:

- place recognition: a HOG/Hellinger global descriptor per keyframe; the
  database is one matrix and a query is one product with all ``nbins``
  circular rolls of the query's orientation bins (in-plane rotation);
- verification: mutual-nearest-neighbour matching of gain-normalized
  patches (an [Na, Nb] distance matrix from one product, a ratio test),
  an IRLS-Umeyama Sim3 seed from the two keyframes' depths, and a
  two-stage robust 3D-2D pose GN (``ops.pose_optimizer``).

The JAX module imports ``ransac_relative_pose`` and makes a PRNG key that
nothing reads; neither is carried here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from svo_pro_universal_tpu_torch.cameras.projections import (
    Camera, DistortionModel, ProjectionModel)
from svo_pro_universal_tpu_torch.frontend.frame_handler import resolve_device
from svo_pro_universal_tpu_torch.ops import pose_optimizer as po
from svo_pro_universal_tpu_torch.ops.interp import extract_patches
from svo_pro_universal_tpu_torch.utils.indexing import take0
from svo_pro_universal_tpu_torch.utils.robust import masked_median
from svo_pro_universal_tpu_torch.utils.transform import SE3, matrix_to_quat


class LoopClosingOptions(NamedTuple):
    descriptor_cells: tuple = (4, 5)    # HOG pooling grid
    descriptor_bins: int = 8            # orientation bins (mod π)
    min_similarity: float = 0.8         # cosine gate for candidates
    min_temporal_gap: int = 8           # skip recent keyframes
    max_keyframes: int = 512            # database capacity (a ring)
    patch_size: int = 16
    # per-pixel score gate in unit-variance patch units: 2(1 − NCC)
    max_match_zmssd_per_px: float = 1.6
    ratio_test: float = 0.8
    min_inliers: int = 20
    ransac_thresh_px: float = 2.0


class KeyframeSnapshot(NamedTuple):
    """Per-keyframe data kept for loop closing (device tensors)."""
    descriptor: torch.Tensor  # [D]
    px: torch.Tensor          # [N, 2]
    f: torch.Tensor           # [N, 3]
    depth: torch.Tensor       # [N] feature depths (0 = unknown)
    patches: torch.Tensor     # [N, P²] level-0 patches around features
    valid: torch.Tensor       # [N]


class LoopCandidate(NamedTuple):
    kf_id: int
    similarity: float


class LoopConstraint(NamedTuple):
    kf_id_from: int          # current keyframe
    kf_id_to: int            # matched older keyframe
    T_cur_old: SE3           # metric relative pose cur←old
    n_inliers: int
    similarity: float


def global_descriptor(image: torch.Tensor, cells: tuple = (4, 5),
                      nbins: int = 8) -> torch.Tensor:
    """HOG-style place signature: per-cell gradient-orientation histograms
    (mod π), each cell L1-normalized and square-rooted (Hellinger), then
    zero-mean and globally L2-normalized."""
    img = image
    dy = img[2:, 1:-1] - img[:-2, 1:-1]
    dx = img[1:-1, 2:] - img[1:-1, :-2]
    mag = torch.sqrt(dx * dx + dy * dy)
    # atan2 in float64, rounded to the image's type: torch's float32 atan2
    # is an ulp off XLA's on ~13% of an integer image's gradients, which
    # often lie on a bin edge (|dx| = |dy| is 45°), and moved ~3% of
    # pixels to another bin (descriptor cosine 0.992 at 752×480)
    ang = torch.atan2(dy.double(), dx.double()).to(img.dtype)
    # ``jnp.remainder``: fmod, then + π where negative
    ang = torch.fmod(ang, torch.pi)
    ang = torch.where(ang < 0, ang + torch.pi, ang)
    h, w = mag.shape
    ch, cw = cells
    bh, bw = h // ch, w // cw
    mag = mag[: ch * bh, : cw * bw]
    ang = ang[: ch * bh, : cw * bw]
    bin_idx = torch.clamp((ang / torch.pi * nbins).to(torch.long), 0,
                          nbins - 1)
    onehot = torch.nn.functional.one_hot(bin_idx, nbins).to(mag.dtype)
    cellh = (onehot * mag[..., None]).reshape(
        ch, bh, cw, bw, nbins).sum((1, 3))           # [ch, cw, nbins]
    cellh = cellh / torch.clamp(cellh.sum(-1, keepdim=True), min=1e-6)
    v = torch.sqrt(cellh).reshape(-1)
    v = v - torch.mean(v)
    return v / torch.clamp(torch.linalg.norm(v), min=1e-8)


def rolled_similarities(desc_mat: torch.Tensor, q: torch.Tensor,
                        cells: tuple, nbins: int) -> torch.Tensor:
    """[K] best cosine of each database row with the query under every
    circular roll of its orientation bins (one product)."""
    qc = q.reshape(cells[0] * cells[1], nbins)
    variants = torch.stack([torch.roll(qc, r, dims=-1).reshape(-1)
                            for r in range(nbins)])
    return torch.amax(desc_mat @ variants.T, dim=-1)


def snapshot_keyframe(image: torch.Tensor, px: torch.Tensor,
                      f: torch.Tensor, depth: torch.Tensor,
                      valid: torch.Tensor,
                      opts: LoopClosingOptions = LoopClosingOptions()
                      ) -> KeyframeSnapshot:
    patches, ok = extract_patches(image, px, opts.patch_size)
    return KeyframeSnapshot(
        global_descriptor(image, opts.descriptor_cells,
                          opts.descriptor_bins),
        px, f, depth, patches, valid & ok)


def _normalize_patches(p: torch.Tensor) -> torch.Tensor:
    """Zero-mean, unit-variance per patch (the score is then a monotone
    function of NCC: invariant to a visit's gain and offset)."""
    c = p - torch.mean(p, dim=-1, keepdim=True)
    sd = torch.sqrt(torch.mean(c * c, dim=-1, keepdim=True))
    return c / torch.clamp(sd, min=1e-3)


def match_snapshots(a: KeyframeSnapshot, b: KeyframeSnapshot,
                    opts: LoopClosingOptions = LoopClosingOptions()
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mutual-NN patch matching with a ratio test on the normalized
    distance Σ(pa−pb)² = 2(area − pa·pb). Returns (idx_b_for_a [Na],
    ok [Na])."""
    area = a.patches.shape[1]
    pa = _normalize_patches(a.patches)
    pb = _normalize_patches(b.patches)
    score = 2.0 * (area - pa @ pb.T)                 # [Na, Nb]
    big = 1e12
    score = torch.where(a.valid[:, None] & b.valid[None, :], score, big)
    best = torch.amin(score, dim=1)
    nn_ab = torch.argmin(score, dim=1)
    cols = torch.arange(score.shape[1], device=score.device)
    second = torch.amin(torch.where(cols[None] == nn_ab[:, None], big,
                                    score), dim=1)
    nn_ba = torch.argmin(score, dim=0)
    mutual = nn_ba[nn_ab] == torch.arange(a.px.shape[0], device=score.device)
    ok = (a.valid & mutual
          & (best < opts.max_match_zmssd_per_px * area)
          & (best < opts.ratio_test * second))
    return nn_ab, ok


def sim3_init_3d3d(xyz_old: torch.Tensor, xyz_cur: torch.Tensor,
                   w0: torch.Tensor, iters: int = 3
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Robust closed-form Sim3 old→cur from matched 3D points, xyz_cur ≈
    s·R·xyz_old + t: IRLS-weighted Umeyama (a 3×3 SVD a round), each round
    re-gated at 3× the median residual. Returns (s, R [3, 3], t). The SVD
    of a 3×3 on the card goes through cuSOLVER and reads its status back
    (one host sync a round; this runs only on loop candidates)."""
    def umeyama(w):
        sw = torch.clamp(torch.sum(w), min=1e-6)
        mo = torch.sum(xyz_old * w[:, None], 0) / sw
        mc = torch.sum(xyz_cur * w[:, None], 0) / sw
        xo = xyz_old - mo
        xc = xyz_cur - mc
        C = (xc * w[:, None]).T @ xo / sw            # cur←old covariance
        U, D, Vt = torch.linalg.svd(C)
        d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
        diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
        R = (U * diag[None, :]) @ Vt
        var_o = torch.clamp(torch.sum(w[:, None] * xo * xo) / sw, min=1e-9)
        s = torch.clamp(torch.sum(D * diag) / var_o, 0.1, 10.0)
        return s, R, mc - s * (R @ mo)

    w = w0.to(torch.float32)
    s, R, t = umeyama(w)
    for _ in range(iters - 1):
        res = xyz_cur - (s * (xyz_old @ R.T) + t[None])
        r = torch.linalg.norm(res, dim=-1)
        gate = 3.0 * masked_median(r, w0) + 1e-4
        w = w0.to(torch.float32) * (r < gate)
        s, R, t = umeyama(w)
    return s, R, t


def _verify_camera(focal_length, device) -> Camera:
    """The 10000×10000 pinhole of unit-plane verification, its intrinsics
    made on ``device`` (from a focal length there: no host read)."""
    fl = torch.as_tensor(focal_length, dtype=torch.float32, device=device)
    zero = torch.zeros_like(fl)
    return Camera(ProjectionModel.PINHOLE, DistortionModel.NONE,
                  torch.stack([fl, fl, zero, zero]), zero.reshape(1),
                  10000, 10000)


def verify_pose(xyz_old: torch.Tensor, f_cur: torch.Tensor,
                ok: torch.Tensor, focal_length, T_init: SE3, max_iter: int,
                thresh_px: float) -> po.PoseOptResult:
    """Two-stage robust 3D-2D verification GN: stage 1 from ``T_init``
    over all candidate matches, stage 2 re-solved on the stage-1 inliers at
    ``thresh_px`` (reference PoseOptimizer removeOutliers + re-solve,
    src/svo/src/pose_optimizer.cpp:196-298). Returns the stage-2 result."""
    n = xyz_old.shape[0]
    dev = xyz_old.device
    cam = _verify_camera(focal_length, dev)

    def run(valid, T0):
        fs = po.PoseOptFeatures(
            xyz_world=xyz_old, f=f_cur,
            grad=torch.zeros((n, 2), device=dev),
            level=torch.zeros((n,), dtype=torch.long, device=dev),
            is_edgelet=torch.zeros((n,), dtype=torch.bool, device=dev),
            valid=valid, T_cam_body=SE3.identity(device=dev), cam=cam)
        return po.optimize_pose(
            [fs], T0, po.PoseOptOptions(max_iter=max_iter,
                                        reproj_thresh_px=thresh_px))

    res1 = run(ok, T_init)
    return run(res1.inlier[0] & ok, res1.T_body_world)


def sim3_seed(xyz_old: torch.Tensor, cur: KeyframeSnapshot,
              ok: torch.Tensor) -> SE3:
    """The verification GN's start: the IRLS-Umeyama pose (bearings are
    scale-free: X_cur ∝ R·X_old + t/s) where ≥ 6 matches carry depths in
    both keyframes, else the identity; selected on the device."""
    both = ok & (cur.depth > 1e-6)
    xyz_cur = cur.f * cur.depth[:, None]
    s3, R3, t3 = sim3_init_3d3d(xyz_old, xyz_cur, both)
    use3 = torch.sum(both.long()) >= 6
    ident = SE3.identity(device=xyz_old.device)
    return SE3(torch.where(use3, matrix_to_quat(R3), ident.q),
               torch.where(use3, t3 / s3, ident.t))


class Verification(NamedTuple):
    """One candidate's geometric verification (device tensors)."""
    verified: torch.Tensor    # bool: ≥ min_inliers matches and GN inliers
    T_cur_old: SE3            # the stage-2 pose, old keyframe → current
    n_nn: torch.Tensor        # mutual-NN matches
    n_matches: torch.Tensor   # of those, with a depth in the old keyframe
    n_inliers: torch.Tensor   # stage-2 GN inliers


def verify_candidate(cur: KeyframeSnapshot, old: KeyframeSnapshot,
                     focal_length, opts: LoopClosingOptions,
                     max_iter: int = 15) -> Verification:
    """3D-2D verification of ``old`` against ``cur`` (JAX
    ``LoopClosing._verify`` and pipeline_slam ``do_loop``): mutual-NN patch
    matches, the old keyframe's depths as 3D points, the GN seeded by
    :func:`sim3_seed` on every match. No host read."""
    nn, ok = match_snapshots(cur, old, opts)
    n_nn = torch.sum(ok.long())
    d_old = old.depth[nn]
    ok = ok & (d_old > 1e-6)
    n_matches = torch.sum(ok.long())
    xyz_old = old.f[nn] * d_old[:, None]      # points in the OLD camera
    res = verify_pose(xyz_old, cur.f, ok, focal_length,
                      sim3_seed(xyz_old, cur, ok), max_iter=max_iter,
                      thresh_px=opts.ransac_thresh_px)
    n_inl = res.n_inliers.long()
    verified = (n_matches >= opts.min_inliers) & (n_inl >= opts.min_inliers)
    return Verification(verified, res.T_body_world, n_nn, n_matches, n_inl)


class LoopClosing:
    """Keyframe database and loop detection (reference LoopClosing,
    loop_closing.h:127-396). The descriptor matrix lives on the device (the
    card unless ``device`` says otherwise) as a ring: past capacity the
    oldest row is evicted (counted)."""

    def __init__(self, opts: LoopClosingOptions = LoopClosingOptions(),
                 device=None):
        self.opts = opts
        self.device = resolve_device(device)
        self.snapshots: list[KeyframeSnapshot] = []
        self.kf_ids: list[int] = []
        self._n_added = 0          # total adds; write row = _n_added % K
        self.n_evicted = 0
        D = (opts.descriptor_cells[0] * opts.descriptor_cells[1]
             * opts.descriptor_bins)
        self._desc_matrix = torch.zeros((opts.max_keyframes, D),
                                        device=self.device)

    def __len__(self):
        return len(self.snapshots)

    def add_keyframe(self, kf_id: int, snapshot: KeyframeSnapshot,
                     focal_length) -> Optional[LoopConstraint]:
        """Query and verify against the database, then insert."""
        result = None
        cand = self._query(snapshot, cur_kf_id=kf_id)
        if cand is not None:
            result = self._verify(kf_id, snapshot, cand, focal_length)
        K = self.opts.max_keyframes
        row = self._n_added % K
        if len(self.snapshots) < K:
            self.snapshots.append(snapshot)
            self.kf_ids.append(kf_id)
        else:
            self.snapshots[row] = snapshot
            self.kf_ids[row] = kf_id
            self.n_evicted += 1
        self._desc_matrix = self._desc_matrix.clone()
        self._desc_matrix[row] = snapshot.descriptor.to(
            self._desc_matrix.device)
        self._n_added += 1
        return result

    def _query(self, snapshot: KeyframeSnapshot, include_recent: bool = False,
               cur_kf_id: Optional[int] = None) -> Optional[LoopCandidate]:
        """The best eligible row (by keyframe-id gap) at or above
        ``min_similarity``; one read of (row, similarity)."""
        n = len(self.snapshots)
        if n == 0:
            return None
        elig = np.zeros((self.opts.max_keyframes,), bool)
        if include_recent or cur_kf_id is None:
            elig[:n] = True
        else:
            elig[:n] = (np.asarray(self.kf_ids)
                        <= cur_kf_id - self.opts.min_temporal_gap)
        if not elig.any():
            return None
        dm = self._desc_matrix
        sims = rolled_similarities(dm, snapshot.descriptor.to(dm.device),
                                   self.opts.descriptor_cells,
                                   self.opts.descriptor_bins)
        sims = torch.where(torch.from_numpy(elig).to(dm.device), sims,
                           float("-inf"))
        best = torch.argmax(sims)
        best, sim = torch.stack([best.to(sims.dtype),
                                 take0(sims, best)]).tolist()
        if sim < self.opts.min_similarity:
            return None
        return LoopCandidate(int(best), sim)

    def _verify(self, kf_id: int, cur: KeyframeSnapshot,
                cand: LoopCandidate, focal_length
                ) -> Optional[LoopConstraint]:
        """3D-2D verification: the old keyframe's depths give 3D points,
        T_cur_old comes from the robust pose GN seeded by the Sim3."""
        v = verify_candidate(cur, self.snapshots[cand.kf_id], focal_length,
                             self.opts)
        verified, n_inl = torch.stack([v.verified.long(),
                                       v.n_inliers]).tolist()  # one read
        if not verified:
            return None
        return LoopConstraint(kf_id, int(self.kf_ids[cand.kf_id]),
                              v.T_cur_old, n_inl, cand.similarity)
