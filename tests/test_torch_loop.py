"""The port's loop-closing pieces against the JAX package's, on the CPU:
``ops.interp.extract_patches``, ``backend.pgo``, ``backend.loop_closing``.

- ``extract_patches``: patches within 1e-4 (bilinear of 0..255 values,
  the same four taps), the in-bounds flags equal.
- ``pgo.optimize`` on tests/test_pgo.py's drift-plus-loop graph (25
  iterations): every node within 1e-3 m and 1e-3 rad of JAX's, the cost
  within 1e-3 of its start; at the truth the cost is below 1e-8.
- ``global_descriptor``: cosine ≥ 0.999 with JAX's on float-valued
  renders, ≥ 1 − 1e-6 on integer images (gradients on bin edges); the
  rolled query picks the same row.
- ``match_snapshots``: the same pairs.
- ``sim3_init_3d3d``: R within 1e-4, s within 1e-4 relative, t within
  1e-4 m (U and V of the SVD are not unique, R, s and t are);
  ``verify_pose``: the same inlier count, the pose within 1e-4.
- ``verify_candidate``, the one verification of ``LoopClosing`` and of
  ``DevicePipelineSLAM``: on the sphere pair the verdict, the match and
  inlier counts equal JAX's ``LoopClosing._verify`` chain, the pose within
  1e-4.
- ``LoopClosing``: no loop on tests/test_loop_closing.py's distinct
  views, as JAX; a revisit of the first view verified against the same
  keyframe with the same inliers and pose as JAX;
  tests/test_loop_pr_benchmark.py's ring eviction gives the same database
  and the same late-place candidate as JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.backend import loop_closing as jlc
from svo_pro_universal_tpu.backend import pgo as jpgo
from svo_pro_universal_tpu.ops.interp import extract_patches as jextract
from svo_pro_universal_tpu.utils.transform import SE3 as JSE3, se3_exp
from svo_pro_universal_tpu_torch.backend import loop_closing as tlc
from svo_pro_universal_tpu_torch.backend import pgo as tpgo
from svo_pro_universal_tpu_torch.ops.interp import extract_patches
from svo_pro_universal_tpu_torch.utils.transform import SE3

from synthetic_utils import render_sphere_view
from test_loop_closing import make_snapshot
from test_loop_pr_benchmark import _plane_snapshot, random_texture
from test_pgo import circle_poses


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_snapshot(js, image) -> tlc.KeyframeSnapshot:
    """The port's snapshot of the JAX snapshot's keyframe: the same image
    and features through the port's ``snapshot_keyframe``."""
    return tlc.snapshot_keyframe(_t(image), _t(js.px), _t(js.f),
                                 _t(js.depth), _t(js.valid))


def _plane_pair(tex, T):
    js = _plane_snapshot(tex, T)
    from test_loop_pr_benchmark import CAM, PLANE_Z, render_plane_view
    img = render_plane_view(tex, T, cam=CAM, plane_z=PLANE_Z)
    return js, _port_snapshot(js, img)


def test_extract_patches_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    c = np.stack([rng.uniform(-6, 86, 200), rng.uniform(-6, 66, 200)],
                 -1).astype(np.float32)
    c[:4] = [[8.0, 8.0], [71.0, 51.0], [72.0, 52.0], [7.5, 8.25]]
    pj, okj = jextract(jnp.asarray(img), jnp.asarray(c), 16)
    pt, okt = extract_patches(_t(img), _t(c), 16)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.any() and not okt.all()
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _drift_graphs():
    """tests/test_pgo.py:40's graph (12 circle poses, drifting odometry,
    one accurate loop constraint weighted 100) in both packages."""
    n = 12
    gt = circle_poses(n)
    drift = se3_exp(jnp.asarray([0.08, 0.03, 0.01, 0.005, 0.0, 0.04]))
    meas = [gt[k].inverse().compose(gt[k + 1]).compose(drift)
            for k in range(n - 1)]
    est = [gt[0]]
    for m in meas:
        est.append(est[-1].compose(m))
    gj = jpgo.make_graph(16, 32)
    gt_ = tpgo.make_graph(16, 32, "cpu")
    for k in range(n):
        gj = gj._replace(q=gj.q.at[k].set(est[k].q),
                         t=gj.t.at[k].set(est[k].t),
                         node_valid=gj.node_valid.at[k].set(True))
    gt_ = gt_._replace(q=_t(gj.q), t=_t(gj.t), node_valid=_t(gj.node_valid))
    edges = [(k, k + 1, meas[k], 1.0) for k in range(n - 1)]
    edges.append((n - 1, 0, gt[-1].inverse().compose(gt[0]), 100.0))
    for slot, (i, j, T, w) in enumerate(edges):
        gj = jpgo.add_constraint(gj, slot, i, j, T, weight_rot=w,
                                 weight_trans=w)
        gt_ = tpgo.add_constraint(gt_, slot, i, j,
                                  SE3(_t(T.q), _t(T.t)), w, w)
    return gj, gt_, gt, est


def test_pgo_graph_matches_jax():
    gj, gt_, _, _ = _drift_graphs()
    for k in gj._fields:
        np.testing.assert_allclose(getattr(gt_, k).numpy(),
                                   np.asarray(getattr(gj, k)), err_msg=k)


def test_pgo_optimize_matches_jax():
    """25 LM iterations on the drift-plus-loop graph: the same poses and
    cost, and the drift at the loop's end corrected as in JAX's test."""
    gj, gt_, gt, est = _drift_graphs()
    oj, cj = jax.jit(lambda x: jpgo.optimize(x, max_iter=25))(gj)
    ot, ct = tpgo.optimize(gt_, max_iter=25)
    c0 = float(tpgo.graph_chi2(gt_))
    assert abs(float(ct) - float(cj)) <= 1e-3 * c0, (float(ct), float(cj))
    np.testing.assert_allclose(ot.t.numpy(), np.asarray(oj.t), atol=1e-3)
    qd = np.abs(np.sum(ot.q.numpy() * np.asarray(oj.q), -1))
    assert (2 * np.arccos(np.clip(qd, 0, 1)) <= 1e-3).all(), qd
    err_before = float(np.linalg.norm(np.asarray(est[-1].t - gt[-1].t)))
    err_after = float(np.linalg.norm(ot.t[11].numpy()
                                     - np.asarray(gt[-1].t)))
    assert err_after < 0.35 * err_before


def test_pgo_zero_residual_at_truth():
    """tests/test_pgo.py's truth graph (slow there): the cost at the
    truth is below 1e-8, as JAX's."""
    gt = circle_poses(12)
    g = tpgo.make_graph(16, 32, "cpu")
    g = g._replace(
        q=g.q.index_copy(0, torch.arange(12),
                         torch.stack([_t(T.q) for T in gt])),
        t=g.t.index_copy(0, torch.arange(12),
                         torch.stack([_t(T.t) for T in gt])),
        node_valid=g.node_valid.index_fill(0, torch.arange(12), True))
    for k in range(11):
        T = gt[k].inverse().compose(gt[k + 1])
        g = tpgo.add_constraint(g, k, k, k + 1, SE3(_t(T.q), _t(T.t)))
    _, chi2 = tpgo.optimize(g, max_iter=5)
    assert float(chi2) < 1e-8


# ---------------------------------------------------------------------------
# loop closing
# ---------------------------------------------------------------------------

VIEWS = [jnp.asarray(v, jnp.float32) for v in (
    [0.0, 0, 0, 0, 0, 0], [0.03, 0.01, 0.0, 0.0, 0.0, 0.01],
    [0.7, 0.3, -0.3, 0.1, 0.4, 0.3], [0.08, -0.03, 0.02, 0.005, -0.01,
                                       0.008])]


def test_global_descriptor_and_query_match_jax():
    imgs = [render_sphere_view(se3_exp(v)) for v in VIEWS]
    dj = [jlc.global_descriptor(im) for im in imgs]
    dt = [tlc.global_descriptor(_t(im)) for im in imgs]
    for a, b in zip(dt, dj):
        assert float(a @ _t(b)) >= 0.999
    # the rolled query over a database of the first three
    opts = jlc.LoopClosingOptions()
    closer = jlc.LoopClosing(opts)
    mat_j = jnp.zeros((8, dj[0].shape[0])).at[:3].set(jnp.stack(dj[:3]))
    elig = jnp.arange(8) < 3
    bj, sj = closer._jit_query(mat_j, dj[3], elig)
    sims = tlc.rolled_similarities(_t(mat_j), dt[3], opts.descriptor_cells,
                                   opts.descriptor_bins)
    sims = torch.where(_t(elig), sims, float("-inf"))
    assert int(torch.argmax(sims)) == int(bj)
    assert abs(float(torch.max(sims)) - float(sj)) < 1e-3


def test_global_descriptor_of_integer_images_matches_jax():
    """Integer-valued frames (uint8 camera images, as bench.py's) put many
    gradients exactly on a bin edge (|dx| = |dy| is 45°), where an ulp of
    atan2 picks the bin: the descriptor equals JAX's (cosine ≥ 1 − 1e-6),
    not only within the 0.999 of float-valued renders."""
    rng = np.random.default_rng(3)
    for k in range(3):
        img = np.clip(np.rint(np.asarray(random_texture(240, 320, 50 + k))
                              + rng.normal(0, 4, (240, 320))), 0, 255)
        img = img.astype(np.float32)
        dj = np.asarray(jlc.global_descriptor(jnp.asarray(img)))
        dt = tlc.global_descriptor(_t(img)).numpy()
        assert float(dj @ dt) >= 1 - 1e-6, (k, float(dj @ dt))


@pytest.fixture(scope="module")
def sphere_pair():
    """Snapshots of two overlapping sphere views (detected corners,
    sphere depths) in both packages."""
    out = []
    for v in (VIEWS[0], VIEWS[3]):
        T = se3_exp(v)
        js, img = make_snapshot(T)
        out.append((js, _port_snapshot(js, img)))
    return out


def test_snapshot_and_match_snapshots_match_jax(sphere_pair):
    (ja, ta), (jb, tb) = sphere_pair
    for js, ts in sphere_pair:
        np.testing.assert_allclose(ts.patches.numpy(), np.asarray(js.patches),
                                   atol=1e-4)
        np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    nj, okj = jlc.match_snapshots(jb, ja)
    nt, okt = tlc.match_snapshots(tb, ta)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    np.testing.assert_array_equal(nt.numpy()[okj], np.asarray(nj)[okj])
    assert okj.sum() >= 15


def test_sim3_and_verify_pose_match_jax(sphere_pair):
    """The verification chain of ``LoopClosing._verify`` on the sphere
    pair: the Sim3 seed (R, s, t) and the two-stage pose GN."""
    (ja, ta), (jb, tb) = sphere_pair
    nj, okj = jlc.match_snapshots(jb, ja)
    d_old = ja.depth[nj]
    okj = okj & (d_old > 1e-6)
    xyz_old = ja.f[nj] * d_old[:, None]
    both = okj & (jb.depth > 1e-6)
    xyz_cur = jb.f * jb.depth[:, None]
    sj, Rj, tj = jlc.sim3_init_3d3d(xyz_old, xyz_cur, both)
    xo, xc = _t(xyz_old), _t(xyz_cur)
    st, Rt, tt = tlc.sim3_init_3d3d(xo, xc, _t(both))
    assert abs(float(st) / float(sj) - 1.0) <= 1e-4
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    from svo_pro_universal_tpu.utils.transform import matrix_to_quat
    T0j = JSE3(matrix_to_quat(Rj), tj / sj)
    rj = jlc.verify_pose(xyz_old, jb.f, okj, 150.0, T0j, max_iter=15,
                         thresh_px=2.0)
    T0t = tlc.sim3_seed(xo, tb, _t(okj))
    rt = tlc.verify_pose(xo, tb.f, _t(okj), torch.tensor(150.0), T0t,
                         max_iter=15, thresh_px=2.0)
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 15
    np.testing.assert_allclose(rt.T_body_world.t.numpy(),
                               np.asarray(rj.T_body_world.t), atol=1e-4)
    qd = abs(float(np.dot(rt.T_body_world.q.numpy(),
                          np.asarray(rj.T_body_world.q))))
    assert 2 * np.arccos(min(qd, 1.0)) <= 1e-4


def test_loop_closing_no_false_loop_on_distinct_views():
    """tests/test_loop_closing.py:85 in both packages: no constraint."""
    opts = dict(min_temporal_gap=2, min_similarity=0.9)
    cj = jlc.LoopClosing(jlc.LoopClosingOptions(**opts))
    ct = tlc.LoopClosing(tlc.LoopClosingOptions(**opts), device="cpu")
    for t in range(6):
        T = se3_exp(jnp.asarray([0.4 * t, 0.1 * t, -0.1 * t,
                                 0.02 * t, 0.06 * t, 0.0], jnp.float32))
        js, img = make_snapshot(T)
        assert cj.add_keyframe(t, js, 150.0) is None
        assert ct.add_keyframe(t, _port_snapshot(js, img),
                               torch.tensor(150.0)) is None
    assert len(ct) == len(cj) == 6


def test_loop_closing_ring_eviction_matches_jax():
    """tests/test_loop_pr_benchmark.py:176 in both packages: 40 places
    into a 16-row ring; the same rows evicted, and a late place still
    found, at the same row, as in JAX."""
    opts = dict(max_keyframes=16, min_temporal_gap=4, min_similarity=0.7,
                min_inliers=10)
    cj = jlc.LoopClosing(jlc.LoopClosingOptions(**opts))
    ct = tlc.LoopClosing(tlc.LoopClosingOptions(**opts), device="cpu")
    pairs = {}
    for k in range(40):
        tex = jnp.asarray(random_texture(120, 160, 1000 + k))
        js, ts = _plane_pair(tex, JSE3.identity())
        pairs[k] = (js, ts)
        outj = cj.add_keyframe(k, js, 150.0)
        outt = ct.add_keyframe(k, ts, torch.tensor(150.0))
        assert (outj is None) == (outt is None), k
    assert len(ct) == 16 and ct.n_evicted == cj.n_evicted == 24
    assert ct.kf_ids == cj.kf_ids
    late = 40 - 4 - 2
    cand_j = cj._query(pairs[late][0], cur_kf_id=50)
    cand_t = ct._query(pairs[late][1], cur_kf_id=50)
    assert cand_t is not None and cand_t.kf_id == cand_j.kf_id
    assert ct.kf_ids[cand_t.kf_id] == late
    assert 0 not in ct.kf_ids and 1 not in ct.kf_ids


def test_loop_closing_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlc.LoopClosing()
    assert tlc.LoopClosing(device="cpu")._desc_matrix.device.type == "cpu"


def test_verify_candidate_matches_jax(sphere_pair):
    """``verify_candidate`` (cur = the second view, old = the first) against
    the chain of JAX's ``LoopClosing._verify``: matches with depth, Sim3
    seed where ≥ 6 carry both depths, two-stage GN."""
    (ja, ta), (jb, tb) = sphere_pair
    opts = jlc.LoopClosingOptions()
    nj, okj = jlc.match_snapshots(jb, ja, opts)
    n_nn = int(jnp.sum(okj))
    d_old = ja.depth[nj]
    okj = okj & (d_old > 1e-6)
    xyz_old = ja.f[nj] * d_old[:, None]
    both = okj & (jb.depth > 1e-6)
    assert int(jnp.sum(both)) >= 6
    sj, Rj, tj = jlc.sim3_init_3d3d(xyz_old, jb.f * jb.depth[:, None], both)
    from svo_pro_universal_tpu.utils.transform import matrix_to_quat
    rj = jlc.verify_pose(xyz_old, jb.f, okj, 150.0,
                         JSE3(matrix_to_quat(Rj), tj / sj), max_iter=15,
                         thresh_px=opts.ransac_thresh_px)
    v = tlc.verify_candidate(tb, ta, torch.tensor(150.0),
                             tlc.LoopClosingOptions())
    assert int(v.n_nn) == n_nn
    assert int(v.n_matches) == int(jnp.sum(okj))
    assert int(v.n_inliers) == int(rj.n_inliers) >= opts.min_inliers
    assert bool(v.verified)
    np.testing.assert_allclose(v.T_cur_old.t.numpy(),
                               np.asarray(rj.T_body_world.t), atol=1e-4)
    qd = abs(float(np.dot(v.T_cur_old.q.numpy(),
                          np.asarray(rj.T_body_world.q))))
    assert 2 * np.arccos(min(qd, 1.0)) <= 1e-4


def test_loop_closing_verifies_a_revisit_as_jax():
    """Keyframes 0..2: the first sphere view, a distant one, then a revisit
    near the first (gap 2): both packages return a constraint from
    keyframe 2 to keyframe 0 with the same inliers and pose."""
    opts = dict(min_temporal_gap=2, min_similarity=0.5)
    cj = jlc.LoopClosing(jlc.LoopClosingOptions(**opts))
    ct = tlc.LoopClosing(tlc.LoopClosingOptions(**opts), device="cpu")
    outs = []
    for t, v in enumerate((VIEWS[0], VIEWS[2], VIEWS[3])):
        js, img = make_snapshot(se3_exp(v))
        outs.append((cj.add_keyframe(t, js, 150.0),
                     ct.add_keyframe(t, _port_snapshot(js, img),
                                     torch.tensor(150.0))))
    for oj, ot in outs[:2]:
        assert oj is None and ot is None
    oj, ot = outs[2]
    assert oj is not None and ot is not None
    assert (ot.kf_id_from, ot.kf_id_to) == (oj.kf_id_from, oj.kf_id_to) \
        == (2, 0)
    assert ot.n_inliers == oj.n_inliers
    np.testing.assert_allclose(ot.T_cur_old.t.numpy(),
                               np.asarray(oj.T_cur_old.t), atol=1e-4)
