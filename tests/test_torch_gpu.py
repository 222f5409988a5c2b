"""The CUDA kernels against their plain versions on the card (marker
``gpu``; skipped without a card). Imports no JAX, so it runs on the card's
machine (whose Python has no JAX, hence no conftest):
``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q``.
Tolerances: the gathers are copies (exact); the fused evaluate those of
tests/test_torch_kernels.py; the align level (each of levels 4..2 from the
same inputs) rotation ≤ 1e-4 rad, translation ≤ 1e-4·depth, n_tracked
equal. The gathers are held on both copy routes of csrc/tiles.cu (TMA at
752 wide, plain loads at 754 and for 10×10 tiles) and in both modes (centres, origins
given), non-finite centres included. Two ranks sharing the card align as
one rank does (pose 1e-5)."""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu_torch.cameras.projections import Camera
from svo_pro_universal_tpu_torch.ops import cuda_align, cuda_tiles
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.testing import synthetic as syn
from svo_pro_universal_tpu_torch.utils.transform import se3_exp


def _assert_normal_system(got, want):
    H, g, chi2, nm = [np.asarray(x, np.float64) for x in got]
    H0, g0, chi20, nm0 = [np.asarray(x, np.float64) for x in want]
    np.testing.assert_allclose(H, H0, rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(g, g0, rtol=2e-4, atol=0.5)
    assert abs(chi2 - chi20) <= max(2e-4 * abs(chi20), 1.0)
    assert nm == nm0


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    pyr = torch.rand((5, 480, 752), device=dev) * 255
    ring = torch.rand((8, 5, 480, 752), device=dev) * 255
    n, R, T = 360, 24, 24
    lvl = torch.as_tensor(rng.integers(0, 5, n), device=dev)
    y0 = torch.as_tensor(rng.integers(0, 480 - R, n), device=dev)
    x0 = torch.as_tensor(rng.integers(0, 752 - T, n), device=dev)
    kf = torch.as_tensor(rng.integers(0, 8, n), device=dev)
    assert torch.equal(cuda_tiles.gather_tiles(pyr, lvl, y0, x0, R, T),
                       cuda_tiles.gather_tiles_plain(pyr, lvl, y0, x0, R, T))
    assert torch.equal(
        cuda_tiles.gather_tiles_ring(ring, kf, lvl, y0, x0, R, T),
        cuda_tiles.gather_tiles_ring_plain(ring, kf, lvl, y0, x0, R, T))
    tiles = torch.rand((n, R, T), device=dev) * 255
    ty = torch.rand(n, device=dev) * (R - 5)
    tx = torch.rand(n, device=dev) * (T - 5)
    w = (torch.rand(n, device=dev) > 0.3).float()
    ref = torch.rand((n, 16), device=dev) * 255
    jac = torch.randn((n, 16, 8), device=dev)
    ab = torch.tensor([0.03, -1.5], device=dev)
    got = cuda_align.fused_evaluate(tiles, ty, tx, w, ref, jac, ab, 4)
    want = cuda_align.fused_evaluate_plain(tiles, ty, tx, w, ref, jac, ab, 4)
    _assert_normal_system([x.cpu() for x in got], [x.cpu() for x in want])


@pytest.mark.gpu
@pytest.mark.parametrize("width", [752, 754])
def test_tile_gathers_match_plain_versions(width):
    """Both gathers in both modes against their plain versions on the card
    (torch.equal on the tiles and all four origin vectors): every case of
    ``syn.tile_case``, NaN, ±inf and 1e30 centres among them, centres read
    by stride, tiles of 10, 12, 24 and 40 (10 takes the plain-load route
    at any width); one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    rng = np.random.default_rng(1)
    pyr = torch.rand((5, 480, width), device="cuda") * 255
    ring = torch.rand((8, 5, 480, width), device="cuda") * 255
    for R in syn.TILE_SIZES:
        assert cuda_tiles.tma_route(pyr, R, R) == (width == 752
                                                   and R % 4 == 0)
    assert syn.tile_gather_mismatches(pyr, ring, rng) == []


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [14, 26])
def test_klt_gathers_match_plain_version(tile):
    """The FivePoint KLT's tiles (14×14 templates, 26×26 search tiles; the
    plain-load route) from a 5-level 752×480 pyramid, N = 360, every
    feature at one level, for each level 0..4 (level 4 is 30×47), centres
    over and past the level: equal to extract_tiles_plain, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    rng = np.random.default_rng(2)
    pyr = torch.rand((5, 480, 752), device="cuda") * 255
    assert not cuda_tiles.tma_route(pyr, tile, tile)
    for level in range(5):
        n = 360
        lvl = torch.full((n,), level, dtype=torch.long, device="cuda")
        cyx = torch.as_tensor(np.stack([
            rng.uniform(-8, (480 >> level) + 8, n),
            rng.uniform(-8, (752 >> level) + 8, n)], -1).astype(np.float32),
            device="cuda")
        before = cuda_tiles.GATHER_TILES.launches
        got = cuda_tiles.extract_tiles(pyr, lvl, cyx, tile, tile)
        assert cuda_tiles.GATHER_TILES.launches == before + 1
        want = cuda_tiles.extract_tiles_plain(pyr, lvl, cyx, tile, tile)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), level


@pytest.mark.gpu
def test_edge_depth_gathers_match_plain_version():
    """edge_depth's gather (N = 512 features, 24×24 tiles at levels 0..1,
    as refine_depth_photometric cuts them): equal to extract_tiles_plain
    in one launch, and one launch per GN iteration of the refinement."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    from svo_pro_universal_tpu_torch.ops import edge_depth
    from svo_pro_universal_tpu_torch.utils.transform import SE3
    rng = np.random.default_rng(3)
    pyr = torch.rand((5, 480, 752), device="cuda") * 255
    n = 512
    lvl = torch.as_tensor(rng.integers(0, 2, n), device="cuda")
    cyx = torch.as_tensor(np.stack([
        rng.uniform(0, 480, n), rng.uniform(0, 752, n)], -1).astype(
            np.float32), device="cuda") / (1 << lvl)[:, None]
    before = cuda_tiles.GATHER_TILES.launches
    got = cuda_tiles.extract_tiles(pyr, lvl, cyx, 24, 24)
    assert cuda_tiles.GATHER_TILES.launches == before + 1
    want = cuda_tiles.extract_tiles_plain(pyr, lvl, cyx, 24, 24)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cam = Camera.pinhole(460.0, 460.0, 376.0, 240.0, 752, 480,
                         device="cuda")
    uv = torch.stack([cyx[:, 1], cyx[:, 0]], -1) * (1 << lvl)[:, None]
    f = torch.nn.functional.normalize(torch.cat(
        [(uv - torch.tensor([376.0, 240.0], device="cuda")) / 460.0,
         torch.ones((n, 1), device="cuda")], -1), dim=-1)
    T = SE3(torch.tensor([1.0, 0.0, 0.0, 0.0], device="cuda"),
            torch.tensor([0.05, 0.0, 0.0], device="cuda"))
    before = cuda_tiles.GATHER_TILES.launches
    out = edge_depth.refine_depth_photometric(
        pyr, cam, T, f, torch.rand((n, 64), device="cuda") * 255,
        torch.full((n,), 2.0, device="cuda"), lvl,
        torch.ones(n, dtype=torch.bool, device="cuda"), n_iter=6)
    assert cuda_tiles.GATHER_TILES.launches == before + 6
    assert torch.isfinite(out.depth).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mono", "prior_alpha_beta", "two_cameras",
                                  "n768"])
def test_align_level_matches_plain_version(case):
    """The cluster kernel against its plain version, level by level from
    the same inputs: one camera, the prior with alpha/beta, two cameras on
    one body, and N = 768 (beyond the 560 features the cluster stages)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    intr = (460.0, 460.0, 376.0, 240.0)
    extras = case == "prior_alpha_beta"
    gain, offset = (1.08, -6.0) if extras else (1.0, 0.0)
    rigs = [(Camera.pinhole(*intr, 752, 480), None)]
    if case == "two_cameras":
        rigs.append((Camera.pinhole(300.0, 300.0, 376.0, 240.0, 752, 480),
                     syn.pose(0.1, 0.0, 0.0, 0.0, 0.3, 0.0)))
    grid = (32, 24) if case == "n768" else (24, 15)
    inputs = [syn.align_problem(cam, syn.pose(0, 0, 0),
                                syn.pose(0.024, 0.004, 0.004), intr, 2.5, 5,
                                grid=grid, gain=gain, offset=offset,
                                T_cam_body=Tcb, device="cuda")
              for cam, Tcb in rigs]
    opts = sia.SparseImgAlignOptions(
        estimate_alpha=extras, estimate_beta=extras,
        prior_lambda_rot=0.1 * extras, prior_lambda_trans=0.05 * extras)
    T_prior = se3_exp(torch.tensor([0.02, 0.0, 0.0, 0.0, 0.001, 0.0],
                                   device="cuda"))
    pre = [sia.precompute_base(inp, False) for inp in inputs]
    state = sia.make_state(device="cuda")
    depth = max(float(inp.depth_ref.max()) for inp in inputs)
    for level in (4, 3, 2):
        cams = sia.level_cameras(inputs, pre, state, opts, level)
        got = cuda_align.align_level(cams, state, opts, level, T_prior)
        want = cuda_align.align_level_plain(cams, state, opts, level,
                                            T_prior)
        assert syn.rotation_gap(got[0].T_icur_iref.q,
                                want[0].T_icur_iref.q) <= 1e-4, level
        dt = (got[0].T_icur_iref.t - want[0].T_icur_iref.t).norm()
        assert float(dt) <= 1e-4 * depth, level
        assert int(got[2]) == int(want[2]) > 100, level
        state = want[0]


@pytest.mark.gpu
def test_segment_sum_is_bit_identical_on_the_card():
    """The backend's float segment sum (``indexing.segment_sum``) at the
    window's shapes gives the same bits on every call on the card, and the
    same bits as on the CPU (the same additions in the same order);
    ``index_add_`` on CUDA sums with atomics in a varying order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    from svo_pro_universal_tpu_torch.utils.indexing import segment_sum
    gen = torch.Generator().manual_seed(0)
    for rows, cols, n in ((600, 45, 5 * 4096), (600, 9, 4096),
                          (600, 240, 5), (1024, 36, 128 * 128)):
        data = torch.randn((rows, cols), generator=gen) * 1e3
        seg = torch.randint(0, n + 1, (rows,), generator=gen)
        seg[: rows // 2] = seg[0]          # one crowded segment
        want = segment_sum(data, seg, n)
        dd, sd = data.cuda(), seg.cuda()
        for _ in range(5):
            assert torch.equal(segment_sum(dd, sd, n).cpu(), want)


@pytest.mark.gpu
def test_host_handler_runs_on_the_card():
    """The host ``FrameHandlerMono`` (OneShot) for 8 frames of the textured
    plane at 752×480 on the card and on the CPU: TRACKING throughout, one
    read a frame, the same stages and keyframes, positions within 5 mm;
    the tile gathers and align_level launched on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    import chip_smoke as cs
    from svo_pro_universal_tpu_torch.frontend.frame_handler import (
        FrameHandlerMono, Stage)
    from svo_pro_universal_tpu_torch.ops import _cuda
    frames = [syn.render_textured_plane(cs.gt_pose(t), cs.INTR, cs.W, cs.H,
                                        cs.PLANE_Z) for t in range(8)]
    out = {}
    for dev in ("cuda", "cpu"):
        h = FrameHandlerMono(cs.euroc_config(),
                             Camera.pinhole(*cs.INTR, cs.W, cs.H),
                             device=dev)
        _cuda.reset_counts()
        out[dev] = [h.add_image(f, t * 0.05) for t, f in enumerate(frames)]
        assert h.host_reads == len(frames)
        if dev == "cuda":
            launches = {k.name: k.launches for k in _cuda.KERNELS}
            assert min(launches["gather_tiles"], launches["align_level"],
                       launches["gather_tiles_ring"]) > 0, launches
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g.stage == c.stage == Stage.TRACKING
        assert g.is_keyframe == c.is_keyframe
        assert np.linalg.norm(g.T_world_cam[:3, 3]
                              - c.T_world_cam[:3, 3]) <= 5e-3


@pytest.mark.gpu
def test_two_rank_alignment_on_the_card():
    """``distributed_align`` on 2 ranks sharing the card (gloo) against one
    rank's ``sia.run`` (the ``align_level`` kernel): pose within 1e-5; each
    rank launches ``fused_evaluate`` ``levels × (max_iter + 1)`` times and
    the gathers at least once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with `python -m "
                    "pytest --noconftest tests/test_torch_gpu.py -m gpu`")
    from svo_pro_universal_tpu_torch.parallel import dryrun
    from svo_pro_universal_tpu_torch.parallel.mesh import launch
    from svo_pro_universal_tpu_torch.testing.parallel_cases import run_steps
    inp, _ = dryrun.synthetic_inputs(h=48, w=64, n_feat=32, device="cpu")
    opts = sia.SparseImgAlignOptions(max_level=1, min_level=0, max_iter=5)
    one, _ = sia.run([dryrun.synthetic_inputs(h=48, w=64, n_feat=32,
                                              device="cuda")[0]],
                     sia.make_state(device="cuda"), opts)
    ranks = launch(2, run_steps, None, [("align", dict(
        shape=(2,), inp=inp, state0=sia.make_state(), opts=opts))])
    for r in ranks:
        a = r["align"][0]
        np.testing.assert_allclose(a["t"].numpy(),
                                   one.T_icur_iref.t.cpu().numpy(), atol=1e-5)
        np.testing.assert_allclose(a["q"].numpy(),
                                   one.T_icur_iref.q.cpu().numpy(), atol=1e-5)
        assert a["launches"]["fused_evaluate"] == 2 * (opts.max_iter + 1)
        assert a["launches"]["align_level"] == 0
        assert a["launches"]["gather_tiles"] > 0
