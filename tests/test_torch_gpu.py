"""The CUDA kernels against their plain versions on the card (marker
``gpu``; skipped without a card). Imports no JAX, so it runs on the card's
machine (whose Python has no JAX, hence no conftest):
``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q``.
Tolerances: the gathers are copies (exact); the fused evaluate those of
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from svo_pro_universal_tpu_torch.ops import cuda_align, cuda_tiles


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
