"""The motion-only pose GN kernel's dispatch and wrapper, on the CPU. The
kernel itself (``csrc/pose.cu``) runs only on the card, where
tests/test_torch_gpu.py holds it against its plain version.

- A CPU tensor takes ``optimize_pose_plain``: the same bits as calling it,
  and no ``pose_gn`` launch, in every case of ``syn.POSE_CASES``
  (``test_stage_pose_and_structure_match_jax`` holds the stage against the
  JAX package).
- The card's wrapper raises, naming the input, on what the kernel does not
  take: two feature sets, an engaged prior, N outside 1..POSE_GN_MAX_N,
  another dtype, tensors on two devices.
- ``pose.cu``'s entry point and its feature limit agree with the
  ``Kernel``'s symbol, ``argtypes`` and ``POSE_GN_MAX_N``, read from the
  source text.
"""

import ctypes
import re

import pytest
import torch

from svo_pro_universal_tpu_torch.ops import _cuda
from svo_pro_universal_tpu_torch.ops import pose_optimizer as po
from svo_pro_universal_tpu_torch.testing import synthetic as syn
from svo_pro_universal_tpu_torch.utils.transform import se3_exp


@pytest.mark.parametrize("case", syn.POSE_CASES)
def test_cpu_takes_the_plain_version(case):
    fss, T0, opts = syn.pose_problem(case, seed=3)
    before = po.POSE_GN.launches
    got = po.optimize_pose(fss, T0, opts)
    want = po.optimize_pose_plain(fss, T0, opts)
    assert po.POSE_GN.launches == before == 0
    pairs = [(got.T_body_world.q, want.T_body_world.q),
             (got.T_body_world.t, want.T_body_world.t),
             (got.inlier[0], want.inlier[0]),
             (got.error_before_px, want.error_before_px),
             (got.error_after_px, want.error_after_px),
             (got.n_inliers, want.n_inliers)]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _with(fs, **fields):
    return fs._replace(**fields)


def _rejected_inputs(kind: str):
    fss, T0, opts = syn.pose_problem("cell", seed=0, n=24)
    fs = fss[0]
    prior = None
    if kind == "two_sets":
        fss = [fs, fs]
    elif kind == "prior":
        prior = se3_exp(torch.zeros(6))
        opts = opts._replace(prior_lambda=0.1)
    elif kind == "too_many":
        n = po.POSE_GN_MAX_N + 1
        fss = [po.PoseOptFeatures(
            torch.zeros((n, 3)), torch.zeros((n, 3)), torch.zeros((n, 2)),
            torch.zeros(n, dtype=torch.long),
            torch.zeros(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.bool), fs.T_cam_body, fs.cam)]
    elif kind == "empty":
        fss = [po.PoseOptFeatures(*(x[:0] for x in fs[:6]), fs.T_cam_body,
                                  fs.cam)]
    elif kind == "float64":
        fss = [_with(fs, xyz_world=fs.xyz_world.double())]
    elif kind == "int32_level":
        fss = [_with(fs, level=fs.level.int())]
    elif kind == "two_devices":
        fss = [_with(fs, f=torch.zeros((24, 3), device="meta"))]
    return fss, T0, opts, prior


@pytest.mark.parametrize("kind,match", [
    ("two_sets", "2 feature sets"), ("prior", "no prior"),
    ("too_many", "4097 features"), ("empty", "0 features"),
    ("float64", "xyz_world is torch.float64"),
    ("int32_level", "level is torch.int32"),
    ("two_devices", "tensors on")])
def test_card_wrapper_rejects_what_the_kernel_does_not_take(kind, match):
    fss, T0, opts, prior = _rejected_inputs(kind)
    with pytest.raises(ValueError, match=match):
        po.pose_gn_inputs(fss, T0, opts, prior)


def test_card_wrapper_takes_the_port_callers_inputs():
    """One set, a prior given with prior_lambda 0 (not engaged): the
    kernel's eleven input tensors, in its order, the contiguous ones as
    they are and a transposed one copied."""
    fss, T0, opts = syn.pose_problem("verify", seed=0)
    fs = fss[0]
    got = po.pose_gn_inputs(fss, T0, opts, T_prior=T0)
    want = [fs.xyz_world, fs.f, fs.grad, fs.level, fs.is_edgelet, fs.valid,
            fs.T_cam_body.q, fs.T_cam_body.t, T0.q, T0.t,
            fs.cam.intrinsics[:2]]
    assert len(got) == len(want)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(got, want))
    xyz_t = fs.xyz_world.T.contiguous().T
    got = po.pose_gn_inputs([_with(fs, xyz_world=xyz_t)], T0, opts)
    assert got[0].is_contiguous() and torch.equal(got[0], fs.xyz_world)


def test_other_devices_are_refused():
    fss, T0, opts = syn.pose_problem("cell", seed=0, n=8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        po.optimize_pose(fss, T0, opts)


def test_pose_cu_entry_point_matches_the_kernel():
    src = (_cuda.CSRC / po.POSE_GN.source).read_text()
    m = re.search(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert m is not None and m.group(1) == po.POSE_GN.symbol
    params = [p.strip() for p in m.group(2).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_int if p.startswith("int ") else
             ctypes.c_float if p.startswith("float ") else None
             for p in params]
    assert kinds == po.POSE_GN.argtypes
    assert int(re.search(r"kMaxN = (\d+);", src).group(1)) \
        == po.POSE_GN_MAX_N
    assert po.POSE_GN in _cuda.KERNELS
