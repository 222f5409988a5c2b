"""The plain reference agrees with the port on small inputs on the CPU
(where the port runs the plain versions of its kernels), and its control,
the reference in TF32 standing in the program's place, fails each
comparison."""

import numpy as np
import pytest
import torch

from port_bench import control
from port_bench import reference as ref
from port_bench.spans import KernelSampler, to_cpu
from svo_pro_universal_tpu_torch.backend import window_ba as wba
from svo_pro_universal_tpu_torch.cameras.projections import Camera
from svo_pro_universal_tpu_torch.ops import cuda_align, cuda_tiles
from svo_pro_universal_tpu_torch.ops import sparse_img_align as sia
from svo_pro_universal_tpu_torch.testing import synthetic as syn
from svo_pro_universal_tpu_torch.utils.transform import SE3

W, H = 320, 240
INTR = (230.0, 230.0, 160.0, 120.0)


@pytest.fixture(scope="module")
def sampled():
    """The kernel calls of one coarse-to-fine sparse alignment, sampled
    through the harness's wrappers."""
    cam = Camera.pinhole(*INTR, W, H)
    T_ref = np.eye(4)
    T_cur = syn.pose(0.03, -0.02, 0.01, 0.01, -0.015, 0.005)
    inp = syn.align_problem(cam, T_ref, T_cur, INTR, 2.0, 5, grid=(12, 8))
    sampler = KernelSampler(0, {"extract_tiles": (9, 9),
                                "extract_tiles_ring": (9, 9),
                                "align_level": (9, 9)})
    sampler.install(cuda_tiles, cuda_align)
    sampler.active = True
    try:
        sia.run([inp], sia.make_state(), sia.SparseImgAlignOptions(
            max_level=4, min_level=2))
    finally:
        sampler.uninstall()
    return to_cpu(dict(sampler.samples))


def test_gathers_agree_exactly(sampled):
    assert sampled["extract_tiles"]
    for s in sampled["extract_tiles"]:
        assert ref.gather_mismatches(s, ring=False) == 0


def test_gather_control_fails(sampled):
    assert sum(ref.gather_mismatches(s, False, ref.tf32)
               for s in sampled["extract_tiles"]) > 0


def test_ring_gather_agrees():
    rng = np.random.default_rng(3)
    ring4 = torch.from_numpy(rng.uniform(0, 255, (3, 2, 40, 56))
                             .astype(np.float32))
    kf = torch.tensor([0, 2, 1, 5, -1])
    level = torch.tensor([0, 1, 1, 0, 3])
    cyx = torch.tensor([[5.2, 7.7], [20.5, 3.1], [39.0, 55.0], [0.0, 0.0],
                        [12.4, 30.6]])
    out = cuda_tiles.extract_tiles_ring(ring4, kf, level, cyx, 6, 8)
    s = {"args": (ring4, kf, level, cyx, 6, 8), "out": out}
    assert ref.gather_mismatches(s, ring=True) == 0
    assert ref.gather_mismatches(s, True, ref.tf32) > 0


def test_alignment_agrees(sampled):
    assert len(sampled["align_level"]) == 3
    for s in sampled["align_level"]:
        assert ref.align_gap(s) < 1e-5


def test_alignment_control_fails(sampled):
    gaps = [ref.align_gap(s, ref.tf32) for s in sampled["align_level"]]
    assert max(gaps) > 1e-4


def test_alignment_reaches_the_reference_loop(sampled):
    for s in sampled["align_level"]:
        assert ref.align_shortfall(s) < 1e-3
    # a level that returns its input state falls short
    frozen = [dict(s, out=(s["state"], *s["out"][1:]))
              for s in sampled["align_level"]]
    assert max(ref.align_shortfall(s) for s in frozen) > 1e-2


def _solve_sample(frozen=False):
    """One window solve of a perturbed synthetic VI window with a
    marginalization prior, sampled through the harness's wrapper."""
    torch.manual_seed(1)
    w = syn.synthetic_ba_window(S=5, n_landmarks=60, L=64, No=256,
                                obs_per_state=40)
    D = w.S * wba.DOF
    A = torch.randn(D, D) * 0.1
    w = w._replace(
        p=w.p + 0.02 * torch.randn_like(w.p),
        lm_pos=w.lm_pos + 0.01 * torch.randn_like(w.lm_pos),
        bg=0.01 * torch.randn_like(w.bg), zupt=torch.full((w.S,), 3.0),
        H_prior=A @ A.T + torch.eye(D), b_prior=0.1 * torch.randn(D),
        has_prior=torch.tensor(True))
    sampler = KernelSampler(0, {"optimize": (1, 1)})
    sampler.install(cuda_tiles, cuda_align, wba)
    sampler.active = True
    try:
        if frozen:
            sampler.uninstall()
            undo = control.FAULTS["frozen_solve"](None)
            sampler.install(cuda_tiles, cuda_align, wba)
        wba.optimize(w, SE3.identity(), torch.tensor(460.0), wba.BAOptions())
    finally:
        sampler.uninstall()
        if frozen:
            undo()
    return to_cpu(sampler.samples["optimize"][0])


def test_window_cost_is_the_solves_cost():
    s = _solve_sample()
    cost = wba.system_chi2(s["out"], SE3.identity(), torch.tensor(460.0),
                           wba.BAOptions())
    got = ref.window_cost({k: getattr(s["out"], k)
                           for k in ref.WINDOW_FIELDS},
                          (torch.tensor([1.0, 0, 0, 0]), torch.zeros(3)),
                          460.0, s["opts"])
    assert abs(got - float(cost)) / abs(got) < 1e-4
    assert abs(float(s["cost"]) - float(cost)) / abs(got) < 1e-4


def test_a_frozen_solve_keeps_its_cost():
    assert ref.solve_kept([_solve_sample()]) < 0.9
    assert ref.solve_kept([_solve_sample(frozen=True)]) == 1.0


def test_window_cost_agrees():
    torch.manual_seed(0)
    w = syn.synthetic_ba_window(S=5, n_landmarks=60, L=64, No=256,
                                obs_per_state=40)
    # off the optimum: landmarks moved by ~1 cm
    w = w._replace(lm_pos=w.lm_pos + 0.01 * torch.randn_like(w.lm_pos))
    Tcb = SE3.identity()
    opts = wba.BAOptions()
    e, _, _, wgt, _ = wba._reproj_terms(w, Tcb, torch.tensor(460.0), opts)
    prog = float(torch.sum(torch.sum(e * e, -1) * wgt))
    win = {k: getattr(w, k) for k in ("q", "p", "state_valid", "lm_pos",
                                      "lm_valid", "obs_state", "obs_lm",
                                      "obs_f", "obs_valid")}
    args = ((Tcb.q, Tcb.t), 460.0, opts.pixel_sigma, opts.huber_reproj)
    r = ref.window_visual_chi2(win, *args)
    assert abs(prog - r) / r < 1e-5
    c = ref.window_visual_chi2(win, *args, rnd=ref.tf32)
    assert abs(c - r) / r > 1e-4


def test_sim3_alignment_recovers_a_similarity():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(50, 3))
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    est = (gt - 0.3) @ R / 1.7
    err, (s, R2, t) = ref.ate(est, gt)
    assert err < 1e-9 and abs(s - 1.7) < 1e-9
