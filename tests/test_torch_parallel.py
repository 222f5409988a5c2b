"""The port's multi-device layer (``parallel/``) on gloo CPU ranks, against
the JAX package's single-device functions.

The ranks are processes started by ``parallel.mesh.launch`` (spawn, a
FileStore rendezvous, one thread each); one spawn of 2, 4 and 8 ranks runs
every step of this file (``testing.parallel_cases.run_steps``). JAX's own
tests hold its sharded versions to its single-device ones at these bounds
(test_multichip.py:29-46, test_sharded_ba.py:65-97); those tests are slow
here, so the single-device JAX functions are the reference:

- ``partition_observations``: equal to JAX's to the bit, ``n_dropped``
  included (test_sharded_ba.py's window, and its overflow case);
- ``distributed_align`` on 2 and 4 ranks against JAX's ``sia.run`` on
  ``__graft_entry__._synthetic_inputs(h=48, w=64, n_feat=32)``: pose within
  1e-5; also against the port's one-device ``run``; one all-reduce per
  evaluate, ``levels × (max_iter + 1)`` of them;
- ``distributed_seed_update`` on 4 ranks: against JAX's ``update_seeds`` at
  test_torch_modules.py's seed tolerances (n_updated within 2, at most 2
  ftype flips, state rtol 1e-3 / atol 1e-5 where ftype agrees); against the
  port's one-device update: equal ftype and counts, state within 1e-6
  relative;
- ``distributed_optimize`` on 4 ranks over ``(f,)`` and 8 over ``(h, f)``
  against JAX's ``wba.optimize`` on the partitioned window: p, q within
  2e-4, chi2 within 2%; against the port's one-device ``optimize``: 1e-5
  (landmarks 5e-4, as test_global_map_dcn.py holds them);
  with ``void_on_single_view`` and a once-seen landmark every rank voids
  exactly the iterations one rank voids;
- ``comms_volume_per_solve`` equal to the bytes a 2-rank solve counted.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.backend import window_ba as jwba
from svo_pro_universal_tpu.common import seed as jseed
from svo_pro_universal_tpu.ops import depth_filter as jdf
from svo_pro_universal_tpu.ops import matcher as jmatcher
from svo_pro_universal_tpu.ops import sparse_img_align as jsia
from svo_pro_universal_tpu.parallel import sharded_ba as jsba
from svo_pro_universal_tpu.utils.transform import SE3 as JSE3
from svo_pro_universal_tpu.utils.transform import (
    quat_multiply, quat_normalize, so3_exp)
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.backend import window_ba as twba
from svo_pro_universal_tpu_torch.common import seed as tseed
from svo_pro_universal_tpu_torch.common.types import FeatureType
from svo_pro_universal_tpu_torch.ops import depth_filter as tdf
from svo_pro_universal_tpu_torch.ops import matcher as tmatcher
from svo_pro_universal_tpu_torch.ops import sparse_img_align as tsia
from svo_pro_universal_tpu_torch.parallel import dryrun
from svo_pro_universal_tpu_torch.parallel.mesh import launch
from svo_pro_universal_tpu_torch.parallel.sharded_ba import (
    comms_volume_per_solve, partition_observations)
from svo_pro_universal_tpu_torch.testing.parallel_cases import run_steps
from svo_pro_universal_tpu_torch.utils.transform import SE3

from test_window_ba import _make_window, simulate_vi
from torch_parity_utils import to_dict

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import __graft_entry__ as graft  # noqa: E402

ALIGN_OPTS = dict(max_level=1, min_level=0, max_iter=5)
BA_ITERS = 5
FOCAL = 300.0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def align_inputs():
    """JAX's and the port's copy of the graft entry's synthetic inputs."""
    jinp, _ = graft._synthetic_inputs(h=48, w=64, n_feat=32)
    tinp, tcam = dryrun.synthetic_inputs(h=48, w=64, n_feat=32,
                                         device="cpu")
    for name in ("pyr_ref", "pyr_cur", "px_ref", "f_ref", "depth_ref",
                 "valid"):
        np.testing.assert_allclose(_np(getattr(tinp, name)).astype(float),
                                   _np(getattr(jinp, name)).astype(float),
                                   atol=1e-5, err_msg=name)
    return jinp, tinp, tcam


def _seed_args(inp, cam, lib):
    """The dry run's seed update inputs (graft dryrun_multichip) for JAX
    (``lib`` "jax") or the port."""
    n = inp.px_ref.shape[0]
    if lib == "jax":
        seeds = jseed.make(jnp.full((n,), 2.0), jnp.full((n,), 0.5))
        return (inp.pyr_ref, inp.pyr_cur, cam,
                JSE3(jnp.array([1.0, 0, 0, 0]), jnp.array([0.05, 0.0, 0.0])),
                inp.px_ref, inp.f_ref, jnp.zeros((n, 2)),
                jnp.zeros((n,), jnp.int32),
                jnp.full((n,), int(FeatureType.CORNER_SEED), jnp.int32),
                seeds, jnp.asarray(2.0))
    seeds = tseed.make(torch.full((n,), 2.0), torch.full((n,), 0.5))
    return (inp.pyr_ref, inp.pyr_cur, cam,
            SE3(torch.tensor([1.0, 0, 0, 0]), torch.tensor([0.05, 0.0, 0.0])),
            inp.px_ref, inp.f_ref, torch.zeros((n, 2)),
            torch.zeros((n,), dtype=torch.long),
            torch.full((n,), int(FeatureType.CORNER_SEED), dtype=torch.long),
            seeds, torch.tensor(2.0))


SEED_KW = dict(max_search_level=1, sigma2_convergence_threshold=200.0)


@pytest.fixture(scope="module")
def ba_window():
    """test_sharded_ba.py's perturbed window (JAX)."""
    rng = np.random.default_rng(42)
    states, segs = simulate_vi()
    w = _make_window(states, segs, obs_noise=5e-4)
    S = w.S
    dq = [jnp.array([1.0, 0, 0, 0])]
    for _ in range(S - 1):
        dq.append(so3_exp(jnp.asarray(
            rng.normal(0, 0.02, 3).astype(np.float32))))
    return w._replace(
        q=quat_normalize(quat_multiply(w.q, jnp.stack(dq))),
        p=w.p + jnp.asarray(np.concatenate(
            [np.zeros((1, 3)), rng.normal(0, 0.04, (S - 1, 3))]
        ).astype(np.float32)))


def _partitioned(jw, n):
    """(JAX partitioned window, port copy of it)."""
    jwp, dropped = jsba.partition_observations(jw, n)
    assert dropped == 0
    return jwp, convert.window(to_dict(jwp), "cpu")


def _once_seen(tw):
    """The port window with landmark 0 left one valid observation."""
    rows = torch.nonzero(tw.obs_valid & (tw.obs_lm == 0))[:, 0]
    valid = tw.obs_valid.clone()
    valid[rows[1:]] = False
    return tw._replace(obs_valid=valid)


def _ba_step(tw, shape, axes, opts):
    return ("ba", dict(shape=shape, w=tw, T_cam_body=SE3.identity(),
                       focal=torch.tensor(FOCAL), opts=opts, axes=axes))


@pytest.fixture(scope="module")
def runs(align_inputs, ba_window):
    """Every sharded step of this file: one spawn each of 2, 4, 8 ranks."""
    _, tinp, tcam = align_inputs
    aopts = tsia.SparseImgAlignOptions(**ALIGN_OPTS)
    align = ("align", dict(inp=tinp, state0=tsia.make_state(), opts=aopts))
    out = {}
    _, tw2 = _partitioned(ba_window, 2)
    out[2] = launch(2, run_steps, "cpu", [
        (align[0], align[1] | dict(shape=(2,))),
        _ba_step(tw2, (2,), ("f",), twba.BAOptions(max_iter=BA_ITERS)),
        _ba_step(_once_seen(tw2), (2,), ("f",), twba.BAOptions(
            max_iter=BA_ITERS, void_on_single_view=True))], device="cpu")
    _, tw4 = _partitioned(ba_window, 4)
    out[4] = launch(4, run_steps, "cpu", [
        (align[0], align[1] | dict(shape=(4,))),
        ("seeds", dict(shape=(4,), args=_seed_args(tinp, tcam, "torch"),
                       kwargs=SEED_KW)),
        _ba_step(tw4, (4,), ("f",), twba.BAOptions(max_iter=BA_ITERS)),
        _ba_step(_once_seen(tw4), (4,), ("f",), twba.BAOptions(
            max_iter=BA_ITERS, void_on_single_view=True))], device="cpu")
    _, tw8 = _partitioned(ba_window, 8)
    out[8] = launch(8, run_steps, "cpu", [
        _ba_step(tw8, (2, 4), ("h", "f"),
                 twba.BAOptions(max_iter=BA_ITERS))], device="cpu")
    return out


# ---------------------------------------------------------------------------
# partition_observations
# ---------------------------------------------------------------------------

def _overflow_window():
    """test_partition_counts_drops: 6 rows of shard 0's landmarks, 2 fit."""
    w = jwba.make_window(3, 16, 16)
    return w._replace(
        obs_state=w.obs_state.at[:6].set(0),
        obs_lm=w.obs_lm.at[:6].set(jnp.asarray([0, 1, 0, 1, 0, 1])),
        obs_valid=w.obs_valid.at[:6].set(True))


@pytest.mark.parametrize("case,n", [("sharded_ba", 8), ("sharded_ba", 4),
                                    ("overflow", 8)])
def test_partition_observations_equal_to_jax(case, n, ba_window):
    jw = ba_window if case == "sharded_ba" else _overflow_window()
    jwp, jd = jsba.partition_observations(jw, n)
    twp, td = partition_observations(convert.window(to_dict(jw), "cpu"), n)
    assert td == jd
    if case == "overflow":
        assert td == 4
    for name in ("obs_state", "obs_lm", "obs_f", "obs_valid"):
        assert np.array_equal(_np(getattr(twp, name)),
                              _np(getattr(jwp, name))), name


# ---------------------------------------------------------------------------
# alignment and seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_distributed_align_matches_jax_and_port(n, runs, align_inputs):
    jinp, tinp, _ = align_inputs
    jst, _ = jsia.run([jinp], jsia.make_state(),
                      jsia.SparseImgAlignOptions(**ALIGN_OPTS))
    tst, tstats = tsia.run([tinp], tsia.make_state(),
                           tsia.SparseImgAlignOptions(**ALIGN_OPTS))
    levels = ALIGN_OPTS["max_level"] - ALIGN_OPTS["min_level"] + 1
    for r in runs[n]:
        a = r["align"][0]
        np.testing.assert_allclose(_np(a["t"]), _np(jst.T_icur_iref.t),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(a["q"]), _np(jst.T_icur_iref.q),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(a["t"]), _np(tst.T_icur_iref.t),
                                   atol=1e-5)
        np.testing.assert_allclose(_np(a["q"]), _np(tst.T_icur_iref.q),
                                   atol=1e-5)
        assert int(a["n_tracked"]) == int(tstats.n_tracked)
        # one all-reduce of the packed (H, g, chi2, n) per evaluate
        assert a["comm_calls"]["all_reduce"] == \
            levels * (ALIGN_OPTS["max_iter"] + 1)
        assert a["comm_bytes"]["all_reduce"] == \
            levels * (ALIGN_OPTS["max_iter"] + 1) * 74 * 4
    # the rolled image is a +2 px x-shift: an x-translation is recovered
    assert abs(float(runs[n][0]["align"][0]["t"][0])) > 1e-3


def test_distributed_seed_update_matches_jax_and_port(runs, align_inputs):
    jinp, tinp, tcam = align_inputs
    jcam = graft._synthetic_inputs(h=48, w=64, n_feat=32)[1]
    jargs = _seed_args(jinp, jcam, "jax")
    jres = jdf.update_seeds(
        *jargs[:2], jcam, jcam, *jargs[3:], **SEED_KW,
        matcher_opts=jmatcher.MatcherOptions(max_epi_search_steps=32))
    targs = _seed_args(tinp, tcam, "torch")
    tres = tdf.update_seeds(
        *targs[:2], tcam, tcam, *targs[3:], **SEED_KW,
        matcher_opts=tmatcher.MatcherOptions(max_epi_search_steps=32))
    assert int(tres.n_updated) > 10
    for r in runs[4]:
        s = r["seeds"]
        # against the port's one-device update: the same per-seed program
        assert np.array_equal(_np(s["ftype"]), _np(tres.ftype))
        assert s["n_updated"] == int(tres.n_updated)
        assert s["n_converged"] == int(tres.n_converged)
        np.testing.assert_allclose(_np(s["seed_state"]),
                                   _np(tres.seed_state), rtol=1e-6)
        # against JAX
        assert abs(s["n_updated"] - int(jres.n_updated)) <= 2
        jft = _np(jres.ftype)
        same = _np(s["ftype"]) == jft
        assert (~same).sum() <= 2
        np.testing.assert_allclose(_np(s["seed_state"])[same],
                                   _np(jres.seed_state)[same], rtol=1e-3,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# window BA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shape", [(4, "(f,)"), (8, "(h, f) = (2, 4)")])
def test_distributed_optimize_matches_jax_and_port(n, shape, runs,
                                                   ba_window):
    jwp, twp = _partitioned(ba_window, n)
    jw1, jchi = jwba.optimize(jwp, JSE3.identity(), jnp.asarray(FOCAL),
                              jwba.BAOptions(max_iter=BA_ITERS))
    tw1, tchi, _ = twba.optimize(twp, SE3.identity(), torch.tensor(FOCAL),
                                 twba.BAOptions(max_iter=BA_ITERS))
    for r in runs[n]:
        b = r["ba"][0]
        np.testing.assert_allclose(_np(b["p"]), _np(jw1.p), atol=2e-4)
        np.testing.assert_allclose(_np(b["q"]), _np(jw1.q), atol=2e-4)
        assert abs(b["chi2"] - float(jchi)) < 0.02 * max(float(jchi), 1.0)
        np.testing.assert_allclose(_np(b["p"]), _np(tw1.p), atol=1e-5)
        np.testing.assert_allclose(_np(b["q"]), _np(tw1.q), atol=1e-5)
        np.testing.assert_allclose(_np(b["lm_pos"]), _np(tw1.lm_pos),
                                   atol=5e-4)
        assert np.array_equal(_np(b["lm_valid"]), _np(tw1.lm_valid))
        assert abs(b["chi2"] - float(tchi)) <= 1e-4 * max(float(tchi), 1.0)


@pytest.mark.parametrize("n", [2, 4])
def test_void_on_single_view_agrees_across_ranks(n, runs, ba_window):
    """A landmark seen once voids the state step on every rank exactly
    where the one-device solve voids it: the single-view count is summed
    over the ranks, so the rank that owns the landmark does not void
    alone."""
    _, twp = _partitioned(ba_window, n)
    opts = twba.BAOptions(max_iter=BA_ITERS, void_on_single_view=True)
    tw1, tchi, tvoid = twba.optimize(_once_seen(twp), SE3.identity(),
                                     torch.tensor(FOCAL), opts)
    assert int(tvoid) > 0
    for r in runs[n]:
        b = r["ba#2"][0]
        assert b["n_void"] == int(tvoid)
        np.testing.assert_allclose(_np(b["p"]), _np(tw1.p), atol=1e-5)
        np.testing.assert_allclose(_np(b["q"]), _np(tw1.q), atol=1e-5)


@pytest.mark.parametrize("void", [False, True])
def test_comms_volume_equals_counted_bytes(void, runs, ba_window):
    vol = comms_volume_per_solve(ba_window.S, BA_ITERS, void)
    for r in runs[2]:
        b = r["ba#2" if void else "ba"][0]
        assert b["comm_bytes"]["all_reduce"] == vol["bytes_per_solve"]
        # the landmarks come back by one gather of [L, 4] float32
        assert b["comm_bytes"]["all_gather"] == ba_window.L * 4 * 4
