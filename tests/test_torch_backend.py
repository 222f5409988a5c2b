"""The port's IMU handling and sliding-window VI backend against the JAX
package's, on the CPU.

- ``ImuHandler`` (windows, packed window, rotation prior, stationarity) on
  the streams of tests/test_imu_handler.py: host numpy, equal to 1e-6;
  ``preintegrate`` / ``gyro_rotation_prior`` / ``preintegrate_with_cov``:
  Δq, Δv, Δp, the bias Jacobians within 1e-5 relative to their scale, the
  covariance within 1e-4 relative to its largest entry (float32, 200 steps
  summed in another order). Skipping zero-length steps is bit-identical
  with the masked loop.
- ``imu_residual``, ``build_system``, ``solve_schur``, ``optimize``,
  ``alignment_solve``, ``marginalize_oldest`` on ``synthetic_ba_window``
  (perturbed): every quantity within 1e-4 relative to its own largest
  entry, or 1e-3 where a solve amplifies rounding (``H_prior``, whose
  eigenvalues span ~1e8, and the solved states). The port's float64
  ``solve_schur`` against JAX's evaluated in float64 on the same system,
  with and without a once-seen landmark: 1e-6 relative. ``optimize`` steps
  the states with a once-seen landmark by default and voids under
  ``void_on_single_view``. ``indexing.segment_sum`` against
  ``jax.ops.segment_sum``.
- One ``_marginalize_program`` / ``_step_program`` / ``_apply_program``
  call of ``DeviceBackend``, each from the same JAX state, on a body
  accelerating past a box of landmarks: the slid window within 1e-3
  relative; the keyframe's absorption within 1e-5 with equal slot tables;
  after the whole step the masks and buffer counters equal, the cost not
  above the absorbed state's and every output finite (the LM solves of a
  window with once-seen landmarks are not reproducible in float32, so the
  port's backend runs with ``void_on_single_view`` here: see the test);
  the frontend correction within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_pro_universal_tpu.backend import device_interface as jdbe
from svo_pro_universal_tpu.backend import imu_factor as jimf
from svo_pro_universal_tpu.backend import window_ba as jwba
from svo_pro_universal_tpu.cameras.rig import ImuParams as JImuParams
from svo_pro_universal_tpu.common.frame import make_empty_frame as jempty
from svo_pro_universal_tpu.common.point import make_pool as jmake_pool
from svo_pro_universal_tpu.config import Config as JConfig
from svo_pro_universal_tpu.frontend import imu_handler as jih
from svo_pro_universal_tpu.frontend.map import make_ring as jmake_ring
from svo_pro_universal_tpu.ops.pyramid import build_pyramid as jbuild
from svo_pro_universal_tpu.testing.synthetic import synthetic_ba_window
from svo_pro_universal_tpu.utils.transform import SE3 as JSE3, se3_exp
from svo_pro_universal_tpu_torch import convert
from svo_pro_universal_tpu_torch.backend import device_interface as tdbe
from svo_pro_universal_tpu_torch.backend import imu_factor as timf
from svo_pro_universal_tpu_torch.backend import window_ba as twba
from svo_pro_universal_tpu_torch.cameras import rig as trig
from svo_pro_universal_tpu_torch.common.frame import make_empty_frame as tempty
from svo_pro_universal_tpu_torch.frontend import imu_handler as tih
from svo_pro_universal_tpu_torch.ops.pyramid import build_pyramid as tbuild
from svo_pro_universal_tpu_torch.utils.indexing import segment_sum
from svo_pro_universal_tpu_torch.utils.transform import SE3

from torch_parity_utils import to_dict

G = 9.81


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_rel(got, want, rel, what="", floor=1e-6):
    """|got − want| ≤ rel · max(max|want|, floor), elementwise."""
    got = np.asarray(got.detach().cpu().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)            # ±inf entries must match exactly
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    got, want = got[fin], want[fin]
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, floor)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale, (what, err, scale)


def assert_tree_rel(got, want, rel, skip=()):
    """``assert_rel`` leaf by leaf over a port NamedTuple and the JAX
    dict of the same fields; bools and integers exactly."""
    for k, w in want.items():
        if k in skip:
            continue
        g = getattr(got, k)
        if isinstance(w, dict):
            assert_tree_rel(g, w, rel)
        elif np.asarray(w).dtype.kind in "biu":
            np.testing.assert_array_equal(
                np.asarray(g.cpu().numpy() if isinstance(g, torch.Tensor)
                           else g), np.asarray(w), err_msg=k)
        else:
            assert_rel(g, w, rel, k)


# ---------------------------------------------------------------------------
# IMU handler and preintegration
# ---------------------------------------------------------------------------

def _streams(rng):
    n = 201
    ts = np.arange(n) / 200.0
    gyro = (np.array([0.3, -0.2, 0.5]) + rng.normal(0, 0.05, (n, 3))
            ).astype(np.float32)
    acc = (np.array([0.5, 0.2, G]) + rng.normal(0, 0.2, (n, 3))
           ).astype(np.float32)
    return ts, gyro, acc


def _handlers(rng):
    ts, gyro, acc = _streams(rng)
    hj, ht = jih.ImuHandler(), tih.ImuHandler()
    for t, g, a in zip(ts, gyro, acc):
        hj.add_measurement(t, g, a)
        ht.add_measurement(t, g, a)
    return hj, ht


def test_imu_handler_matches_jax(rng):
    hj, ht = _handlers(rng)
    wj, wt = hj.window_between(0.2, 0.7), ht.window_between(0.2, 0.7)
    for a, b in zip(wt, wj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ht.window_packed(0.1, 0.83),
                                  hj.window_packed(0.1, 0.83))
    R = np.eye(3)
    np.testing.assert_allclose(ht.relative_rotation_prior_np(0.2, 0.7, R),
                               hj.relative_rotation_prior_np(0.2, 0.7, R),
                               atol=1e-6)
    assert ht.is_stationary(0.9) == hj.is_stationary(0.9)
    pj = hj.relative_rotation_prior(0.2, 0.7, JSE3.identity())
    pt = ht.relative_rotation_prior(0.2, 0.7, SE3.identity())
    np.testing.assert_allclose(pt.q.numpy(), np.asarray(pj.q), atol=1e-5)
    g = np.array([2.0, -1.0, 9.0], np.float32)
    np.testing.assert_allclose(
        tih.initial_attitude_from_gravity(_t(g)).numpy(),
        np.asarray(jih.initial_attitude_from_gravity(jnp.asarray(g))),
        atol=1e-6)


def test_preintegrate_matches_jax(rng):
    hj, ht = _handlers(rng)
    wj, wt = hj.window_between(0.0, 0.9), ht.window_between(0.0, 0.9)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.05, 0.0, -0.03], np.float32)
    pj = jih.preintegrate(wj, jnp.asarray(bg), jnp.asarray(ba))
    pt = tih.preintegrate(wt, _t(bg), _t(ba))
    for a, b in zip(pt, pj):
        assert_rel(a, b, 1e-5)
    assert_rel(tih.gyro_rotation_prior(wt, _t(bg)),
               jih.gyro_rotation_prior(wj, jnp.asarray(bg)), 1e-5)


def _masked_window(ht, t0, t1, cut):
    """The frame-relative packed window, masked like the VIO backend's
    (t > cut, t ≤ 0), as (port ImuWindow, JAX ImuWindow, host steps)."""
    pk = ht.window_packed(t0, t1)
    t, v = pk[:, 0], pk[:, 7] > 0.5
    mask = v & (t > np.float32(cut)) & (t <= np.float32(1e-6))
    args = (pk[:, 0], pk[:, 1:4], pk[:, 4:7], mask)
    return (tih.ImuWindow(*(_t(a) for a in args)),
            jih.ImuWindow(*(jnp.asarray(a) for a in args)),
            tdbe.imu_steps(t, mask))


def _masked_preintegrate(window, bias_gyr, bias_acc, sigma_gyr_c,
                         sigma_acc_c):
    """The JAX scan's own form of ``preintegrate_with_cov``: every step of
    the window runs, and one of length 0 keeps the carry (``where`` on
    every carry entry), with the port's per-step arithmetic."""
    from svo_pro_universal_tpu_torch.utils.transform import (
        quat_multiply, quat_normalize, quat_to_matrix, skew, so3_exp)
    dts = tih.step_dts(window)
    f32 = dts.dtype
    keep = dts > 0
    w = window.gyro[:-1] - bias_gyr
    a = window.acc[:-1] - bias_acc
    dq = so3_exp(w * dts[:, None])
    dR = quat_to_matrix(dq)
    Sa = skew(a)
    q = (torch.arange(4) == 0).to(f32)
    qs = [q]
    for k in range(dts.shape[0]):
        q = torch.where(keep[k], quat_normalize(quat_multiply(q, dq[k])), q)
        qs.append(q)
    R = quat_to_matrix(torch.stack(qs[:-1]))
    A, BQBt, RSa = timf._step_blocks(dts, dR, R, Sa, sigma_gyr_c,
                                     sigma_acc_c)
    ar_dt = timf._matvec(R, a) * dts[:, None]
    half_ar_dt2 = 0.5 * timf._matvec(R, a) * dts[:, None] * dts[:, None]
    R_dt = R * dts[:, None, None]
    half_R_dt2 = 0.5 * R * dts[:, None, None] * dts[:, None, None]
    dRT = dR.transpose(-1, -2)
    eye_dt = torch.eye(3, dtype=f32) * dts[:, None, None]
    v = torch.zeros(3, dtype=f32)
    p = torch.zeros_like(v)
    P = torch.zeros((9, 9), dtype=f32)
    Jq = torch.zeros((3, 3), dtype=f32)
    Jvg, Jva, Jpg, Jpa = Jq, Jq, Jq, Jq
    for k in range(dts.shape[0]):
        dt = dts[k]
        RSaJq = RSa[k] @ Jq
        new = (p + v * dt + half_ar_dt2[k], v + ar_dt[k],
               A[k] @ P @ A[k].T + BQBt[k], dRT[k] @ Jq - eye_dt[k],
               Jvg - RSaJq * dt, Jva - R_dt[k],
               Jpg + Jvg * dt - 0.5 * RSaJq * dt * dt,
               Jpa + Jva * dt - half_R_dt2[k])
        p, v, P, Jq, Jvg, Jva, Jpg, Jpa = (
            torch.where(keep[k], x, o) for x, o in zip(
                new, (p, v, P, Jq, Jvg, Jva, Jpg, Jpa)))
    P = P + torch.eye(9, dtype=f32) * 1e-10
    return timf.PreintFactor(q, v, p, torch.sum(dts), Jq, Jvg, Jva, Jpg,
                             Jpa, bias_gyr, bias_acc, P)


def test_preintegrate_with_cov_matches_jax(rng):
    _, ht = _handlers(rng)
    wt, wj, steps = _masked_window(ht, -0.3, 0.95, -0.4)
    assert 0 < len(steps) < wt.t.shape[0] - 1
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.05, 0.0, -0.03], np.float32)
    fj = jimf.preintegrate_with_cov(wj, jnp.asarray(bg), jnp.asarray(ba),
                                    1.2e-3, 8e-3)
    ft = timf.preintegrate_with_cov(wt, _t(bg), _t(ba), 1.2e-3, 8e-3,
                                    steps)
    for k, a, b in zip(ft._fields, ft, fj):
        assert_rel(a, b, 1e-4 if k == "cov" else 1e-5, k)
    # the masked loop over every step gives the same bits
    fm = _masked_preintegrate(wt, _t(bg), _t(ba), 1.2e-3, 8e-3)
    for k, a, b in zip(ft._fields, ft, fm):
        assert torch.equal(a, b), k
    info_j = jimf.imu_information(fj, 0.03, 0.1)
    info_t = timf.imu_information(ft, 0.03, 0.1)
    assert_rel(info_t, info_j, 1e-3)


def test_rig_yaml_parses_the_example():
    """The port's rig parser on the repo's EuRoC calibration."""
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "param" / "euroc_mono.yaml")
    rig = trig.load_rig_yaml(str(path))
    assert len(rig) == 1 and rig.cameras[0].width == 752
    assert rig.imu_params.imu_rate == 200.0
    assert rig.imu_params.g == pytest.approx(9.8082)
    R = SE3(rig.T_body_cam[0].q, rig.T_body_cam[0].t)
    assert abs(float(torch.linalg.norm(R.q)) - 1.0) < 1e-6
    assert rig.stereo_baseline == 0.0


# ---------------------------------------------------------------------------
# window BA on synthetic_ba_window
# ---------------------------------------------------------------------------

TCB = JSE3.identity()
FOCAL = 460.0


@pytest.fixture(scope="module")
def ba_window():
    """synthetic_ba_window (S=6) with states and landmarks perturbed."""
    w = synthetic_ba_window(S=6, n_landmarks=60, L=64, No=360,
                            obs_per_state=50)
    rng = np.random.default_rng(3)
    dp = jnp.asarray(rng.normal(0, 0.02, w.p.shape).astype(np.float32))
    dl = jnp.asarray(rng.normal(0, 0.03, w.lm_pos.shape).astype(np.float32))
    dth = jnp.asarray(rng.normal(0, 0.01, w.p.shape).astype(np.float32))
    from svo_pro_universal_tpu.utils.transform import (
        quat_multiply, so3_exp)
    w = w._replace(p=w.p + dp.at[0].set(0.0), lm_pos=w.lm_pos + dl,
                   q=quat_multiply(w.q, so3_exp(dth.at[0].set(0.0))),
                   v=w.v + 0.05)
    return w


def _port_window(jw):
    return convert.window(to_dict(jw), "cpu")


def _tcb():
    return SE3(_t(np.asarray(TCB.q)), _t(np.asarray(TCB.t)))


def test_imu_residual_and_terms_match_jax(ba_window):
    jw = ba_window
    tw = _port_window(jw)
    opts_j, opts_t = jwba.BAOptions(), twba.BAOptions()
    rj, Jij, Jjj = jwba._imu_terms(jw, opts_j)
    rt, Jit, Jjt = twba._imu_terms(tw, opts_t)
    assert_rel(rt, rj, 1e-4, "r")
    assert_rel(Jit, Jij, 1e-4, "J_i")
    assert_rel(Jjt, Jjj, 1e-4, "J_j")
    assert_rel(twba._imu_residuals(tw, opts_t), rj, 1e-4)


def test_build_system_and_solve_match_jax(ba_window):
    jw = ba_window
    tw = _port_window(jw)
    opts_j, opts_t = jwba.BAOptions(), twba.BAOptions()
    sj = jwba.build_system(jw, TCB, jnp.asarray(FOCAL), opts_j)
    st = twba.build_system(tw, _tcb(), torch.tensor(FOCAL), opts_t)
    for name, a, b in zip(("Hpp", "bp", "U", "Hll", "bl", "chi2"), st, sj):
        assert_rel(a, b, 1e-4, name)
    assert_rel(twba.system_chi2(tw, _tcb(), torch.tensor(FOCAL), opts_t),
               sj[5], 1e-4)
    dj = jwba.solve_schur(*sj[:5], 1e-4, jw.lm_valid)
    dt = twba.solve_schur(*st[:5], torch.tensor(1e-4), tw.lm_valid)
    assert not bool(dt[2])
    assert_rel(dt[0], dj[0], 1e-3, "dx")
    assert_rel(dt[1], dj[1], 1e-3, "dl")


def test_optimize_matches_jax(ba_window):
    """Three LM iterations with the in-window VI alignment on."""
    jw = ba_window
    tw = _port_window(jw)
    wj, cj = jwba.optimize(jw, TCB, jnp.asarray(FOCAL), jwba.BAOptions())
    wt, ct, n_void = twba.optimize(tw, _tcb(), torch.tensor(FOCAL),
                                   twba.BAOptions())
    assert int(n_void) == 0          # every landmark has ≥ 2 views here
    # the converged cost is rounding-dominated: hold it to the start's
    c0 = float(jwba.build_system(jw, TCB, jnp.asarray(FOCAL),
                                 jwba.BAOptions())[5])
    assert abs(float(ct) - float(cj)) <= 1e-3 * c0
    for k in ("q", "p", "v", "lm_pos"):
        assert_rel(getattr(wt, k), np.asarray(getattr(wj, k)), 1e-3, k)
    # the biases stay near 0 (~1e-4) and are weakly observed: within 1e-5
    # absolute (rad/s, m/s²)
    for k in ("bg", "ba"):
        assert_rel(getattr(wt, k), np.asarray(getattr(wj, k)), 1e-3, k,
                   floor=1e-2)
    assert int(wt.align_n) == int(wj.align_n)


def _once_seen(tw):
    """The port window with landmark 0 left one view (its other views'
    observations switched off)."""
    views = torch.nonzero(tw.obs_valid & (tw.obs_lm == 0)).flatten()
    assert views.numel() >= 2
    return tw._replace(obs_valid=tw.obs_valid.index_fill(0, views[1:],
                                                         False))


def test_optimize_voids_the_state_step_on_a_once_seen_landmark(ba_window):
    """Under ``void_on_single_view`` (the rule the parity tests with JAX's
    float32 runs set) one landmark left with a single window view voids
    every iteration's state step: the states stay as they were, the other
    landmarks still move, and the count says so."""
    tw = _once_seen(_port_window(ba_window))
    opts = twba.BAOptions(vi_alignment=False, void_on_single_view=True)
    assert twba.single_view_landmarks(tw, _tcb(), torch.tensor(FOCAL),
                                      opts).nonzero().flatten().tolist() \
        == [0]
    wt, ct, n_void = twba.optimize(tw, _tcb(), torch.tensor(FOCAL), opts)
    assert int(n_void) == opts.max_iter
    for k in ("q", "p", "v", "bg", "ba"):
        assert torch.equal(getattr(wt, k), getattr(tw, k)), k
    assert torch.equal(wt.lm_pos[0], tw.lm_pos[0])
    assert not torch.equal(wt.lm_pos[1:], tw.lm_pos[1:])
    assert float(ct) < float(twba.system_chi2(tw, _tcb(),
                                              torch.tensor(FOCAL), opts))


def test_optimize_steps_the_states_with_a_once_seen_landmark(ba_window):
    """By default the float64 solve inverts the once-seen landmark's damped
    block as JAX's float64 evaluation does: no iteration is voided, the
    states and every landmark move, and the cost falls."""
    tw = _once_seen(_port_window(ba_window))
    opts = twba.BAOptions(vi_alignment=False)
    wt, ct, n_void = twba.optimize(tw, _tcb(), torch.tensor(FOCAL), opts)
    assert int(n_void) == 0
    for k in ("q", "p", "v"):
        assert not torch.equal(getattr(wt, k), getattr(tw, k)), k
    assert not torch.equal(wt.lm_pos[0], tw.lm_pos[0])
    c0 = float(twba.system_chi2(tw, _tcb(), torch.tensor(FOCAL), opts))
    assert float(ct) < 0.5 * c0, (float(ct), c0)
    for x in (wt.q, wt.p, wt.v, wt.lm_pos):
        assert torch.isfinite(x).all()


@pytest.mark.parametrize("once_seen", [False, True])
def test_solve_schur_matches_jax_in_float64(ba_window, once_seen):
    """The default solve against JAX's ``solve_schur`` evaluated in float64
    (``jax.enable_x64``) on the same float32-built system, upcast: both in
    float64, so they agree to rounding of the cond ~1e7 system: 1e-6
    relative to each step's largest entry. With a once-seen landmark the
    damped rank-2 block is inverted, as the float64 reference does."""
    tw = _port_window(ba_window)
    if once_seen:
        tw = _once_seen(tw)
    opts = twba.BAOptions()
    st = twba.build_system(tw, _tcb(), torch.tensor(FOCAL), opts)
    mu = 1e-4
    dx, dl, void = twba.solve_schur(*st[:5], torch.tensor(mu), tw.lm_valid)
    assert dx.dtype == torch.float32 and not bool(void)
    with jax.enable_x64(True):
        args = [jnp.asarray(x.numpy().astype(np.float64)) for x in st[:5]]
        dj = jwba.solve_schur(*args, jnp.float64(mu),
                              jnp.asarray(tw.lm_valid.numpy()))
        dj = [np.asarray(x) for x in dj]
    assert dj[0].dtype == np.float64
    assert np.abs(dj[0]).max() > 1e-4           # a real state step
    assert_rel(dx, dj[0], 1e-6, "dx")
    assert_rel(dl, dj[1], 1e-6, "dl")


@pytest.mark.parametrize("shape,n", [((0, 3), 5), ((1,), 5), ((7, 2, 2), 3),
                                     ((600, 15, 3), 2049), ((1000, 225), 6)])
def test_segment_sum_matches_jax(shape, n):
    """``indexing.segment_sum`` (sorted, segmented scan) against
    ``jax.ops.segment_sum`` on the same rows, out-of-range segments
    included: within float32 rounding of the summation order (1e-6 of the
    absolute sum), a NaN row reaching only its own segment, integers
    exactly."""
    rng = np.random.default_rng(shape[0] + n)
    d = rng.normal(0, 1, shape).astype(np.float32)
    seg = rng.integers(-2, n + 3, shape[0])
    if shape[0] > 1:
        seg[0] = 1 % n
        d[0] = np.nan
    got = segment_sum(torch.from_numpy(d), torch.from_numpy(seg), n).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(d), jnp.asarray(seg),
                                          n))
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    absum = np.asarray(jax.ops.segment_sum(jnp.abs(jnp.asarray(d)),
                                           jnp.asarray(seg), n))
    assert (np.abs(got - want)[fin] <= 1e-6 * absum[fin] + 1e-7).all()
    di = rng.integers(-50, 50, shape).astype(np.int64)
    np.testing.assert_array_equal(
        segment_sum(torch.from_numpy(di), torch.from_numpy(seg), n).numpy(),
        np.asarray(jax.ops.segment_sum(jnp.asarray(di.astype(np.int32)),
                                       jnp.asarray(seg), n)))


def test_alignment_solve_matches_jax(ba_window):
    jw = ba_window
    tw = _port_window(jw)
    opts_j, opts_t = jwba.BAOptions(), twba.BAOptions()
    oj = jwba.vi_alignment(jw, opts_j)
    ot = twba.vi_alignment(tw, opts_t)
    for a, b in zip(ot, oj):
        if np.asarray(b).dtype == bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert_rel(a, b, 1e-3)


def test_marginalize_oldest_matches_jax(ba_window):
    jw = ba_window
    tw = _port_window(jw)
    mj = jwba.marginalize_oldest(jw, TCB, jnp.asarray(FOCAL),
                                 jwba.BAOptions())
    mt = twba.marginalize_oldest(tw, _tcb(), torch.tensor(FOCAL),
                                 twba.BAOptions())
    # H_prior: eigenvalues up to ~1e8 (gauge), compare relative to scale
    assert_tree_rel(mt, to_dict(mj), 1e-3)
    # and a second slide from the first one's prior
    mj2 = jwba.marginalize_oldest(mj, TCB, jnp.asarray(FOCAL),
                                  jwba.BAOptions())
    mt2 = twba.marginalize_oldest(mt, _tcb(), torch.tensor(FOCAL),
                                  twba.BAOptions())
    assert_tree_rel(mt2, to_dict(mj2), 1e-3)


# ---------------------------------------------------------------------------
# the DeviceBackend programs
# ---------------------------------------------------------------------------

S_WIN, P_POOL, N_FT, M_IMU = 5, 96, 64, 64


ACC = 2.0        # m/s² along x, from rest


def _backend_inputs(k: int, rng):
    """(ts, T_cam_world) of keyframe k: a level body accelerating from
    rest along x past a box of landmarks, as the backend's first state
    (v = 0) assumes."""
    ts = 0.15 * k
    T = se3_exp(jnp.array([-0.5 * ACC * ts * ts, 0.0, 0.0, 0.0, 0.0, 0.0],
                          jnp.float32))
    return ts, T


def _make_backends():
    cfg = JConfig()
    cfg.backend.max_landmarks = 80
    cfg.backend.max_obs_per_kf = 40
    kw = dict(num_keyframes=S_WIN)
    jb = jdbe.DeviceBackend(jnp.asarray(FOCAL), TCB, imu_params=JImuParams(),
                            opts=jwba.BAOptions(max_iter=3,
                                                vi_alignment=False),
                            backend_cfg=cfg.backend, **kw)
    # the window holds once-seen landmarks, whose float32 blocks decide
    # JAX's step: the port reproduces the void (see the module docstring)
    tb = tdbe.DeviceBackend(torch.tensor(FOCAL), _tcb(),
                            imu_params=trig.ImuParams(),
                            opts=twba.BAOptions(max_iter=3,
                                                vi_alignment=False,
                                                void_on_single_view=True),
                            backend_cfg=convert.config(
                                {"backend": vars(cfg.backend)}).backend,
                            device="cpu", **kw)
    return jb, tb


def test_device_backend_defaults_to_the_card(monkeypatch):
    """DeviceBackend, an entry point of its own, runs on the card unless
    it is given a device: without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdbe.DeviceBackend(torch.tensor(FOCAL), _tcb(),
                           imu_params=trig.ImuParams())
    tb = tdbe.DeviceBackend(torch.tensor(FOCAL), _tcb(),
                            imu_params=trig.ImuParams(), device="cpu")
    assert tb.state.window.q.device.type == "cpu"
    assert tb.focal.device.type == "cpu"


def _scene(rng):
    pool = np.stack([rng.uniform(-2, 3, P_POOL), rng.uniform(-1.5, 1.5,
                                                             P_POOL),
                     rng.uniform(2.5, 6, P_POOL)], -1).astype(np.float32)
    return pool


def _frame_obs(T, pool, rng):
    """Every keyframe sees the same 60 landmarks (in another order) and
    absorbs the first ``max_obs_per_kf`` (40) of them, so most landmark
    blocks of the window have ≥ 2 views; a few have one, a rank-2 block
    whose float32 inverse (cond ~1e8) differs between XLA and LAPACK
    (ROADMAP Queue 3)."""
    lids = rng.permutation(N_FT).astype(np.int32)
    lids[lids >= 60] = -1
    X = np.asarray(T.apply(jnp.asarray(pool[np.maximum(lids, 0)])))
    f = X / np.linalg.norm(X, axis=-1, keepdims=True)
    f = (f + rng.normal(0, 5e-4, f.shape)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return lids, f, np.ones(N_FT, bool)


def _imu_packed(ts, last, rng):
    """[M, 8] packed window of the accelerating level body (specific force
    (ACC, 0, g)), times relative to ts, covering (last − 0.015, ts]. The
    samples carry sensor noise: a noise-free constant specific force reads
    as stationary to the backend's zero-motion detector."""
    t = np.arange(M_IMU, dtype=np.float64) * 0.005
    t = t - t[-1]
    n = int(round((ts - max(last, 0.0)) / 0.005)) + 3
    pk = np.zeros((M_IMU, 8), np.float32)
    pk[:, 0] = t.astype(np.float32)
    pk[:, 1:4] = rng.normal(0, 0.02, (M_IMU, 3))
    pk[:, 4:7] = rng.normal(0, 0.2, (M_IMU, 3)) + np.array([ACC, 0.0, G])
    pk[M_IMU - min(n, M_IMU):, 7] = 1.0
    return pk


def _run_jax_backend(jb, pool, rng, n_states):
    """n_states JAX _step_program calls (marginalizing when full); returns
    the state before the last call and that call's inputs."""
    st = jb.state
    k, last = 0, -1.0
    calls = []
    for i in range(n_states):
        ts, T = _backend_inputs(i, rng)
        lids, f, valid = _frame_obs(T, pool, rng)
        pk = _imu_packed(ts, last, rng)
        calls.append((st, k, ts, T, lids, f, valid, pk, last))
        if k >= jb.S:
            st = jb._jit_marg(st)
            k -= 1
        st, _, _ = _jax_step(jb, st, k, ts, T, lids, f, valid, pool, pk,
                             last)
        k += 1
        last = ts
    return st, k, calls


def _windows(pk, ts, last):
    t = pk[:, 0]
    raw = (pk[:, 7] > 0.5) & (t <= np.float32(1e-6))
    rel = np.float32(last) - np.float32(ts)
    mask = raw & (t > rel)
    return raw, mask


def _jax_step(jb, st, k, ts, T, lids, f, valid, pool, pk, last):
    raw, mask = _windows(pk, ts, last)
    J = jnp.asarray
    iw = jih.ImuWindow(J(pk[:, 0]), J(pk[:, 1:4]), J(pk[:, 4:7]), J(mask))
    iw_raw = jih.ImuWindow(J(pk[:, 0]), J(pk[:, 1:4]), J(pk[:, 4:7]),
                           J(raw))
    dt_prev = max(np.float32(ts) - np.float32(last), np.float32(1e-3))
    have_prev = (last >= 0) and dt_prev < np.float32(jb.max_imu_gap)
    return jb._jit_step(st, J(k, jnp.int32), jnp.float32(dt_prev),
                        jnp.float32(ts), T, J(lids), J(f), J(valid),
                        J(pool), iw, J(have_prev), J(True), iw_raw)


def _port_step(tb, st, k, ts, T, lids, f, valid, pool, pk, last):
    dt_prev = max(np.float32(ts) - np.float32(last), np.float32(1e-3))
    have_prev = bool(last >= 0 and dt_prev < np.float32(tb.max_imu_gap))
    Tt = SE3(_t(np.asarray(T.q)), _t(np.asarray(T.t)))
    return tb._step_program(
        st, k, dt_prev, np.float32(ts), Tt, _t(lids.astype(np.int64)),
        _t(f), _t(valid), _t(pool), _t(pk), pk,
        np.float32(last) - np.float32(ts), have_prev, True)


def test_device_backend_programs_match_jax():
    rng = np.random.default_rng(5)
    jb, tb = _make_backends()
    pool = _scene(rng)
    st_j, k, calls = _run_jax_backend(jb, pool, rng, S_WIN + 1)
    assert k == S_WIN
    # one marginalization from the same (full-window) state
    before = calls[-1][0]
    mj = jb._jit_marg(before)
    mt = tb._marginalize_program(convert.backend_state(to_dict(before),
                                                       "cpu"))
    assert_tree_rel(mt.window, to_dict(mj.window), 1e-3)
    # one step from the slid state: the same inputs as the JAX run's last
    _, kk, ts, T, lids, f, valid, pk, last = calls[-1]
    # the keyframe's absorption (state, IMU factor, slots, observations)
    raw, mask = _windows(pk, ts, last)
    dt_prev = max(np.float32(ts) - np.float32(last), np.float32(1e-3))
    J = jnp.asarray
    aj = jb._add_keyframe(
        mj, J(kk - 1), jnp.float32(dt_prev), T, J(lids), J(f), J(valid),
        J(pool), jih.ImuWindow(J(pk[:, 0]), J(pk[:, 1:4]), J(pk[:, 4:7]),
                               J(mask)), J(True))
    at = tb._add_keyframe(
        convert.backend_state(to_dict(mj), "cpu"), kk - 1, dt_prev,
        SE3(_t(np.asarray(T.q)), _t(np.asarray(T.t))),
        _t(lids.astype(np.int64)), _t(f), _t(valid), _t(pool),
        tih.ImuWindow(_t(pk[:, 0]), _t(pk[:, 1:4]), _t(pk[:, 4:7]),
                      _t(mask)), True, tdbe.imu_steps(pk[:, 0], mask))
    assert_tree_rel(at.window, to_dict(aj.window), 1e-5)
    np.testing.assert_array_equal(at.slot_lid.numpy(),
                                  np.asarray(aj.slot_lid))
    np.testing.assert_array_equal(at.slot_age.numpy(),
                                  np.asarray(aj.slot_age))
    assert at.next_age == int(aj.next_age)

    sj, Tj, cj = _jax_step(jb, mj, kk - 1, ts, T, lids, f, valid, pool, pk,
                           last)
    tb.tracer.start()                   # the backend's LM counters
    s_t, Tt, ct = _port_step(tb, convert.backend_state(to_dict(mj), "cpu"),
                             kk - 1, ts, T, lids, f, valid, pool, pk, last)
    assert s_t.abuf_n == int(sj.abuf_n)
    # 4 of the window's 57 landmarks have one view: every LM iteration's
    # state step was voided, and the counters say so
    counts = tb.tracer.totals
    assert counts["lm_iterations"] == 3 and int(counts["lm_voided"]) == 3
    assert counts["backend_solves"] == 1
    assert s_t.abuf_last_ts == np.float32(sj.abuf_last_ts)
    for key in ("obs_valid", "obs_lm", "state_valid", "imu_valid", "zupt",
                "lm_valid"):
        np.testing.assert_array_equal(getattr(s_t.window, key).numpy(),
                                      np.asarray(getattr(sj.window, key)),
                                      err_msg=key)
    # the LM solves: the window holds landmarks seen once (rank-2 blocks);
    # their float32 inverses are non-finite in JAX on the CPU (the NaN
    # voids the whole state step there) and finite in LAPACK, and neither
    # is the float64 solution (ROADMAP Queue 3). What both hold to: the
    # keep-best LM never raises the cost, and every output is finite.
    w0 = at.window
    c0 = float(twba.system_chi2(w0, tb.T_cam_body, tb.focal, tb.opts))
    c_end = float(twba.system_chi2(s_t.window, tb.T_cam_body, tb.focal,
                                   tb.opts))
    assert c_end <= c0
    for x in (s_t.window.q, s_t.window.p, s_t.window.v, s_t.window.lm_pos,
              Tt.q, Tt.t, ct):
        assert torch.isfinite(x).all()
    assert bool(s_t.window.has_prior) == bool(sj.window.has_prior)

    # the correction of the frontend from the JAX step's state
    ring_j, pool_j, frame_j = _frontend(pool, rng)
    rj, pj, fj, s_j, c_j = jb._jit_apply(sj, ring_j, pool_j, frame_j, Tj,
                                         cj)
    rt, pt, ft, s_t2, c_t = tb._apply_program(
        convert.backend_state(to_dict(sj), "cpu"),
        convert.ring(to_dict(ring_j), "cpu"),
        convert.pool(to_dict(pool_j), "cpu"),
        convert.frame(to_dict(frame_j), "cpu"),
        SE3(_t(np.asarray(Tj.q)), _t(np.asarray(Tj.t))), _t(np.asarray(cj)))
    assert_rel(s_t2, np.asarray(s_j), 1e-4)
    assert_rel(c_t, np.asarray(c_j), 1e-4)
    assert_rel(pt.pos, np.asarray(pj.pos), 1e-4)
    assert_tree_rel(ft, to_dict(fj), 1e-4, skip=("pyramid",))
    assert_tree_rel(rt.frames, to_dict(rj.frames), 1e-4, skip=("pyramid",))


def _frontend(pool, rng):
    """A small JAX ring / pool / frame: 3 keyframes with seeds, the pool's
    landmarks."""
    tpl = jempty(jbuild(jnp.zeros((16, 16), jnp.float32), 1), N_FT)
    ring = jmake_ring(tpl, 4)
    frames = ring.frames
    Tq = jnp.tile(jnp.array([1.0, 0, 0, 0]), (4, 1))
    Tt = jnp.asarray(rng.normal(0, 0.3, (4, 3)).astype(np.float32))
    seeds = jnp.asarray(rng.uniform(0.2, 0.5, (4, N_FT, 4)).astype(
        np.float32))
    frames = frames._replace(T_cam_world=JSE3(Tq, Tt), seed_state=seeds,
                             seed_mu_range=jnp.full((4,), 2.0))
    ring = ring._replace(frames=frames,
                         valid=jnp.array([True, True, True, False]),
                         last_added=jnp.asarray(2))
    jp = jmake_pool(P_POOL, 4)
    jp = jp._replace(pos=jnp.asarray(pool), valid=jnp.ones(P_POOL, bool))
    frame = jax.tree.map(lambda x: x[1], frames)
    return ring, jp, frame


@pytest.mark.parametrize("moving", [False, True])
def test_zero_motion_prior_needs_the_frontend_at_rest(moving):
    """A noise-free constant specific force reads as stationary to the IMU
    test of both packages, so by default both put the zero-velocity prior
    on a window state that moves at 0.5 m/s, as at rest. With the port's
    opt-in ``zupt_require_rest`` the frontend's velocity (the state's
    initial v0) must also be within 3 σ of rest: then only the resting
    state is flagged (ROADMAP, deliberate divergences)."""
    rng = np.random.default_rng(2)
    jb, tb = _make_backends()
    _, tr = _make_backends()
    tr.zupt_require_rest = True
    pool = _scene(rng)
    pk = np.zeros((M_IMU, 8), np.float32)
    pk[:, 0] = (np.arange(M_IMU) - (M_IMU - 1)) * 0.005
    pk[:, 4:7] = [ACC, 0.0, G]
    pk[:, 7] = 1.0
    dt, J = 0.15, jnp.asarray
    sj, st, sr = jb.state, tb.state, tr.state
    for k in range(2):
        T = se3_exp(jnp.array([-0.5 * dt * k * moving, 0.0, 0.0, 0.0, 0.0,
                               0.0], jnp.float32))
        lids, f, valid = _frame_obs(T, pool, rng)
        mask = pk[:, 7] > 0.5
        sj = jb._add_keyframe(
            sj, J(k), jnp.float32(dt), T, J(lids), J(f), J(valid), J(pool),
            jih.ImuWindow(J(pk[:, 0]), J(pk[:, 1:4]), J(pk[:, 4:7]),
                          J(mask)), J(True))
        args = (k, dt, SE3(_t(np.asarray(T.q)), _t(np.asarray(T.t))),
                _t(lids.astype(np.int64)), _t(f), _t(valid), _t(pool),
                tih.ImuWindow(_t(pk[:, 0]), _t(pk[:, 1:4]), _t(pk[:, 4:7]),
                              _t(mask)), True, tdbe.imu_steps(pk[:, 0], mask))
        st = tb._add_keyframe(st, *args)
        sr = tr._add_keyframe(sr, *args)
    rest = 1.0 / tb.zupt_sigma_v ** 2
    for s in (sj, st):
        assert float(s.window.zupt[1]) == pytest.approx(rest)
        assert float(s.window.zupt[0]) == pytest.approx(rest)
    assert float(sr.window.zupt[1]) == pytest.approx(0.0 if moving
                                                     else rest)
    assert float(sr.window.zupt[0]) == pytest.approx(rest)


def test_host_backend_api_at_epoch_stamps_matches_jax():
    """``add_keyframe_device`` (the host handlers' backend API) at
    EuRoC-epoch stamps (1403636579.763555584 s on), fed by each package's
    ``ImuHandler`` with one 200 Hz stream, over S_WIN + 1 keyframes (one
    marginalization). Where JAX casts the absolute stamp to float32 (the
    step's ``F32(timestamp)``, the alignment buffer's last stamp, which
    resolves 128 s there) and where the window's times are relative
    float32 (``window_between``), the port gives the same values: the IMU
    windows to the bit, ``abuf_last_ts`` equal, and the buffer's count,
    factor flags, the window's state and IMU masks and its factors' dt
    (1e-6) equal. A frame made at the epoch (common/frame.py) keeps JAX's
    float32 stamp."""
    t_epoch = 1403636579.763555584
    tf = tempty(tbuild(torch.zeros((16, 16)), 1), N_FT, timestamp=t_epoch)
    jf = jempty(jbuild(jnp.zeros((16, 16), jnp.float32), 1), N_FT,
                timestamp=t_epoch)
    assert tf.timestamp.dtype == torch.float32
    assert tf.timestamp.item() == float(np.float32(jf.timestamp))
    assert tf.timestamp.item() != t_epoch           # 128 s apart there
    rng = np.random.default_rng(9)
    jb, tb = _make_backends()
    pool = _scene(rng)
    _, pool_j, frame_j = _frontend(pool, rng)
    pool_t = convert.pool(to_dict(pool_j), "cpu")
    frame_t = convert.frame(to_dict(frame_j), "cpu")
    ji, ti = jih.ImuHandler(JImuParams()), tih.ImuHandler(trig.ImuParams())
    n_imu = 0
    for i in range(S_WIN + 1):
        ts, T = _backend_inputs(i, rng)
        while n_imu * 0.005 <= ts + 0.01:
            g = rng.normal(0, 0.02, 3).astype(np.float32)
            a = (rng.normal(0, 0.2, 3) + [ACC, 0.0, G]).astype(np.float32)
            ji.add_measurement(t_epoch + n_imu * 0.005, g, a)
            ti.add_measurement(t_epoch + n_imu * 0.005, g, a)
            n_imu += 1
        if i:
            last = t_epoch + _backend_inputs(i - 1, rng)[0]
            wj = ji.window_between(last, t_epoch + ts)
            wt = ti.window_between(last, t_epoch + ts)
            for key in ("t", "gyro", "acc", "valid"):
                np.testing.assert_array_equal(
                    getattr(wt, key).numpy(), np.asarray(getattr(wj, key)),
                    err_msg=key)
        jb.add_keyframe_device(t_epoch + ts, frame_j._replace(T_cam_world=T),
                               pool_j, imu_handler=ji)
        tb.add_keyframe_device(
            t_epoch + ts, frame_t._replace(T_cam_world=SE3(
                _t(np.asarray(T.q)), _t(np.asarray(T.t)))),
            pool_t, imu_handler=ti)
    sj, st = jb.state, tb.state
    assert tb.n_states == jb.n_states == S_WIN and tb._ts == jb._ts
    assert st.abuf_last_ts == np.float32(sj.abuf_last_ts) == np.float32(
        t_epoch + _backend_inputs(S_WIN, rng)[0])
    assert int(st.abuf_n) == int(sj.abuf_n)
    np.testing.assert_array_equal(st.abuf_fvalid.numpy(),
                                  np.asarray(sj.abuf_fvalid))
    for key in ("state_valid", "imu_valid"):
        np.testing.assert_array_equal(getattr(st.window, key).numpy(),
                                      np.asarray(getattr(sj.window, key)),
                                      err_msg=key)
    np.testing.assert_allclose(st.window.imu.dt.numpy(),
                               np.asarray(sj.window.imu.dt), atol=1e-6)
