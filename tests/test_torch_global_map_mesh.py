"""The port's map-block-partitioned ``GlobalMap(mesh=...)`` on gloo CPU
ranks against the JAX package's ``GlobalMap`` without a mesh.

tests/test_global_map_dcn.py's feed (80 landmarks, 10 keyframes, its
options: 12 keyframes, 256 landmarks, 4096 observations, one solve of 6
LM iterations by ``force_optimize``) goes into a ``GlobalMap`` on a
``(2, 2)`` mesh partitioned over ``(h, f)`` and on a ``(4, 1)`` mesh
partitioned over ``(h,)``, every rank making the same calls (one spawn of
4 ranks runs both). Held as test_global_map_dcn.py:194-203 holds JAX's own
partitioned map: keyframe positions and landmarks (by id) within 5e-4, the
same landmark ids, chi2 within 2%; no observation row dropped, no warning,
and every rank with the same result. The one-device port map is held to
JAX's at the same bounds.

Slot order: the same feed over 40 keyframes at the default capacities (32
states, 1024 slots, 4096 rows), without a solve, into a map on a 4-rank
mesh. By default the port hands out the slots of JAX's ``_lm_slot``
(cursor order) and its window's 4-shard partition drops as many rows as
JAX's window's; with the opt-in ``spread_slots`` it drops none.
"""

import numpy as np
import pytest

from svo_pro_universal_tpu.backend.global_map import GlobalMap as JGlobalMap
from svo_pro_universal_tpu.backend.global_map import (
    GlobalMapOptions as JOptions)
from svo_pro_universal_tpu.parallel.sharded_ba import (
    partition_observations as jpartition)
from svo_pro_universal_tpu.utils.transform import SE3 as JSE3
from svo_pro_universal_tpu_torch.backend.global_map import GlobalMapOptions
from svo_pro_universal_tpu_torch.parallel.mesh import launch
from svo_pro_universal_tpu_torch.testing.parallel_cases import (
    global_map_step, run_steps)

from test_global_map_dcn import _feed

OPTS = dict(max_keyframes=12, max_landmarks=256, max_obs=4096,
            optimize_every=100, ba_iters=6)
MESHES = {"(2, 2) over (h, f)": ((2, 2), ("h", "f")),
          "(4, 1) over (h,)": ((4, 1), ("h",))}
SLOT_KEYFRAMES = 40                     # > 32 states: the ring evicts
SLOT_OPTS = dict(optimize_every=SLOT_KEYFRAMES + 1)   # no solve
SHARDS = 4


def _landmarks():
    return np.random.default_rng(7).uniform(
        [-2, -2, 2], [2, 2, 6], (80, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_map():
    gm = JGlobalMap(300.0, JSE3.identity(), JOptions(**OPTS))
    _feed(gm, np.random.default_rng(11), _landmarks())
    chi2 = gm.force_optimize()
    poses, _ = gm.keyframe_poses()
    ids, pos = gm.optimized_landmarks()
    return dict(poses=poses, lm_ids=ids, lm_pos=pos, chi2=chi2)


@pytest.fixture(scope="module")
def rank_maps():
    steps = [("global_map", dict(shape=shape, axes=axes,
                                 opts=GlobalMapOptions(**OPTS),
                                 lm=_landmarks(), n_kf=10))
             for shape, axes in MESHES.values()]
    steps += [("global_map_slots", dict(
        shape=(SHARDS,), opts=GlobalMapOptions(**SLOT_OPTS), lm=_landmarks(),
        n_kf=SLOT_KEYFRAMES, shards=SHARDS, spread_slots=spread))
        for spread in (False, True)]
    return launch(SHARDS, run_steps, "cpu", steps, device="cpu")


@pytest.fixture(scope="module")
def jax_slots():
    """JAX's map fed the slot-order feed: its slot of each landmark id,
    and the rows its window's 4-shard partition drops."""
    gm = JGlobalMap(300.0, JSE3.identity(), JOptions(**SLOT_OPTS))
    _feed(gm, np.random.default_rng(11), _landmarks(), SLOT_KEYFRAMES)
    return dict(lid2slot=dict(gm.lid2slot),
                dropped=jpartition(gm.window, SHARDS)[1])


def _assert_close(got, ref):
    np.testing.assert_allclose(got["poses"], ref["poses"], atol=5e-4)
    assert abs(got["chi2"] - ref["chi2"]) < 0.02 * max(ref["chi2"], 1.0)
    assert set(got["lm_ids"].tolist()) == set(ref["lm_ids"].tolist())
    np.testing.assert_allclose(got["lm_pos"][np.argsort(got["lm_ids"])],
                               ref["lm_pos"][np.argsort(ref["lm_ids"])],
                               atol=5e-4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_partitioned_global_map_matches_jax(mesh, rank_maps, jax_map):
    key = "global_map" if mesh == list(MESHES)[0] else "global_map#2"
    first = rank_maps[0][key]
    for r in rank_maps:
        got = r[key]
        assert got["last_dropped_obs"] == 0
        assert got["drop_warnings"] == []
        _assert_close(got, jax_map)
        np.testing.assert_array_equal(got["poses"], first["poses"])
        assert got["chi2"] == first["chi2"]


def test_one_device_global_map_matches_jax(jax_map):
    got = global_map_step("cpu", None, GlobalMapOptions(**OPTS),
                          _landmarks(), 10)
    assert got["last_dropped_obs"] == 0
    _assert_close(got, jax_map)


def test_global_map_slots_follow_jax_cursor_order(rank_maps, jax_slots):
    # JAX's order crowds shard 0: its window's partition drops rows
    assert jax_slots["dropped"] > 0
    for r in rank_maps:
        got = r["global_map_slots"]
        assert got["lid2slot"] == jax_slots["lid2slot"]
        assert got["dropped"] == jax_slots["dropped"]


def test_global_map_spread_slots_drop_no_row(rank_maps, jax_slots):
    per_shard = GlobalMapOptions().max_landmarks // SHARDS
    for r in rank_maps:
        got = r["global_map_slots#2"]
        assert got["dropped"] == 0
        assert got["lid2slot"].keys() == jax_slots["lid2slot"].keys()
        shards = [s // per_shard for s in got["lid2slot"].values()]
        # dealt round-robin: the shards' landmark counts differ by ≤ 1
        counts = np.bincount(shards, minlength=SHARDS)
        assert counts.max() - counts.min() <= 1, counts
