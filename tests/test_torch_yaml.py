"""``utils.yaml_lite``, the port's YAML reader and writer, against PyYAML
(present here, used only as the oracle), and the port's ``load_config`` /
``load_rig_yaml`` against the JAX package's, field for field.

- Each of examples/param/{pinhole,euroc_mono,euroc_stereo}.yaml and a set
  of hand-written documents of the subset read equal to ``yaml.safe_load``
  (exact: the same Python values and types).
- ``1e-3`` (an exponent and no dot) is a float, as in YAML 1.2, where
  PyYAML's YAML 1.1 resolver keeps a string; input outside the subset
  (YAML 1.1's ``yes``, ``.nan``, ``1_000``, backslash escapes among it)
  raises ``ValueError`` naming its line.
- ``load_config`` equals JAX's on every field JAX has (the port's one
  more, ``backend.zupt_require_rest``, keeps its default);
  ``load_rig_yaml``'s cameras
  (float32 intrinsics and distortion, to the bit), extrinsics (1e-7) and
  IMU parameters equal JAX's.
- What ``dump`` writes reads back equal through ``yaml.safe_load``, and
  through ``load`` where every float is finite.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import yaml

from svo_pro_universal_tpu.cameras.rig import load_rig_yaml as jload_rig
from svo_pro_universal_tpu.config import load_config as jload_config
from svo_pro_universal_tpu_torch.cameras.rig import load_rig_yaml
from svo_pro_universal_tpu_torch.config import load_config
from svo_pro_universal_tpu_torch.utils import yaml_lite

PARAMS = Path(__file__).resolve().parent.parent / "examples" / "param"
FILES = ("pinhole", "euroc_mono", "euroc_stereo")

SNIPPETS = [
    "a: 1\nb: -2\nc: +3\nd: 0\n",
    "f: 1.5\ng: -0.25\nh: 12.0e-4\ni: 8.0E+3\nj: .5\nk: 3.\nl: -0.0\n",
    "t: true\nT: True\nf: False\nF: false\nq: 'yes'\n",
    "a: null\nb: ~\nc:\nd: 'null'\n",
    "s: hello world\nq: 'it''s # here'\nd: \"double # quoted\"\ne: x#y\n",
    "# a comment\nk: v   # trailing comment\n\n\nl: [1, 2]  # list\n",
    "cams:\n- camera:\n    label: cam0\n    size: [752, 480]\n  T: {a: 1}\n",
    "top:\n  - 1\n  - [2, 3]\n  - k: v\n    j: w\n  -\n    z: 0\n",
    "m:\n  n:\n    o:\n      p: deep\nq: shallow\n",
    "data: [0.0148655429818, -0.999880929698,\n       0.00414029679422,\n"
    "       -0.0216401454975]\nafter: 1\n",
    "flow: {a: [1, {b: 2}], 'c d': x}\nempty: []\nnone: {}\n",
    "- a\n- b: 1\n  c: 2\n- [x, 'y, z']\n",
    "str: .infinity\nver: 1.0.0\nneg: -x1\n",
    "url: http://x.y/z\nkey: 'a: b'\ndash: -x\n",
    "---\nk: v\n",
]


def _same(a, b) -> bool:
    """Equal values of equal types (nan equal to nan)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("name", FILES)
def test_param_files_read_as_pyyaml_reads_them(name):
    text = (PARAMS / f"{name}.yaml").read_text()
    assert _same(yaml_lite.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("k", range(len(SNIPPETS)))
def test_snippets_read_as_pyyaml_reads_them(k):
    assert _same(yaml_lite.load(SNIPPETS[k]), yaml.safe_load(SNIPPETS[k]))


def test_exponent_without_dot_is_a_float_and_bad_input_raises():
    assert yaml_lite.load("a: 1e-3\nb: 2E5\n") == {"a": 1e-3, "b": 2e5}
    assert yaml.safe_load("a: 1e-3") == {"a": "1e-3"}      # YAML 1.1
    for text, line in (("a: 1\n   b: 2\n", 2), ("a: &x 1\n", 1),
                       ("a: [1, 2\nb: 3\n", 1), ("a: |\n  x\n", 1),
                       ("k: v\n---\nl: w\n", 2), ("a: 1\n\tb: 2\n", 2),
                       ("- a\nb: 1\n", 2), ("a: 'open\n", 1),
                       ("a: 1\nb: yes\n", 2), ("a: [1, .nan]\n", 1),
                       ("a: 1_000\n", 1), ("a: \"t\\tx\"\n", 1)):
        with pytest.raises(ValueError, match=f"line {line}"):
            yaml_lite.load(text)


def _config_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    assert d["backend"].pop("zupt_require_rest") is False
    return d


def test_load_config_matches_jax():
    for name in FILES + (None,):
        path = None if name is None else str(PARAMS / f"{name}.yaml")
        assert (_config_dict(load_config(path))
                == dataclasses.asdict(jload_config(path))), name
    over = {"pipeline_is_stereo": True, "max_fts": 200}
    assert (_config_dict(load_config(str(PARAMS / "pinhole.yaml"), over))
            == dataclasses.asdict(jload_config(str(PARAMS / "pinhole.yaml"),
                                               over)))


@pytest.mark.parametrize("name", ("euroc_mono", "euroc_stereo"))
def test_load_rig_yaml_matches_jax(name):
    path = str(PARAMS / f"{name}.yaml")
    rig, jrig = load_rig_yaml(path, device="cpu"), jload_rig(path)
    assert (rig.label, len(rig)) == (jrig.label, len(jrig))
    for c, jc in zip(rig.cameras, jrig.cameras):
        assert (int(c.projection), int(c.distortion), c.width, c.height,
                c.label) == (int(jc.projection), int(jc.distortion),
                             jc.width, jc.height, jc.label)
        assert np.array_equal(c.intrinsics.numpy(), np.asarray(jc.intrinsics))
        n = np.asarray(jc.dist_params).shape[-1]
        assert np.array_equal(c.dist_params.numpy()[:n],
                              np.asarray(jc.dist_params))
    for T, jT in zip(rig.T_body_cam, jrig.T_body_cam):
        np.testing.assert_allclose(T.q.numpy(), np.asarray(jT.q), atol=1e-7)
        np.testing.assert_allclose(T.t.numpy(), np.asarray(jT.t), atol=1e-7)
    assert (dataclasses.asdict(rig.imu_params)
            == dataclasses.asdict(jrig.imu_params))
    if jrig.imu_init is not None:
        assert (dataclasses.asdict(rig.imu_init)
                == dataclasses.asdict(jrig.imu_init))
    doc = yaml.safe_load(Path(path).read_text())
    for M, node in zip(rig.T_B_C_matrices, doc["cameras"]):
        assert np.array_equal(M.reshape(-1), np.asarray(node["T_B_C"]["data"],
                                                        np.float64))


def test_dump_reads_back():
    doc = {"keyframes": [{"slot": 0, "frame_id": 12,
                          "q_cam_world": [1.0, 0.0, -2.5e-05, 1e+20],
                          "t_cam_world": [0.125, -3.0, 7.0]},
                         {"slot": 3, "frame_id": -1, "q_cam_world": [],
                          "t_cam_world": [0.0, 0.0, 0.0]}],
           "points": [{"id": 4, "pos": [1.5, 2.5, 3.5]}],
           "align_type": "sim3", "align_num_frames": -1,
           "s": "a: b # c", "t": "true", "n": None, "b": False,
           "nested": {"x": {"y": [1, 2]}, "empty": {}}, "list": [[1, 2], [3]],
           "nan": float("nan"), "inf": float("-inf"), "np": np.float32(0.5),
           "npi": np.int64(7)}
    text = yaml_lite.dump(doc)
    want = dict(doc, np=0.5, npi=7)
    assert _same(yaml.safe_load(text), want)
    finite = {k: v for k, v in doc.items() if k not in ("nan", "inf")}
    text = yaml_lite.dump(finite)
    assert _same(yaml_lite.load(text), dict(finite, np=0.5, npi=7))
    assert _same(yaml.safe_load(text), dict(finite, np=0.5, npi=7))
    assert yaml_lite.dump({"s": "yes", "q": "it's"}) == \
        "s: 'yes'\nq: 'it''s'\n"
