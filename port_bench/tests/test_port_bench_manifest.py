"""BENCHMARK.json against the benchmark contract's rules of form, and every
file it names present: the cells' configurations, traffic, limits and the
per-layer readers."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(MANIFEST["command"]) <= 32


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_allowed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n


def test_metric_entries():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.add(m["layer"])
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or m["unit"] == "%":
            assert m["better"] in ("higher", "lower")


def test_cells_and_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in configs
        assert NAME.fullmatch(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        bench = ROOT / "port_bench"
        assert (bench / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((bench / "limits" /
                             f"{w['name']}.json").read_text())["checks"]
        assert limits and all("max" in v for v in limits.values())
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("port_bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["assumed"]
        assert len(c["reduced"]) <= 16


def test_config_settings_exist_in_the_port():
    from svo_pro_universal_tpu_torch.config import Config
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in cfg["settings"]:
            node = Config()
            for part in key.split("."):
                assert hasattr(node, part), key
                node = getattr(node, part)
