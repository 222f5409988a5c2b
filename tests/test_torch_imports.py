"""The port stands alone: importing every module of
``svo_pro_universal_tpu_torch`` and ``chip_smoke.py`` loads neither JAX nor
any module of the JAX package (checked in a fresh interpreter, since this
test process has both loaded); and with ``yaml``, ``PIL``, ``cv2``,
``matplotlib`` and ``jax`` blocked (a GPU deployment may have none of
them) every module, runner included, imports and the three parameter
files of examples/param load."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, json, pkgutil, sys
import svo_pro_universal_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "svo_pro_universal_tpu"
             or m.startswith("svo_pro_universal_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    run = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out["bad"]
    # the walk found the port's pipelines, kernels and tests' helpers
    for name in ("frontend.pipeline_stereo", "frontend.pipeline_stereo_vio",
                 "frontend.pipeline_array", "ops.cuda_align",
                 "testing.synthetic", "frontend.slam", "backend.interface",
                 "backend.global_map", "utils.yaml_lite", "io", "viz",
                 "native_loader", "datasets.euroc", "utils.perf",
                 "utils.stage_profile", "utils.solver", "common.occupancy",
                 "ops.edge_depth", "runners.run_euroc_vio",
                 "runners.run_euroc_mono", "runners.run_euroc_stereo",
                 "runners.run_image_dir", "runners.run_video",
                 "parallel.mesh", "parallel.sharded_ops",
                 "parallel.sharded_ba", "parallel.dryrun",
                 "testing.parallel_cases"):
        assert f"svo_pro_universal_tpu_torch.{name}" in out["modules"]


BLOCKED_PROBE = """
import importlib, json, pkgutil, sys
BLOCKED = ("yaml", "PIL", "cv2", "matplotlib", "jax", "jaxlib")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
import svo_pro_universal_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from svo_pro_universal_tpu_torch.cameras.rig import load_rig_yaml
from svo_pro_universal_tpu_torch.config import load_config
cfg = load_config("examples/param/pinhole.yaml")
rigs = {p: load_rig_yaml(f"examples/param/{p}.yaml", device="cpu")
        for p in ("euroc_mono", "euroc_stereo")}
print(json.dumps({
    "n": len(names), "max_fts": cfg.capacity.max_fts,
    "init": cfg.init.init_method,
    "cams": {p: [c.width for c in r.cameras] for p, r in rigs.items()},
    "g": rigs["euroc_stereo"].imu_params.g,
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in BLOCKED)}))
"""


def test_port_loads_the_param_files_without_yaml_pil_cv2_matplotlib():
    run = subprocess.run([sys.executable, "-c", BLOCKED_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["n"] > 60
    assert (out["max_fts"], out["init"]) == (360, "FivePoint")
    assert out["cams"] == {"euroc_mono": [752],
                           "euroc_stereo": [752, 752]}
    assert out["g"] == 9.8082
