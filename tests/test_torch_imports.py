"""The port stands alone: importing every module of
``svo_pro_universal_tpu_torch`` and ``chip_smoke.py`` loads neither JAX nor
any module of the JAX package (checked in a fresh interpreter, since this
test process has both loaded)."""

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
                 "backend.global_map"):
        assert f"svo_pro_universal_tpu_torch.{name}" in out["modules"]
