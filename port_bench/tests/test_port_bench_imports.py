"""The harness's check that nothing of JAX or the JAX package is loaded,
by whole top-level module names (the port's name begins with the JAX
package's), and a fresh interpreter that loads the harness and the port's
modules it drives without loading either."""

import subprocess
import sys
from pathlib import Path

from port_bench import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "svo_pro_universal_tpu_torch_x", None)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", None)
    assert "svo_pro_universal_tpu_torch_x" not in run.forbidden_modules()
    assert "jaxtyping_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "svo_pro_universal_tpu.frontend", None)
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    found = run.forbidden_modules()
    assert "svo_pro_universal_tpu" in found and "jax" in found


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "from port_bench import run, checks, control, devtrace, scene\n"
        "from port_bench import reference\n"
        "import svo_pro_universal_tpu_torch.frontend.pipeline_vio\n"
        "import svo_pro_universal_tpu_torch.ops.cuda_align\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_means_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "euroc_mono_vio.laps", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
