"""``align_level`` (csrc/align.cu, one cluster launch a pyramid level of
sparse alignment) against its memory roofline."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "port_bench_roofline", Path(__file__).with_name("_roofline.py"))
_roof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roof)


def read(ctx):
    return _roof.share(ctx, "align_level_kernel", "align_level")
