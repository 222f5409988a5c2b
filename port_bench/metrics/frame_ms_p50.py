"""Median host-clock ms of one ``add_image`` call in the window (the
device stage machine: pipeline.py / pipeline_vio.py)."""

import numpy as np


def read(ctx):
    t = ctx["spans"].get("add_image")
    return float(np.percentile(t, 50)) * 1e3 if t else None
