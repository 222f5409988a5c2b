"""90th-percentile host-clock ms of one ``add_image`` call in the window
(the frames that carry a keyframe step, a backend solve or a SLAM step)."""

import numpy as np


def read(ctx):
    t = ctx["spans"].get("add_image")
    return float(np.percentile(t, 90)) * 1e3 if t else None
