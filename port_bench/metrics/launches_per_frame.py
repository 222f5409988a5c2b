"""Kernel launches on the device per frame of the traced window (from
the profiler's trace: every kernel, PyTorch's and the port's own)."""


def read(ctx):
    tr = ctx["trace"]
    return tr["launches"] / tr["frames"] if tr["frames"] else None
