"""A hand-written kernel's share (%) of its memory roofline: the mean bytes
one launch must move (from its call's shapes, counted by the harness) at
the card's HBM rate, over the mean device time of one launch of it across
the traced window. None when the trace holds no launch of it."""


def share(ctx, kernel: str, call: str, exclude: str = None):
    launches, secs = 0, 0.0
    for name, (n, s) in ctx["trace"]["kernels"].items():
        if kernel in name and (exclude is None or exclude not in name):
            launches += n
            secs += s
    nbytes = ctx["bytes"].get(call)
    if not launches or not secs or not nbytes:
        return None
    t_bound = sum(nbytes) / len(nbytes) / ctx["hbm_bytes_per_s"]
    return 100.0 * t_bound / (secs / launches)
