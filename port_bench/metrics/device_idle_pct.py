"""Share (%) of the traced window in which no activity ran on the
device."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
