"""Host-clock ms in ``StagePrograms._tracking_step`` (alignment,
reprojection, pose and structure GN, seeds, keyframe policy) per frame
of the window."""


def read(ctx):
    t = ctx["spans"].get("_tracking_step")
    return sum(t) / ctx["frames"] * 1e3 if t and ctx["frames"] else None
