"""Mean host-clock ms of one ``StagePrograms._keyframe_step`` call (the
keyframe's detection, seeds and ring insert)."""


def read(ctx):
    t = ctx["spans"].get("_keyframe_step")
    return sum(t) / len(t) * 1e3 if t else None
