"""Mean host-clock ms of one ``DevicePipelineVIO._vio_backend_step`` call
that ran the window backend (marginalization, absorb, LM solve, alignment
buffer, merge); the frames where no state was due are not counted."""


def read(ctx):
    t = ctx["spans"].get("_vio_backend_step")
    return sum(t) / len(t) * 1e3 if t else None
