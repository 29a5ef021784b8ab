"""frame_loop.device_ops: device operations (kernels, copies, fills) a
frame in the traced window: the launches the host must issue.  Left out
of a trace that lost kernel records."""


def read(trace):
    if not trace.whole() or not trace.ops or not trace.frames:
        return None
    return len(trace.ops) / trace.frames
