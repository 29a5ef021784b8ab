"""k1_trace.ms_per_frame: device ms a frame of the tracer kernel K1
(`kernels/window_trace.py`, records named `trace_kernel`); left out
where the trace lacks a record of a K1 launch the program counted."""

KERNEL = "trace_kernel"


def read(trace):
    if not trace.whole(KERNEL) or not trace.frames:
        return None
    ms = trace.device_ms(KERNEL)
    return ms / trace.frames if ms > 0 else None
