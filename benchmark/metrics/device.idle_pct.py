"""Idle share of the device over the traced window, in %: 1 minus the
union of the device operations' intervals over the window's length.
Left out of a trace that lost kernel records."""


def read(trace):
    if not trace.whole() or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
