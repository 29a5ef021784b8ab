"""frame_p95_ms: the 95th percentile of every image interval of the
window over its frames, in ms (host clock): the stutter a viewer feels."""


def read(window):
    return window.quantile_ms(0.95)
