"""setup_s: process start to window open, in s (host clock): kernels
built or loaded, the scene made, warm images run."""


def read(window):
    return window.setup_s
