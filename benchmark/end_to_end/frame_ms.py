"""frame_ms: window seconds over the frames rendered in it, in ms (host
clock; an image ends when the program hands it to the host, and holds
one frame, or the mean of the traffic's `frames_per_image` frames)."""


def read(window):
    return window.mean_ms()
