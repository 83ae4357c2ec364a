"""Model FLOPs of the images captioned in the window over the window at the
bf16 peak."""

from gpubench.readers import window_mfu


def read(trace):
    return window_mfu(trace)
