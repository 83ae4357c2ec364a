"""Kernel C's share of its roofline over the pool's decode steps, the bytes
each active slot's cache needs at its position."""

from gpubench.readers import roofline


def read(trace):
    return roofline(trace, "kernel_c")
