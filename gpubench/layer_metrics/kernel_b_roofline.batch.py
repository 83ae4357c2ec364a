"""Kernel B's share of its roofline over the lockstep decode steps."""

from gpubench.readers import roofline


def read(trace):
    return roofline(trace, "kernel_b")
