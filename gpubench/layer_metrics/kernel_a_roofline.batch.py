"""Kernel A's share of its roofline over each batch's ViT calls and fused
[BOS, image, prompt] prefill."""

from gpubench.readers import roofline


def read(trace):
    return roofline(trace, "kernel_a")
