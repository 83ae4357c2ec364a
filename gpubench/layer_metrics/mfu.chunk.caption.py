"""Model FLOPs of the pool chunks' active rows over the chunks' wall time at
the bf16 peak."""

from gpubench.readers import span_mfu


def read(trace):
    return span_mfu(trace, "step")
