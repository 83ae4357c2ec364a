"""Mean wall time of a pool `step()` call that dispatched a chunk, from the
harness's spans."""

from gpubench.readers import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "step")
