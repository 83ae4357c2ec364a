"""Mean wall time of an admission's `prepare` (crops, ViT, projection,
image and prompt prefill, under the launch lock), from the harness's spans.
The pool's chunks wait while it holds the lock, so it stretches the
stream's token gaps."""

from gpubench.readers import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "prepare")
