"""The arithmetic the per-layer metric readers share. Each reader in
`layer_metrics/` is one call of these on the run's `Trace`; a reader that
finds nothing to read returns None, never 0."""

from __future__ import annotations

import re
from typing import Optional

from .common import PEAK_BF16_FLOP_S, busy_seconds


def _in_window(trace, t0: float) -> bool:
    return trace.window[0] <= t0 < trace.window[1]


def span_mean_ms(trace, name: str) -> Optional[float]:
    """Mean wall time of the spans `name` that began in the window."""
    spans = [(a, b) for a, b, _ in trace.spans.spans.get(name, []) if _in_window(trace, a)]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)


def span_mfu(trace, name: str) -> Optional[float]:
    """Model FLOPs of the spans `name` that began in the window over their
    summed wall time at the card's bf16 peak, in %."""
    spans = [(a, b, f) for a, b, f in trace.spans.spans.get(name, []) if _in_window(trace, a)]
    wall = sum(b - a for a, b, _ in spans)
    flops = sum(f for *_, f in spans)
    if not spans or wall <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (wall * PEAK_BF16_FLOP_S)


def window_mfu(trace) -> Optional[float]:
    """Model FLOPs of the work completed in the window over the window, less
    the time the tracer held the process, at the card's bf16 peak, in %."""
    flops = sum(f for t, _, f in trace.completions if _in_window(trace, t))
    if flops <= 0:
        return None
    return 100.0 * flops / ((trace.window[1] - trace.window[0] - trace.paused) * PEAK_BF16_FLOP_S)


def roofline(trace, kernel: str) -> Optional[float]:
    """The least time of the calls whose kernel `kernel` work lies wholly
    inside the traced part, over the device time of that kernel's events
    there (names matched by `kernels.json`), in %. Calls cut by the trace's
    edges add device time and no work, so the share errs low."""
    lo, hi = trace.traced
    least = sum(s for a, b, s in trace.spans.kernel_work.get(kernel, []) if a >= lo and b <= hi)
    pattern = re.compile(trace.kernel_names[kernel])
    device = sum(e - s for s, e, n, k in trace.events if k == "kernel" and pattern.search(n))
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device


def idle_share(trace) -> Optional[float]:
    """The traced part's share of time with no kernel or copy running, in %."""
    lo, hi = trace.traced
    if not trace.events or hi <= lo:
        return None
    busy = busy_seconds((max(s, lo), min(e, hi)) for s, e, *_ in trace.events
                        if e > lo and s < hi)
    return 100.0 * (1.0 - busy / (hi - lo))
