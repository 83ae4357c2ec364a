"""Shared pieces of the harness: where its files are, the statistics of the
end-to-end metrics, the device trace's reduction, the check that no JAX
module is loaded, and the result line.

Nothing here imports the program (`moondream_tpu_torch`); the harness
imports it only after the chip check, in `harness.py`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent  # gpubench/
REPO = ROOT.parent  # the checkout's root

# Published dense peaks of one NVIDIA H100 SXM (data sheet, no sparsity).
PEAK_BF16_FLOP_S = 989e12
PEAK_BYTES_S = 3.35e12

# Top-level module names that may not be loaded in a run's process. Compared
# whole: the port's own name starts with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "moondream_tpu")


def load_json(kind: str, name: str) -> dict:
    """gpubench/<kind>/<name>.json."""
    path = ROOT / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """gpubench/<kind>/<name>.py as a module of its own, found by name (a
    name may hold dots, so it is loaded from its path, not imported)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"gpubench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared as a whole word."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------- statistics

def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks; an
    infinite value (a failed request) sorts last and can be the answer."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    k = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    if lo == hi or xs[hi] == xs[lo]:
        return xs[lo]
    if math.isinf(xs[hi]):
        return xs[hi] if k > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median, with the quartiles of
    statistics.quantiles(values, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def request_latencies(requests: Sequence[dict]) -> Dict[str, List[float]]:
    """Per request, seconds from its due time: to the first token ("ttft"),
    to the last ("latency"), and the mean gap between its tokens ("tpot",
    requests of two tokens or more). A request that failed, or has no
    token, counts with infinite latency in every list it belongs to."""
    out = {"ttft": [], "latency": [], "tpot": []}
    for r in requests:
        ok = r.get("ok") and r.get("first") is not None
        n = r.get("n_tokens", 0)
        if not ok:
            out["ttft"].append(math.inf)
            out["latency"].append(math.inf)
            if r.get("tokens", 0) >= 2:
                out["tpot"].append(math.inf)
            continue
        out["ttft"].append(r["first"] - r["due"])
        out["latency"].append(r["last"] - r["due"])
        if n >= 2:
            out["tpot"].append((r["last"] - r["first"]) / (n - 1))
    return out


def mean_tpot(requests: Sequence[dict]) -> float:
    """Seconds per output token over all requests of two tokens or more:
    the sum of their (last - first token) over the sum of their (tokens -
    1). Infinite if any of them failed."""
    span = steps = 0.0
    for r in requests:
        if r.get("tokens", 0) < 2 and r.get("n_tokens", 0) < 2:
            continue
        if not (r.get("ok") and r.get("first") is not None and r.get("n_tokens", 0) >= 2):
            return math.inf
        span += r["last"] - r["first"]
        steps += r["n_tokens"] - 1
    if steps == 0:
        raise ValueError("no request of two tokens or more")
    return span / steps


def throughput(completions: Sequence[Tuple[float, int]], t0: float, t1: float) -> float:
    """Items completed per second over the whole window [t0, t1): every
    completion (time, count) inside it, over the window's length."""
    done = sum(n for t, n in completions if t0 <= t < t1)
    return done / (t1 - t0)


# ------------------------------------------------------------- device trace

def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The gaps (start, end) in [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    return [(s, e) for s, e in gaps if e > s]


# -------------------------------------------------------------- result line

def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Tuple[float, str]],
                device: dict, checks: Sequence[Tuple[str, float, float]],
                breakdown: Optional[dict] = None) -> str:
    """The run's last line: the driver's keys, then the numbers compared
    with their limits under "checks", last."""
    out = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": _finite(v), "unit": u} for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": _finite(v), "limit": lim} for name, v, lim in checks}
    return json.dumps(out, separators=(",", ":"))


# A latency that is infinite (a failed request at the percentile) is
# printed as this many of its unit: JSON has no infinity.
INFINITE = 1e12


def _finite(v: float) -> float:
    return INFINITE if math.isinf(v) else v


def env_for_run() -> Dict[str, str]:
    """Cache directories inside the checkout, at fixed paths, so that only a
    cell's first run in a checkout builds; and transformers kept from
    loading flax."""
    cache = REPO / ".gpubench_cache"
    return {
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
        "TRITON_CACHE_DIR": str(cache / "triton"),
        "CUDA_CACHE_PATH": str(cache / "cuda"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
    }


def apply_env() -> None:
    for k, v in env_for_run().items():
        os.environ.setdefault(k, v)
