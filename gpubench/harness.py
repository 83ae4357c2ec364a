"""One run of one cell: set-up, the driver's window, the device trace, the
check against the plain reference, and the result line.

`run.py` checks for the card and calls `run_cell`; the tests call it on the
CPU at a tiny size. A cell is `workloads/<name>.json`: its configuration
(`configs/<config>.json`), its traffic driver (`drivers/<driver>.py`) and
its parameters. Per-layer metrics are `layer_metrics/<metric>.py`, each a
`read(trace) -> float or None`, run in a `--trace 1` run for the metrics
that BENCHMARK.json lists for the cell.
"""

from __future__ import annotations

import gc
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import common, weights
from .common import load_json, load_module


class IdTokenizer:
    """A tokenizer under which every id yields text: an id decodes to its
    decimal digits and a newline, so the serving stream flushes each token
    as it comes and its chunks carry the exact ids; text of space-separated
    decimal ids encodes back to them."""

    def encode(self, text: str) -> List[int]:
        return [int(t) for t in text.split()]

    def decode(self, ids) -> str:
        return "".join(f"{int(i)}\n" for i in ids)


def parse_ids(text: str) -> List[int]:
    return [int(t) for t in text.split()]


def make_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A uint8 (h, w, 3) image of the seed's: a coarse 4 x 4 layout of
    colours under pixel noise, so that images differ as wholes (features of
    pure noise average out alike) and every crop holds detail."""
    grid = rng.integers(0, 256, (4, 4, 3)).astype(np.int16)
    base = np.repeat(np.repeat(grid, -(-h // 4), axis=0), -(-w // 4), axis=1)[:h, :w]
    noise = rng.integers(-48, 49, (h, w, 3), dtype=np.int16)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@dataclass
class Sample:
    """One finished request or image that the reference checks."""
    image: np.ndarray
    prompt: List[int]
    served: List[int]


@dataclass
class Spans:
    """Host spans the harness records around its calls into the program
    (traced runs only): name -> [(start, end, FLOPs)], and per kernel the
    least seconds of each call, [(host start, host end, seconds)]."""
    spans: Dict[str, List[Tuple[float, float, float]]] = field(default_factory=dict)
    kernel_work: Dict[str, List[Tuple[float, float, float]]] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def span(self, name: str, t0: float, t1: float, flops: float = 0.0) -> None:
        with self.lock:
            self.spans.setdefault(name, []).append((t0, t1, flops))

    def work(self, kernel: str, t0: float, t1: float, seconds: float) -> None:
        with self.lock:
            self.kernel_work.setdefault(kernel, []).append((t0, t1, seconds))


@dataclass
class Trace:
    """What the per-layer readers read: the window, the host spans and the
    device events of the traced part of it (start, end in host seconds,
    name, "kernel" or "copy")."""
    window: Tuple[float, float]
    traced: Tuple[float, float]
    spans: Spans
    events: List[Tuple[float, float, str, str]]
    completions: List[Tuple[float, int, float]]  # (time, images, FLOPs) of the batch cells
    kernel_names: Dict[str, str]
    paused: float = 0.0  # seconds of the window the tracer's start and stop held


class Run:
    """What a driver gets: the model, the cell, the seed, and the calls that
    mark the window and the traced part of it."""

    def __init__(self, cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
                 model, device, t_process: float, log):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.seconds, self.trace, self.model, self.device = seconds, trace, model, device
        self.t_process, self.log = t_process, log
        self.spans = Spans()
        self.window: Optional[Tuple[float, float]] = None
        self.setup_s: Optional[float] = None
        self._prof = None
        self._events = None
        # seconds the tracer's start and stop held the process (traced runs)
        self.paused = 0.0
        self.traced: Optional[Tuple[float, float]] = None

    def rng(self, stream: int) -> np.random.Generator:
        """The seed's random stream number `stream` (any seed size)."""
        return np.random.default_rng([self.seed, stream])

    def open_window(self, t0: float) -> None:
        """Set-up ends at t0, when the window opens. From here the run has
        the window and WATCHDOG_S more to end in (see `_watchdog`)."""
        self.setup_s = t0 - self.t_process
        if self.device.type == "cuda":
            _watchdog(self.seconds + WATCHDOG_S)

    def close_window(self, t0: float, t1: float) -> None:
        self.window = (t0, t1)

    # ----------------------------------------------------------- tracing
    def trace_warm(self) -> None:
        """Start and stop a device trace once during set-up (traced runs on
        the card): the first start loads and initialises the tracer, which
        would otherwise stall the window."""
        if self.trace and self.device.type == "cuda":
            self.trace_start()
            with _launch_lock():
                self._prof.stop()
            self._prof = None
            self.paused = 0.0

    def trace_start(self) -> None:
        """Start the device trace (traced runs on the card only). The tracer
        is switched on and off only while no thread of the program launches:
        under the lock that every launch of the serving pool and every graph
        capture holds, with the card drained."""
        if not self.trace or self.device.type != "cuda":
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        t = time.monotonic()
        with _launch_lock():
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            self._t_prof = time.monotonic()
        self.paused += time.monotonic() - t

    def trace_stop(self) -> None:
        if self._prof is None:
            return
        import torch

        # calls counted end here; every kernel launched so far is traced
        t1 = time.monotonic()
        with _launch_lock():
            torch.cuda.synchronize()
            self._prof.stop()
        self.traced = (self._t_prof, t1)
        self.paused += time.monotonic() - t1

    def device_events(self) -> List[Tuple[float, float, str, str]]:
        """The traced device events (kernels, copies, sets) as (start, end)
        in host seconds, name, "kernel" or "copy"."""
        if self._prof is None:
            return []
        if self._events is None:
            res = self._prof.profiler.kineto_results
            # the profiler's clock to the host's: its trace began at trace_start
            shift = self._t_prof - res.trace_start_ns() * 1e-9
            out = []
            for e in res.events():
                if e.device_type().name != "CUDA":
                    continue
                s = e.start_ns() * 1e-9 + shift
                name = e.name()
                kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
                out.append((s, s + e.duration_ns() * 1e-9, name, kind))
            self._events = sorted(out)
        return self._events


# Seconds a run on the card may take past its window (the traffic's drain,
# the trace's reading and the reference's check take under 90), and in
# set-up (a checkout's first run builds the kernels).
WATCHDOG_S = 240.0
SETUP_WATCHDOG_S = 1100.0


def _watchdog(seconds: float) -> None:
    """End the process with every thread's stack on standard error, and no
    result, if it has not ended `seconds` from now: a run that hangs fails
    with a message instead. Re-arming replaces the previous deadline."""
    import faulthandler

    faulthandler.dump_traceback_later(seconds, exit=True)


def _launch_lock():
    """The program's launch lock (`engine/graphs.lock`)."""
    from moondream_tpu_torch.engine import graphs

    return graphs.lock()


def load_cell(name: str) -> Tuple[dict, dict]:
    cell = load_json("workloads", name)
    return cell, load_json("configs", cell["config"])


def build_model(cfg: dict, seed: int, device, dtype_name: str):
    """The program's model with the seed's weights and the id tokenizer."""
    import torch
    from moondream_tpu_torch.config import MoondreamConfig
    from moondream_tpu_torch.models.moondream import MoondreamModel
    from moondream_tpu_torch.weights import build_params

    dtype = getattr(torch, dtype_name)
    mcfg = MoondreamConfig.from_dict(cfg["model"])
    params = build_params(mcfg, device, dtype, region=False)
    weights.load_into(params, cfg["model"], seed)
    return MoondreamModel(mcfg, params=params, tokenizer=IdTokenizer(), dtype=dtype,
                          device=device, seed=0)


def sample_indices(n: int, want: int, longest: int, rng: np.random.Generator) -> List[int]:
    """`want` of n indices drawn from the seed, the longest among them."""
    rest = [i for i in range(n) if i != longest]
    pick = rng.choice(len(rest), size=min(want - 1, len(rest)), replace=False)
    return sorted({longest, *(rest[i] for i in pick)})


def check_outputs(run: Run, samples: Sequence[Sample], control: bool = False) -> Dict[str, float]:
    """The reference over each sampled request, through every token it was
    served: the widest gap of a served token's logit under the reference's
    best ("gap"); with `control`, the widest gap of the tokens the fp8
    reference puts first at each of those positions ("control_gap")."""
    import torch

    from .reference import plain

    plain.strict_fp32()
    mcfg = run.cfg["model"]
    leaves = weights.Leaves(mcfg, run.seed, run.device, getattr(torch, run.cfg["dtype"]))
    ref = plain.Model(mcfg, leaves, run.device)
    ctl = plain.Model(mcfg, leaves, run.device, quant="fp8") if control else None
    suppress = [mcfg["tokenizer"]["answer_id"]]
    served, controlled = [], []
    with torch.no_grad():
        for s in samples:
            if not s.served:  # nothing to judge: the length check counts it
                continue
            lg = ref.sequence_logits(s.image, s.prompt, s.served)
            served += plain.gaps(lg, s.served, suppress)
            if ctl is not None:
                chosen = plain.control_choices(ctl.sequence_logits(s.image, s.prompt, s.served),
                                               suppress)
                controlled += plain.gaps(lg, chosen, suppress)
            del lg
    del leaves, ref, ctl
    out = {"tokens_checked": len(served), "gap": max(served, default=0.0)}
    if controlled:
        out["control_gap"] = max(controlled)
    return out


def read_layer_metrics(run: Run, cell_name: str, result: dict) -> Dict[str, Tuple[float, str]]:
    """Each per-layer metric BENCHMARK.json lists for this cell, by its
    reader; a reader that finds nothing is left out."""
    bench = json.loads((common.REPO / "BENCHMARK.json").read_text())
    trace = Trace(run.window, run.traced or run.window, run.spans,
                  run.device_events(), result.get("completions", []),
                  load_json("layer_metrics", "kernels"), run.paused)
    out = {}
    for m in bench["per_layer"]:
        if cell_name not in m.get("workloads", [cell_name]):
            continue
        value = load_module("layer_metrics", m["name"]).read(trace)
        if value is not None:
            out[m["name"]] = (value, m["unit"])
    return out


def breakdown(run: Run) -> Optional[dict]:
    """The traced part's device operations that took most time and its
    longest idle gaps, each named by the host span open at its middle."""
    events = run.device_events()
    if not events or run.traced is None:
        return None
    per: Dict[str, float] = {}
    for s, e, n, _ in events:
        short = _short_name(n)
        per[short] = per.get(short, 0.0) + (e - s)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    lo, hi = run.traced
    gaps = common.idle_gaps([(s, e) for s, e, *_ in events], lo, hi)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:6]:
        mid = (s + e) / 2
        host = [n for n, spans in run.spans.spans.items()
                if any(a <= mid <= b for a, b, _ in spans)]
        named.append([("+".join(sorted(host)) or "no harness span"), e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def _short_name(name: str) -> str:
    """A kernel's name without its namespaces, return type and arguments,
    at most 40 characters."""
    for part in ("void ", "(anonymous namespace)::", "at::native::", "cutlass::"):
        name = name.replace(part, "")
    depth, out = 0, []
    for ch in name:  # drop the argument list, keep the template arguments
        if ch == "(" and depth == 0 and out:
            break
        depth += (ch == "<") - (ch == ">")
        out.append(ch)
    return "".join(out)[:40]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_process: Optional[float] = None, cell_overrides: Optional[dict] = None,
             cfg_overrides: Optional[dict] = None, control: bool = False,
             log=sys.stderr) -> dict:
    """One run; returns {"line": the result line, "result": the driver's
    result, "checks": [(name, value, limit)], "correct": bool}."""
    import torch

    t_process = time.monotonic() if t_process is None else t_process
    device = torch.device(device)
    if device.type == "cuda":
        _watchdog(SETUP_WATCHDOG_S)
    cell, cfg = load_cell(cell_name)
    cell = {**cell, **(cell_overrides or {})}
    if cfg_overrides:
        cfg = {**cfg, **cfg_overrides}
    model = build_model(cfg, seed, device, cfg["dtype"])
    if device.type == "cuda":
        # the peak of the program's own state, not of the weights' draw
        torch.cuda.reset_peak_memory_stats()
    run = Run(cell, cfg, seed, seconds, trace, model, device, t_process, log)
    driver = load_module("drivers", cell["driver"])
    result = driver.run(run)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    del model, run.model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = cell["limits"]
    got = check_outputs(run, result["samples"], control=control)
    # each number the cell's file gives a limit: the driver's counts, the
    # reference's readings
    values = {**result["counts"], **got}
    checks = [(name, values[name], limit) for name, limit in limits.items()]
    correct = all(v <= lim for _, v, lim in checks) and result["failed"] == 0 and bool(
        result["samples"])
    if trace:
        metrics = read_layer_metrics(run, cell_name, result)
    else:
        metrics = dict(result["metrics"])
        metrics["setup_s"] = (run.setup_s, "s")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    bd = None
    if trace and run.traced is not None:
        events = run.device_events()
        if not events:
            raise RuntimeError("the device trace recorded no device operation")
        dev["busy_s"] = common.busy_seconds((s, e) for s, e, *_ in events)
        dev["window_s"] = run.traced[1] - run.traced[0]
        bd = breakdown(run)
    print("readings: " + json.dumps(got), file=log)
    if device.type == "cuda":
        import faulthandler

        faulthandler.cancel_dump_traceback_later()
    line = common.result_line(correct, result["attempted"], result["failed"], metrics, dev,
                              checks, bd)
    return {"line": line, "result": result, "checks": checks, "correct": correct,
            "readings": got, "metrics": metrics}
