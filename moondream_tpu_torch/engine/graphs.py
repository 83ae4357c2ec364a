"""CUDA graphs of the decode loops' runs and of the serving pool's chunk:
the port's counterpart of the JAX package's fused device loops
(moondream_tpu/engine/generate.py:170, batched.py:175, serving.py:382),
which run a whole generation or chunk as one compiled device program.

The loops keep their state in device tensors of fixed address and read it
on the host once per run of DONE_CHECK_EVERY steps (engine/generate.py). On
the card such a run is one CUDA graph: captured the first time a full run
of its key is needed and replayed from then on, one launch from the host
where the eager steps issue ~1100 per bf16 decode step. The pool's plain
chunk (`serving.serve_chunk`) is one graph per (chunk, sampling) of its
engine. A key names everything a graph bakes in: the loop, the batch,
kv_bound, the addresses of the cache tensors (and with them the cache
format: bf16 or int8 KV, MHA or GQA; the weights, dense or int4, belong to
the model that owns the cache of graphs), the LoRA adapter's factors
(`adapter_key`), eos and suppressed ids, greedy or sampled and the
generator.

First use of a key: the run executes eagerly on a side stream (its
warm-up: kernel modules load, that stream's decode workspace grows to the
run's split plan, cuBLAS sets up), then the same run is captured on that
stream (capture launches nothing) into a memory pool that the cache's
graphs share. Replays go to the caller's current stream in order, never
two at once, so sharing the pool is safe. An entry keeps what its graph
reads or writes that nobody else holds: its static state, the decode
workspace it captured, its generator.

Launch counts: the kernel wrappers count in Python, which a replay does not
run. Each capture records its graph's launches and takes them back from
`build.LAUNCHES`; every replay adds them (`build.add_launches`), so the
counts stay exact. The collectives of a tensor-parallel rank's graphs
(`parallel.comm.COLLECTIVES`) are counted the same way.

There is no fallback: a capture or a replay that fails raises. The loops'
`graphed=False` runs the same steps eagerly, for comparison; a CPU tensor
always runs them eagerly.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from ..kernels.attention import stream_workspace
from ..kernels.build import LAUNCHES, add_launches, launches_since
from ..models.text import LORA_SITES
from ..parallel.comm import COLLECTIVES

# Replays per graph label, and one record per capture (label, capture ms,
# bytes the graphs' memory pool grew by, launches per replay), since
# reset_graph_counts().
REPLAYS: Dict[str, int] = {}
CAPTURES: List[Dict[str, Any]] = []
# Graphs (and their static state) a cache keeps, least recently used out.
CACHE_ENTRIES = 16

_lock = threading.RLock()  # one capture at a time: they share a stream
_streams: Dict[torch.device, torch.cuda.Stream] = {}


def lock() -> threading.RLock:
    """The lock every capture holds. A thread that launches kernels beside
    a capturing one (a pipeline's producer) holds it meanwhile, so that
    none of its launches falls inside a capture: the capture would count
    them as its graph's and take them back from the launch counts."""
    return _lock


def enabled(dev: torch.device) -> bool:
    """Whether loops and pools on `dev` run through CUDA graphs: on the
    card, always (unless a loop is asked to run eagerly)."""
    return dev.type == "cuda"


def reset_graph_counts() -> None:
    REPLAYS.clear()
    CAPTURES.clear()


class StepGraph:
    """A captured CUDA graph, the launches one replay makes and what it
    holds."""

    def __init__(self, graph, launches: Dict[str, int], label: str, keep: Tuple,
                 collectives: Optional[Dict[str, int]] = None):
        self.graph = graph
        self.launches = launches
        self.label = label
        self.keep = keep
        self.collectives = collectives or {}

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)
        for name, n in self.collectives.items():
            COLLECTIVES[name] += n
        REPLAYS[self.label] = REPLAYS.get(self.label, 0) + 1


class Entry:
    """A key's static device state and, once captured, its graphs, all over
    the one state: one per start phase of a loop whose steps differ by
    their index (the structured loop's x, y and size steps; 0 for every
    other loop and chunk), and one per (phase, length) of a shorter run
    (LoopRun's `tails`)."""

    def __init__(self, state: Any):
        self.state = state
        self.graphs: Dict[Hashable, StepGraph] = {}


class GraphCache:
    """The graphs of one owner (a text model's loops, or one pool), least
    recently used first out, over one shared memory pool."""

    def __init__(self, capacity: int = CACHE_ENTRIES):
        self.capacity = capacity
        self.entries: "OrderedDict[Hashable, Entry]" = OrderedDict()
        self.pool = None

    def entry(self, key: Hashable, make_state: Callable[[], Any]) -> Entry:
        with _lock:
            entry = self.entries.get(key)
            if entry is None:
                entry = self.entries[key] = Entry(make_state())
                while len(self.entries) > self.capacity:
                    self.entries.popitem(last=False)
            self.entries.move_to_end(key)
            return entry


def cache_of(owner: Any) -> GraphCache:
    """The graph cache an object carries (created at first use)."""
    cache = owner.__dict__.get("_cuda_graphs")
    if cache is None:
        cache = owner.__dict__["_cuda_graphs"] = GraphCache()
    return cache


def tensor_key(*tensors: Optional[torch.Tensor]) -> Tuple:
    """Address, shape and dtype of each tensor a graph reads or writes in
    place without holding it: a key that matches finds them where the graph
    does."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in tensors)


def adapter_key(lora: Optional[dict]) -> Optional[Tuple]:
    """tensor_key of a stacked LoRA adapter's factors (qkv, proj, fc1, fc2;
    A then B; an absent site as None), or None without an adapter. A graph
    bakes in the factors' addresses, so a key that names the cache names
    the adapter too: two adapters, or one and none, never share a graph."""
    if lora is None:
        return None
    pairs = [(lora.get(grp) or {}).get(name) for grp, name in LORA_SITES]
    return tensor_key(*(None if p is None else p[f] for p in pairs for f in ("A", "B")))


def group_key(owner: Any) -> Optional[str]:
    """The mesh and rank of a tensor-parallel rank's text model (its
    `shard`, `parallel.mesh.shard_text_model`), or None: a graph captures
    its collectives over that rank's process groups, so a rank's keys
    name them (an unsharded model's keys are as they were)."""
    shard = getattr(owner, "shard", None)
    return None if shard is None else shard.key


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _streams:
        _streams[dev] = torch.cuda.Stream(dev)
    return _streams[dev]


def capture(cache: GraphCache, fn: Callable[[], Any], label: str,
            generator: Optional[torch.Generator] = None) -> Tuple[StepGraph, Any, Any]:
    """Run fn() eagerly on the side stream (the warm-up, a real run: its
    result comes back), then capture fn() into a CUDA graph on that stream.
    Returns (the graph, the warm-up's result, the captured run's result:
    tensors of the graph's pool that each replay rewrites). `generator`: a
    CUDA generator that fn draws from, registered with the graph so that
    each replay advances it as the eager run does (the default generator
    always is)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    side, cur = _side_stream(dev), torch.cuda.current_stream(dev)
    with _lock:
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = fn()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        if cache.pool is None:
            cache.pool = torch.cuda.graph_pool_handle()
        before, reserved = dict(LAUNCHES), torch.cuda.memory_reserved(dev)
        before_coll = dict(COLLECTIVES)
        # Python's collector must not run inside the capture: a graph it
        # frees then (an evicted entry's) is destroyed mid-capture, which
        # CUDA forbids and which invalidates the capture. Collect first.
        gc.collect()
        gc_enabled = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=cache.pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                except BaseException:
                    try:  # end the capture; the error inside it is the one to report
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                finally:
                    launches = launches_since(before)
                    LAUNCHES.update(before)
                    collectives = {n: c - before_coll[n] for n, c in COLLECTIVES.items()
                                   if c != before_coll[n]}
                    COLLECTIVES.update(before_coll)
                graph.capture_end()
        finally:
            if gc_enabled:
                gc.enable()
        cur.wait_stream(side)
        CAPTURES.append({"label": label, "ms": (time.perf_counter() - t0) * 1e3,
                         "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
                         "launches": sum(launches.values())})
        keep = (stream_workspace(dev, side.cuda_stream), generator)
        return StepGraph(graph, launches, label, keep, collectives), first, out


class LoopRun:
    """run(n, phase): n steps of a loop over its device state, step j
    called as step(state, phase + j). A full run (n == run_len) on the card
    replays the graph of the key and `phase`, captured by the first such
    run; with `tails`, so does a shorter run, under its length too (the
    structured loop, whose host knows every run's length in advance).
    Otherwise a shorter run, a CPU state or an eager loop runs the steps
    one by one, through the same step function."""

    def __init__(self, entry: Entry, step: Callable[[Any, int], None], run_len: int,
                 cache: Optional[GraphCache], label: str,
                 generator: Optional[torch.Generator], tails: bool = False):
        self.entry, self.step, self.run_len = entry, step, run_len
        self.cache, self.label, self.generator = cache, label, generator
        self.tails = tails

    def _steps(self, n: int, phase: int) -> None:
        for j in range(n):
            self.step(self.entry.state, phase + j)

    def __call__(self, n: int, phase: int = 0) -> None:
        if self.cache is None or n > self.run_len or (n < self.run_len and not self.tails):
            self._steps(n, phase)
            return
        at = phase if n == self.run_len else (phase, n)
        graph = self.entry.graphs.get(at)
        if graph is None:
            self.entry.graphs[at], _, _ = capture(
                self.cache, lambda: self._steps(n, phase), self.label, self.generator)
        else:
            graph.replay()


def loop(owner: Any, key: Hashable, make_state: Callable[[], Any],
         step: Callable[[Any, int], None], run_len: int, graphed: bool, label: str,
         generator: Optional[torch.Generator] = None,
         tails: bool = False) -> Tuple[Any, LoopRun]:
    """(state, run) of a decode loop: with `graphed`, the key's static
    state in `owner`'s graph cache (its graphs replay full runs, and with
    `tails` shorter ones too); else a fresh state whose runs are eager."""
    if not graphed:
        state = make_state()
        return state, LoopRun(Entry(state), step, run_len, None, label, None)
    cache = cache_of(owner)
    group = group_key(owner)
    entry = cache.entry(key if group is None else (key, group), make_state)
    return entry.state, LoopRun(entry, step, run_len, cache, label, generator, tails)


def chunk(cache: GraphCache, key: Hashable, fn: Callable[..., Any],
          inputs: Sequence[torch.Tensor], label: str,
          generator: Optional[torch.Generator] = None) -> Any:
    """fn(*inputs) through the key's graph: the first call captures it over
    static copies of `inputs` (and returns the warm-up's result); later
    calls copy `inputs` into those copies, replay, and return a copy of the
    graph's outputs (a NamedTuple of tensors and Nones), which the next
    replay would overwrite."""
    entry = cache.entry(key, lambda: [t.clone() for t in inputs])
    if not entry.graphs:
        static = entry.state
        entry.graphs[0], first, out = capture(cache, lambda: fn(*static), label, generator)
        entry.state = (static, out)
        return first
    static, out = entry.state
    for s, t in zip(static, inputs):
        s.copy_(t)
    entry.graphs[0].replay()
    return type(out)(*(t.clone() if isinstance(t, torch.Tensor) else t for t in out))
