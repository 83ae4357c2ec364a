"""Process groups, the rank launcher, the collectives of the sharded engines
and the rank-0 control plane: the port's side of what GSPMD does for the
JAX package (moondream_tpu/parallel/).

JAX drives every device from one process and lets XLA insert the
collectives; PyTorch runs one process per GPU. So:

  * `launch(world, fn, *args, timeout_s=...)` starts `world` ranks, each
    with its process group up (`nccl` on the card, `gloo` on the CPU: the
    backend follows the device, and nothing falls back to the CPU), runs
    fn(rank, *args) in each and returns every rank's result. When a rank
    fails, or the timeout passes, every rank is killed and it raises.
  * `init_process_group(device, rank, world, port)` is the same set-up for
    a caller that starts its own ranks (or a world of one).
  * `all_reduce_fp32`, `gather_rows` and `gather_cols` are the sharded
    engines' collectives: the fp32 sum of the row-parallel linears' partial
    products over tp, and the gathers of the vocabulary shards (over tp),
    of the dp groups' rows and of the crop-parallel ViT's shares.
    `reduce_scatter_fp32`, `send_to` and `recv_from` are training's too
    (`grad`, `pipeline`): the transpose of a sequence gather, and the
    activations and their gradients between pipeline stages.
    `COLLECTIVES` counts their calls (a CUDA graph's replays count them
    again, as `build.LAUNCHES` counts kernels).
  * The control plane keeps JAX's single-controller API: user code runs on
    rank 0 against `Controller.proxy(name)` views of its objects, which
    broadcast each call that changes state (`MIRRORED`: its name and
    arguments, over a gloo group) before running it, and then whether it
    raised; the other ranks run `follow`, which makes the same call on their
    own objects and raises where its outcome differs. Every rank's host
    scheduler then takes the same decisions, so every rank launches the
    same collectives in the same order.
"""

from __future__ import annotations

import datetime
import queue
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# how long a collective, or a rank joining the group, may wait
GROUP_TIMEOUT = datetime.timedelta(seconds=600)

# Collective calls since reset_collective_counts(), by name.
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
                               "send": 0, "recv": 0}


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def backend_for(device) -> str:
    """The process group's backend for ranks on `device` (a torch.device or
    its type): nccl on the card, gloo on the CPU; anything else raises."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no collective backend for ranks on {kind!r}")
    return BACKENDS[kind]


def rank_device(device, rank: int) -> torch.device:
    """Rank `rank`'s device: its own card (rank modulo the cards on this
    host), or the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: nccl ranks need a card each")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(kind)


def init_process_group(device, rank: int = 0, world: int = 1,
                       port: Optional[int] = None) -> torch.device:
    """Join the default process group through the TCP store that listens
    on localhost:port (`launch` serves one): nccl for ranks on the card,
    each on its own card; gloo on the CPU. A world of one needs no port
    (it serves its own store). Returns this rank's device."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if port is None:
        if world != 1:
            raise ValueError("a world of more than one rank needs its store's port")
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True, timeout=GROUP_TIMEOUT)
    else:
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False, timeout=GROUP_TIMEOUT)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend_for(dev), store=store, rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT, **kw)
    return dev


def process_device() -> torch.device:
    """The device of this rank's process group: its card under nccl, the
    CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with comm.launch "
                           "or comm.init_process_group")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ------------------------------------------------------------ collectives


# A group of None stands for a mesh axis of one rank that the mesh does not
# name: its collectives are skipped. The world group is dist.group.WORLD.


def all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of an fp32 tensor over `group`, in place; returns it."""
    if x.dtype != torch.float32:
        raise TypeError(f"all_reduce_fp32 sums fp32 partials, got {x.dtype}")
    if group is None:
        return x
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    COLLECTIVES["all_gather"] += 1
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along the last dim, in rank order:
    each rank's (..., n) shard of a vocabulary-parallel product."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    lead, w = x.shape[:-1], x.shape[-1]
    rows = gather_rows(x.reshape(1, -1), group)  # (n, prod(lead) * w)
    return rows.reshape(n, -1, w).permute(1, 0, 2).reshape(*lead, n * w)


def reduce_scatter_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """The fp32 sum of `x` over `group`, of which this rank keeps its block
    along dim 0 (dim 0 splits evenly over the group, in rank order). NCCL
    reduce-scatters; gloo has no reduce-scatter, so there the whole sum is
    all-reduced and the rank's block cut from it (the same values)."""
    if x.dtype != torch.float32:
        raise TypeError(f"reduce_scatter_fp32 sums fp32 tensors, got {x.dtype}")
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over {n} ranks")
    x = x.contiguous()
    COLLECTIVES["reduce_scatter"] += 1
    if dist.get_backend(group) == "nccl":
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x.chunk(n)[r].contiguous()


def send_to(x: torch.Tensor, group, peer: int) -> None:
    """Send `x` to rank `peer` of `group` (its rank within the group; the
    global rank is looked up with dist.get_global_rank). Blocks until the
    peer's matching recv_from has taken it or the group's timeout passes."""
    COLLECTIVES["send"] += 1
    dist.send(x.contiguous(), dst=dist.get_global_rank(group, peer))


def recv_from(shape, dtype: torch.dtype, device, group, peer: int) -> torch.Tensor:
    """A tensor of `shape` and `dtype` sent by rank `peer` of `group`."""
    out = torch.empty(shape, dtype=dtype, device=device)
    COLLECTIVES["recv"] += 1
    dist.recv(out, src=dist.get_global_rank(group, peer))
    return out


def warm_up(group, device: torch.device) -> None:
    """One collective over `group`: NCCL builds a communicator at a group's
    first collective, which must not happen inside a CUDA graph's capture."""
    x = torch.zeros(1, device=device)
    dist.all_reduce(x, group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- launcher


def _rank_main(rank: int, world: int, port: int, device: str, threads: int,
               fn: Callable, args: Tuple, results) -> None:
    torch.set_num_threads(threads)
    try:
        init_process_group(device, rank, world, port)
        out = fn(rank, *args)
        results.put(("ok", rank, out))
    except BaseException:  # the parent reports it and kills the others
        results.put(("error", rank, traceback.format_exc()))
        return
    dist.destroy_process_group()


def launch(world: int, fn: Callable, *args, timeout_s: Optional[float] = 120.0,
           device: str = "cuda", threads: int = 1) -> List[Any]:
    """Run fn(rank, *args) in `world` new processes, one per rank, each with
    the default process group up on `device` (nccl ranks on one card each,
    by default; with device="cpu", gloo ranks with `threads` torch threads
    each; without a card, every rank raises and so does the launch), and
    return their results in rank order. `fn` and `args` must pickle (a
    function defined at the top of an importable module); so must the
    results. If a rank raises or dies, or `timeout_s` passes first (None:
    no limit), every rank is killed and a RuntimeError names the rank and
    carries its traceback. Ranks start from a fork server (a clean
    process, unlike a fork of this one, which may run threads) that has
    imported torch once, so a second launch does not import it again.
    The ranks meet at a TCP store that this process serves on a port the
    system picks."""
    import multiprocessing as mp

    rank_device(device, 0)  # no card for nccl ranks: raise before any rank starts
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False,
                          timeout=GROUP_TIMEOUT)
    port = store.port
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device, threads, fn, args, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    outs: Dict[int, Any] = {}
    failure = None
    try:
        while len(outs) < world and failure is None:
            if deadline is not None and time.monotonic() > deadline:
                failure = f"timed out after {timeout_s} s with ranks {sorted(outs)} done"
                break
            try:
                kind, rank, out = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in outs and p.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                continue
            if kind == "error":
                failure = f"rank {rank} raised:\n{out}"
            else:
                outs[rank] = out
        if failure is None:
            for p in procs:
                p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        del store
    if failure is not None:
        raise RuntimeError(f"launch({world}, {getattr(fn, '__name__', fn)}): {failure}")
    return [outs[r] for r in range(world)]


# ----------------------------------------------------------- control plane

# The calls that a Controller mirrors on every rank: those that change a
# rank's state or launch work on its card (collectives included). The pool's
# admissions, steps and cancels, and the model's entry points (single-stream
# and batched). Any other attribute of a mirrored object, a method included
# (`free_slots`, a tokenizer's encode), is read on rank 0 alone.
MIRRORED = frozenset({
    # models.serve.ContinuousBatchingEngine
    "submit", "submit_many", "submit_detect", "submit_point", "submit_gaze",
    "prepare", "prepare_structured", "prepare_gaze", "admit_prepared",
    "release_prepared", "encode_for", "step", "cancel", "drain",
    # models.moondream.MoondreamModel
    "encode_image", "encode_images", "load_encoded_image", "compile", "caption",
    "query", "detect", "point", "detect_gaze", "caption_batch", "query_batch",
    "detect_batch", "point_batch",
})
# Attributes of a mirrored object that are mirrored objects themselves.
MIRRORED_ATTRS = frozenset({"model"})
# How long a follower whose call raised waits for rank 0's outcome of the
# same call before it gives up (rank 0 may be blocked in a collective that
# this rank never reached).
OUTCOME_WAIT_S = 120.0


class _Ref:
    """An object that an earlier mirrored call returned, by handle: each
    rank substitutes its own result of that call."""

    def __init__(self, handle: int):
        self.handle = handle


def _results(res: Any) -> List[Any]:
    """A call's result and the items of a list or tuple result, in order:
    those that can be followed by a weak reference (an EncodedImage, a
    PreparedRequest; not a str, an int or a dict) are kept by handle, since
    they hold device state of the rank that made them and so never cross
    the control plane themselves."""
    out = [res]
    if isinstance(res, (list, tuple)):
        out.extend(res)
    kept = []
    for o in out:
        try:
            weakref.ref(o)
        except TypeError:
            continue
        kept.append(o)
    return kept


class Controller:
    """Rank 0's side of the control plane over the gloo group `group` (the
    world's ranks; rank 0 is its source). `roots` names the objects whose
    `MIRRORED` calls are mirrored, on every rank under the same names;
    `proxy(name)` is rank 0's view of one. A call broadcasts the root's
    name, the attribute path, the method and its arguments (the objects
    earlier calls returned travel by handle; callables and locks, such as
    a streaming callback or a launch lock, go as None; a tensor raises,
    since each rank's tensors differ), runs on rank 0, then broadcasts
    whether it raised: a follower whose own call ended otherwise raises, so
    that its rank dies (and `launch` ends the world) instead of departing
    from rank 0's state. Calls are serialised under `lock` (a re-entrant
    lock; a server passes the one its threads hold while they launch, so
    that the two never nest in opposite orders), held for the whole call:
    the broadcast order is the run order. `close()` ends the followers'
    loops."""

    def __init__(self, group, roots: Dict[str, Any], lock=None):
        self.group = group
        self.roots = roots
        self._lock = lock if lock is not None else threading.RLock()
        self._handles: Dict[int, Tuple[int, Any]] = {}  # id(obj) -> (handle, weakref)
        self._next = 0
        self._released: List[int] = []
        self.closed = False

    def proxy(self, name: str) -> "Mirror":
        return Mirror(self, (name,))

    def _out(self, x: Any) -> Any:
        held = self._handles.get(id(x))
        if held is not None and held[1]() is x:
            return _Ref(held[0])
        if isinstance(x, torch.Tensor):
            raise TypeError("a mirrored call takes host data, not tensors: each rank's "
                            "tensors are its own")
        if isinstance(x, Mirror):
            raise TypeError("pass the object a mirrored call returned, not a proxy")
        if isinstance(x, (list, tuple)):
            return type(x)(self._out(v) for v in x)
        if isinstance(x, dict):
            return {k: self._out(v) for k, v in x.items()}
        if callable(x) or hasattr(x, "acquire"):
            return None
        return x

    def _keep(self, res: Any) -> None:
        for obj in _results(res):
            handle = self._next
            self._next += 1
            self._handles[id(obj)] = (handle, weakref.ref(obj))
            weakref.finalize(obj, self._drop, id(obj), handle)

    def _drop(self, key: int, handle: int) -> None:
        held = self._handles.get(key)
        if held is not None and held[0] == handle:
            del self._handles[key]
        self._released.append(handle)

    def _send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=0, group=self.group)

    def call(self, path: Tuple[str, ...], method: str, args: Tuple, kwargs: Dict) -> Any:
        with self._lock:
            if self.closed:
                raise RuntimeError("the controller is closed")
            obj = self.resolve(path)
            released, self._released = self._released, []
            self._send((path, method, self._out(args), self._out(kwargs), released))
            try:
                res = getattr(obj, method)(*args, **kwargs)
            except Exception:
                _outcome(self.group, False)
                raise
            _outcome(self.group, True)
            self._keep(res)
            return res

    def resolve(self, path: Tuple[str, ...]) -> Any:
        obj = self.roots[path[0]]
        for name in path[1:]:
            obj = getattr(obj, name)
        return obj

    def close(self) -> None:
        """End every follower's loop (idempotent)."""
        with self._lock:
            if not self.closed:
                self.closed = True
                self._send(None)


def _outcome(group, ok: Optional[bool], wait_s: Optional[float] = None) -> bool:
    """Rank 0's outcome of the call just made, broadcast over `group`: rank 0
    passes its own (`ok`); a follower passes None and gets it, waiting at
    most `wait_s` seconds (None: the group's timeout), or raises
    TimeoutError."""
    flag = torch.tensor([1 if ok else 0], dtype=torch.uint8)
    if ok is not None:
        dist.broadcast(flag, src=0, group=group)
        return ok
    work = dist.broadcast(flag, src=0, group=group, async_op=True)
    if wait_s is None:
        work.wait()
    else:
        deadline = time.monotonic() + wait_s
        while not work.is_completed():
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank 0 gave no outcome within {wait_s} s")
            time.sleep(0.01)
        work.wait()
    return bool(flag.item())


class Mirror:
    """Rank 0's view of a root object (or of its `MIRRORED_ATTRS`, such as
    a pool's model): a `MIRRORED` method call goes through the controller;
    reading any other attribute, calling any other method, reads or runs
    rank 0's own as it is."""

    def __init__(self, ctl: Controller, path: Tuple[str, ...]):
        object.__setattr__(self, "_ctl", ctl)
        object.__setattr__(self, "_path", path)

    def __getattr__(self, name: str) -> Any:
        ctl, path = self._ctl, self._path
        if name in MIRRORED:
            return lambda *a, **k: ctl.call(path, name, a, k)
        if name in MIRRORED_ATTRS:
            return Mirror(ctl, path + (name,))
        return getattr(ctl.resolve(path), name)

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("set attributes on every rank, not through a mirror")


def follow(group, roots: Dict[str, Any]) -> int:
    """A follower's loop: receive each call rank 0's Controller broadcasts
    over `group`, make it on this rank's own `roots`, and compare how it
    ended with rank 0's outcome, until the controller closes. A call that
    raised on rank 0 too (the same call on the same state) is passed over;
    one whose outcome differs raises here: RuntimeError where rank 0's
    raised and this rank's did not, this rank's own exception where rank
    0's did not raise (or gave no outcome within `OUTCOME_WAIT_S`). Returns
    the number of calls made."""
    table: Dict[int, Any] = {}
    nxt = 0
    calls = 0

    def inn(x):
        if isinstance(x, _Ref):
            return table[x.handle]
        if isinstance(x, (list, tuple)):
            return type(x)(inn(v) for v in x)
        if isinstance(x, dict):
            return {k: inn(v) for k, v in x.items()}
        return x

    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=group)
        msg = box[0]
        if msg is None:
            return calls
        path, method, args, kwargs, released = msg
        for h in released:
            table.pop(h, None)
        obj = roots[path[0]]
        for name in path[1:]:
            obj = getattr(obj, name)
        calls += 1
        try:
            res = getattr(obj, method)(*inn(args), **inn(kwargs))
        except Exception as err:
            try:
                leader_ok = _outcome(group, None, OUTCOME_WAIT_S)
            except TimeoutError:
                raise err
            if leader_ok:
                raise
            continue
        if not _outcome(group, None):
            raise RuntimeError(f"rank 0's {'.'.join(path)}.{method} raised where this "
                               f"rank's returned: the ranks' states would depart")
        for o in _results(res):
            table[nxt] = o
            nxt += 1


def control_group():
    """A gloo group of every rank for the control plane (the default group
    itself under gloo; a new one beside nccl). Every rank must call it, in
    the same order as its other group creations."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    return dist.new_group(backend="gloo")
