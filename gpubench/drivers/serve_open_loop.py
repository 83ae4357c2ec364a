"""Open-loop image requests through the program's HTTP serving front end,
in process: `moondream_tpu_torch.serve_http.ServingFrontend.
text_request_stream`, images handed over decoded, no socket.

Requests arrive on a schedule fixed before the run: every seed gets the
same inter-arrival gaps (the quantiles of an exponential at the cell's
rate), the same image shapes in the cell's shares, the same output
lengths and question lengths (evenly spaced over their ranges), each list
in an order of its own drawn from the seed; the seed also draws the
pixels, an image of its own for every request (users send distinct
images: no request can reuse another's encode), and the question ids. A
few seconds of the same traffic before the window bring the pool to its
steady occupancy (set-up), and the traffic goes on past the window until
every request due in the window has ended.
Each request is timed from its due time: a stall counts against the
requests behind it. A request that fails or times out counts as a miss.

Parameters (workloads/<cell>.json): "frontend" {n_slots, slot_len,
chunk}, "request" ("caption" or "query"), "rate_per_s", "warm_s",
"images" [[h, w, share], ...], "output_tokens" [lo, hi], "question_tokens"
[lo, hi] (queries), "sample" (requests the reference checks), "timeout_s", "clients".
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from gpubench import common, work
from gpubench.harness import Run, Sample, sample_indices, make_image, parse_ids


def spaced(lo: int, hi: int, n: int) -> List[int]:
    """n whole numbers spread evenly over [lo, hi] (the midpoints of n equal
    bins)."""
    return [int(lo + math.floor((hi - lo + 1) * (i + 0.5) / n)) for i in range(n)]


def exp_gaps(rate: float, n: int, span: float) -> np.ndarray:
    """n inter-arrival gaps, the exponential's quantiles at `rate`, scaled to
    sum to `span` seconds exactly."""
    g = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    return g * (span / g.sum())


def schedule(cell: dict, rng: np.random.Generator, seconds: float) -> List[dict]:
    """The requests of a run: warm traffic over [-warm_s, 0), the window's
    over [0, seconds), and as much again after it, due times relative to
    the window's start. Each: due, shape, tokens (output length), question
    length."""
    rate = cell["rate_per_s"]
    shapes = [(int(h), int(w)) for h, w, _ in cell["images"]]
    shares = np.array([s for *_, s in cell["images"]], dtype=float)
    out = []
    for lo, span in ((-cell["warm_s"], cell["warm_s"]), (0.0, seconds), (seconds, seconds)):
        n = max(1, int(round(rate * span)))
        gaps = rng.permutation(exp_gaps(rate, n, span))
        due = lo + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        counts = np.floor(shares / shares.sum() * n).astype(int)
        counts[0] += n - counts.sum()
        kinds = rng.permutation(np.repeat(np.arange(len(shapes)), counts))
        toks = rng.permutation(spaced(*cell["output_tokens"], n))
        qlen = rng.permutation(spaced(*cell.get("question_tokens", (0, 0)), n))
        for i in range(n):
            out.append({"due": float(due[i]), "shape": shapes[kinds[i]],
                        "tokens": int(toks[i]), "qlen": int(qlen[i]),
                        "window": 0.0 <= due[i] < seconds})
    return out


def make_images(reqs: List[dict], rng: np.random.Generator) -> None:
    """Each request's own image, drawn in schedule order."""
    for q in reqs:
        q["image"] = make_image(rng, *q["shape"])


def run(r: Run) -> dict:
    from moondream_tpu_torch.serve_http import ServingFrontend

    cell, cfg = r.cell, r.cfg["model"]
    fe = cell["frontend"]
    frontend = ServingFrontend(r.model, n_slots=fe["n_slots"], slot_len=fe["slot_len"],
                               chunk=fe["chunk"])
    eng = frontend.engine
    eng.eos_id = -1  # every request emits exactly its drawn number of tokens
    reqs = schedule(cell, r.rng(1), r.seconds)
    make_images(reqs, r.rng(2))
    qrng = r.rng(3)
    vocab = cfg["text"]["vocab_size"]
    for q in reqs:
        q["question"] = (" ".join(str(int(t)) for t in qrng.integers(16, vocab, q["qlen"]))
                         if cell["request"] == "query" else None)
        q["prompt"] = eng._text_prompt(q["question"], "normal")
    if r.trace:
        _instrument(r, eng)
    frontend.warmup()
    r.trace_warm()

    def client(q: dict, t_base: float) -> None:
        q["ok"], q["first"], q["ids"] = False, None, []
        try:
            stream = frontend.text_request_stream(
                q["image"], q["question"], "normal", q["tokens"],
                timeout_s=cell["timeout_s"])
            for chunk in stream:
                now = time.monotonic() - t_base
                if q["first"] is None:
                    q["first"] = now
                q["ids"].extend(parse_ids(chunk))
                q["last"] = now
            q["ok"] = True
        except (TimeoutError, RuntimeError, ValueError) as e:
            q["error"] = repr(e)
        q["n_tokens"] = len(q["ids"])

    pool = ThreadPoolExecutor(max_workers=cell["clients"])
    futures = []
    t_base = time.monotonic() + cell["warm_s"]  # the window's start
    t_open = t_base
    r.open_window(t_base)
    trace_at = (r.seconds - cell["trace_s"]) / 2
    traced = [False, False]
    try:
        for q in reqs:
            while True:
                now = time.monotonic() - t_base
                if r.trace and not traced[0] and now >= trace_at:
                    t_base += _held(r.trace_start)  # the schedule waits out the tracer
                    traced[0] = True
                if r.trace and traced[0] and not traced[1] and now >= trace_at + cell["trace_s"]:
                    t_base += _held(r.trace_stop)
                    traced[1] = True
                if now >= q["due"]:
                    break
                time.sleep(min(q["due"] - now, 0.002))
            if q["due"] >= r.seconds and all(f.done() for f, w in futures if w):
                break
            q["sent"] = time.monotonic() - t_base
            futures.append((pool.submit(client, q, t_base), q["window"]))
        deadline = time.monotonic() + cell["timeout_s"]
        for f, _ in futures:
            f.result(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if traced[0] and not traced[1]:
            r.trace_stop()
        pool.shutdown(wait=True)
        frontend.shutdown()
    r.close_window(t_open, t_base + r.seconds)
    return _result(r, reqs)


def _held(call) -> float:
    """Seconds `call` held the process."""
    t = time.monotonic()
    call()
    return time.monotonic() - t


def _result(r: Run, reqs: List[dict]) -> dict:
    cell = r.cell
    win = [q for q in reqs if q["window"]]
    lat = common.request_latencies(win)
    metrics = {"ttft_p95_ms": (common.percentile(lat["ttft"], 95) * 1e3, "ms"),
               "latency_p95_ms": (common.percentile(lat["latency"], 95) * 1e3, "ms")}
    if cell["request"] == "caption":
        metrics["tpot_mean_ms"] = (common.mean_tpot(win) * 1e3, "ms")
    metrics = {k: v for k, v in metrics.items() if k in cell["end_to_end"]}
    done = [q for q in win if q.get("ok")]
    failed = len(win) - len(done)
    wrong_len = sum(q["n_tokens"] != q["tokens"] for q in done)
    samples = []
    if done:
        longest = max(range(len(done)), key=lambda i: done[i]["n_tokens"])
        pick = sample_indices(len(done), cell["sample"], longest, r.rng(4))
        samples = [Sample(done[i]["image"], done[i]["prompt"], done[i]["ids"]) for i in pick]
    late = [q["sent"] - q["due"] for q in win]
    print(f"window requests {len(win)}, done {len(done)}, failed {failed}, "
          f"generator late by at most {max(late) * 1e3:.1f} ms, "
          f"ttft p50 {common.percentile(lat['ttft'], 50) * 1e3:.1f} ms, "
          f"p95 {common.percentile(lat['ttft'], 95) * 1e3:.1f} ms, "
          f"latency p50 {common.percentile(lat['latency'], 50) * 1e3:.1f} ms, "
          f"tpot p95 {common.percentile(lat['tpot'] or [0.0], 95) * 1e3:.2f} ms", file=r.log)
    errors = sorted({q["error"] for q in win if "error" in q})
    if errors:
        print(f"errors: {errors[:3]}", file=r.log)
    return {"attempted": len(win), "failed": failed, "metrics": metrics, "samples": samples,
            "counts": {"wrong_length_requests": wrong_len},
            "requests": win}


def _instrument(r: Run, eng) -> None:
    """Spans around the pool's calls (traced runs only): each prepare (its
    wall time and the model FLOPs of its encode and prompt prefill; kernel
    A's least time over the ViT and the image prefill), each step that
    dispatched a chunk (its wall time and the FLOPs of its active rows;
    kernel C's least time per pool step). The rows' positions follow from
    each admission's position and token budget: every active row advances
    one position per step until its budget is spent."""
    cfg = r.cfg["model"]
    n_slots, chunk = eng.n_slots, eng.chunk
    rows: Dict[int, List[int]] = {}  # slot -> [position, budget left]
    prepare, admit, dispatch, step = eng.prepare, eng.admit_prepared, eng._dispatch_chunk, eng.step
    state = threading.local()

    def timed_prepare(image, question=None, caption_length="normal", **kw):
        t0 = time.monotonic()
        out = prepare(image, question=question, caption_length=caption_length, **kw)
        t1 = time.monotonic()
        h, w = image.shape[:2]
        r.spans.span("prepare", t0, t1, work.prepare_flops(cfg, h, w, len(out.prompt)))
        r.spans.work("kernel_a", t0, t1, work.encode_kernel_a(cfg, h, w))
        return out

    def counted_admit(prep, max_tokens=512, on_text=None):
        slot = eng.free_slots()[0]
        out = admit(prep, max_tokens=max_tokens, on_text=on_text)
        rows[slot] = [prep.pos, min(max_tokens, eng.slot_len - prep.pos)]
        return out

    def counted_dispatch():
        t = time.monotonic()
        flops, steps = 0.0, []
        for j in range(chunk):
            pos = [p + j for p, left in rows.values() if left > j]
            if pos:
                steps.append(pos)
                flops += sum(work.decode_row_flops(cfg, p) for p in pos)
        for slot in rows:
            p, left = rows[slot]
            rows[slot] = [p + min(chunk, left), max(0, left - chunk)]
        for pos in steps:
            r.spans.work("kernel_c", t, t, work.pool_step_kernel(cfg, pos, n_slots))
        state.flops = flops
        dispatch()

    def timed_step(launch_lock=None):
        state.flops = None
        t0 = time.monotonic()
        out = step(launch_lock)
        if state.flops is not None:
            r.spans.span("step", t0, time.monotonic(), state.flops)
        return out

    eng.prepare, eng.admit_prepared = timed_prepare, counted_admit
    eng._dispatch_chunk, eng.step = counted_dispatch, timed_step
