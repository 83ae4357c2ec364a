"""A closed loop of images through the program's offline captioner,
`moondream_tpu_torch.engine.pipeline.BatchPipeline.caption`, with EOS off
so that every image gets exactly its tokens.

The images come as a stream drawn from the seed: each image a shape of the
cell's in its share (the same counts for every seed, in an order of the
seed's) and pixels of the seed's. One batch warms the pipeline up (set-up);
then one call runs the stream, and the window opens at its first finished
batch. Images count when their batch has been read back inside the window;
the window closes after `seconds`, and the call stops there.

Parameters (workloads/<cell>.json): "pipeline" {batch_size, prefetch},
"output_tokens", "images" [[h, w, share], ...], "image_pool" (distinct
images per shape), "stream" (images in the call, more than a window
takes), "sample" (images the reference checks).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from gpubench import common, work
from gpubench.harness import Run, Sample, sample_indices, make_image, parse_ids


class _WindowClosed(Exception):
    """Raised from the read-back of the first batch past the window."""


def stream(cell: dict, rng: np.random.Generator, n: int) -> List[tuple]:
    """n (shape, pool index) pairs: the cell's shares exactly, shuffled."""
    shapes = [(int(h), int(w)) for h, w, _ in cell["images"]]
    shares = np.array([s for *_, s in cell["images"]], dtype=float)
    counts = np.floor(shares / shares.sum() * n).astype(int)
    counts[0] += n - counts.sum()
    kinds = rng.permutation(np.repeat(np.arange(len(shapes)), counts))
    return [(shapes[k], int(rng.integers(cell["image_pool"]))) for k in kinds]


def run(r: Run) -> dict:
    from moondream_tpu_torch.engine.pipeline import BatchPipeline

    cell, cfg = r.cell, r.cfg["model"]
    pc = cell["pipeline"]
    tokens = cell["output_tokens"]
    pipe = BatchPipeline(r.model, batch_size=pc["batch_size"], prefetch=pc["prefetch"],
                         eos_id=-1)
    rng = r.rng(2)
    images: Dict[tuple, List[np.ndarray]] = {
        (int(h), int(w)): [make_image(rng, int(h), int(w)) for _ in range(cell["image_pool"])]
        for h, w, _ in cell["images"]}
    order = stream(cell, r.rng(1), cell["stream"])
    settings = {"max_tokens": tokens, "temperature": 0.0, "top_p": 0.0}
    prompt = list(r.model.config.tokenizer.templates["caption"]["normal"])

    # set-up: one batch of the stream's own shapes
    pipe.caption([images[s][i] for s, i in order[:pc["batch_size"]]], settings=settings)
    r.trace_warm()

    done: List[tuple] = []  # (time, batch index, texts)
    window = {}
    collect = pipe._collect

    def timed_collect(dispatched, n_real):
        t_in = time.monotonic()
        texts = collect(dispatched, n_real)
        now = time.monotonic()
        if r.trace:
            r.spans.span("collect", t_in, now)
        if "t0" not in window:
            window["t0"] = now
            r.open_window(now)
            if r.trace:
                window["trace"] = now + (r.seconds - cell["trace_s"]) / 2
        else:
            done.append((now, len(done), texts))
        if r.trace and "traced" not in window and now >= window.get("trace", now + 1):
            r.trace_start()
            window["traced"] = now
        if "traced" in window and "stopped" not in window and (
                now >= window["traced"] + cell["trace_s"]):
            r.trace_stop()
            window["stopped"] = now
        if now >= window["t0"] + r.seconds:
            raise _WindowClosed
        return texts

    pipe._collect = timed_collect
    if r.trace:
        _instrument(r, pipe, cfg, len(prompt), tokens)
    try:
        pipe.caption([images[s][i] for s, i in order], settings=settings)
        raise RuntimeError(f"the stream of {cell['stream']} images ended inside the window")
    except _WindowClosed:
        pass
    finally:
        if "traced" in window and "stopped" not in window:
            r.trace_stop()
    t0 = window["t0"]
    t1 = t0 + r.seconds
    r.close_window(t0, t1)
    bsz = pc["batch_size"]
    inside = [(t, b, texts) for t, b, texts in done if t < t1]
    finished = []  # (image index in the stream, ids)
    for t, b, texts in inside:
        # batch 0 of the call opened the window; done[k] is its batch k + 1
        for j, text in enumerate(texts):
            finished.append(((b + 1) * bsz + j, parse_ids(text)))
    per_image = work.caption_flops
    completions = [(t, len(texts), sum(
        per_image(cfg, *order[(b + 1) * bsz + j][0], len(prompt), tokens)
        for j in range(len(texts)))) for t, b, texts in inside]
    wrong = sum(len(ids) != tokens for _, ids in finished)
    samples = []
    if finished:
        pick = sample_indices(len(finished), cell["sample"], 0, r.rng(4))
        samples = [Sample(images[order[finished[i][0]][0]][order[finished[i][0]][1]],
                          prompt, finished[i][1]) for i in pick]
    n = len(finished)
    rate = common.throughput([(t, len(texts)) for t, _, texts in done], t0, t1)
    print(f"window images {n} in {len(inside)} batches, {rate:.3f} images/s", file=r.log)
    return {"attempted": n, "failed": 0, "samples": samples,
            "metrics": {"images_per_s": (rate, "images/s")},
            "counts": {"wrong_length_captions": wrong},
            "completions": completions}


def _instrument(r: Run, pipe, cfg: dict, prompt_len: int, tokens: int) -> None:
    """Kernel work per dispatched batch (traced runs only): kernel A's least
    time over each crop group's ViT and the fused [BOS, image, prompt]
    prefill, kernel B's over the lockstep decode steps that the captions
    need (tokens - 1 after the prefill's first)."""
    dispatch = pipe._dispatch
    pos = cfg["text"]["prefix_attn"] + prompt_len

    def counted_dispatch(batch, *args, **kw):
        t = time.monotonic()
        v, tc = cfg["vision"], cfg["text"]
        bsz = sum(len(idxs) for _, _, idxs, _ in batch.groups)
        a = sum(v["enc_n_layers"] * work.least_seconds(*work.vit_attention(cfg, n * len(idxs)))
                for _, n, idxs, _ in batch.groups)
        a += tc["n_layers"] * work.least_seconds(*work.text_attention(cfg, pos, 0, batch=bsz))
        out = dispatch(batch, *args, **kw)
        t1 = time.monotonic()
        r.spans.span("dispatch", t, t1)
        r.spans.work("kernel_a", t, t1, a)
        for j in range(tokens - 1):
            r.spans.work("kernel_b", t, t1, work.lockstep_step_kernel(cfg, bsz, pos + j))
        return out

    pipe._dispatch = counted_dispatch
