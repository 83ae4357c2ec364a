"""Drive the PyTorch port's caption, query, lockstep-batch, serving,
speculative, region-head (detect, point, gaze, reasoning, spatial refs),
multi-image pipeline, int8 w8a8, LoRA, steering and finetuning paths once
on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. build: nvcc-build the attention kernels (A, and the decode kernel with
     its B, B-GQA and C entries, bf16 and int8), the W4A16 and the w8a8
     kernels from moondream_tpu_torch/csrc and g++-build the native crop
     and native BPE libraries, all at once, into moondream_tpu_torch/_build;
  2. kernels vs plain: each kernel against its plain PyTorch version (fp32
     on the same inputs, TF32 off) at the main paths' shapes (the gaze
     batch's B 20 span and step, the speculative verify spans: kernel B and
     B-int8 at Tq 8 past the prefix, kernel C bf16, int8 and prefix-shared
     at Tq 8 and 16, and a 24-row span that the pool splits into two kernel
     C launches), kernel B's device-position form (bf16, int8, GQA stacked
     and single-layer, at the caption's and the lockstep batch's decode
     step and at pos kv_bound - 1; bf16 and int8 at the speculative verify
     spans, Tq 8 and 16 at pos 730, 800 and 1016) with its device-only
     time beside the host form's, with median times of both, each case's
     bound (bytes or
     operations over the H100's peak rates) and the time of one PyTorch
     call computing the same function where there is one (SDPA; the
     int4-pack matmul); the w8a8 kernels (the quantize pass, then kernel S
     or kernel L) bit for bit against their plain version at every shape
     of the int8 paths, rows equal across M and routes, each case beside
     torch._int_mm where it takes the shape (phase_w8a8_kernels);
  3. small references: the tiny config in bf16 on the card and in bf16 on
     the CPU (plain versions), each against fp32 on the CPU, same weights:
     the caption path dense, then with int4 text blocks and an int8 KV
     cache, then with one KV head (GQA) and a plain or int8 cache; the
     lockstep batches' encode_images, batched prompt prefill (spans of 8
     and 16) and one decode step over 3 images, MHA and GQA; one
     serving-pool decode step, plain and prefix-shared; the region-head
     paths with peaked decoders, whose boxes, points and ids must equal
     the CPU's; the speculative verify forwards (pool k 8 and 24, plain and
     prefix-shared; batch-1 spans of 8 and 24 rows), and a batch-1
     speculative caption, a speculative pool, a mixed pool and a mixed
     speculative pool, whose ids and boxes must equal the CPU's; the
     caption path with int8 text blocks and a static int8 ViT; the caption
     path under a rank-4 LoRA variant (a seeded adapter file); the
     steered caption (a seeded control vector: the steered prompt's and
     decode step's logits, and 16 greedy ids, fused and streamed, equal to
     the CPU's fp32 ids under the peaked oracle);
  4. the main paths at MOONDREAM_2B widths and depth with seeded random
     weights, each with exact kernel launch counts (reset just before the
     path, read just after): the bf16 model (caption, query, lockstep
     caption_batch / query_batch over 8 images, three continuous-batching
     pools), the same weights with int4 text blocks and an int8 KV cache
     (caption, query, a prefix-shared pool), and the 2B with 8 KV heads
     (GQA), bf16 (caption, query, lockstep batches) then kv_int8 (caption,
     query); the region-head paths: bf16 detect, point, detect_gaze (eye
     and accuracy mode), query with reasoning and with spatial refs and
     detect_batch over 8 images, int4 + kv_int8 detect and GQA detect, each
     with its decode loops' host reads (at most one per DONE_CHECK_EVERY
     steps plus one); speculative decode (k 8) of a bf16 and an int4 +
     kv_int8 caption and query (tok/s, accept rate, host reads, ids against
     plain greedy with the logit margin where they differ), bf16
     speculative pools of k 8 and k 24, and a mixed pool of text, detect,
     point and gaze rows, plain and speculative, whose structured results
     must equal the single requests'. Captions check repeated greedy ids,
     streamed == plain and one sampled caption; pools check no host sync
     inside a chunk (plain, speculative, mixed and mixed speculative).
     The answer loops, the lockstep batches and the plain pools replay
     CUDA graphs (engine/graphs.py), so these launch counts include the
     replays'. Per model a graph phase runs the graphed paths against the
     same steps run eagerly in turns: the batch-1 answer loop (greedy, and
     sampled from one seed), the lockstep caption batch (MHA and GQA), the
     plain, prefix-shared and int4 + kv_int8 pools; ids must be equal bit
     for bit, every graph replays once more with a host sync an error, and
     it prints tok/s, ms per lockstep step and per pool chunk of both and
     each capture's ms and graph pool bytes. A loop-graph phase does the
     same for the other graphed loops, every replay under the sync
     error mode and launch counts equal between graphed and eager: the
     speculative caption (bf16 and int4 + kv_int8; a sampled one from one
     seed), and on the bf16 model the reasoning loop and query, detect,
     point, both gaze modes, detect_batch and the spec, spec-sampled,
     mixed and mixed spec pools. A GQA speculative caption runs the eager
     span loop (kernel A takes its spans) under its own loop label.
     The multi-image pipelines on the bf16 model: BatchPipeline over 20
     images of three sizes at batch 8 in turns with encode_images +
     caption_batch (images/s, ids under the logit-margin rule, exact
     launches, no new loop graph in a second run), BatchPipeline(
     speculative=8) (kernel C over the lockstep verify spans; tok/s,
     accept rate, reads), PooledPipeline plain and k 8 on cold engines
     against serial submissions, and submit_many against 8 submit calls;
     an int4 + kv_int8 PooledPipeline; the 2B with int8 w8a8 text blocks
     and a static int8 ViT calibrated on the smoke's normalized crops
     (caption, query, encode against its dynamic int8 and bf16 ViT in
     turns, the graphed answer loop against eager, a pool, speculative
     decode, 96 w8a8 launches per decode token and 108 per ViT call, each
     after one launch of the quantize pass);
     LoRA variants ("4 2B variants"): two seeded rank-16 adapters at the 2B
     widths, written as .pt files and loaded through settings["variant"]:
     the zero-B one gives the base model's prompt logits and greedy ids bit
     for bit, the nonzero one changes them; under it the graphed answer
     loop equals eager with exact launches, base / variant / base capture
     one new graph, the graphs replay with a host sync an error, base and
     variant tok/s, ms per graphed step and device launches per step
     (torch.profiler) are printed, and one detect and one BatchPipeline
     run; the int4 + kv_int8 and the int8 w8a8 models caption under it,
     graphed equal to eager (W4A16 and the w8a8 kernels on the adapter's
     route); multi-variant pools ("4 2B variant pools"): base rows beside
     rows of a rank-16 and a rank-8 adapter in one graphed pool on each
     of the three models, exact launches, every row against the
     single-stream greedy ids under its variant's factors as the pool
     holds them (the logit-margin rule) and its first-forward logits
     bit for bit the pool's forward with every row through its vid and
     nearest batch-1's step under its own adapter;
     on the bf16 model also graphed == eager, chunks under the sync error
     mode, a zero-B pool bit for bit the base pool, a speculative variant
     pool, and the base and variant pools' ms per chunk, tok/s and device
     launches per chunk in turns;
     steering ("4 2B steering", PR 18): a seeded unit-row vector at 4.2
     in the caption and query, graphed and eager in turns (equal ids,
     exact launches), the steered graphs under the sync error mode,
     streamed == fused, scale 0 == unsteered, a speculative k 8 steered
     caption (margin rule), steered and unsteered ms and device launches
     per graphed step, a second vector and scale replaying the same graph,
     HiddenStateCollector.collect and train_control_vectors, and a
     steered int4 + kv_int8 caption;
     the front ends on the bf16 model: "4 2B HTTP server"
     (serve_http.make_server over real HTTP on 127.0.0.1: sequential
     captions and queries on PNG uploads with exact launch counts, each
     equal to a directly driven engine's; SSE == plain; 8 concurrent
     captions sharing chunks under the logit-margin rule; detect, point,
     gaze equal to the model's own calls; chat completions; the p50
     single-caption latency over HTTP, the direct pool and model.caption
     in turns); "4 2B CLI" (cli._benchmark's encode ms and streamed
     tok/s; `python3 -m moondream_tpu_torch.cli --demo` in a subprocess);
     "4 2B HF wrapper" (answer_question == query; a same-shape embedding
     swap changes the graphed answer as the eager one); "4 native BPE"
     (the g++-built native/bpe.cpp against the tokenizers library);
     "4 2B evals" (phase_eval, PR 20): the twelve eval loops of
     moondream_tpu_torch/eval on stand-in rows (2 each, four image sizes,
     16-token answers), eval_all, quant_drift's dynamic and static int8-ViT
     drift and caption agreement against an int4 + kv_int8 and an int8
     w8a8 twin (the dense model stays dense), and the recipes'
     detect_frames over 8 frames in one batch, the gaze recipe's per-face
     detect_gaze and its process_video on a synthetic mp4, each part with
     its kernels' launches and every graph replay under the sync error
     mode; scores and gates mean nothing with random weights;
     then the 0.5B (MOONDREAM_05B) caption path over a single-tile image. Phase 2 also holds kernel A at
     the pipeline's fused [BOS, image, prompt] prefill, kernel C at the
     lockstep speculative verify, kernel B's device form at Tq 8 and 16
     with bounds, and kernels A and B at the 0.5B's widths. Phase 3 also
     holds one text and one region training step of the tiny config (loss
     and every gradient, bf16 on the card against fp32 on the CPU);
  5. finetuning at MOONDREAM_2B widths and depth (phase_finetune): the
     text finetune over four synthetic images at grad-accum 2 (two
     updates) and the region finetune over two boxes, through the CLIs'
     functions, with exact kernel A launches, ms per mini-step and per
     update, training tokens/s and peak memory; the frozen trees bit for
     bit unchanged, wte moved by weight decay alone, the saved .pt
     reloaded equal, and the graphed caption (graphs captured before the
     training) equal to an eager one on the trained weights; LoRA
     finetuning (PR 18, phase_lora_finetune): a rank-16 adapter over a
     fresh 2B, four --synthetic mini-steps at grad-accum 2, the base bit
     for bit unchanged, ms per mini-step and per update and peak memory
     beside the full text finetune's, and the saved variant served by a
     graphed caption.

    python3 chip_smoke.py --variants   # the LoRA variant phases alone
    python3 chip_smoke.py --steer      # the steering and LoRA-finetune phases alone
    python3 chip_smoke.py --serve      # the front-end phases alone
    python3 chip_smoke.py --eval       # the eval and recipe phase alone

Prints the card's name and power limit first, then which of PIL,
tokenizers and transformers the machine has, the seconds of each phase,
a kernels JSON line second to last, and {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import importlib.util
import io
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")

from moondream_tpu_torch import cli, native_bpe, serve_http  # noqa: E402
from moondream_tpu_torch.config import MOONDREAM_05B, MOONDREAM_2B, tiny_test_config  # noqa: E402
from moondream_tpu_torch.engine import batched as batched_engine  # noqa: E402
from moondream_tpu_torch.engine.batched import (  # noqa: E402
    batched_steps,
    decode_step_batched,
    generate_text_batched,
    sample_tokens_batched,
)
from moondream_tpu_torch.engine.generate import (  # noqa: E402
    DONE_CHECK_EVERY,
    LOOP_COUNTS,
    _verify_logits,
    decode_step,
    generate_reasoning,
    generate_text,
    generate_text_spec,
    generate_text_spec_sampled,
    reset_loop_counts,
)
from moondream_tpu_torch.engine import graphs  # noqa: E402
from moondream_tpu_torch.engine import serving as serving_engine  # noqa: E402
from moondream_tpu_torch.finetune import finetune_region, finetune_text  # noqa: E402
from moondream_tpu_torch.finetune import lora as ft_lora  # noqa: E402
from moondream_tpu_torch.finetune import trainer as finetune_trainer  # noqa: E402
from moondream_tpu_torch.finetune.optim import named_leaves, trainable  # noqa: E402
from moondream_tpu_torch.hf_moondream import HfMoondream  # noqa: E402
from moondream_tpu_torch.engine.pipeline import BatchPipeline, PooledPipeline  # noqa: E402
from moondream_tpu_torch.engine.serving import (  # noqa: E402
    ragged_decode_step,
    ragged_verify_step,
)
from moondream_tpu_torch.kernels import attention as K  # noqa: E402
from moondream_tpu_torch.kernels import quant as KQ  # noqa: E402
from moondream_tpu_torch.kernels.build import (  # noqa: E402
    LAUNCHES,
    build_parallel,
    build_seconds,
    reset_launch_counts,
)
from moondream_tpu_torch.models.moondream import MoondreamModel, _prompt_pad  # noqa: E402
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine  # noqa: E402
from moondream_tpu_torch.models.text import (  # noqa: E402
    LORA_SITES,
    Int4Linear,
    KVCache,
    dequantize_kv,
    layer_adapters,
    produce_hidden,
    quantize_kv,
    quantize_text_params,
    quantize_text_params_int8,
    quantize_weight_int8,
    text_encoder,
)
from moondream_tpu_torch.models.vision import (  # noqa: E402
    collect_vision_act_stats,
    normalize_crops,
    quantize_vision_params,
    vision_encoder,
)
from moondream_tpu_torch.ops.attention import (  # noqa: E402
    decode_attention,
    decode_attention_cached,
    decode_attention_cached_plain,
    decode_attention_plain,
    decode_attention_ragged_plain,
    flash_attention,
    flash_attention_plain,
    unified_mask,
)
from moondream_tpu_torch.ops.image_crops import load_native  # noqa: E402
from moondream_tpu_torch.ops.layers import (  # noqa: E402
    Int8Linear,
    Linear,
    int8_linear,
    int8_linear_fp64,
    int8_linear_plain,
    pack_int8_weight,
    q8_codes_plain,
)
from moondream_tpu_torch.repeng import HiddenStateCollector, train_control_vectors  # noqa: E402
from moondream_tpu_torch.ops.quant import (  # noqa: E402
    quantize_weight_torch,
    quantized_matmul,
    quantized_matmul_plain,
    unpack_codes,
)
from moondream_tpu_torch.tokenizer import ByteTokenizer, load_tokenizer  # noqa: E402
from moondream_tpu_torch.utils.streaming import stream_text  # noqa: E402
from moondream_tpu_torch.weights import build_params, init_params, load_params  # noqa: E402

DEV = torch.device("cuda")
BF16 = torch.bfloat16
# Each kernel is held to its plain version run in fp32 on the same bf16
# inputs (TF32 off), relative to the largest |plain| value:
#   max|kernel - plain| <= KERNEL_REL_TOL * max|plain|.
# Rounding the output to bf16 alone costs up to 2^-8 (3.9e-3) of that. The
# plain version fed the bf16 inputs as they are (bf16 probabilities and
# output) is printed beside each case as the bf16 floor.
KERNEL_REL_TOL = 1e-2
# Tiny config on the same bf16-valued weights: the card's bf16 run (the
# kernels) may stray from the fp32 run on the CPU by at most this many times
# as far as the CPU's own bf16 run (the plain versions) does, per output.
# Both runs round every activation to bf16, so a correct kernel moves the
# result about as much as bf16 does; a wrong mask moves it far more.
SMALL_REF_FACTOR = 2.0
SEED = 0
# The H100 SXM's published peaks (NVIDIA's data sheet, dense): HBM bytes/s
# and bf16 tensor-core FLOP/s. A kernel's bound is the larger of the bytes
# its function must move (each input read once, each output written once)
# over the first and its operations over the second, both counted from
# this run's inputs at the kernel's headline shape.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
# dense int8 tensor-core operations per second (the w8a8 kernel's bound)
PEAK_INT8_OP_S = 1979e12
# The 2B with 8 KV heads for its 32 query heads (GQA, rep 4): the published
# widths otherwise.
MOONDREAM_2B_GQA = dataclasses.replace(
    MOONDREAM_2B, text=dataclasses.replace(MOONDREAM_2B.text, n_kv_heads=8)
)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: `reps` calls captured in one CUDA graph and
    replayed between two events, so the host's cost of issuing each launch
    (Python, checks, the launch itself) is left out, unlike median_ms."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_build() -> None:
    build_parallel([*K.LOADERS, *KQ.LOADERS, load_native, native_bpe.available])
    if load_native() is None:
        raise RuntimeError("native crop library did not build")
    if not native_bpe.available():
        raise RuntimeError("native BPE library did not build")
    print("build seconds:", {k: round(v, 2) for k, v in build_seconds.items()})


def bound(nbytes: float, flops: float, peak_ops: float = PEAK_BF16_FLOP_S) -> dict:
    """The least time the card could take for work that moves `nbytes` and
    does `flops` operations at `peak_ops` (bf16 unless given), and which of
    the two sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def attn_work(q, k, v, attended: int) -> tuple:
    """(bytes, flops) of attention: q, k, v read once and the output (q's
    shape, bf16) written once; QK^T and PV over the `attended` (query row,
    key column) pairs of every batch row and query head."""
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + q.numel() * 2
    return nbytes, 4 * q.shape[1] * q.shape[-1] * attended


def sdpa(q, k, v, mask, gqa=False):
    """One PyTorch call computing the attention function of kernels A, B,
    B-GQA and C on the same inputs (timed as a yardstick only; the port
    never calls it): SDPA with the unified mask as a boolean tensor."""
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=gqa)


def int4pack_mm(x, qw):
    """One PyTorch call computing the W4A16 product on the same codes:
    `torch._weight_int4pack_mm` (tinygemm: w = (code - 8) * scale + zero')
    after a one-time repack at the first call, with zero' = zero + 8 *
    scale so that it equals code * scale + zero; scales and zeros in bf16,
    as it takes them."""
    state = {}

    def call():
        if not state:
            codes = unpack_codes(qw["packed"]).t().contiguous().to(torch.int32)  # (N, K)
            w = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
            state["w"] = torch._convert_weight_to_int4pack(w, 8)
            state["sz"] = torch.stack(
                [qw["scale"], qw["zero"] + 8 * qw["scale"]], dim=-1).to(BF16).contiguous()
            state["group"] = codes.shape[1] // qw["scale"].shape[0]
        return torch._weight_int4pack_mm(x, state["w"], state["group"], state["sz"])

    return call


GQA_KERNELS = (K.DECODE_GQA, K.DECODE_GQA_LAYER)


def phase_kernels(gen: torch.Generator) -> dict:
    """Kernel vs plain at the main path's shapes; returns per-kernel summary."""
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV, dtype=BF16)
    summary = {name: {"err": 0.0}
               for name in (K.FLASH, K.DECODE, K.RAGGED, *GQA_KERNELS, KQ.W4A16)}

    def check(name, label, run, plain, args, work=None, library=None, timed=True):
        """run(): the kernel on the tensors `args`; plain(*args): the plain
        version, fed them with bf16 ones in fp32 (converted once, outside
        the timed call) and as they are. `work` (bytes, flops) gives the
        case's bound and `library` a PyTorch call computing the same
        function (None where there is none), timed beside it. The first
        case of each kernel is its headline shape: the kernels line reports
        its numbers, and it must give `work`. An edge case (`timed` False)
        is held to the same tolerance and not timed."""
        got = run().float()
        fargs = [a.float() if a.dtype == BF16 else a for a in args]
        f32 = lambda: plain(*fargs)
        want = f32()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        floor = (plain(*args).float() - want).abs().max().item()
        if not (torch.isfinite(got).all() and err <= KERNEL_REL_TOL * scale):
            raise AssertionError(
                f"{name} {label}: max_abs_err {err} > {KERNEL_REL_TOL} * {scale}"
            )
        s = summary[name]
        s["err"] = max(s["err"], err)
        if not timed:
            print(f"{name} {label}: max_abs_err {err:.3e} = {err / scale:.2e} of "
                  f"max|plain| {scale:.3f} (tol {KERNEL_REL_TOL}, bf16 plain "
                  f"{floor / scale:.2e})")
            return
        ms, plain_ms = median_ms(run), median_ms(f32)
        dev_ms, dev_plain_ms = graph_ms(run), graph_ms(f32)
        print(f"{name} {label}: max_abs_err {err:.3e} = {err / scale:.2e} of "
              f"max|plain| {scale:.3f} (tol {KERNEL_REL_TOL}, bf16 plain "
              f"{floor / scale:.2e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
              f"device only: kernel {dev_ms:.4f} ms plain {dev_plain_ms:.4f} ms")
        lib_ms, lib_dev_ms = library_time(name, library, want, scale)
        if work is not None:
            b = bound(*work)
            print(f"{name} {label}: bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
                  f"({b['bytes']:.4g} bytes, {b['flops']:.4g} flop), kernel device "
                  f"only {dev_ms / b['bound_ms']:.1f} x bound")
        if lib_dev_ms is not None:
            print(f"{name} {label}: kernel device only {dev_ms / lib_dev_ms:.2f} x library")
        if "ms" not in s:  # the headline shape
            s.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms,
                     library_device_ms=lib_dev_ms, **b)
        del fargs

    def library_time(name, library, want, scale):
        """Median launch time of the library call (as `ms`) and its device
        time (as graph_ms; None where a CUDA graph cannot capture it), both
        None only when the case has none. Raises when the call fails or
        does not compute the same function within the kernel's tolerance."""
        if library is None:
            return None, None
        err = (library().float() - want).abs().max().item()
        if not err <= KERNEL_REL_TOL * scale:
            raise AssertionError(
                f"{name} library call disagrees: max_abs_err {err} > {KERNEL_REL_TOL} * {scale}")
        lib_ms = median_ms(library)
        try:
            lib_dev_ms = graph_ms(library)
            dev = f"{lib_dev_ms:.4f}"
        except RuntimeError as e:  # a call that a CUDA graph cannot capture
            lib_dev_ms, dev = None, f"not measured ({type(e).__name__})"
        print(f"{name} library call: max_abs_err {err:.3e}, {lib_ms:.4f} ms; "
              f"device only {dev} ms")
        return lib_ms, lib_dev_ms

    # ViT: 13 crops x 16 heads, 768 tokens (729 real), head_dim 72, as head
    # views of the fused QKV projection.
    b, t, h, d = 13, 768, 16, 72
    qkv = randn(b, t, 3 * h * d)
    q, k, v = (x.view(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, -1))
    mask = unified_mask(t, t, 0, 729, DEV)
    check(K.FLASH, "vit 13x16x768x768 d72 prefix729",
          lambda: flash_attention(q, k, v, 0, 729),
          lambda q, k, v: flash_attention_plain(q, k, v, 0, 729), (q, k, v),
          attn_work(q, k, v, b * int(mask.sum())), sdpa(q, k, v, mask))

    # Text cases read k/v as the layer view of a (1, 32, 2048, 64) cache.
    cache_k, cache_v = randn(1, 32, 2048, 64), randn(1, 32, 2048, 64)
    for label, tq, tk, pos, prefix in (
        ("image prefill 32x730x768 d64 prefix730", 730, 768, 0, 730),
        ("span 32x128x1024 pos700 prefix730", 128, 1024, 700, 730),
        ("causal 32x512x512", 512, 512, 0, 0),
        ("kv 2048: 32x2048x2048 prefix730", 2048, 2048, 0, 730),
        # the gaze prompt (17 rows) and a query with two spatial refs (20
        # rows), each padded to 24 at kv_bound 768
        ("span 32x24x768 pos730 prefix730", 24, 768, 730, 730),
    ):
        q = randn(1, 32, tq, 64)
        kk, vv = cache_k[:, :, :tk], cache_v[:, :, :tk]
        mask = unified_mask(tq, tk, pos, prefix, DEV)
        check(K.FLASH, label,
              lambda: flash_attention(q, kk, vv, pos, prefix),
              lambda q, k, v: flash_attention_plain(q, k, v, pos, prefix), (q, kk, vv),
              attn_work(q, kk, vv, int(mask.sum())), sdpa(q, kk, vv, mask))

    # Decode on a stacked (24, 1, 32, 2048, 64) cache, layer 13, kv_bound
    # 1536, garbage (unit normals x 1000) in every slot past the span. In the
    # "diagonal" cases row i's query is the key at pos + i, so that column
    # holds ~70% of the row's weight: a mask off by one moves the output by
    # about max|plain|.
    # Tq 8 at pos 800: a speculative verify span past the prefix
    for tq, pos in ((1, 735), (8, 730), (8, 800)):
        kc, vc = randn(24, 1, 32, 2048, 64), randn(24, 1, 32, 2048, 64)
        kc[:, :, :, pos + tq:] *= 1000
        vc[:, :, :, pos + tq:] *= 1000
        # the columns this read needs, and the layer view SDPA takes
        cols = min(max(pos + tq, 730), 1536)
        kl, vl = kc[13, :, :, :1536], vc[13, :, :, :1536]
        mask = unified_mask(tq, 1536, pos, 730, DEV)
        for kind, q in (("random q", randn(1, 32, tq, 64)),
                        ("diagonal q", kc[13, :, :, pos:pos + tq].clone())):
            check(K.DECODE,
                  f"stacked L24 layer13 tq{tq} pos{pos} bound1536 garbage tail, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, 13, pos, 730, 1536),
                  lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, pos, 730, 1536),
                  (q, kc, vc), attn_work(q, kl[..., :cols, :], vl[..., :cols, :],
                                         int(mask[:, :cols].sum())),
                  sdpa(q, kl, vl, mask))
        del kl, vl

    # Kernel B at the MHA lockstep batch's shapes: a stacked (24, 8, 32,
    # 1024, 64) cache, layer 13, prefix 730, kv_bound 896; decode (Tq 1,
    # pos 800) and the batched prompt spans (Tq 8 caption, Tq 16 query, pos
    # 730); x1000 garbage past each span; the diagonal query of every batch
    # row is its own key, so a batch-stride fault moves the output too.
    tk = 896
    for tq, pos in ((1, 800), (8, 730), (16, 730)):
        kc, vc = randn(24, 8, 32, 1024, 64), randn(24, 8, 32, 1024, 64)
        kc[..., pos + tq:, :] *= 1000
        vc[..., pos + tq:, :] *= 1000
        cols = max(pos + tq, 730)
        kl, vl = kc[13, :, :, :tk], vc[13, :, :, :tk]
        mask = unified_mask(tq, tk, pos, 730, DEV)
        for kind, q in (("random q", randn(8, 32, tq, 64)),
                        ("diagonal q", kc[13, :, :, pos:pos + tq].clone())):
            check(K.DECODE,
                  f"stacked L24 batch8 layer13 tq{tq} pos{pos} bound{tk} garbage tail, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, 13, pos, 730, tk),
                  lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, pos, 730, tk),
                  (q, kc, vc), attn_work(q, kl[..., :cols, :], vl[..., :cols, :],
                                         8 * int(mask[:, :cols].sum())),
                  sdpa(q, kl, vl, mask))
        del kc, vc, kl, vl

    # The accuracy-mode gaze batch: 20 rows (10 eye positions over the image
    # and 10 over its mirror) on a (24, 20, 32, 768, 64) cache, layer 13.
    # Kernel A prefills the 17-row gaze prompt padded to 24 at pos 730 over
    # the layer view's 768 columns (prefix 730); kernel B then takes the y
    # step (Tq 1, pos 747, causal, kv_bound 768). x1000 garbage past each
    # span; the diagonal query of every row is its own key.
    kc, vc = randn(24, 20, 32, 768, 64), randn(24, 20, 32, 768, 64)
    kl, vl = kc[13], vc[13]
    for t in (kc, vc):
        t[..., 754:, :] *= 1000
    mask = unified_mask(24, 768, 730, 730, DEV)
    for kind, q in (("random q", randn(20, 32, 24, 64)), ("diagonal q", kl[:, :, 730:754].clone())):
        check(K.FLASH, f"gaze span batch20 32x24x768 pos730 prefix730, layer view, {kind}",
              lambda: flash_attention(q, kl, vl, 730, 730),
              lambda q, k, v: flash_attention_plain(q, k, v, 730, 730), (q, kl, vl),
              attn_work(q, kl[..., :754, :], vl[..., :754, :], 20 * int(mask.sum())),
              sdpa(q, kl, vl, mask))
    for t in (kc, vc):
        t[..., 748:754, :] *= 1000
    mask = unified_mask(1, 768, 747, 0, DEV)
    for kind, q in (("random q", randn(20, 32, 1, 64)), ("diagonal q", kl[:, :, 747:748].clone())):
        check(K.DECODE, f"gaze step stacked L24 batch20 layer13 tq1 pos747 bound768, {kind}",
              lambda: decode_attention_cached(q, kc, vc, 13, 747, 0, 768),
              lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, 747, 0, 768),
              (q, kc, vc), attn_work(q, kl[..., :748, :], vl[..., :748, :], 20 * 748),
              sdpa(q, kl, vl, mask))
    del kc, vc, kl, vl

    # Kernel B's int8 entry, the same cases on an int8 (24, 1, 32, 2048, 64)
    # cache quantized by the port (a scale per token and head pair), with
    # random codes and scales x1000 in every slot past the span; the
    # diagonal query is the dequantized key at pos + i.
    for tq, pos in ((1, 735), (8, 730), (8, 800)):
        codes, scales = [], []
        for _ in range(2):
            c, sc = quantize_kv(torch.randn(24, 32, 2048, 64, generator=gen, device=DEV), 2)
            c, sc = c.view(24, 1, 32, 2048, 64), sc.view(24, 1, 16, 2048)
            tail = c[..., pos + tq:, :]
            tail.copy_(torch.randint(-127, 128, tail.shape, generator=gen, device=DEV))
            sc[..., pos + tq:] *= 1000
            codes.append(c)
            scales.append(sc)
        (kc, vc), (ks, vs) = codes, scales
        diag = dequantize_kv(kc[13, :, :, pos:pos + tq], ks[13, :, :, pos:pos + tq], BF16)
        # codes of the attended columns, their scales, q and the output; no
        # single PyTorch call attends over int8 codes with per-token scales
        cols = min(max(pos + tq, 730), 1536)
        work = (2 * 32 * cols * 64 + 2 * 16 * cols * 4 + 2 * 32 * tq * 64 * 2,
                4 * 32 * 64 * tq * cols)
        for kind, q in (("random q", randn(1, 32, tq, 64)), ("diagonal q", diag)):
            check(K.DECODE,
                  f"int8 stacked L24 layer13 tq{tq} pos{pos} bound1536 garbage tail, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, 13, pos, 730, 1536, ks, vs),
                  lambda q: decode_attention_cached_plain(q, kc, vc, 13, pos, 730, 1536, ks, vs),
                  (q,), work)
    del codes, scales, kc, vc, ks, vs

    # Kernel C on a 2B serving pool: a bf16 (24, 8, 32, 1024, 64) cache,
    # layer 13, one position per slot (slot 4 idle at 0), x1000 garbage
    # past each slot's span; the diagonal query is each slot's own key.
    # Tq 8 and 16 are the speculative pools' verify spans (k 8; k 16, and
    # each 16-row piece of a k 24 span).
    slots, layer = 8, 13
    pool_pos = {1: [735, 736, 800, 1000, 0, 760, 900, 1022],
                4: [735, 736, 800, 1000, 0, 760, 900, 1020],
                8: [735, 736, 800, 1000, 0, 760, 900, 1016],
                16: [735, 736, 800, 1000, 0, 760, 900, 1008]}
    for tq, pos in pool_pos.items():
        pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
        kc, vc = randn(24, slots, 32, 1024, 64), randn(24, slots, 32, 1024, 64)
        for b, p in enumerate(pos):
            kc[:, b, :, p + tq:] *= 1000
            vc[:, b, :, p + tq:] *= 1000
        diag = torch.stack([kc[layer, b, :, p:p + tq] for b, p in enumerate(pos)])
        # per-slot masks (S, 1, Tq, T); bytes: each slot's attended columns
        rows = pos_t.long()[:, None, None, None] + torch.arange(tq, device=DEV)[:, None]
        mask = torch.arange(1024, device=DEV) <= rows
        ncols = sum(p + tq for p in pos)
        kv_bytes = 2 * 32 * ncols * 64 * 2
        for kind, q in (("random q", randn(slots, 32, tq, 64)), ("diagonal q", diag)):
            check(K.RAGGED, f"ragged pool 24x8x32x1024 d64 layer13 tq{tq} garbage tails, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, layer, pos_t, 0),
                  lambda q, k, v: decode_attention_ragged_plain(q, k, v, layer, pos_t, 0),
                  (q, kc, vc), (kv_bytes + 2 * q.numel() * 2, 4 * 32 * 64 * int(mask.sum())),
                  sdpa(q, kc[layer], vc[layer], mask))
    del kc, vc, diag

    def shared_work(pos, pid_t, tq, val_bytes, scale_bytes, prefix_len=730):
        """(bytes, flops) of one prefix-shared pool layer: q read and the
        output written in bf16; each slot's attended suffix columns, and
        each prefix entry's columns up to the furthest any of its slots
        attends, read once (values of `val_bytes`, a `scale_bytes` scale
        per token and head pair); QK^T and PV over the attended pairs."""
        pids_h = pid_t.tolist()
        suffix = sum(max(p + tq - prefix_len, 0) for p in pos)
        prefix = sum(max(min(p + tq, prefix_len) for p, e in zip(pos, pids_h) if e == entry)
                     for entry in set(pids_h))
        col_bytes = 2 * 32 * (64 * val_bytes + scale_bytes / 2)
        pairs = sum(p + i + 1 for p in pos for i in range(tq))
        return ((suffix + prefix) * col_bytes + 2 * slots * 32 * tq * 64 * 2,
                4 * 32 * 64 * pairs)

    # Prefix-shared: suffix (24, 8, 32, 384, 64), prefix pool (24, 4, 32,
    # 768, 64) with prefix_len 730, entries shared by several slots; x1000
    # garbage past each suffix span and in the prefix padding 730-767. The
    # diagonal query's first row is prefix entry pids[b]'s key at column
    # 100: reading another entry moves the output by ~max|plain|.
    pids = torch.tensor([0, 0, 1, 2, 3, 1, 2, 0], dtype=torch.int32, device=DEV)
    shared_pos = {1: [735, 730, 800, 1100, 0, 760, 900, 1113],
                  4: [735, 730, 800, 1100, 0, 760, 900, 1110],
                  8: [735, 730, 800, 1100, 0, 760, 900, 1106],
                  16: [735, 730, 800, 1098, 0, 760, 900, 1098]}
    for tq, pos in shared_pos.items():
        pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
        kc, vc = randn(24, slots, 32, 384, 64), randn(24, slots, 32, 384, 64)
        for b, p in enumerate(pos):
            kc[:, b, :, max(p + tq - 730, 0):] *= 1000
            vc[:, b, :, max(p + tq - 730, 0):] *= 1000
        pk, pv = randn(24, 4, 32, 768, 64), randn(24, 4, 32, 768, 64)
        pk[..., 730:, :] *= 1000
        pv[..., 730:, :] *= 1000
        diag = randn(slots, 32, tq, 64)
        diag[:, :, 0] = pk[layer, pids.long(), :, 100]
        for kind, q in (("random q", randn(slots, 32, tq, 64)), ("prefix-diagonal q", diag)):
            check(K.RAGGED, f"prefix-shared 24x8x32x384 + 24x4x32x768 prefix730 tq{tq}, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, layer, pos_t, 0, None,
                                                  pref_k=pk, pref_v=pv, pids=pids, prefix_len=730),
                  lambda q, k, v, pk, pv: decode_attention_ragged_plain(
                      q, k, v, layer, pos_t, 0, None, pref_k=pk, pref_v=pv, pids=pids,
                      prefix_len=730),
                  (q, kc, vc, pk, pv), shared_work(pos, pids, tq, 2, 0))
    del kc, vc, pk, pv, diag

    # Kernel C's int8 entry: both pools again on int8 caches quantized by
    # the port, random codes with scales x1000 in every garbage slot.
    def int8_cache(shape, ends):
        c, sc = quantize_kv(torch.randn(shape[0] * shape[1], *shape[2:], generator=gen,
                                        device=DEV), 2)
        c, sc = c.view(shape), sc.view(shape[0], shape[1], shape[2] // 2, shape[3])
        for b, e in enumerate(ends):
            tail = c[:, b, :, e:]
            tail.copy_(torch.randint(-127, 128, tail.shape, generator=gen, device=DEV))
            sc[:, b, :, e:] *= 1000
        return c, sc

    for tq, pos in pool_pos.items():
        pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
        ends = [p + tq for p in pos]
        (kc, ks), (vc, vs) = (int8_cache((24, slots, 32, 1024, 64), ends) for _ in range(2))
        diag = torch.stack([dequantize_kv(kc[layer, b, :, p:p + tq], ks[layer, b, :, p:p + tq], BF16)
                            for b, p in enumerate(pos)])
        for kind, q in (("random q", randn(slots, 32, tq, 64)), ("diagonal q", diag)):
            check(K.RAGGED, f"int8 ragged pool 24x8x32x1024 layer13 tq{tq} garbage tails, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, layer, pos_t, 0, None, ks, vs),
                  lambda q: decode_attention_ragged_plain(q, kc, vc, layer, pos_t, 0, None, ks, vs),
                  (q,), shared_work(pos, torch.arange(slots), tq, 1, 4, prefix_len=0))
    del kc, vc, ks, vs, diag
    for tq, pos in shared_pos.items():
        pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
        ends = [max(p + tq - 730, 0) for p in pos]
        (kc, ks), (vc, vs) = (int8_cache((24, slots, 32, 384, 64), ends) for _ in range(2))
        (pkc, pks), (pvc, pvs) = (int8_cache((24, 4, 32, 768, 64), [730] * 4) for _ in range(2))
        diag = randn(slots, 32, tq, 64)
        diag[:, :, 0] = dequantize_kv(pkc[layer, pids.long(), :, 100:101],
                                      pks[layer, pids.long(), :, 100:101], BF16)[:, :, 0]
        args = (layer, pos_t, 0, None, ks, vs, pkc, pvc, pks, pvs, pids, 730)
        for kind, q in (("random q", randn(slots, 32, tq, 64)), ("prefix-diagonal q", diag)):
            check(K.RAGGED, f"int8 prefix-shared 24x8x32x384 + 24x4x32x768 prefix730 tq{tq}, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, *args),
                  lambda q: decode_attention_ragged_plain(q, kc, vc, *args),
                  (q,), shared_work(pos, pids, tq, 1, 4))
    del kc, vc, ks, vs, pkc, pvc, pks, pvs, diag, args

    # Kernel B's GQA entries at the GQA 2B's shapes (8 KV heads, rep 4): a
    # stacked (24, B, 8, 1024, 64) cache, layer 13, pos 800, prefix 730,
    # kv_bound 896, B 1 and 8; then the single-layer entry on (B, 8, 896,
    # 64) with rep 4 and (B, 32, 896, 64) with rep 1 (the MHA function of
    # `_decode_kernel`); x1000 garbage past pos everywhere. The diagonal
    # query of head h is its KV head's key at pos.
    pos, prefix, tk = 800, 730, 896
    mask = unified_mask(1, tk, pos, prefix, DEV)
    for bsz in (1, 8):
        kc, vc = randn(24, bsz, 8, 1024, 64), randn(24, bsz, 8, 1024, 64)
        kc[..., pos + 1:, :] *= 1000
        vc[..., pos + 1:, :] *= 1000
        kl, vl = kc[13, :, :, :tk], vc[13, :, :, :tk]
        work = lambda q, k, v: attn_work(q, k[..., :pos + 1, :], v[..., :pos + 1, :],
                                         q.shape[0] * (pos + 1))
        for kind, q in (("random q", randn(bsz, 32, 1, 64)),
                        ("diagonal q", kc[13, :, :, pos:pos + 1].repeat_interleave(4, dim=1))):
            check(K.DECODE_GQA, f"stacked gqa 24x{bsz}x8x1024 rep4 layer13 pos{pos} "
                  f"bound{tk} garbage tail, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, 13, pos, prefix, tk),
                  lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, pos, prefix, tk),
                  (q, kc, vc), work(q, kl, vl), sdpa(q, kl, vl, mask, gqa=True))
        for hkv, rep in ((8, 4), (32, 1)):
            kl, vl = kc[13, :, :, :tk].clone(), vc[13, :, :, :tk].clone()
            if hkv == 32:
                kl, vl = randn(bsz, 32, tk, 64), randn(bsz, 32, tk, 64)
                kl[..., pos + 1:, :] *= 1000
                vl[..., pos + 1:, :] *= 1000
            for kind, q in (("random q", randn(bsz, 32, 1, 64)),
                            ("diagonal q", kl[:, :, pos:pos + 1].repeat_interleave(rep, dim=1))):
                check(K.DECODE_GQA_LAYER, f"single layer {bsz}x{hkv}x{tk} rep{rep} pos{pos}, {kind}",
                      lambda: decode_attention(q, kl, vl, pos, prefix),
                      lambda q, k, v: decode_attention_plain(q, k, v, pos, prefix),
                      (q, kl, vl), work(q, kl, vl), sdpa(q, kl, vl, mask, gqa=rep > 1))
        del kc, vc, kl, vl

    # Edge cases of the redesigned kernels, held to the same tolerance and
    # not timed. Kernel A: `prefix` one column either side of the 64-column
    # wgmma step and the 128-column tile (32 heads, 512 x 512, pos 0), the
    # GQA prompt spans (8 and 16 rows at pos 730 over heads repeated from 8
    # KV heads, kv_bound 896), and the ViT's d72 head views with q's and
    # k's columns next to each head's 72 (the padding's neighbours) x30: a
    # kernel that read them as padding would move every score.
    kk, vv = cache_k[:, :, :512], cache_v[:, :, :512]
    for prefix in (63, 64, 65, 127, 128, 129):
        for kind, q in (("random q", randn(1, 32, 512, 64)), ("diagonal q", kk.clone())):
            check(K.FLASH, f"edge 32x512x512 prefix{prefix}, {kind}",
                  lambda: flash_attention(q, kk, vv, 0, prefix),
                  lambda q, k, v: flash_attention_plain(q, k, v, 0, prefix), (q, kk, vv),
                  timed=False)
    kr, vr = (randn(1, 8, 896, 64).repeat_interleave(4, 1) for _ in range(2))
    for tq in (8, 16):
        for kind, q in (("random q", randn(1, 32, tq, 64)),
                        ("diagonal q", kr[:, :, 730:730 + tq].clone())):
            check(K.FLASH, f"edge gqa prompt span 32x{tq}x896 pos730 prefix730, {kind}",
                  lambda: flash_attention(q, kr, vr, 730, 730),
                  lambda q, k, v: flash_attention_plain(q, k, v, 730, 730), (q, kr, vr),
                  timed=False)
    b, t, h, d = 13, 768, 16, 72
    qkv = randn(b, t, 3 * h * d)
    qkv.view(b, t, 3 * h, d)[:, :, :2 * h, :8] *= 30  # q and k heads
    q, k, v = (x.view(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, -1))
    check(K.FLASH, "edge vit d72, the padding's neighbours x30, 729 real rows",
          lambda: flash_attention(q, k, v, 0, 729),
          lambda q, k, v: flash_attention_plain(q, k, v, 0, 729), (q, k, v), timed=False)
    del qkv, q, k, v, kr, vr

    # The decode kernel's column splits: kernel B (bf16 and int8) at pos 0,
    # 63, 64 (a tile edge) and the last slot over (2, 1, 32, 2048, 64)
    # caches (layer 1, full read bound: 2048 columns for 32 pairs), x1000
    # garbage past each span; GQA rep 1, 2, 4 and 16 (32 query heads) at
    # pos 0, 64 and 2047.
    def garbage_tail(x, end):
        x = x.clone()
        x[..., end:, :] *= 1000
        return x

    base_k, base_v = randn(2, 1, 32, 2048, 64), randn(2, 1, 32, 2048, 64)
    for tq, pos in ((1, 0), (1, 63), (1, 64), (1, 2047), (8, 0), (8, 64), (16, 2032)):
        kc, vc = garbage_tail(base_k, pos + tq), garbage_tail(base_v, pos + tq)
        (k8, ks), (v8, vs) = (quantize_kv(x.float().view(2, 32, 2048, 64), 2)
                              for x in (kc, vc))
        k8, v8 = k8.view(2, 1, 32, 2048, 64), v8.view(2, 1, 32, 2048, 64)
        ks, vs = ks.view(2, 1, 16, 2048), vs.view(2, 1, 16, 2048)
        for kind, q in (("random q", randn(1, 32, tq, 64)),
                        ("diagonal q", kc[1, :, :, pos:pos + tq].clone())):
            check(K.DECODE, f"edge stacked 2x1x32x2048 tq{tq} pos{pos}, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, 1, pos, 0),
                  lambda q, k, v: decode_attention_cached_plain(q, k, v, 1, pos, 0),
                  (q, kc, vc), timed=False)
            check(K.DECODE, f"edge int8 stacked 2x1x32x2048 tq{tq} pos{pos}, {kind}",
                  lambda: decode_attention_cached(q, k8, v8, 1, pos, 0, None, ks, vs),
                  lambda q: decode_attention_cached_plain(q, k8, v8, 1, pos, 0, None, ks, vs),
                  (q,), timed=False)
    for rep in (1, 2, 4, 16):
        hkv = 32 // rep
        for pos in (0, 64, 2047):
            # rows before the prefix edge 730 attend every column below it
            kc = garbage_tail(base_k[:, :, :hkv], max(pos + 1, 730))
            vc = garbage_tail(base_v[:, :, :hkv], max(pos + 1, 730))
            for kind, q in (("random q", randn(1, 32, 1, 64)),
                            ("diagonal q", kc[1, :, :, pos:pos + 1].repeat_interleave(rep, 1))):
                check(K.DECODE_GQA, f"edge stacked gqa 2x1x{hkv}x2048 rep{rep} pos{pos}, {kind}",
                      lambda: decode_attention_cached(q, kc, vc, 1, pos, 730),
                      lambda q, k, v: decode_attention_cached_plain(q, k, v, 1, pos, 730),
                      (q, kc, vc), timed=False)
                check(K.DECODE_GQA_LAYER, f"edge single layer 1x{hkv}x2048 rep{rep} pos{pos}, "
                      f"{kind}",
                      lambda: decode_attention(q, kc[1], vc[1], pos, 730),
                      lambda q, k, v: decode_attention_plain(q, k, v, pos, 730),
                      (q, kc[1], vc[1]), timed=False)
    del base_k, base_v, kc, vc, k8, v8, ks, vs

    # Kernel B's device-position form, as the graphed decode steps call it:
    # one token per row, the position a (B,) int32 tensor on the card, the
    # splits planned from the read bound; prefix 0 (decode steps are
    # causal). bf16 and int8 stacked (24, B, 32, T, 64) caches, GQA rep 4
    # over 8 KV heads (stacked, and the single-layer entry over a
    # dequantized [0, kv_bound) layer), at the caption's step (B 1, pos 735,
    # kv_bound 1024), the lockstep batch's (B 8, pos 800, kv_bound 896) and
    # the last column the bound reads (pos kv_bound - 1); x1000 garbage past
    # each row's position, random and diagonal queries. Then each form's
    # device-only time beside the host form's at the decode shapes.
    dev_pos = lambda b, p: torch.full((b,), p, dtype=torch.int32, device=DEV)
    forms = []
    for b, pos, kvb, t in ((1, 735, 1024, 2048), (8, 800, 896, 1024), (1, 1023, 1024, 2048)):
        at = f"batch{b} tq1 pos{pos} bound{kvb}"
        pt = dev_pos(b, pos)
        kc, vc = (garbage_tail(randn(24, b, 32, t, 64), pos + 1) for _ in range(2))
        diag = kc[13, :, :, pos:pos + 1].clone()
        for kind, q in (("random q", randn(b, 32, 1, 64)), ("diagonal q", diag)):
            check(K.DECODE, f"device pos stacked L24 layer13 {at}, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, 13, pt, 0, kvb, lockstep=True),
                  lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, pos, 0, kvb),
                  (q, kc, vc), timed=False)
        q = randn(b, 32, 1, 64)
        host_ms = graph_ms(lambda: decode_attention_cached(q, kc, vc, 13, pos, 0, kvb))
        dev_ms = graph_ms(lambda: decode_attention_cached(q, kc, vc, 13, pt, 0, kvb,
                                                          lockstep=True))
        forms.append((K.DECODE, at, host_ms, dev_ms))
        (k8, ks), (v8, vs) = (quantize_kv(x.float().view(24 * b, 32, t, 64), 2) for x in (kc, vc))
        k8, v8 = k8.view(24, b, 32, t, 64), v8.view(24, b, 32, t, 64)
        ks, vs = ks.view(24, b, 16, t), vs.view(24, b, 16, t)
        diag = dequantize_kv(k8[13, :, :, pos:pos + 1], ks[13, :, :, pos:pos + 1], BF16)
        for kind, q in (("random q", randn(b, 32, 1, 64)), ("diagonal q", diag)):
            check(K.DECODE, f"device pos int8 stacked L24 layer13 {at}, {kind}",
                  lambda: decode_attention_cached(q, k8, v8, 13, pt, 0, kvb, ks, vs,
                                                  lockstep=True),
                  lambda q: decode_attention_cached_plain(q, k8, v8, 13, pos, 0, kvb, ks, vs),
                  (q,), timed=False)
        q = randn(b, 32, 1, 64)
        host_ms = graph_ms(lambda: decode_attention_cached(q, k8, v8, 13, pos, 0, kvb, ks, vs))
        dev_ms = graph_ms(lambda: decode_attention_cached(q, k8, v8, 13, pt, 0, kvb, ks, vs,
                                                       lockstep=True))
        forms.append((K.DECODE_INT8, at, host_ms, dev_ms))
        del k8, v8, ks, vs
        kg, vg = kc[:, :, :8].contiguous(), vc[:, :, :8].contiguous()
        del kc, vc
        layer_k, layer_v = kg[13, :, :, :kvb].contiguous(), vg[13, :, :, :kvb].contiguous()
        diag = kg[13, :, :, pos:pos + 1].repeat_interleave(4, 1)
        for kind, q in (("random q", randn(b, 32, 1, 64)), ("diagonal q", diag)):
            check(K.DECODE_GQA, f"device pos stacked gqa rep4 L24 layer13 {at}, {kind}",
                  lambda: decode_attention_cached(q, kg, vg, 13, pt, 0, kvb, lockstep=True),
                  lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, pos, 0, kvb),
                  (q, kg, vg), timed=False)
            check(K.DECODE_GQA_LAYER, f"device pos single layer gqa rep4 {at}, {kind}",
                  lambda: decode_attention(q, layer_k, layer_v, pt, 0),
                  lambda q, k, v: decode_attention_plain(q, k, v, pos, 0),
                  (q, layer_k, layer_v), timed=False)
        q = randn(b, 32, 1, 64)
        for name, host_fn, dev_fn in (
                (K.DECODE_GQA, lambda: decode_attention_cached(q, kg, vg, 13, pos, 0, kvb),
                 lambda: decode_attention_cached(q, kg, vg, 13, pt, 0, kvb, lockstep=True)),
                (K.DECODE_GQA_LAYER, lambda: decode_attention(q, layer_k, layer_v, pos, 0),
                 lambda: decode_attention(q, layer_k, layer_v, pt, 0))):
            forms.append((name, at, graph_ms(host_fn), graph_ms(dev_fn)))
        del kg, vg, layer_k, layer_v
    # Kernel B's and B-int8's device form at the graphed speculative verify
    # spans: Tq 8 and 16 rows at pos + i on a (24, 1, 32, 2048, 64) cache,
    # layer 13, kv_bound 1536, prefix 0, at pos 730, 800 and 1016 (the
    # last span that fits 1032 columns), x1000 garbage past the span,
    # random and diagonal queries (row i's own key at pos + i); then the
    # device-only time of each form at pos 800.
    for tq in (8, 16):
        for pos in (730, 800, 1016):
            at = f"batch1 tq{tq} pos{pos} bound1536"
            pt = dev_pos(1, pos)
            kc, vc = (garbage_tail(randn(24, 1, 32, 2048, 64), pos + tq) for _ in range(2))
            diag = kc[13, :, :, pos:pos + tq].clone()
            for kind, q in (("random q", randn(1, 32, tq, 64)), ("diagonal q", diag)):
                check(K.DECODE, f"device pos span stacked L24 layer13 {at}, {kind}",
                      lambda: decode_attention_cached(q, kc, vc, 13, pt, 0, 1536, lockstep=True),
                      lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, pos, 0, 1536),
                      (q, kc, vc), timed=False)
            (k8, ks), (v8, vs) = (quantize_kv(x.float().view(24, 32, 2048, 64), 2)
                                  for x in (kc, vc))
            k8, v8 = k8.view(24, 1, 32, 2048, 64), v8.view(24, 1, 32, 2048, 64)
            ks, vs = ks.view(24, 1, 16, 2048), vs.view(24, 1, 16, 2048)
            diag = dequantize_kv(k8[13, :, :, pos:pos + tq], ks[13, :, :, pos:pos + tq], BF16)
            for kind, q in (("random q", randn(1, 32, tq, 64)), ("diagonal q", diag)):
                check(K.DECODE, f"device pos span int8 stacked L24 layer13 {at}, {kind}",
                      lambda: decode_attention_cached(q, k8, v8, 13, pt, 0, 1536, ks, vs,
                                                      lockstep=True),
                      lambda q: decode_attention_cached_plain(q, k8, v8, 13, pos, 0, 1536,
                                                              ks, vs),
                      (q,), timed=False)
            if pos == 800:
                q = randn(1, 32, tq, 64)
                forms.append((K.DECODE, at, graph_ms(
                    lambda: decode_attention_cached(q, kc, vc, 13, pos, 0, 1536)), graph_ms(
                    lambda: decode_attention_cached(q, kc, vc, 13, pt, 0, 1536, lockstep=True))))
                forms.append((K.DECODE_INT8, at, graph_ms(
                    lambda: decode_attention_cached(q, k8, v8, 13, pos, 0, 1536, ks, vs)),
                    graph_ms(lambda: decode_attention_cached(q, k8, v8, 13, pt, 0, 1536, ks, vs,
                                                             lockstep=True))))
            del kc, vc, k8, v8, ks, vs
    for name, at, host_ms, dev_ms in forms:
        print(f"{name} device pos form {at}: device only {dev_ms:.4f} ms, host pos form "
              f"{host_ms:.4f} ms ({dev_ms / host_ms:.2f} x)")

    # The device form at the spans of every graphed verify, pos 800, bound
    # 1536 (Tq 8, and Tq 16: every k 16 span), timed with its bound, and
    # bf16 beside SDPA; the attended columns are 0 .. pos + i.
    for tq in (8, 16):
        pos, pt = 800, dev_pos(1, 800)
        kc, vc = (garbage_tail(randn(24, 1, 32, 2048, 64), pos + tq) for _ in range(2))
        kl, vl = kc[13, :, :, :1536], vc[13, :, :, :1536]
        mask = unified_mask(tq, 1536, pos, 0, DEV)
        cols, attended = pos + tq, int(mask.sum())
        q = randn(1, 32, tq, 64)
        check(K.DECODE, f"device pos span stacked L24 layer13 batch1 tq{tq} pos{pos} bound1536",
              lambda: decode_attention_cached(q, kc, vc, 13, pt, 0, 1536, lockstep=True),
              lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, pos, 0, 1536),
              (q, kc, vc), attn_work(q, kl[..., :cols, :], vl[..., :cols, :], attended),
              sdpa(q, kl, vl, mask))
        (k8, ks), (v8, vs) = (quantize_kv(x.float().view(24, 32, 2048, 64), 2) for x in (kc, vc))
        k8, v8 = k8.view(24, 1, 32, 2048, 64), v8.view(24, 1, 32, 2048, 64)
        ks, vs = ks.view(24, 1, 16, 2048), vs.view(24, 1, 16, 2048)
        # codes and scales of the attended columns, q and the output
        work = (2 * 32 * cols * 64 + 2 * 16 * cols * 4 + 2 * q.numel() * 2,
                4 * 32 * 64 * attended)
        check(K.DECODE, f"device pos span int8 stacked L24 layer13 batch1 tq{tq} pos{pos} "
              "bound1536",
              lambda: decode_attention_cached(q, k8, v8, 13, pt, 0, 1536, ks, vs, lockstep=True),
              lambda q: decode_attention_cached_plain(q, k8, v8, 13, pos, 0, 1536, ks, vs),
              (q,), work)
        del kc, vc, kl, vl, k8, v8, ks, vs

    # The pipelines' shapes. Kernel A at BatchPipeline's fused [BOS, image,
    # caption prompt] prefill: 8 rows x 32 heads x 738 query rows (730 +
    # the 5-token prompt padded to 8) at pos 0, prefix 730, over the 768
    # columns of the layer view (kv_bound 768), x1000 garbage past row 738;
    # the diagonal query is each row's own key.
    kc, vc = (garbage_tail(randn(8, 32, 1024, 64), 738) for _ in range(2))
    kl, vl = kc[:, :, :768], vc[:, :, :768]
    mask = unified_mask(738, 768, 0, 730, DEV)
    for kind, q in (("random q", randn(8, 32, 738, 64)), ("diagonal q", kl[:, :, :738].clone())):
        check(K.FLASH, f"fused pipeline prefill batch8 32x738x768 prefix730, {kind}",
              lambda: flash_attention(q, kl, vl, 0, 730),
              lambda q, k, v: flash_attention_plain(q, k, v, 0, 730), (q, kl, vl),
              attn_work(q, kl[..., :738, :], vl[..., :738, :], 8 * int(mask.sum())),
              sdpa(q, kl, vl, mask))
    del kc, vc, kl, vl
    # Kernel C at the lockstep speculative verify (generate_text_spec_batched,
    # k 8): 8 rows of one (24, 8, 32, 1024, 64) cache (kv_bound 1024),
    # desynced at positions 738-800, no prefix segment; x1000 garbage past
    # each row's span; the diagonal query is each row's own keys.
    pos = [738, 745, 752, 760, 771, 780, 790, 800]
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    kc, vc = randn(24, 8, 32, 1024, 64), randn(24, 8, 32, 1024, 64)
    for b, p in enumerate(pos):
        kc[:, b, :, p + 8:] *= 1000
        vc[:, b, :, p + 8:] *= 1000
    diag = torch.stack([kc[13, b, :, p:p + 8] for b, p in enumerate(pos)])
    rows = pos_t.long()[:, None, None, None] + torch.arange(8, device=DEV)[:, None]
    mask = torch.arange(1024, device=DEV) <= rows
    kv_bytes = 2 * 32 * sum(p + 8 for p in pos) * 64 * 2
    for kind, q in (("random q", randn(8, 32, 8, 64)), ("diagonal q", diag)):
        check(K.RAGGED, f"lockstep spec verify 24x8x32x1024 layer13 tq8 pos738-800, {kind}",
              lambda: decode_attention_cached(q, kc, vc, 13, pos_t, 0, 1024),
              lambda q, k, v: decode_attention_ragged_plain(q, k, v, 13, pos_t, 0, 1024),
              (q, kc, vc), (kv_bytes + 2 * q.numel() * 2, 4 * 32 * 64 * int(mask.sum())),
              sdpa(q, kc[13], vc[13], mask))
    del kc, vc, diag

    # The 0.5B's widths (MOONDREAM_05B), held only: kernel A over a 2-crop
    # ViT batch (10 heads, d 72) and the [BOS, image] prefill (16 heads,
    # d 64), kernel B at a decode step of the (24, 1, 16, 2048, 64) cache.
    qkv = randn(2, 768, 3 * 10 * 72)
    q, k, v = (x.view(2, 768, 10, 72).transpose(1, 2) for x in qkv.split(720, -1))
    check(K.FLASH, "0.5B vit 2x10x768x768 d72 prefix729",
          lambda: flash_attention(q, k, v, 0, 729),
          lambda q, k, v: flash_attention_plain(q, k, v, 0, 729), (q, k, v), timed=False)
    kc, vc = (garbage_tail(randn(24, 1, 16, 2048, 64), 736) for _ in range(2))
    q = randn(1, 16, 730, 64)
    check(K.FLASH, "0.5B image prefill 16x730x768 d64 prefix730",
          lambda: flash_attention(q, kc[13, :, :, :768], vc[13, :, :, :768], 0, 730),
          lambda q, k, v: flash_attention_plain(q, k[13, :, :, :768], v[13, :, :, :768], 0, 730),
          (q, kc, vc), timed=False)
    for kind, q in (("random q", randn(1, 16, 1, 64)), ("diagonal q", kc[13, :, :, 735:736])):
        check(K.DECODE, f"0.5B stacked L24 layer13 16 heads tq1 pos735 bound1024, {kind}",
              lambda: decode_attention_cached(q, kc, vc, 13, 735, 730, 1024),
              lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, 735, 730, 1024),
              (q, kc, vc), timed=False)
    del kc, vc, qkv

    # Kernel C: a pool whose slots sit at 0, 1, 730 and the last column at
    # once, slot 4 idle at 0 (bf16 and int8, Tq 1 and 4); most of the
    # early slots' splits are empty.
    for tq, pos in ((1, [0, 1, 730, 1023, 0, 64, 63, 500]),
                    (4, [0, 1, 730, 1020, 0, 64, 60, 500])):
        pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
        kc, vc = randn(24, slots, 32, 1024, 64), randn(24, slots, 32, 1024, 64)
        for b, p in enumerate(pos):
            kc[:, b, :, p + tq:] *= 1000
            vc[:, b, :, p + tq:] *= 1000
        diag = torch.stack([kc[layer, b, :, p:p + tq] for b, p in enumerate(pos)])
        (k8, ks), (v8, vs) = (int8_cache((24, slots, 32, 1024, 64), [p + tq for p in pos])
                              for _ in range(2))
        for kind, q in (("random q", randn(slots, 32, tq, 64)), ("diagonal q", diag)):
            check(K.RAGGED, f"edge ragged pool slots at {pos} tq{tq}, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, layer, pos_t, 0),
                  lambda q, k, v: decode_attention_ragged_plain(q, k, v, layer, pos_t, 0),
                  (q, kc, vc), timed=False)
            check(K.RAGGED, f"edge int8 ragged pool slots at {pos} tq{tq}, {kind}",
                  lambda: decode_attention_cached(q, k8, v8, layer, pos_t, 0, None, ks, vs),
                  lambda q: decode_attention_ragged_plain(q, k8, v8, layer, pos_t, 0, None,
                                                          ks, vs),
                  (q,), timed=False)
    del kc, vc, k8, v8, ks, vs, diag
    # A verify span of 24 rows (a k 24 speculative pool): the dispatch
    # splits it into launches of 16 and 8 rows, the second at pos + 16;
    # plain and prefix-shared, x1000 garbage past each span.
    pos = [735, 736, 800, 1000, 0, 760, 900, 1000]
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    kc, vc = randn(24, slots, 32, 1024, 64), randn(24, slots, 32, 1024, 64)
    for b, p in enumerate(pos):
        kc[:, b, :, p + 24:] *= 1000
        vc[:, b, :, p + 24:] *= 1000
    diag = torch.stack([kc[layer, b, :, p:p + 24] for b, p in enumerate(pos)])
    for kind, q in (("random q", randn(slots, 32, 24, 64)), ("diagonal q", diag)):
        check(K.RAGGED, f"edge ragged pool tq24 (16 + 8 rows), {kind}",
              lambda: decode_attention_cached(q, kc, vc, layer, pos_t, 0),
              lambda q, k, v: decode_attention_ragged_plain(q, k, v, layer, pos_t, 0),
              (q, kc, vc), timed=False)
    kc, vc = kc[:, :, :, :384].contiguous(), vc[:, :, :, :384].contiguous()
    pk, pv = randn(24, 4, 32, 768, 64), randn(24, 4, 32, 768, 64)
    pk[..., 730:, :] *= 1000
    pv[..., 730:, :] *= 1000
    for b, p in enumerate(pos):
        kc[:, b, :, max(p + 24 - 730, 0):] *= 1000
        vc[:, b, :, max(p + 24 - 730, 0):] *= 1000
    q = randn(slots, 32, 24, 64)
    check(K.RAGGED, "edge prefix-shared tq24 (16 + 8 rows), random q",
          lambda: decode_attention_cached(q, kc, vc, layer, pos_t, 0, None, pref_k=pk,
                                          pref_v=pv, pids=pids, prefix_len=730),
          lambda q, k, v, pk, pv: decode_attention_ragged_plain(
              q, k, v, layer, pos_t, 0, None, pref_k=pk, pref_v=pv, pids=pids, prefix_len=730),
          (q, kc, vc, pk, pv), timed=False)
    del kc, vc, pk, pv, diag, q
    n_split, cols = K.plan_decode_splits(384 + 730, slots * 32)
    print(f"prefix-shared pools above: {n_split} splits of {cols} columns per (slot, head); "
          f"the prefix edge 730 lies inside split {730 // cols} "
          f"[{730 // cols * cols}, {730 // cols * cols + cols})")

    # W4A16 on weights quantized on the card, at the 2B text blocks' (K, N)
    # and M 1 (decode), 8 (a pool step, the 8-row caption span), 16 (the
    # query span), 64 and 128 (lockstep spans). Then row invariance: rows
    # of M 8 / 16 / 64 equal the same rows run at M 1 / 8 / 16, bit for bit.
    fp32 = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    for k, n, what in ((2048, 6144, "qkv"), (2048, 2048, "proj"),
                       (2048, 8192, "fc1"), (8192, 2048, "fc2")):
        qw = quantize_weight_torch(fp32(k, n) * k ** -0.5)
        wbytes = sum(t.numel() * t.element_size() for t in qw.values())
        n_split, rows = KQ.plan_w4a16_splits(k, n, k // qw["scale"].shape[0])
        for m in (1, 8, 16, 64, 128):
            x = randn(m, k)
            check(KQ.W4A16, f"{what} M{m} K{k} N{n} ({n_split} splits of {rows} rows)",
                  lambda: quantized_matmul(x, qw),
                  lambda x: quantized_matmul_plain(x, qw), (x,),
                  (wbytes + 2 * (m * k + m * n), 2 * m * k * n), int4pack_mm(x, qw))
        x = randn(64, k)
        full = quantized_matmul(x, qw)
        for m in (1, 8, 16):
            if not torch.equal(quantized_matmul(x[:m], qw), full[:m]):
                raise AssertionError(f"{KQ.W4A16} {what}: rows of M {m} differ from M 64's")
        print(f"{KQ.W4A16} {what}: rows of M 1 / 8 / 16 equal those of M 64 bit for bit")
    # Edge cases, not timed: the tiny config's widths (K 64 / 128, groups of
    # 32 / 64), a half-full last tile (N % 64 == 32), M 65 and 300 (several
    # M tiles), and M 1 / 16 on layer 13 of a stacked (24, 1024, 6144) qkv
    # weight, read as a view.
    for m, k, n in ((1, 64, 64), (8, 64, 192), (13, 128, 128), (16, 128, 64),
                    (1, 2048, 96), (9, 8192, 2080), (65, 2048, 2048), (300, 512, 256)):
        qw = quantize_weight_torch(fp32(k, n) * k ** -0.5)
        x = randn(m, k)
        check(KQ.W4A16, f"edge M{m} K{k} N{n}", lambda: quantized_matmul(x, qw),
              lambda x: quantized_matmul_plain(x, qw), (x,), timed=False)
    stacked = quantize_weight_torch(fp32(24, 2048, 6144) * 2048 ** -0.5)
    qw = {name: t[13] for name, t in stacked.items()}
    for m in (1, 16):
        x = randn(m, 2048)
        check(KQ.W4A16, f"edge qkv M{m}, layer 13 of a stacked (24, 1024, 6144) view",
              lambda: quantized_matmul(x, qw),
              lambda x: quantized_matmul_plain(x, qw), (x,), timed=False)
    del stacked, qw
    torch.cuda.synchronize()
    return summary


# (label, K, N) of the 2B's text and ViT block linears and the 0.5B ViT's MLP
TEXT_2B = (("qkv", 2048, 6144), ("proj", 2048, 2048), ("fc1", 2048, 8192), ("fc2", 8192, 2048))
VIT_2B = (("qkv", 1152, 3456), ("proj", 1152, 1152), ("fc1", 1152, 4304), ("fc2", 4304, 1152))
VIT_05B = (("fc1", 720, 2690), ("fc2", 2690, 720))


def _int_mm_accepts(m: int, k: int, n: int) -> bool:
    """Whether torch._int_mm takes an (M, K) x (K, N) int8 product on the
    card: M > 16 and K, N multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def phase_w8a8_kernels(gen: torch.Generator) -> dict:
    """The w8a8 kernels (the quantize pass, then kernel S or kernel L)
    against their plain version (`int8_linear_plain`, run on the card on
    the same bf16 inputs) at the main paths' shapes: the 2B text linears at
    M 1 (decode), 8 (lockstep, a pool step, a verify span), 16 (a prompt
    span), 32 and 64 (either side of the kernels' edge), 72 (a pool's
    verify rows), 200, 730 (the image prefill) and 5840 (the lockstep
    prefill of 8 images), the GQA qkv (N 3072), the 2B ViT's linears at M
    9984 (13 crops x 768 rows), static and dynamic, and the 0.5B ViT's MLP
    (K or N 2690) at 2 crops; N(0, 1) rows, some with one outlier channel
    (x 60); edge cases (M 65, K 36 and 100) and rows of rounding ties. The
    bf16 outputs must equal the plain version's bit for bit, except where
    its float64 emulation of the fused multiply-add rounds twice (the
    float64 value an exact fp32 tie), there within 1 bf16 ulp; the count
    of differing outputs is printed. The pass's codes and row scales must
    equal q8_act's / q8_static's (`q8_codes_plain`). Rows of M 1 to 730
    must equal the same rows of M 1024 through every route that takes
    them. Every case is timed (the linear: launch and device only; the
    product kernel and the pass alone: device only) beside its bound
    (bytes, or int8 operations at 1979 TOPS), and torch._int_mm on the same
    codes (the int32 product alone: a yardstick that favours the library)
    wherever it takes the shape. Returns the summaries of the linear
    (headline: the ViT qkv, static) and of the pass."""
    s = {"err": 0.0, "differing": 0, "elements": 0}
    q = {"err": 0.0}

    def weights(k, n, static):
        w = torch.randn(k, n, generator=gen, device=DEV) * k ** -0.5
        codes, scale = quantize_weight_int8(w)
        b = (torch.randn(n, generator=gen, device=DEV) * 0.1).to(BF16)
        inv_a = None
        if static:  # ~25-32 codes per unit: |x| > ~4 clips
            inv_a = torch.zeros(-(-k // 64) * 64, device=DEV)
            inv_a[:k] = 127.0 / (4.0 + torch.rand(k, generator=gen, device=DEV))
        return pack_int8_weight(codes), scale, b, inv_a

    def case(label, m, k, n, static=False, outlier=False, headline=False, ties=False):
        wq, scale, b, inv_a = weights(k, n, static)
        kp = wq.shape[1]
        x = torch.randn(m, k, generator=gen, device=DEV)
        if outlier:
            x[:, k // 3] *= 60.0
        if ties:  # rows of half-integers up to |126.5| and an amax of 127: x / a and
            # x * inv_a (1) sit on or a hair past rounding ties
            x[:] = (torch.arange(k, device=DEV) % 254 - 127).float() + 0.5
            x[:, 0] = 127.0
            if inv_a is not None:
                inv_a[:k] = 1.0
        x = x.to(BF16)
        codes = torch.empty(m, kp, dtype=torch.int8, device=DEV)
        a = None if static else torch.empty(m, device=DEV)
        got = KQ.w8a8_linear(x, wq, scale, b, inv_a, codes, a)
        want = int8_linear_plain(x, wq, scale, b, inv_a)
        diff = got.view(torch.int16) != want.view(torch.int16)
        n_diff = int(diff.sum())
        if n_diff:
            ulps = (got.view(torch.int16)[diff].int() - want.view(torch.int16)[diff].int()).abs()
            y64 = int8_linear_fp64(x, wq, scale, b, inv_a)[diff]
            near = y64.float().double()
            other = 2 * y64 - near  # the other fp32 neighbour when y64 is a tie
            tie = (y64 != near) & (other.float().double() == other)
            if ulps.max().item() > 1 or not tie.all():
                raise AssertionError(f"{KQ.W8A8} {label}: {n_diff} outputs differ, at most "
                                     f"{ulps.max().item()} bf16 ulps, not all double roundings")
        want_codes, want_a = q8_codes_plain(x, inv_a, kp)
        if not torch.equal(codes, want_codes):
            raise AssertionError(f"{KQ.W8A8_QUANTIZE} {label}: activation codes differ")
        if not static and not torch.equal(a, want_a):
            raise AssertionError(f"{KQ.W8A8_QUANTIZE} {label}: row scales differ")
        s["err"] = max(s["err"], (got.float() - want.float()).abs().max().item())
        s["differing"] += n_diff
        s["elements"] += got.numel()
        plan = KQ.plan_w8a8(m, k, n, torch.cuda.get_device_properties(DEV).multi_processor_count)
        run = lambda: int8_linear(x, wq, scale, b, inv_a)
        ms, dev_ms = median_ms(run), graph_ms(run)
        quantize = lambda: KQ.w8a8_quantize(x, inv_a, kp, codes, a)
        pass_ms = graph_ms(quantize)
        product_ms = graph_ms(lambda: KQ.w8a8_linear(x, wq, scale, b, inv_a, plan=plan)) - pass_ms
        extra = [] if inv_a is None else [inv_a]
        bd = bound(_nbytes(x, wq, scale, b, *extra) + 2 * m * n, 2 * m * k * n, PEAK_INT8_OP_S)
        pass_bd = bound(_nbytes(x, codes, *extra) + (0 if static else 4 * m), 0)
        where = (f"kernel S fm {plan.fm} fn {plan.fn} cluster {plan.cs}" if plan.route == "small"
                 else f"kernel L 128x{plan.bn}, {plan.splits} split(s) of K")
        line = (f"{KQ.W8A8} {label} M{m} K{k} N{n} {'static' if static else 'dynamic'}"
                f"{', outlier channel' if outlier else ''} ({where}): {n_diff} of {got.numel()} "
                f"bf16 outputs differ from the plain version's, codes"
                f"{'' if static else ' and row scales'} equal; linear (pass + product) {ms:.4f} "
                f"ms, device only {dev_ms:.4f} ms, bound {bd['bound_ms']:.5f} ms by "
                f"{bd['bound_by']} ({bd['bytes']:.4g} bytes, {bd['flops']:.4g} int8 op; "
                f"{dev_ms / bd['bound_ms']:.1f} x bound); pass alone {pass_ms:.4f} ms (bound "
                f"{pass_bd['bound_ms']:.5f} ms by bytes), product ~{product_ms:.4f} ms")
        lib_ms = lib_dev_ms = None
        if _int_mm_accepts(m, k, n):
            xc, wt = want_codes[:, :k].contiguous(), wq[:, :k].t().contiguous()
            lib = lambda: torch._int_mm(xc, wt)
            acc = (xc.double() @ wt.double()).to(torch.int32)
            if not torch.equal(lib(), acc):
                raise AssertionError(f"{KQ.W8A8}: torch._int_mm disagrees with the int32 product")
            lib_ms, lib_dev_ms = median_ms(lib), graph_ms(lib)
            line += (f"; torch._int_mm on the same codes (product only) device only "
                     f"{lib_dev_ms:.4f} ms, linear {dev_ms / lib_dev_ms:.2f} x library")
        if headline:
            plain_ms = median_ms(lambda: int8_linear_plain(x, wq, scale, b, inv_a), reps=5)
            q_plain_ms = median_ms(lambda: q8_codes_plain(x, inv_a, kp), reps=5)
            line += f"; plain {plain_ms:.4f} ms, the pass's plain {q_plain_ms:.4f} ms"
            s.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms,
                     library_device_ms=lib_dev_ms, **bd)
            q.update(ms=median_ms(quantize), plain_ms=q_plain_ms, library_ms=None,
                     device_ms=pass_ms, library_device_ms=None, **pass_bd)
        print(line)

    for i, (name, k, n) in enumerate(VIT_2B):  # the headline first: the main path's ViT
        case(f"2B ViT {name}", 13 * 768, k, n, static=True, headline=i == 0)
        case(f"2B ViT {name}", 13 * 768, k, n, outlier=name == "qkv")
    for name, k, n in TEXT_2B:
        for m in (1, 8, 16, 32, 64, 72, 200, 730, 5840):
            case(f"2B text {name}", m, k, n, outlier=m == 8)
    for m in (1, 8):
        case("2B GQA qkv", m, 2048, 3072, outlier=m == 1)
    # a row's bits depend only on that row and the weight, whatever M and
    # whichever route: rows of M 1 to 730 through kernel S (M <= 32) and
    # kernel L at either tile width, K split or not, equal the same rows of
    # M 1024, static and dynamic
    checked = 0
    for static in (False, True):
        wq, scale, b, inv_a = weights(2048, 6144, static)
        x = torch.randn(1024, 2048, generator=gen, device=DEV).to(BF16)
        full = int8_linear(x, wq, scale, b, inv_a)
        for m in (1, 8, 16, 32, 64, 65, 72, 200, 730):
            plans = {KQ.plan_w8a8(m, 2048, 6144, route="large", bn=bn) for bn in KQ.LARGE_BNS}
            plans.add(KQ.plan_w8a8(m, 2048, 6144))
            if m <= KQ.SMALL_MAX_M:
                plans.add(KQ.plan_w8a8(m, 2048, 6144, route="small"))
            for plan in plans:
                got = KQ.w8a8_linear(x[:m].clone(), wq, scale, b, inv_a, plan=plan)
                if not torch.equal(got, full[:m]):
                    raise AssertionError(f"{KQ.W8A8}: rows of M {m} through {plan} differ from "
                                         "M 1024's")
                checked += 1
    print(f"{KQ.W8A8} 2B text qkv: rows of M 1 / 8 / 16 / 32 / 64 / 65 / 72 / 200 / 730 equal "
          f"those of M 1024 bit for bit through every route ({checked} plans, static and "
          "dynamic)")
    for name, k, n in VIT_05B:
        case(f"0.5B ViT {name}", 2 * 768, k, n, static=True, outlier=True)
        case(f"0.5B ViT {name}", 2 * 768, k, n)
    for m, k, n, static in ((65, 2048, 96, False), (3, 36, 24, True), (17, 100, 40, False)):
        case("edge", m, k, n, static=static)
    for m, static in ((4, False), (4, True), (200, False), (200, True)):
        case("edge ties", m, 512, 64, static=static, ties=True)
    torch.cuda.synchronize()
    print(f"{KQ.W8A8}: {s['differing']} of {s['elements']} bf16 outputs differ from the plain "
          f"version's over all cases (each a double-rounding tie of its float64 fma, 1 ulp)")
    return {KQ.W8A8: s, KQ.W8A8_QUANTIZE: q}


def phase_small_reference(img: np.ndarray, int4: bool = False, kv_int8: bool = False,
                          n_kv_heads: int = 2, int8: bool = False,
                          variant: str = None) -> None:
    """Tiny config on one set of bf16-valued weights: bf16 on the card (the
    kernels) and bf16 on the CPU (the plain versions), each against fp32 on
    the CPU, as a fraction of the fp32 run's largest magnitude: the KV
    snapshot, the prompt's logits and one decode step's logits. With
    `int4`, every run quantizes the text blocks to int4 from those weights
    (the same codes on both devices, checked); with `kv_int8` the KV cache
    is int8 and its snapshot is compared dequantized; `n_kv_heads` 1 is GQA
    (one KV head for the two query heads). With `int8`, every run quantizes
    the text blocks to int8 w8a8 and the ViT blocks to static int8 with one
    set of activation statistics (the fp32 CPU model's, over the image's
    normalized crops), the same codes on both devices, checked. With
    `variant` (a bf16-valued adapter file at the tiny widths), every run
    encodes, prefills and decodes under that LoRA variant."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, kv_int8=kv_int8, n_kv_heads=n_kv_heads))
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    state = {n: t.to(BF16).float() for n, t in state.items()}
    tmpl = list(cfg.tokenizer.templates["caption"]["normal"])
    stats = None
    if int8:
        params = build_params(cfg, "cpu", torch.float32)
        params.load_state_dict(state)
        stats = collect_vision_act_stats(
            normalized_crops(MoondreamModel(cfg, params, ByteTokenizer(), torch.float32,
                                            device="cpu"), [img]), params["vision"])

    def run(device, dtype) -> dict:
        params = build_params(cfg, device, dtype)
        params.load_state_dict(state)
        if int4:
            quantize_text_params(params["text"])
        if int8:
            quantize_text_params_int8(params["text"])
            quantize_vision_params(params["vision"], stats)
        m = MoondreamModel(cfg, params, ByteTokenizer(), dtype, device=device)
        s = None if variant is None else {"variant": variant}
        lora = m._variant(s)
        enc = m.encode_image(img, settings=s)
        kv = m.load_encoded_image(enc)
        logits, _, _, pos, kv = m._prefill_prompt(kv, tmpl, enc.pos, 0.0, 0.0, lora=lora)
        emb = text_encoder(torch.tensor([[300]], device=device), m.text)
        step = decode_step(m.text, kv, emb, pos, m._decode_bound(pos + 8), lora=lora)[0]
        out = {"logits": logits, "decode logits": step}
        if int8:
            out["codes"] = torch.cat([t.flatten().cpu() for b in params["text"].blocks
                                      for t in (b.qkv.wq, b.mlp.fc2.wq)]
                                     + [b.qkv.wq.flatten().cpu() for b in params["vision"].blocks])
        if not kv_int8:
            return {"k": enc.k, "v": enc.v, **out}
        out.update(k=dequantize_kv(enc.k, enc.ks, torch.float32),
                   v=dequantize_kv(enc.v, enc.vs, torch.float32))
        if int4:
            out["codes"] = torch.cat([b.mlp.fc1.packed.flatten().cpu()
                                      for b in params["text"].blocks])
        return out

    ref = run("cpu", torch.float32)
    codes = ref.pop("codes", None)

    def rel(out) -> dict:
        if codes is not None and not torch.equal(out.pop("codes"), codes):
            raise AssertionError("int4 / int8 codes differ from the fp32 CPU run's")
        return {n: ((out[n].float().cpu() - ref[n]).abs().max()
                    / ref[n].abs().max()).item() for n in ref}

    card, cpu = rel(run(DEV, BF16)), rel(run("cpu", BF16))
    r5 = lambda d: {n: round(e, 5) for n, e in d.items()}
    what = " + ".join(["GQA"] * (n_kv_heads == 1) + ["int4 text blocks"] * int4
                      + ["int8 text blocks + static int8 ViT"] * int8
                      + ["int8 KV cache" if kv_int8 else "bf16"]
                      + ["a rank 4 LoRA variant"] * (variant is not None))
    print(f"small reference (tiny config, {what}, vs fp32 on the cpu), rel max err: "
          f"card bf16 {r5(card)}, cpu bf16 {r5(cpu)}, tol {SMALL_REF_FACTOR} x cpu bf16")
    if not all(card[n] <= SMALL_REF_FACTOR * cpu[n] for n in ref):
        raise AssertionError(f"tiny-config reference mismatch: {card} vs {cpu}")


def phase_batch_reference(images: list, n_kv_heads: int = 2) -> None:
    """The lockstep batches' device work on the tiny config, on one set of
    bf16-valued weights: `encode_images` over the images (one ViT group per
    size), ONE batched prompt prefill (the caption template, a span of 8,
    then the query prompt, a span of 16) and one lockstep decode step with
    another token per row. bf16 on the card (kernel B at batch > 1; under
    GQA, `n_kv_heads` 1, kernel A for the spans and B's GQA entry for the
    step) and bf16 on the CPU (the plain versions) are each held against
    fp32 on the CPU as phase_small_reference holds them: KV snapshots,
    prompt logits and decode logits of every row."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, n_kv_heads=n_kv_heads))
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    state = {n: t.to(BF16).float() for n, t in state.items()}
    tmpl = cfg.tokenizer.templates
    tokens = [[300], [17], [5], [411]][:len(images)]
    spans = {}

    def run(device, dtype) -> dict:
        params = build_params(cfg, device, dtype)
        params.load_state_dict(state)
        m = MoondreamModel(cfg, params, ByteTokenizer(), dtype, device=device)
        encs = m.encode_images(images)
        out = {"k": torch.cat([e.k for e in encs], 1), "v": torch.cat([e.v for e in encs], 1)}
        for task, ids in (("caption", list(tmpl["caption"]["normal"])),
                          ("query", list(tmpl["query"]["prefix"]) + m._encode_text(POOL_QUESTION)
                           + list(tmpl["query"]["suffix"]))):
            logits, _, kv, pos, length, bound = m._batched_prompt_prefill(
                encs, ids, {}, lambda pos, length, pad: pos + pad + 8 + 1)
            spans[task] = kv.k.shape[1], pos, length
            emb = text_encoder(torch.tensor(tokens, device=device), m.text)
            step = decode_step_batched(m.text, kv, emb, pos + length, bound)[0]
            m._recycle_kv(kv)
            out.update({f"{task} logits": logits, f"{task} decode logits": step})
        return out

    ref = run("cpu", torch.float32)
    rel = lambda out: {n: ((out[n].float().cpu() - ref[n]).abs().max()
                           / ref[n].abs().max()).item() for n in ref}
    card, cpu = rel(run(DEV, BF16)), rel(run("cpu", BF16))
    r5 = lambda d: {n: round(e, 5) for n, e in d.items()}
    what = "GQA" if n_kv_heads == 1 else "MHA"
    print(f"batch reference (tiny config, {what} bf16, {len(images)} images, (rows, pos, "
          f"prompt length) {spans}, vs fp32 on the cpu), rel max err: card bf16 {r5(card)}, "
          f"cpu bf16 {r5(cpu)}, tol {SMALL_REF_FACTOR} x cpu bf16")
    if not all(card[n] <= SMALL_REF_FACTOR * cpu[n] for n in ref):
        raise AssertionError(f"tiny-config batch reference mismatch: {card} vs {cpu}")


def phase_serving_reference() -> None:
    """One serving-pool decode step (`ragged_decode_step`) of the tiny config
    over 4 slots at distinct positions, on seeded caches: plain, then with a
    shared prefix segment. The logits of bf16 on the card (kernel C) and of
    bf16 on the CPU (its plain version) are each held against fp32 on the
    CPU, same weights and caches, as phase_small_reference holds them."""
    cfg = tiny_test_config()
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    state = {n: t.to(BF16).float() for n, t in state.items()}
    gen = torch.Generator().manual_seed(SEED + 1)
    tc = cfg.text
    cache = lambda n, t: [torch.randn(tc.n_layers, n, tc.n_heads, t, tc.head_dim,
                                      generator=gen).to(BF16).float() for _ in range(2)]
    tokens = torch.tensor([5, 300, 17, 400], dtype=torch.int32)
    cases = {
        "plain": (cache(4, 1024), None, [0, 731, 850, 1000], None, 0),
        "prefix-shared": (cache(4, 384), cache(2, 768), [731, 760, 900, 1020], [1, 0, 1, 0], 730),
    }
    for label, (kv, pref, pos, pids, prefix_len) in cases.items():
        def run(device, dtype) -> torch.Tensor:
            params = build_params(cfg, device, dtype)
            params.load_state_dict(state)
            to = lambda ts: KVCache(*(t.to(device, dtype) for t in ts))
            return ragged_decode_step(
                params["text"], to(kv), tokens.to(device),
                torch.tensor(pos, dtype=torch.int32, device=device), None,
                None if pref is None else to(pref),
                None if pids is None else torch.tensor(pids, dtype=torch.int32, device=device),
                prefix_len,
            ).float().cpu()

        ref = run("cpu", torch.float32)
        rel = lambda x: ((x - ref).abs().max() / ref.abs().max()).item()
        card_err, cpu_err = rel(run(DEV, BF16)), rel(run("cpu", BF16))
        print(f"serving reference (tiny config, one {label} pool step, slots at {pos}), "
              f"logits rel max err vs fp32 on the cpu: card bf16 {card_err:.5f}, "
              f"cpu bf16 {cpu_err:.5f}, tol {SMALL_REF_FACTOR} x cpu bf16")
        if not card_err <= SMALL_REF_FACTOR * cpu_err:
            raise AssertionError(f"{label} pool step: {card_err} vs cpu bf16 {cpu_err}")


def sync_ms(t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def linear_kinds(model) -> dict:
    """The block linears' runtime formats, as expected_launches takes them."""
    text, vit = type(model.text.blocks[0].qkv), type(model.vision.blocks[0].qkv)
    return {"int4": text is Int4Linear, "int8": text is Int8Linear, "int8_vit": vit is Int8Linear}


def format_label(model) -> str:
    """int4 / int8 text blocks, the int8 ViT's kind, the KV cache and heads."""
    k, cfg = linear_kinds(model), model.config
    vit = ("static int8 ViT" if model.vision.blocks[0].qkv.inv_a is not None
           else "dynamic int8 ViT") if k["int8_vit"] else None
    return (" + ".join(["int4"] * k["int4"] + ["int8"] * k["int8"] + [vit] * bool(vit)
                       + ["kv_int8" if cfg.text.kv_int8 else "bf16"])
            + f", {cfg.text.n_kv_heads} KV heads")


def normalized_crops(model, images) -> torch.Tensor:
    """The crops of `images` on the model's device, normalized to [-1, 1] as
    the runtime feeds the ViT: what static int8 calibration must see."""
    crops = np.concatenate([model._crops(im)[0] for im in images])
    return normalize_crops(torch.from_numpy(crops).to(model.device), model.dtype)


def expected_launches(cfg, n_vit: int, spans: int, steps: int, int4: bool = False,
                      batch_prefill: bool = False, long_spans: int = 0,
                      prefills: int = None, int8: bool = False,
                      int8_vit: bool = False) -> dict:
    """Exact launch counts of a path: `n_vit` ViT calls (kernel A per
    vision block), `prefills` [BOS, image] prefills (kernel A per text
    block; by default one when the path encodes, or one batched), `spans`
    prompt prefills of <= 16 rows, `long_spans` of 17 to 1024 rows and
    `steps` decode steps (the decode loops run whole runs of
    DONE_CHECK_EVERY steps: `batched_steps`). Long spans take kernel A;
    short ones kernel B under MHA and kernel A (heads repeated) under GQA;
    decode steps take kernel B (bf16 or int8 entry) under MHA and kernel B's
    GQA entries under GQA (the stacked one, or the single-layer one over the
    dequantized int8 layer). int4 blocks add four W4A16 launches per layer
    per span or step (the prefills' 730 rows take a dense product); int8
    text blocks four w8a8 launches per layer per prefill, span or step, and
    int8 ViT blocks four per ViT block per ViT call."""
    tc = cfg.text
    L_txt, mha = tc.n_layers, tc.n_kv_heads == tc.n_heads
    if prefills is None:
        prefills = int(n_vit > 0 or batch_prefill)
    want = {name: 0 for name in LAUNCHES}
    want[K.FLASH] = n_vit * cfg.vision.enc_n_layers + L_txt * (prefills + long_spans)
    if mha:
        want[K.DECODE_INT8 if tc.kv_int8 else K.DECODE] = L_txt * (spans + steps)
    else:
        want[K.FLASH] += L_txt * spans
        want[K.DECODE_GQA_LAYER if tc.kv_int8 else K.DECODE_GQA] = L_txt * steps
    if int4:
        want[KQ.W4A16] = 4 * L_txt * (spans + long_spans + steps)
    if int8:
        want[KQ.W8A8] += 4 * L_txt * (prefills + spans + long_spans + steps)
    if int8_vit:
        want[KQ.W8A8] += 4 * cfg.vision.enc_n_layers * n_vit
    want[KQ.W8A8_QUANTIZE] = want[KQ.W8A8]  # every w8a8 linear runs the pass first
    return want


def check_launches(label: str, launches: dict, want: dict) -> None:
    print(f"{label} launches:", launches, "expected:", want)
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches} != {want}")


def phase_main_path(img: np.ndarray, power: str, cfg=MOONDREAM_2B, int4: bool = False,
                    params=None) -> tuple:
    """The 2B caption and query paths through the entry points, on `cfg`
    (its kv_int8 and n_kv_heads choose the cache and MHA or GQA). `int4`:
    seeded weights with the text blocks quantized to int4 on the card;
    `params`: reuse a model's parameters (int8 text or ViT blocks among
    them are counted as such). Returns (launch counts of the caption run,
    of the query run), the model."""
    L_txt = cfg.text.n_layers
    kv_int8 = cfg.text.kv_int8
    graphs.reset_graph_counts()  # phase_graphs prints this model's captures
    t0 = time.perf_counter()
    if int4:
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV, BF16)
        lins = lambda: [lin for b in params["text"].blocks
                        for lin in (b.qkv, b.proj, b.mlp.fc1, b.mlp.fc2)]
        dense_bytes = _nbytes(*(lin.w for lin in lins()))
        quantize_text_params(params["text"])
        packed_bytes = _nbytes(*(t for lin in lins() for t in (lin.packed, lin.scale, lin.zero)))
    model = MoondreamModel(cfg, params, ByteTokenizer(), BF16, seed=SEED, device=DEV)
    size = "0.5B" if cfg == MOONDREAM_05B else "2B"
    label, kinds = format_label(model), linear_kinds(model)
    print(f"{size} model ({label}) on the card: {sync_ms(t0):.1f} ms")
    greedy = {"temperature": 0.0, "max_tokens": 64}

    # The counted run: one encode and one caption through the entry points.
    reset_launch_counts()
    t0 = time.perf_counter()
    enc = model.encode_image(img)
    cold_encode_ms = sync_ms(t0)
    text = model.caption(enc, "normal", settings=greedy)["caption"]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    snap = (L_txt, 1, cfg.text.n_kv_heads, 730, cfg.text.head_dim)
    if enc.pos != 730 or tuple(enc.k.shape) != snap:
        raise AssertionError(f"snapshot shape {tuple(enc.k.shape)}")
    kv_dtype = torch.int8 if kv_int8 else BF16
    if enc.k.dtype != kv_dtype or (enc.ks is not None) != kv_int8:
        raise AssertionError(f"snapshot dtype {enc.k.dtype}, scales {enc.ks is not None}")
    values = (enc.k, enc.v) if not kv_int8 else (enc.ks, enc.vs)
    if not all(torch.isfinite(t).all() for t in values):
        raise AssertionError("non-finite KV snapshot")

    # Timed runs of the phases, twice: greedy ids must repeat exactly.
    t0 = time.perf_counter()
    model.encode_image(img)
    encode_ms = sync_ms(t0)
    tmpl = list(cfg.tokenizer.templates["caption"]["normal"])
    runs = []
    for _ in range(2):
        kv = model.load_encoded_image(enc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, first, pos, _ = model._prefill_prompt(kv, tmpl, enc.pos, 0.0, 0.0)
        prefill_ms = sync_ms(t0)
        if logits.shape != (cfg.text.vocab_size,) or not torch.isfinite(logits).all():
            raise AssertionError("bad prompt logits")
        t0 = time.perf_counter()
        ids = model._generate_answer_tokens(kv, first, pos, greedy)
        decode_s = sync_ms(t0) / 1e3
        runs.append((ids, prefill_ms, len(ids) / decode_s))
    ids = runs[0][0]
    if runs[1][0] != ids or not ids:
        raise AssertionError("greedy ids differ between runs")
    if not all(0 <= i < cfg.text.vocab_size for i in ids):
        raise AssertionError("token id out of range")
    if "".join(stream_text(ids, model._decode_tokens)) != text:
        raise AssertionError("entry-point caption differs from the timed run")
    # the decode steps (emitted tokens rounded up to a whole run of
    # DONE_CHECK_EVERY, at most the limit), each through every text layer;
    # the 730-row image prefill's linears take the dense route (M >= 512)
    steps = batched_steps(len(ids), greedy["max_tokens"])
    check_launches(f"main path ({label}), {len(ids)} tokens, {steps} steps", launches,
                   expected_launches(cfg, 1, 1, steps, **kinds))
    if model.caption(enc, "normal", settings=greedy)["caption"] != text:
        raise AssertionError("second greedy caption differs")
    streamed = "".join(model.caption(enc, "normal", stream=True, settings=greedy)["caption"])
    if streamed != text:
        raise AssertionError("streamed caption differs from the plain one")
    sampled = model.caption(enc, "normal", settings={"max_tokens": 64})["caption"]
    if not isinstance(sampled, str):
        raise AssertionError("sampled caption failed")

    # One query on the encoded image, counted: a 15-token prompt span.
    model.tokenizer = IdTokenizer()
    reset_launch_counts()
    t0 = time.perf_counter()
    answer = _ids(model.query(enc, POOL_QUESTION, settings=greedy)["answer"])
    query_ms = sync_ms(t0)
    query_launches = dict(LAUNCHES)
    steps = batched_steps(len(answer), greedy["max_tokens"])
    check_launches(f"query ({label}), {len(answer)} tokens, {steps} steps", query_launches,
                   expected_launches(cfg, 0, 1, steps, **kinds))
    streamed = "".join(model.query(enc, POOL_QUESTION, stream=True, settings=greedy)["answer"])
    if _ids(streamed) != answer:
        raise AssertionError("streamed answer differs from the plain one")

    prefill_ms = min(r[1] for r in runs)
    tok_s = max(r[2] for r in runs)
    print(f"{size} caption path ({label}) on {power}: encode {encode_ms:.1f} ms "
          f"(cold {cold_encode_ms:.1f} ms), prompt prefill {prefill_ms:.2f} ms, "
          f"decode {tok_s:.1f} tok/s over {len(runs[0][0])} tokens "
          f"(greedy, batch 1, {len(model._crops(img)[0])} crops); one query {query_ms:.1f} ms "
          f"({len(answer)} tokens, encoded image)")
    kv = model.load_encoded_image(enc)
    if int4:
        print(f"bytes: text block linears int4 {packed_bytes} (packed + scale/zero) "
              f"vs bf16 {dense_bytes}")
    if kinds["int8"]:
        lins = [t for b in model.text.blocks for lin in (b.qkv, b.proj, b.mlp.fc1, b.mlp.fc2)
                for t in (lin.wq, lin.scale)]
        print(f"bytes: text block linears int8 {_nbytes(*lins)} (codes + scales)")
    print(f"bytes: KV cache ({label}) "
          f"{_nbytes(*(t for t in (kv.k, kv.v, kv.ks, kv.vs) if t is not None))}")
    model._recycle_kv(kv)
    return (launches, query_launches), model


def phase_int8_main_path(img: np.ndarray, images: list, power: str) -> tuple:
    """The 2B (published widths, full depth) with int8 w8a8 text blocks and a
    statically calibrated int8 ViT, on seeded random weights quantized on
    the card: the ViT is calibrated (collect_vision_act_stats) on the
    normalized crops of the smoke's own images, and a copy of it is
    quantized with dynamic activation codes. Then phase_main_path's caption
    and query with exact launch counts (w8a8: 96 per decode token, span or
    image prefill, 108 per ViT call). Returns (launch counts of the caption
    run, of the query run), the model and its three ViTs by name."""
    t0 = time.perf_counter()
    params = init_params(MOONDREAM_2B, torch.Generator(device=DEV).manual_seed(SEED), DEV, BF16)
    dense_bytes = _nbytes(*(lin.w for b in params["text"].blocks
                            for lin in (b.qkv, b.proj, b.mlp.fc1, b.mlp.fc2)))
    quantize_text_params_int8(params["text"])
    probe = MoondreamModel(MOONDREAM_2B, params, ByteTokenizer(), BF16, seed=SEED, device=DEV)
    vits = {"bf16": params["vision"], "dynamic": copy.deepcopy(params["vision"]),
            "static": copy.deepcopy(params["vision"])}
    crops = normalized_crops(probe, [img, *images])
    stats = collect_vision_act_stats(crops, vits["static"])
    quantize_vision_params(vits["dynamic"])
    quantize_vision_params(vits["static"], stats)
    params["vision"] = vits["static"]
    del probe
    print(f"2B int8 weights on the card: text quantized, ViT calibrated on {crops.shape[0]} "
          f"normalized crops ({crops.shape[0] // 16 * 16} used, chunks of 16) and quantized "
          f"static and dynamic: {sync_ms(t0):.1f} ms; text block linears bf16 {dense_bytes} "
          f"bytes")
    launches, model = phase_main_path(img, power, MOONDREAM_2B, params=params)
    return launches, model, vits


def phase_int8_encode(model, img: np.ndarray, vits: dict, power: str) -> None:
    """encode_image with the static int8, the dynamic int8 and the bf16 ViT
    of one set of weights, in turns (static, dynamic, bf16, bf16, dynamic,
    static, twice over), each counted (w8a8: 108 launches per ViT call with
    an int8 ViT, 96 for the int8 text blocks' image prefill). Prints the
    median encode ms of each and the int8 ViTs' agreement with bf16 (the
    smallest cosine similarity of a token's features)."""
    cfg = model.config
    x = normalized_crops(model, [img])
    feats, times = {}, {name: [] for name in vits}
    for name in ("static", "dynamic", "bf16", "bf16", "dynamic", "static") * 2:
        model.params["vision"] = vits[name]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        model.encode_image(img)
        times[name].append(sync_ms(t0))
        check_launches(f"encode_image ({name} ViT, int8 text)", dict(LAUNCHES),
                       expected_launches(cfg, 1, 0, 0, int8=True, int8_vit=name != "bf16"))
        if name not in feats:
            feats[name] = vision_encoder(x, vits[name]).float()
    model.params["vision"] = vits["static"]
    cos = {name: torch.nn.functional.cosine_similarity(feats[name], feats["bf16"], dim=-1)
           .min().item() for name in ("static", "dynamic")}
    if not all(math.isfinite(c) and c > 0.9 for c in cos.values()):
        raise AssertionError(f"int8 ViT features far from bf16's: {cos}")
    ms = {name: statistics.median(t) for name, t in times.items()}
    print(f"2B encode_image (int8 text, 13 crops) on {power}, median of 4 in turns: static int8 "
          f"ViT {ms['static']:.1f} ms, dynamic int8 ViT {ms['dynamic']:.1f} ms, bf16 ViT "
          f"{ms['bf16']:.1f} ms; ViT features vs bf16, smallest token cosine: static "
          f"{cos['static']:.5f}, dynamic {cos['dynamic']:.5f}")


class IdTokenizer(ByteTokenizer):
    """ByteTokenizer whose decode renders every id as `<id>`: a pool's
    result strings then carry the exact ids."""

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _ids(text: str) -> list:
    return [int(t) for t in text[1:-1].split("><")] if text else []


POOL_QUESTION = "What is it?"  # 15 prompt tokens: a span for kernel B
# (image, question) of the 8 requests: captions and queries over 3 images
POOL_REQUESTS = [(0, None), (1, None), (2, POOL_QUESTION), (0, POOL_QUESTION),
                 (1, None), (2, None), (0, None), (1, POOL_QUESTION)]
POOL_TOKENS = 48


def _variant_settings(trees, name):
    """The encode settings of a pool request under variant `name`."""
    return None if name is None else {"variant_tree": trees[name], "variant_label": name}


def _pool_run(model, images, kind: dict, sync_check: bool = False, variants=None,
              rows=None) -> dict:
    """Encode the images, then serve POOL_REQUESTS through one pool: four
    admitted at once, the other four one per step, then drain. Returns the
    results with counts and timings. With `sync_check`, two chunks are
    dispatched under torch.cuda.set_sync_debug_mode("error") right after
    the first four admissions (in a graphed pool the first captures the
    chunk's CUDA graph and the second replays it). `variants` ({name:
    adapter tree}) and `rows` (a variant name or None per request): a
    multi-variant pool, each request encoded and served under its own
    variant; one encode per (image, variant) ("encs_by": that dict,
    "encs": the base encodes by image)."""
    rows = rows or [None] * len(POOL_REQUESTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encs_by = {}
    for (img, _), name in zip(POOL_REQUESTS, rows):
        if (img, name) not in encs_by:
            encs_by[img, name] = model.encode_image(images[img],
                                                    settings=_variant_settings(variants, name))
    encs = [encs_by.get((i, None)) for i in range(len(images))]
    encode_ms = sync_ms(t0)
    eng = ContinuousBatchingEngine(model, n_slots=8, slot_len=1024, chunk=8,
                                   eos_id=-1, variants=variants, **kind)
    chunks, step_ms, admit_ms = [0], [], []
    dispatch = eng._dispatch_chunk

    def counted_dispatch():
        chunks[0] += 1
        dispatch()

    eng._dispatch_chunk = counted_dispatch

    def submit(i):
        img, question = POOL_REQUESTS[i]
        t0 = time.perf_counter()
        rid = eng.submit(encs_by[img, rows[i]], question=question, max_tokens=POOL_TOKENS,
                         variant=rows[i])
        admit_ms.append(sync_ms(t0))
        return rid

    def step():
        t0 = time.perf_counter()
        eng.step()
        step_ms.append(sync_ms(t0))

    rids = [submit(i) for i in range(4)]
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._dispatch_chunk()
            eng._dispatch_chunk()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for i in range(4, len(POOL_REQUESTS)):
        step()
        rids.append(submit(i))
    entries = len(eng._pref_pid_of) if eng.prefix_share else None
    while any(s.active for s in eng.slots) or eng._inflight:
        step()
    out = [_ids(eng.results[r]) for r in rids]
    if [len(ids) for ids in out] != [POOL_TOKENS] * len(rids):
        raise AssertionError(f"pool token counts {[len(ids) for ids in out]}")
    if eng.prefix_share and any(eng._pref_refs):
        raise AssertionError(f"prefix refcounts not released: {eng._pref_refs}")
    nbytes = lambda kv: _nbytes(*(t for t in (kv.k, kv.v, kv.ks, kv.vs) if t is not None))
    slots_bytes = nbytes(eng.kv)
    pref_bytes = nbytes(eng.kv_pref) if eng.prefix_share else 0
    return {"out": out, "chunks": chunks[0], "entries": entries, "encode_ms": encode_ms,
            "step_ms": step_ms, "admit_ms": admit_ms, "encs": encs, "encs_by": encs_by,
            "engine": eng,
            "cache_bytes": slots_bytes + pref_bytes,
            "plain_bytes": slots_bytes * eng.slot_len // eng.kv.k.shape[3]}


def phase_pool(model, images, power: str, label: str, **kind) -> dict:
    """One 2B continuous-batching pool (n_slots 8, slot_len 1024, chunk 8,
    greedy, eos -1 so every request decodes POOL_TOKENS tokens) driven
    through the engine's entry points. The counted run checks exact launch
    counts and one prefix entry per image, and is timed; a second run
    checks no host sync inside a chunk and identical ids. Where a request's
    ids differ from batch-1's, batch-1's logit margin there is printed."""
    cfg, kinds = model.config, linear_kinds(model)
    L_txt, L_vit, kv8 = cfg.text.n_layers, cfg.vision.enc_n_layers, cfg.text.kv_int8
    model.tokenizer = IdTokenizer()
    reset_launch_counts()
    run = _pool_run(model, images, kind)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    n_req, n_img = len(POOL_REQUESTS), len(images)
    want = {name: 0 for name in LAUNCHES}
    want[K.FLASH] = n_img * (L_vit + L_txt)  # each encode: ViT + image prefill
    want[K.DECODE_INT8 if kv8 else K.DECODE] = n_req * L_txt  # prompts
    want[K.RAGGED_INT8 if kv8 else K.RAGGED] = L_txt * 8 * run["chunks"]
    if kinds["int4"]:  # the image prefills' 730 rows take a dense product
        want[KQ.W4A16] = 4 * L_txt * (n_req + 8 * run["chunks"])
    if kinds["int8"]:
        want[KQ.W8A8] += 4 * L_txt * (n_img + n_req + 8 * run["chunks"])
    if kinds["int8_vit"]:
        want[KQ.W8A8] += 4 * L_vit * n_img
    want[KQ.W8A8_QUANTIZE] = want[KQ.W8A8]
    check_launches(f"pool {label}, {run['chunks']} chunks", launches, want)
    if kind.get("prefix_share") and run["entries"] != n_img:
        raise AssertionError(f"{run['entries']} prefix entries for {n_img} images")

    again = _pool_run(model, images, kind, sync_check=True)
    if again["out"] != run["out"]:
        raise AssertionError(f"pool {label}: ids differ between two runs")
    # timings from the counted run: the checked run's extra chunk delays
    # every later read-back by one chunk, as pipeline depth 2 would
    tokens = n_req * POOL_TOKENS
    decode_s = sum(run["step_ms"]) / 1e3
    print(f"2B pool {label} on {power}: {tokens / decode_s:.1f} tok/s decode "
          f"({tokens} tokens in {run['chunks']} chunks of 8 steps x 8 slots, "
          f"{sum(run['step_ms']) / run['chunks']:.2f} ms per chunk, token read-back "
          f"included), admission {statistics.median(run['admit_ms']):.2f} ms median "
          f"(prompt prefill + slot write), encode of {n_img} images "
          f"{run['encode_ms']:.1f} ms; KV cache bytes {run['cache_bytes']} "
          f"(a plain pool of these slots: {run['plain_bytes']})")

    # agreement with batch-1 decoding of the same prompts (printed only:
    # cuBLAS reduces in another order at M = 1 than at M = 8); where a
    # request differs, batch-1's logit margin at the first differing token
    agree, margins = [], []
    refs = _batch1_refs(model, again["encs"], POOL_REQUESTS, POOL_TOKENS)
    for (enc, prompt, ids), pool_ids in zip(refs, again["out"]):
        n = next((i for i, (a, b) in enumerate(zip(pool_ids, ids)) if a != b),
                 min(len(pool_ids), len(ids)))
        agree.append(n)
        if n < min(len(pool_ids), len(ids)):
            margins.append(first_difference_margin(model, enc, prompt, ids, pool_ids, n,
                                                   POOL_TOKENS, slots=1024))
    print(f"pool {label} vs batch-1 greedy: matching prefix (tokens of {POOL_TOKENS}) "
          f"per request {agree}" + (
              f"; at the first differing token batch-1's logit margin over the pool's "
              f"pick is {[m[0] for m in margins]}, {[m[1] for m in margins]} bf16 steps "
              f"of its logit" if margins else ""))
    return launches


def first_difference_margin(model, enc, prompt, single, other, n, max_tokens,
                            slots=None, lora=None, decode_lora=None, steer=None) -> tuple:
    """Batch-1 greedy ids `single` and another run's `other` first differ
    at token n: step batch-1 again up to token n (the prompt under the
    adapter `lora` when given, the decode steps under `decode_lora`, by
    default `lora`; every forward under the steering vector `steer` when
    given) and return its logit margin there (its pick minus the other's;
    EOS past a row's end) and that margin in bf16 steps (ulps) of its
    pick's logit. A near tie is a few steps; a run that read the wrong
    weights or cache is far more."""
    eos = model.config.tokenizer.eos_id
    pick = lambda r: r[n] if n < len(r) else eos
    decode_lora = lora if decode_lora is None else decode_lora
    logits, _, _, pos, kv = model._prefill_prompt(
        model.load_encoded_image(enc, slots=slots), prompt, enc.pos, 0.0, 0.0, lora=lora,
        steer=steer)
    bound = model._decode_bound(pos + max_tokens + 1)
    for i in range(n):
        emb = text_encoder(torch.tensor([[single[i]]], device=DEV), model.text)
        logits = decode_step(model.text, kv, emb, pos + i, bound, decode_lora, steer)[0]
    logits = logits.reshape(-1).float()
    model._recycle_kv(kv)
    margin = (logits[pick(single)] - logits[pick(other)]).item()
    top = abs(logits[pick(single)].item())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0 ** -133
    return round(margin, 4), round(margin / ulp, 2)


def phase_batch(model, images, power: str) -> list:
    """Lockstep batches on a 2B model through the entry points: caption_batch
    and query_batch over the images (three sizes: encode_images forms one
    ViT group per (crop count, tiling)), each a counted run with exact
    launch counts; then the caption batch timed phase by phase (encode,
    batched prompt prefill, lockstep decode), its greedy ids repeated, and
    each row against batch-1 `caption` of the same image (printed)."""
    cfg = model.config
    tc = cfg.text
    label = f"2B bf16, {tc.n_kv_heads} KV heads"
    model.tokenizer = IdTokenizer()
    greedy = {"temperature": 0.0, "max_tokens": 64}
    n_img = len(images)
    n_groups = len({(crops.shape[0], tiling) for crops, tiling in map(model._crops, images)})
    runs, batch_ids = [], {}
    for task in ("caption", "query"):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if task == "caption":
            texts = model.caption_batch(images, "normal", settings=greedy)
        else:
            texts = model.query_batch(images, POOL_QUESTION, settings=greedy)
        ms = sync_ms(t0)
        launches = dict(LAUNCHES)
        ids = [_ids(t) for t in texts]
        steps = batched_steps(max(len(r) for r in ids), greedy["max_tokens"])
        check_launches(f"{task}_batch ({label}), {n_img} images in {n_groups} ViT groups, "
                       f"{steps} lockstep steps", launches,
                       expected_launches(cfg, n_groups, 1, steps, batch_prefill=True))
        if len(ids) != n_img or not all(0 <= i < tc.vocab_size for r in ids for i in r):
            raise AssertionError(f"{task}_batch: bad ids")
        print(f"2B {task}_batch ({label}) on {power}: {n_img / (ms / 1e3):.2f} images/s, "
              f"{ms:.1f} ms per batch of {n_img} from images (crops, ViT, prefill, "
              f"decode), tokens per row {[len(r) for r in ids]}")
        runs.append(launches)
        batch_ids[task] = ids

    # The caption batch by phases, from the images again.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encs = model.encode_images(images)
    encode_ms = sync_ms(t0)
    tmpl = list(cfg.tokenizer.templates["caption"]["normal"])
    t0 = time.perf_counter()
    logits, _, kv, pos, length, kv_bound = model._batched_prompt_prefill(
        encs, tmpl, greedy, lambda pos, length, pad: pos + pad + 64 + 1)
    prefill_ms = sync_ms(t0)
    t0 = time.perf_counter()
    first = sample_tokens_batched(logits, model.generator, 0.0, 0.0)
    res = generate_text_batched(model.text, kv, first, pos + length, model.generator, 0.0,
                                0.0, 64, cfg.tokenizer.eos_id, (cfg.tokenizer.answer_id,),
                                kv_bound)
    counts = res.counts.tolist()
    decode_s = sync_ms(t0) / 1e3
    model._recycle_kv(kv)
    again = [row[:n] for row, n in zip(res.tokens.tolist(), counts)]
    if again != batch_ids["caption"]:
        raise AssertionError("caption batch ids differ between two runs")
    steps = res.pos - pos - length
    print(f"2B caption_batch ({label}) by phase on {power}: encode_images {encode_ms:.1f} ms "
          f"({n_img / (encode_ms / 1e3):.2f} images/s), batched prompt prefill "
          f"{prefill_ms:.2f} ms, lockstep decode {sum(counts) / decode_s:.1f} tok/s "
          f"({sum(counts)} tokens, {steps} steps x {n_img} rows, "
          f"{decode_s * 1e3 / max(steps, 1):.2f} ms per step)")

    # Batch-1 captions of the same images on the card (printed: cuBLAS sums
    # M = 8 and M = 1 in another order, so near ties may flip). Where a row
    # differs, batch-1 is stepped again up to the first differing token and
    # its logit margin there (its pick minus the batch row's) is printed:
    # a near tie has a margin of a few bf16 steps of the logits; a row that
    # read another row's cache would differ from its first token on.
    same, first, margin = 0, [], []
    for enc, row in zip(encs, batch_ids["caption"]):
        single = _ids(model.caption(enc, "normal", settings=greedy)["caption"])
        same += single == row
        if single == row:
            continue
        n = next((i for i, (a, b) in enumerate(zip(single, row)) if a != b),
                 min(len(single), len(row)))
        first.append(n)
        margin.append(first_difference_margin(model, enc, tmpl, single, row, n,
                                              greedy["max_tokens"]))
    print(f"caption_batch ({label}) vs batch-1 caption: {same} of {n_img} rows "
          "have equal greedy ids" + (
              f"; the others first differ at token {first}, where batch-1's logit "
              f"margin over the batch row's pick is {[m[0] for m in margin]} "
              f"({[m[1] for m in margin]} bf16 steps of its logit)" if first else ""))
    return runs


# Settings of the structured paths: the gaze face box, the spatial refs (a
# point and a box: a 20-row query prompt) and greedy 64-token answers.
FACE = {"x_min": 0.35, "x_max": 0.55, "y_min": 0.2, "y_max": 0.4}
SPATIAL_REFS = [(0.3, 0.4), (0.2, 0.3, 0.6, 0.7)]
GREEDY64 = {"temperature": 0.0, "max_tokens": 64}


def _same(a, b, atol: float = 1e-6) -> bool:
    """Equal nested results, floats within atol (exp2 may round by an ulp
    differently on the card)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k], atol) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y, atol) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= atol
    return a == b


def phase_structured_reference(img: np.ndarray) -> None:
    """The region-head paths on the tiny config, bf16 on the card against
    fp32 on the CPU, on one set of bf16-valued weights whose choices are
    decisive in bf16: the region decoders' fc2 biases get N(0, 50^2) (the
    peaked oracle) and lm_head's bias +30 on coord_id, so every greedy token
    is coord_id (never EOS) and every reasoning token takes the coordinate
    branch. detect and point (6 objects), detect_gaze in eye mode and in
    accuracy mode (20 rows in one lockstep batch: kernel A at B 20 and
    kernel B at B 20), query with reasoning (16 tokens) and with spatial
    refs must give the CPU's boxes, points and ids."""
    cfg = tiny_test_config()
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    gen = torch.Generator().manual_seed(SEED + 3)
    for site in ("coord_decoder", "size_decoder"):
        b = state[f"region.{site}.fc2.b"]
        state[f"region.{site}.fc2.b"] = b + 50 * torch.randn(b.shape, generator=gen)
    state["text.lm_head.b"][cfg.tokenizer.coord_id] += 30.0
    state = {n: t.to(BF16).float() for n, t in state.items()}
    greedy = {"temperature": 0.0, "max_tokens": 16}

    def run(device, dtype) -> dict:
        params = build_params(cfg, device, dtype)
        params.load_state_dict(state)
        m = MoondreamModel(cfg, params, IdTokenizer(), dtype, device=device)
        enc = m.encode_image(img)
        random.seed(SEED)
        return {
            "detect": m.detect(enc, "object", settings={"max_objects": 6}),
            "point": m.point(enc, "object", settings={"max_objects": 6}),
            "gaze eye": m.detect_gaze(enc, eye=(0.4, 0.3)),
            "gaze accuracy": m.detect_gaze(img, face=FACE,
                                           unstable_settings={"prioritize_accuracy": True}),
            "reasoning": m.query(enc, "What?", reasoning=True, settings=greedy),
            "spatial refs": m.query(enc, "What?", spatial_refs=SPATIAL_REFS, settings=greedy),
        }

    want, got = run("cpu", torch.float32), run(DEV, BF16)
    if len(want["detect"]["objects"]) != 6 or want["gaze accuracy"]["gaze"] is None:
        raise AssertionError(f"tiny structured reference is not decisive: {want}")
    if not want["reasoning"]["reasoning"]["grounding"]:
        raise AssertionError("tiny reasoning reference took no coordinate branch")
    bad = [k for k in want if not _same(got[k], want[k])]
    print(f"structured reference (tiny config, card bf16 vs cpu fp32, peaked decoders): "
          f"{len(want) - len(bad)} of {len(want)} paths equal ({', '.join(want)}); "
          f"detect {got['detect']['objects'][0]}, gaze accuracy {got['gaze accuracy']}")
    if bad:
        raise AssertionError(f"structured reference differs: "
                             f"{ {k: (got[k], want[k]) for k in bad} }")


def _peaked_tiny_state(cfg, scale: float = 50.0) -> dict:
    """The tiny config's seeded weights, bf16-valued, with the peaked
    oracle of phase_structured_reference: region decoders' fc2 biases
    + N(0, scale^2) and lm_head's bias +30 on coord_id. At scale 50 every
    region argmax is the bias's own; at 0.1 it moves with the hidden state."""
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    gen = torch.Generator().manual_seed(SEED + 3)
    for site in ("coord_decoder", "size_decoder"):
        b = state[f"region.{site}.fc2.b"]
        state[f"region.{site}.fc2.b"] = b + scale * torch.randn(b.shape, generator=gen)
    state["text.lm_head.b"][cfg.tokenizer.coord_id] += 30.0
    return {n: t.to(BF16).float() for n, t in state.items()}


def phase_spec_reference(img: np.ndarray) -> None:
    """The speculative and mixed paths on the tiny config. First the verify
    forwards' logits, bf16 on the card and on the CPU each against fp32 on
    the CPU (as phase_serving_reference): a pool verify step
    (`ragged_verify_step`) of k 8 and 24 rows (24: kernel C in two
    launches), plain and prefix-shared, and a batch-1 verify span of 8
    (kernel B) and 24 rows (kernel A). Then, under the peaked oracle, the
    ids and boxes of a batch-1 speculative caption, a speculative pool, a
    mixed pool (caption, detect, point, gaze) and a mixed speculative pool:
    card bf16 must equal CPU fp32. Then the two mixed pools again with the
    region biases' noise at x0.1, where each box follows the hidden state
    the chunk holds for its row (a request's boxes and points differ from
    one another) yet every argmax stays decisive in bf16: card bf16 must
    still equal CPU fp32. (At x1 the card machine's CPU reference gives
    every object the bias's box; with no noise, bf16 flips argmaxes.)"""
    cfg = tiny_test_config()
    tc = cfg.text
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    state = {n: t.to(BF16).float() for n, t in state.items()}
    gen = torch.Generator().manual_seed(SEED + 4)
    cache = lambda n, t: [torch.randn(tc.n_layers, n, tc.n_heads, t, tc.head_dim,
                                      generator=gen).to(BF16).float() for _ in range(2)]
    toks = torch.randint(0, tc.vocab_size, (4, 24), generator=gen)
    cases = {
        "pool": (cache(4, 1024), None, [0, 731, 850, 1000], None, 0),
        "prefix-shared pool": (cache(4, 384), cache(2, 768), [731, 760, 900, 1020], [1, 0, 1, 0],
                               730),
        "batch-1": (cache(1, 1024), None, 800, None, 0),
    }
    errs = {}
    for label, (kv, pref, pos, pids, prefix_len) in cases.items():
        for k in (8, 24):
            def run(device, dtype) -> torch.Tensor:
                params = build_params(cfg, device, dtype)
                params.load_state_dict(state)
                to = lambda ts: KVCache(*(t.to(device, dtype) for t in ts))
                if label == "batch-1":
                    return _verify_logits(params["text"], to(kv), toks[0, :k].to(device), pos,
                                          None, ()).float().cpu()
                return ragged_verify_step(
                    params["text"], to(kv), toks[:, :k].to(device),
                    torch.tensor(pos, dtype=torch.int32, device=device), None, None, None,
                    None if pref is None else to(pref),
                    None if pids is None else torch.tensor(pids, dtype=torch.int32, device=device),
                    prefix_len,
                )[0].float().cpu()

            ref = run("cpu", torch.float32)
            rel = lambda x: ((x - ref).abs().max() / ref.abs().max()).item()
            card_err, cpu_err = rel(run(DEV, BF16)), rel(run("cpu", BF16))
            errs[f"{label} k{k}"] = (round(card_err, 5), round(cpu_err, 5))
            if not card_err <= SMALL_REF_FACTOR * cpu_err:
                raise AssertionError(f"{label} verify k {k}: {card_err} vs cpu bf16 {cpu_err}")
    print(f"spec reference (tiny config, verify logits rel max err vs fp32 on the cpu, "
          f"(card bf16, cpu bf16), tol {SMALL_REF_FACTOR} x cpu bf16): {errs}")

    greedy = {"temperature": 0.0, "max_tokens": 16, "speculative": 8}

    def paths(state, device, dtype, pools) -> dict:
        params = build_params(cfg, device, dtype)
        params.load_state_dict(state)
        m = MoondreamModel(cfg, params, IdTokenizer(), dtype, device=device)
        enc = m.encode_image(img)
        out = {}
        if "spec pool" in pools:
            out["caption"] = m.caption(enc, settings=greedy)["caption"]
        for name, kw in (("spec pool", {"speculative": 8}), ("mixed pool", {}),
                         ("mixed spec pool", {"speculative": 8})):
            if name not in pools:
                continue
            eng = ContinuousBatchingEngine(m, n_slots=5, slot_len=1024, chunk=3,
                                           max_objects=3, **kw)
            rids = [eng.submit(enc, max_tokens=12), eng.submit(enc, POOL_QUESTION, max_tokens=12)]
            if name != "spec pool":
                rids += [eng.submit_detect(enc, "object"), eng.submit_point(enc, "object"),
                         eng.submit_gaze(enc, (0.4, 0.3))]
            res = eng.drain()
            out[name] = [res[r] for r in rids]
        return out

    everything = ("spec pool", "mixed pool", "mixed spec pool")
    for scale, pools in ((50.0, everything), (0.1, everything[1:])):
        state = _peaked_tiny_state(cfg, scale)
        want = paths(state, "cpu", torch.float32, pools)
        got = paths(state, DEV, BF16, pools)
        det = want["mixed pool"][2]["objects"]
        if len(det) != 3 or want["mixed pool"][4]["gaze"] is None:
            raise AssertionError(f"tiny mixed reference is not decisive: {want['mixed pool']}")
        pts = want["mixed pool"][3]["points"]
        if scale < 1 and min(len({tuple(o.values()) for o in rows}) for rows in (det, pts)) < 2:
            raise AssertionError(f"x{scale:g} boxes do not follow the hidden state: {det}, {pts}")
        bad = [k for k in want if not _same(got[k], want[k])]
        print(f"spec reference (tiny config, card bf16 vs cpu fp32, region biases "
              f"x{scale:g}): {len(want) - len(bad)} of {len(want)} paths equal "
              f"({', '.join(want)}); detect {got['mixed spec pool'][2]['objects']}")
        if bad:
            raise AssertionError(f"spec reference x{scale:g} differs: "
                                 f"{ {k: (got[k], want[k]) for k in bad} }")


SPEC_K = 8  # the 2B speculative paths' k (settings={"speculative": True})


def _first_diff(a: list, b: list) -> int:
    """The first index where two id lists differ, counting a length
    difference (len of both when equal)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                len(a) if len(a) == len(b) else min(len(a), len(b)))


def _check_margin(label: str, model, enc, prompt, single, other, max_tokens, slots=None,
                  lora=None, decode_lora=None, steer=None):
    """None where `other` equals batch-1 greedy `single` (under the adapters
    `lora` / `decode_lora` of `first_difference_margin` when given); else
    batch-1's logit margin at the first difference as (margin, bf16 steps).
    Raises above 8 bf16 steps: a near tie is a few, a wrong accepted draft
    or a span mask off by one far more."""
    n = _first_diff(single, other)
    if n == len(single) == len(other):
        return None
    m = first_difference_margin(model, enc, prompt, single, other, n, max_tokens, slots, lora,
                                decode_lora, steer)
    if abs(m[1]) > 8:
        raise AssertionError(f"{label}: ids differ from batch-1 greedy at token {n} with a "
                             f"logit margin of {m[1]} bf16 steps")
    return n, m


def phase_spec(model, enc, power: str) -> list:
    """The 2B speculative caption and query (settings["speculative"] = 8,
    64 greedy tokens) on the encoded image, each a counted run: exact
    launches (every verify span of 8 rows takes kernel B on every layer,
    and four W4A16 or w8a8 launches per layer with int4 or int8 blocks) and
    host reads (one
    per run of 8 verify spans plus one). Ids against the plain greedy call:
    where they differ, batch-1's logit margin (at most 8 bf16 steps). Both
    timed on the host clock, prompt prefill included."""
    cfg = model.config
    label, kinds = format_label(model), linear_kinds(model)
    model.tokenizer = IdTokenizer()
    tmpl = cfg.tokenizer.templates
    tasks = {
        "caption": (list(tmpl["caption"]["normal"]),
                    lambda s: model.caption(enc, "normal", settings=s)["caption"]),
        "query": (list(tmpl["query"]["prefix"]) + model._encode_text(POOL_QUESTION)
                  + list(tmpl["query"]["suffix"]),
                  lambda s: model.query(enc, POOL_QUESTION, settings=s)["answer"]),
    }
    runs, lines, spans = [], [], {}
    for task, (prompt, call) in tasks.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = _ids(call(GREEDY64))
        plain_ms = sync_ms(t0)
        reset_launch_counts()
        reset_loop_counts()
        t0 = time.perf_counter()
        spec = _ids(call({**GREEDY64, "speculative": SPEC_K}))
        spec_ms = sync_ms(t0)
        launches = dict(LAUNCHES)
        loop = dict(LOOP_COUNTS["generate_text_spec"])
        iters = spans[task] = loop["steps"]
        if loop["calls"] != 1 or loop["reads"] > math.ceil(iters / DONE_CHECK_EVERY) + 1:
            raise AssertionError(f"spec {task}: {loop} (one read per run of "
                                 f"{DONE_CHECK_EVERY} verify spans plus one)")
        check_launches(f"spec {task} ({label}), {len(spec)} tokens in {iters} verify spans",
                       launches, expected_launches(cfg, 0, 1 + iters, 0, **kinds))
        runs.append(launches)
        diff = _check_margin(f"spec {task} ({label})", model, enc, prompt, plain, spec, 64)
        tok_s = lambda ids, ms: len(ids) / (ms / 1e3)
        lines.append(
            f"{task} {tok_s(spec, spec_ms):.1f} tok/s spec vs {tok_s(plain, plain_ms):.1f}"
            f" plain ({len(spec)} tokens, {iters} verify spans: accept rate "
            f"{len(spec) / max(iters, 1):.2f} tokens per span, {loop['reads']} host reads; "
            + ("ids equal plain greedy" if diff is None else
               f"first differs from plain greedy at token {diff[0]}, batch-1 margin "
               f"{diff[1][0]} ({diff[1][1]} bf16 steps)") + ")")
    # speculative sampling (the default temperature 0.5, top_p 0.3): the
    # rejection test on the card, within max_tokens, one read per run;
    # then at top_p 0, where the target is one-hot at the argmax: the
    # sampled loop must give the greedy spec ids in as many spans
    greedy_caption = (_ids(tasks["caption"][1]({**GREEDY64, "speculative": SPEC_K})),
                      spans["caption"])
    for top_p in (None, 0.0):
        settings = {"max_tokens": 64, "speculative": SPEC_K}
        if top_p is not None:
            settings.update(temperature=0.5, top_p=top_p)
        reset_loop_counts()
        t0 = time.perf_counter()
        sampled = _ids(tasks["caption"][1](settings))
        ms = sync_ms(t0)
        loop = LOOP_COUNTS["generate_text_spec_sampled"]
        if (not 0 < len(sampled) <= 64
                or loop["reads"] > math.ceil(loop["steps"] / DONE_CHECK_EVERY) + 1):
            raise AssertionError(f"sampled spec caption: {len(sampled)} tokens, {loop}")
        if top_p == 0.0 and (sampled, loop["steps"]) != greedy_caption:
            raise AssertionError(f"sampled spec at top_p 0: {len(sampled)} tokens in "
                                 f"{loop['steps']} spans differ from greedy spec's "
                                 f"{len(greedy_caption[0])} in {greedy_caption[1]}")
        lines.append(f"sampled caption{' at top_p 0' if top_p == 0.0 else ''} "
                     f"{len(sampled) / (ms / 1e3):.1f} tok/s ({len(sampled)} tokens in "
                     f"{loop['steps']} verify spans"
                     + ("; greedy spec's ids and spans" if top_p == 0.0 else "") + ")")
    print(f"2B speculative k {SPEC_K} ({label}) on {power}: " + "; ".join(lines))
    return runs


def _prompt_of(model, question) -> list:
    """A pool request's prompt: the caption template, or a query's."""
    tmpl = model.config.tokenizer.templates
    return (list(tmpl["caption"]["normal"]) if question is None else
            list(tmpl["query"]["prefix"]) + model._encode_text(question)
            + list(tmpl["query"]["suffix"]))


def _batch1_refs(model, encs, requests, max_tokens, eos_id=-1, loras=None,
                 decode_loras=None) -> list:
    """Batch-1 greedy ids of (image, question) requests on their encodes,
    in slots of 1024 as a pool's, with their prompts; request i's prompt
    under the adapter loras[i] when given (its encode made under it), its
    decode steps under decode_loras[i] (default: loras[i])."""
    out = []
    for i, (img, question) in enumerate(requests):
        enc, lora = encs[img], None if loras is None else loras[i]
        dec = lora if decode_loras is None else decode_loras[i]
        prompt = _prompt_of(model, question)
        _, _, first, pos, kv = model._prefill_prompt(
            model.load_encoded_image(enc, slots=1024), prompt, enc.pos, 0.0, 0.0, lora=lora)
        ids = model._generate_answer_tokens(
            kv, first, pos, {"temperature": 0.0, "max_tokens": max_tokens}, eos_id=eos_id,
            lora=dec)
        model._recycle_kv(kv)
        out.append((enc, prompt, ids))
    return out


def phase_spec_pools(model, images, power: str) -> list:
    """Two 2B speculative pools (8 slots of 1024, chunk 8, eos -1, the 8
    POOL_REQUESTS of 48 tokens): k 8, and k 24, whose verify spans take
    kernel C in two launches (16 + 8 rows) per layer; then a sampled pool
    at k 8 (temperature 0.5, top_p 0.3). Each a counted run with exact
    launches, one spec chunk dispatched under
    torch.cuda.set_sync_debug_mode("error"), and ms per chunk; every
    greedy request's ids against batch-1 greedy (margins at most 8 bf16
    steps)."""
    cfg = model.config
    L_txt, L_vit = cfg.text.n_layers, cfg.vision.enc_n_layers
    model.tokenizer = IdTokenizer()
    runs, outs, refs = [], {}, None
    for k in (SPEC_K, 24):
        reset_launch_counts()
        run = _pool_run(model, images, {"speculative": k}, sync_check=True)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        want = {name: 0 for name in LAUNCHES}
        want[K.FLASH] = len(images) * (L_vit + L_txt)
        want[K.DECODE] = len(POOL_REQUESTS) * L_txt
        want[K.RAGGED] = L_txt * 8 * -(-k // 16) * run["chunks"]
        check_launches(f"spec pool k {k}, {run['chunks']} chunks", launches, want)
        runs.append(launches)
        if refs is None:
            refs = _batch1_refs(model, run["encs"], POOL_REQUESTS, POOL_TOKENS)
        diffs = [_check_margin(f"spec pool k {k}", model, enc, prompt, ids, got, POOL_TOKENS,
                               slots=1024)
                 for (enc, prompt, ids), got in zip(refs, run["out"])]
        outs[k] = run["out"]
        tokens = len(POOL_REQUESTS) * POOL_TOKENS
        print(f"2B spec pool k {k} (bf16) on {power}: {tokens / (sum(run['step_ms']) / 1e3):.1f} "
              f"tok/s decode ({tokens} tokens in {run['chunks']} chunks of 8 verify iterations "
              f"x 8 slots, {sum(run['step_ms']) / run['chunks']:.2f} ms per chunk, read-back "
              f"included, one chunk under sync debug mode), accept rate "
              f"{run['engine'].spec_accept_rate:.3f} tokens per slot-iteration; vs batch-1 "
              f"greedy: {sum(d is None for d in diffs)} of {len(diffs)} requests equal"
              + "".join(f"; request {i} first differs at token {d[0]} (margin {d[1][0]}, "
                        f"{d[1][1]} bf16 steps)" for i, d in enumerate(diffs) if d))
    same = sum(a == b for a, b in zip(outs[SPEC_K], outs[24]))
    print(f"spec pools k {SPEC_K} and k 24: {same} of {len(POOL_REQUESTS)} requests with equal ids")
    # the sampled spec pool (serve_chunk_spec_sampled) at temperature 0.5,
    # top_p 0.3: the same counted run, each request exactly its budget
    reset_launch_counts()
    run = _pool_run(model, images, {"speculative": SPEC_K, "temperature": 0.5, "top_p": 0.3},
                    sync_check=True)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if not run["engine"]._sampling_used:
        raise AssertionError("the sampled spec pool took the greedy chunk")
    want = {name: 0 for name in LAUNCHES}
    want[K.FLASH] = len(images) * (L_vit + L_txt)
    want[K.DECODE] = len(POOL_REQUESTS) * L_txt
    want[K.RAGGED] = L_txt * 8 * run["chunks"]
    check_launches(f"sampled spec pool k {SPEC_K}, {run['chunks']} chunks", launches, want)
    runs.append(launches)
    tokens = len(POOL_REQUESTS) * POOL_TOKENS
    print(f"2B sampled spec pool k {SPEC_K} (bf16, temperature 0.5, top_p 0.3) on {power}: "
          f"{tokens / (sum(run['step_ms']) / 1e3):.1f} tok/s decode ({tokens} tokens in "
          f"{run['chunks']} chunks, {sum(run['step_ms']) / run['chunks']:.2f} ms per chunk, "
          f"read-back included, one chunk under sync debug mode), accept rate "
          f"{run['engine'].spec_accept_rate:.3f}")
    return runs


def _peak_region(model) -> None:
    """The peaked oracle on a model's region heads, in place: the coordinate
    and size decoders' fc2 biases + N(0, 50^2), seeded, so every argmax is
    decisive and a pooled box equals the single one whatever order the
    pool's products sum in."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    for site in (model.region.coord_decoder, model.region.size_decoder):
        b = site.fc2.b
        b.data += (50 * torch.randn(b.shape, generator=gen, device=DEV)).to(b.dtype)


MIXED_EYE = (0.45, 0.3)
MIXED_OBJECTS = 8


def phase_mixed_pools(model, images, power: str) -> list:
    """Two 2B mixed pools (8 slots of 1024, chunk 8, max_objects 8, the
    tokenizer's EOS): four caption / query rows of POOL_REQUESTS beside a
    detect, a point and a gaze row, plain and speculative (k 8), with the
    peaked oracle on the region heads (_peak_region; from here on the
    model keeps it). Each a counted run: exact launches (prompt spans of
    <= 16 rows take kernel B, the gaze prompt's 17 kernel A; every pool
    step kernel C, k 8 spans one launch per layer), the first chunk
    dispatched under torch.cuda.set_sync_debug_mode("error"), ms per chunk
    and each structured request's latency from the first admission. The
    boxes, points and gaze must equal the single-request ones; text rows
    against batch-1 greedy (margins at most 8 bf16 steps)."""
    cfg = model.config
    L_txt = cfg.text.n_layers
    model.tokenizer = IdTokenizer()
    _peak_region(model)
    encs = [model.encode_image(im) for im in images]
    settings = {"max_objects": MIXED_OBJECTS}
    singles = {"detect": model.detect(encs[0], "object", settings=settings),
               "point": model.point(encs[1], "object", settings=settings),
               "gaze": model.detect_gaze(encs[2], eye=MIXED_EYE)}
    texts = POOL_REQUESTS[:4]
    refs = _batch1_refs(model, encs, texts, POOL_TOKENS, eos_id=cfg.tokenizer.eos_id)
    pad16 = lambda n: _prompt_pad(n) <= 16
    prompts = [len(p) for _, p, _ in refs] + [
        len(model._structured_prompt("detect", "object")),
        len(model._structured_prompt("point", "object")), model._gaze_embeds([MIXED_EYE])[1]]
    runs = []
    for spec in (0, SPEC_K):
        eng = ContinuousBatchingEngine(model, n_slots=8, slot_len=1024, chunk=8,
                                       max_objects=MIXED_OBJECTS, speculative=spec)
        chunks, step_ms, done_ms = [0], [], {}
        dispatch = eng._dispatch_chunk

        def counted_dispatch():
            chunks[0] += 1
            dispatch()

        eng._dispatch_chunk = counted_dispatch
        reset_launch_counts()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        rids = [eng.submit(encs[i], question=q, max_tokens=POOL_TOKENS) for i, q in texts]
        rids += [eng.submit_detect(encs[0], "object"), eng.submit_point(encs[1], "object"),
                 eng.submit_gaze(encs[2], MIXED_EYE)]
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._dispatch_chunk()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        while any(s.active for s in eng.slots) or eng._inflight:
            t0 = time.perf_counter()
            for rid in eng.step():
                done_ms[rid] = (time.perf_counter() - t_start) * 1e3
            step_ms.append(sync_ms(t0))
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        want = {name: 0 for name in LAUNCHES}
        want[K.DECODE] = L_txt * sum(pad16(n) for n in prompts)
        want[K.FLASH] = L_txt * sum(not pad16(n) for n in prompts)
        want[K.RAGGED] = L_txt * 8 * max(1, -(-spec // 16)) * chunks[0]
        kind = f"mixed spec pool k {spec}" if spec else "mixed pool"
        check_launches(f"{kind}, {chunks[0]} chunks", launches, want)
        runs.append(launches)
        got = {"detect": eng.results[rids[4]], "point": eng.results[rids[5]],
               "gaze": eng.results[rids[6]]}
        bad = [k for k in singles if not _same(got[k], singles[k])]
        if bad:
            raise AssertionError(f"{kind}: pooled {bad} differ from the single request: "
                                 f"{ {k: (got[k], singles[k]) for k in bad} }")
        diffs = [_check_margin(kind, model, enc, prompt, ids, _ids(eng.results[r]), POOL_TOKENS,
                               slots=1024)
                 for (enc, prompt, ids), r in zip(refs, rids)]
        print(f"2B {kind} (bf16) on {power}: {chunks[0]} chunks, "
              f"{sum(step_ms) / len(step_ms):.2f} ms per chunk (read-back included; the first "
              f"under sync debug mode); detect of {len(got['detect']['objects'])} objects done "
              f"in {done_ms[rids[4]]:.1f} ms, point {done_ms[rids[5]]:.1f} ms, gaze "
              f"{done_ms[rids[6]]:.1f} ms from the first admission (single detect: "
              f"{len(singles['detect']['objects'])} objects); boxes, points and gaze equal the "
              f"single requests'; text rows vs batch-1 greedy: {sum(d is None for d in diffs)} "
              f"of {len(diffs)} equal"
              + "".join(f"; row {i} first differs at token {d[0]} ({d[1][1]} bf16 steps)"
                        for i, d in enumerate(diffs) if d)
              + (f"; accept rate {eng.spec_accept_rate:.3f}" if spec else ""))
    return runs


def phase_structured(model, enc, img, batch_images, power: str, int4: bool = False,
                     full: bool = True) -> list:
    """The region-head paths on a 2B model through the entry points, each a
    counted run (kernel launches and the decode loops' host reads, reset
    just before and read just after), timed on the host clock after a
    synchronise: detect (default max_objects 50) on the encoded image;
    with `full` also point, detect_gaze in eye mode (encoded image) and in
    accuracy mode (the image and its mirror: two encodes, one lockstep
    batch of 20), query with reasoning and with two spatial refs (64
    greedy tokens each) and detect_batch over `batch_images`. Returns the
    launch counts of every run."""
    cfg = model.config
    label = (" + ".join(["int4"] * int4 + ["kv_int8" if cfg.text.kv_int8 else "bf16"])
             + f", {cfg.text.n_kv_heads} KV heads")
    model.tokenizer = IdTokenizer()
    runs, times = [], []

    def counted(name, call, want_launches):
        """Run call() with counts reset; want_launches(out) gives the exact
        launch counts. Every decode loop must read the device at most
        ceil(steps / DONE_CHECK_EVERY) + 1 times per call."""
        reset_launch_counts()
        reset_loop_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        ms = sync_ms(t0)
        launches, loops = dict(LAUNCHES), {k: dict(v) for k, v in LOOP_COUNTS.items()}
        for loop, c in loops.items():
            if c["reads"] > math.ceil(c["steps"] / DONE_CHECK_EVERY) + c["calls"]:
                raise AssertionError(f"{name}: {loop} read the device {c['reads']} times "
                                     f"in {c['steps']} steps")
        check_launches(f"{name} ({label}), loops {loops}", launches, want_launches(out))
        runs.append(launches)
        times.append(f"{name} {ms:.1f} ms")
        return out, ms, loops

    def boxes_ok(rows, keys):
        vals = [[r[k] for k in keys] for r in rows]
        return all(math.isfinite(v) for row in vals for v in row) and (
            len(keys) == 2 or all(r["x_min"] <= r["x_max"] and r["y_min"] <= r["y_max"]
                                  for r in rows))

    box_keys = ("x_min", "y_min", "x_max", "y_max")
    for task, spo, keys in (("detect", 3, box_keys), ("point", 2, ("x", "y")))[:1 + full]:
        out, ms, loops = counted(
            task, lambda: getattr(model, task)(enc, "object"),
            lambda o: expected_launches(cfg, 0, 1, batched_steps(
                spo * len(next(iter(o.values()))), spo * 50), int4))
        rows = next(iter(out.values()))
        if len(rows) > 50 or not boxes_ok(rows, keys):
            raise AssertionError(f"{task}: bad result {rows[:3]}")
        if getattr(model, task)(enc, "object") != out:
            raise AssertionError(f"{task}: greedy boxes differ between two runs")
        steps = loops.get("generate_points", {"steps": 0})["steps"]
        times[-1] += f" ({len(rows)} found, {steps} steps, {ms / max(steps, 1):.2f} ms per step)"
    if not full:
        print(f"2B structured ({label}) on {power}: " + "; ".join(times))
        return runs

    out, _, _ = counted("detect_gaze eye mode", lambda: model.detect_gaze(enc, eye=(0.45, 0.3)),
                        lambda o: expected_launches(cfg, 0, 0, 0 if o["gaze"] is None else 2,
                                                    long_spans=1))
    gaze_eye = out["gaze"]
    random.seed(SEED)
    out, _, loops = counted(
        "detect_gaze accuracy mode",
        lambda: model.detect_gaze(img, face=FACE, unstable_settings={"prioritize_accuracy": True}),
        lambda o: expected_launches(cfg, 2, 0, 1, long_spans=1, prefills=2))
    if loops != {"gaze_points_batched": {"calls": 1, "steps": 1, "reads": 1}}:
        raise AssertionError(f"accuracy-mode gaze: one step and one read, got {loops}")
    gaze_acc = out["gaze"]
    for g in (gaze_eye, gaze_acc):
        if g is not None and not all(math.isfinite(v) for v in g.values()):
            raise AssertionError(f"bad gaze {g}")

    def query_want(o, spans, long_spans):
        steps = batched_steps(len(_ids(o["answer"])), 64)
        if "reasoning" in o:
            steps += batched_steps(len(_ids(o["reasoning"]["text"])), 64)
        return expected_launches(cfg, 0, spans, steps, long_spans=long_spans)

    out, ms, loops = counted("query reasoning", lambda: model.query(
        enc, POOL_QUESTION, reasoning=True, settings=GREEDY64), lambda o: query_want(o, 2, 0))
    n_tok = len(_ids(out["reasoning"]["text"])) + len(_ids(out["answer"]))
    times[-1] += (f" ({len(_ids(out['reasoning']['text']))} reasoning + "
                  f"{len(_ids(out['answer']))} answer tokens, {n_tok / (ms / 1e3):.1f} tok/s, "
                  f"{len(out['reasoning']['grounding'])} grounded spans)")
    # The reasoning loop beside the answer loop, back to back from one
    # prefilled reasoning prompt (64 steps each): what the coordinate branch
    # (its MLP and the selected embedding) costs per step.
    tok_cfg = cfg.tokenizer
    tmpl = cfg.tokenizer.templates["query"]
    prompt = (list(tmpl["prefix"]) + model._encode_text(POOL_QUESTION) + list(tmpl["suffix"])
              + [tok_cfg.thinking_id])
    loop_ms = {}
    for loop in ("reasoning", "answer"):
        _, hid, first, pos, kv = model._prefill_prompt(
            model.load_encoded_image(enc), prompt, enc.pos, 0.0, 0.0)
        bound = model._decode_bound(pos + 65)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if loop == "reasoning":
            res = generate_reasoning(model.text, model.region, kv, first, hid, pos, None, 0.0,
                                     0.0, 64, tok_cfg.answer_id, tok_cfg.coord_id,
                                     (tok_cfg.eos_id, tok_cfg.size_id), bound)
        else:
            res = generate_text(model.text, kv, first, pos, None, 0.0, 0.0, 64, -1,
                                (tok_cfg.answer_id,), bound)
        loop_ms[loop] = (sync_ms(t0), res.count)
        model._recycle_kv(kv)
    times.append("loops back to back: " + ", ".join(
        f"{k} {n / (ms / 1e3):.1f} tok/s ({n} tokens, {ms / max(n, 1):.2f} ms per token)"
        for k, (ms, n) in loop_ms.items()))
    out, ms, _ = counted("query spatial refs", lambda: model.query(
        enc, POOL_QUESTION, spatial_refs=SPATIAL_REFS, settings=GREEDY64),
        lambda o: query_want(o, 0, 1))
    if not out["answer"]:
        raise AssertionError("spatial-refs query gave no answer")

    n_groups = len({(c.shape[0], t) for c, t in map(model._crops, batch_images)})
    out, ms, loops = counted(
        f"detect_batch of {len(batch_images)}", lambda: model.detect_batch(batch_images, "object"),
        lambda o: expected_launches(cfg, n_groups, 1, batched_steps(
            3 * max(len(r["objects"]) for r in o), 150), batch_prefill=True))
    if not all(boxes_ok(r["objects"], box_keys) for r in out):
        raise AssertionError("detect_batch: bad boxes")
    times[-1] += (f" from images ({len(batch_images) / (ms / 1e3):.2f} images/s, found "
                  f"{[len(r['objects']) for r in out]})")
    # rows against batch-1 detect on the same images (printed: cuBLAS sums
    # M = 8 and M = 1 in another order, so near-tie bins may flip)
    encs = model.encode_images(batch_images)
    same = sum(model.detect(e, "object") == r for e, r in zip(encs, out))
    print(f"2B structured ({label}) on {power}: " + "; ".join(times)
          + f"; gaze eye {gaze_eye}, accuracy {gaze_acc}; detect_batch rows equal to "
          f"batch-1 detect: {same} of {len(out)}")
    return runs


def _graph_captures(label: str) -> str:
    """The captures since graphs.reset_graph_counts() (the model's creation
    in phase_main_path): per graph label, how many, their median and
    largest capture ms and the bytes the graphs' memory pools grew by (the
    first capture into a pool grows it; later ones mostly reuse it)."""
    out = []
    for name in sorted({c["label"] for c in graphs.CAPTURES}):
        cs = [c for c in graphs.CAPTURES if c["label"] == name]
        ms = [c["ms"] for c in cs]
        out.append(f"{name}: {len(cs)} captures, {statistics.median(ms):.1f} ms median, "
                   f"{max(ms):.1f} ms max, graph pool bytes {sum(c['pool_bytes'] for c in cs)}, "
                   f"{cs[0]['launches']} launches of the port's kernels per replay")
    return f"CUDA graph captures ({label}): " + "; ".join(out)


def phase_graphs(model, enc, images, batch_images, power: str, lockstep: bool = False,
                 pools=()) -> None:
    """The graphed paths of one model against the same steps run eagerly
    (`graphed=False`), in turns (eager, graphed, graphed, eager), in this
    call: the batch-1 answer loop (caption prompt, 64 greedy tokens with
    eos off), a sampled run from one seed, with `lockstep` the caption
    batch over `batch_images` (64 steps, eos off), and `pools`, (label,
    ContinuousBatchingEngine keywords) each. Graphed ids must equal the
    eager ones bit for bit (both plan the decode kernel's splits from
    kv_bound); launch counts of a graphed answer loop must be exact with
    its replays counted; the answer and lockstep graphs replay once more,
    and a third graphed pool dispatches its capturing and its first
    replayed chunk, under torch.cuda.set_sync_debug_mode("error") (no host
    sync). Prints tok/s, ms per lockstep step and per pool chunk of both,
    and each capture's ms and graph pool bytes."""
    cfg, tok = model.config, model.config.tokenizer
    label, kinds = format_label(model), linear_kinds(model)
    tmpl = list(tok.templates["caption"]["normal"])
    suppress = (tok.answer_id,)

    held = [0]

    def replay_without_sync(kv):
        """Replay once more the graphs keyed by kv's tensors (the loop just
        ran on them: their addresses are live), a host sync an error."""
        key = graphs.tensor_key(kv.k, kv.v, kv.ks, kv.vs)
        mine = [g for k, e in graphs.cache_of(model.text).entries.items() if k[-1] == key
                for g in e.graphs.values()]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for g in mine:
                g.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        held[0] += len(mine)

    def answer(graphed, temperature=0.0, seed=None):
        kv = model.load_encoded_image(enc)
        _, _, first, pos, _ = model._prefill_prompt(kv, tmpl, enc.pos, 0.0, 0.0)
        bound = model._decode_bound(pos + 64 + 1)
        gen = None if seed is None else torch.Generator(device=DEV).manual_seed(seed)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = generate_text(model.text, kv, first, pos, gen, temperature, 0.9, 64, -1,
                            suppress, bound, graphed=graphed)
        ms = sync_ms(t0)
        check_launches(f"answer loop ({label}, graphed {graphed}), 64 steps", dict(LAUNCHES),
                       expected_launches(cfg, 0, 0, 64, prefills=0, **kinds))
        if graphed and temperature > 0:
            replay_without_sync(kv)  # the greedy and the sampled graph of this cache
        model._recycle_kv(kv)
        return res.tokens, ms

    ids, _ = answer(True)  # captures the graph of this key if no run has yet
    runs = [(g, *answer(g)) for g in (False, True, True, False)]
    if any(r[1] != ids for r in runs) or len(ids) != 64:
        raise AssertionError(f"answer loop ({label}): graphed and eager ids differ")
    tok_s = {g: statistics.median([64 / (ms / 1e3) for gg, _, ms in runs if gg == g])
             for g in (False, True)}
    sampled = [answer(g, 0.5, seed=SEED + 7)[0] for g in (False, True)]
    if sampled[0] != sampled[1]:
        raise AssertionError(f"sampled answer loop ({label}): graphed ids differ from eager "
                             f"ones from the same seed: {sampled}")
    print(f"2B answer loop ({label}) on {power}: graphed {tok_s[True]:.1f} tok/s, eager "
          f"{tok_s[False]:.1f} tok/s ({tok_s[True] / tok_s[False]:.2f} x; 64 greedy tokens, "
          f"batch 1, ids equal bit for bit; a sampled run equals eager from one seed)")

    if lockstep:
        encs = model.encode_images(batch_images)
        greedy = {"temperature": 0.0, "max_tokens": 64}
        step_ms, rows = {False: [], True: []}, []
        for g in (True, False, True, True, False):
            logits, _, kv, pos, length, bound = model._batched_prompt_prefill(
                encs, tmpl, greedy, lambda pos, length, pad: pos + pad + 64 + 1)
            first = sample_tokens_batched(logits, model.generator, 0.0, 0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = generate_text_batched(model.text, kv, first, pos + length, None, 0.0, 0.0, 64,
                                        -1, suppress, bound, graphed=g)
            out = (res.tokens.tolist(), res.counts.tolist())
            step_ms[g].append(sync_ms(t0) / 64)
            rows.append(out)
            if g and len(rows) == 5 - 1:
                replay_without_sync(kv)
            model._recycle_kv(kv)
        if any(r != rows[0] for r in rows):
            raise AssertionError(f"lockstep ({label}): graphed and eager tokens differ")
        ms = {g: statistics.median(v[-2:]) for g, v in step_ms.items()}
        print(f"2B lockstep caption_batch ({label}, {len(encs)} rows) on {power}: graphed "
              f"{ms[True]:.2f} ms per step, eager {ms[False]:.2f} ms per step "
              f"({ms[False] / ms[True]:.2f} x), tokens equal bit for bit")

    model.tokenizer = IdTokenizer()
    for plabel, kind in pools:
        res = {g: _pool_run(model, images, {**kind, "graphed": g}) for g in (False, True)}
        checked = _pool_run(model, images, {**kind, "graphed": True}, sync_check=True)
        if not res[True]["out"] == res[False]["out"] == checked["out"]:
            raise AssertionError(f"pool {plabel}: graphed and eager ids differ")
        chunk_ms = {g: statistics.median(r["step_ms"]) for g, r in res.items()}
        print(f"2B pool {plabel} on {power}: graphed {chunk_ms[True]:.2f} ms per chunk, eager "
              f"{chunk_ms[False]:.2f} ms per chunk (median step, 8 slots x 8 steps, token "
              f"read-back included; {chunk_ms[False] / chunk_ms[True]:.2f} x), ids equal")

    print(f"{held[0]} answer-loop graph replays of the {label} model with no host sync "
          f"(the pools' chunks: their sync checks); " + _graph_captures(label))


SPEC_TOKENS = 128  # the graphed speculative caption's tokens (eos off)


def _mixed_run(model, encs, spec: int, graphed: bool) -> tuple:
    """A mixed pool (8 slots of 1024, chunk 8, max_objects MIXED_OBJECTS,
    the tokenizer's EOS, speculative `spec`) serving POOL_REQUESTS[:4]
    beside a detect, a point and a gaze request, drained: (the results in
    submission order, median ms per chunk with its read-back)."""
    eng = ContinuousBatchingEngine(model, n_slots=8, slot_len=1024, chunk=8,
                                   max_objects=MIXED_OBJECTS, speculative=spec, graphed=graphed)
    rids = [eng.submit(encs[i], question=q, max_tokens=POOL_TOKENS) for i, q in POOL_REQUESTS[:4]]
    rids += [eng.submit_detect(encs[0], "object"), eng.submit_point(encs[1], "object"),
             eng.submit_gaze(encs[2], MIXED_EYE)]
    step_ms = []
    while any(s.active for s in eng.slots) or eng._inflight:
        t0 = time.perf_counter()
        eng.step()
        step_ms.append(sync_ms(t0))
    return [eng.results[r] for r in rids], statistics.median(step_ms)


def phase_loop_graphs(model, enc, img, images, batch_images, power: str,
                      full: bool = True) -> None:
    """The speculative, reasoning and structured loops, the gaze step and
    the spec and mixed pool chunks against the same steps run eagerly, in
    turns in this call (a first graphed run that captures what it needs,
    then eager, graphed, graphed, eager): the batch-1 speculative caption
    (k 8, SPEC_TOKENS tokens, eos off; a sampled one from one seed,
    eager against graphed), and with `full` the reasoning loop (64 steps,
    the answer token off) and query(reasoning=True), detect (50 objects),
    point, detect_gaze in eye and accuracy mode, detect_batch over
    `batch_images`, and drained pools of each chunk kind that replays a
    graph: speculative (k 8), speculative sampled (temperature
    0.5, top_p 0.9, the pool's generator from seed 0), mixed and mixed
    speculative (k 8). Every replay runs under
    torch.cuda.set_sync_debug_mode("error"). Results must be equal bit for
    bit, and so must the launch counts of every run (a replay adds its
    capture's launches); a graphed run must replay at least one graph and
    its loops read the device at most ceil(steps / 8) + 1 times per call.
    Prints graphed and eager tok/s or ms, capture ms and graph pool bytes,
    replays and reads per path."""
    tok = model.config.tokenizer
    label = format_label(model)
    model.tokenizer = IdTokenizer()
    suppress = (tok.answer_id,)
    caption = list(tok.templates["caption"]["normal"])
    lines = []
    replay = graphs.StepGraph.replay

    def strict_replay(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            replay(self)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    graphs.StepGraph.replay = strict_replay
    try:
        _loop_graph_paths(model, enc, img, images, batch_images, full, label, lines,
                          suppress, caption)
    finally:
        graphs.StepGraph.replay = replay
    print(f"2B loop graphs ({label}) on {power}; every replay under sync debug mode "
          "\"error\", results and launch counts equal graphed and eager: " + "; ".join(lines))


def _loop_graph_paths(model, enc, img, images, batch_images, full, label, lines, suppress,
                      caption) -> None:
    """phase_loop_graphs' paths, each through `turns`."""
    tok = model.config.tokenizer

    def turns(name, call, unit: str) -> None:
        """call(graphed) -> (result, units, loop ms or None: the whole
        call). units / ms per second for tok/s and images/s; ms alone for
        a call or a pool chunk (units None)."""
        runs = {False: [], True: []}
        outs, first_capture = [], len(graphs.CAPTURES)
        for g in (True, False, True, True, False):
            model.graphed = g
            reset_launch_counts()
            reset_loop_counts()
            replays = sum(graphs.REPLAYS.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, units, ms = call(g)
            ms = sync_ms(t0) if ms is None else ms
            loops = {k: dict(v) for k, v in LOOP_COUNTS.items()}
            for loop, c in loops.items():
                if c["reads"] > math.ceil(c["steps"] / DONE_CHECK_EVERY) + c["calls"]:
                    raise AssertionError(f"{name}: {loop} read the device {c['reads']} times "
                                         f"in {c['steps']} steps")
            outs.append((out, dict(LAUNCHES)))
            runs[g].append((ms, units, loops, sum(graphs.REPLAYS.values()) - replays))
        model.graphed = True
        if any(o != outs[0][0] for o, _ in outs):
            raise AssertionError(f"{name} ({label}): graphed and eager results differ")
        if any(n != outs[0][1] for _, n in outs):
            raise AssertionError(f"{name} ({label}): launch counts differ: "
                                 f"{[n for _, n in outs]}")
        if not all(r[3] for r in runs[True][1:]) or any(r[3] for r in runs[False]):
            raise AssertionError(f"{name} ({label}): replays {runs}")
        caps = graphs.CAPTURES[first_capture:]
        rate = {g: statistics.median(
            [(u / (ms / 1e3)) if u is not None else ms for ms, u, _, _ in runs[g][-2:]])
            for g in (False, True)}
        ratio = rate[True] / rate[False] if unit != "ms" else rate[False] / rate[True]
        lines.append(
            f"{name}: graphed {rate[True]:.2f} {unit}, eager {rate[False]:.2f} {unit} "
            f"({ratio:.2f} x); {len(caps)} captures "
            f"({', '.join('%s %.1f ms' % (c['label'], c['ms']) for c in caps)}), graph pool bytes "
            f"{sum(c['pool_bytes'] for c in caps)}, {runs[True][-1][3]} replays, loops "
            f"{runs[True][-1][2]}")

    def spec_caption(g, sampled=False):
        kv = model.load_encoded_image(enc)
        _, _, first, pos, _ = model._prefill_prompt(kv, caption, enc.pos, 0.0, 0.0)
        bound = model._decode_bound(pos + SPEC_TOKENS + SPEC_K + 1)
        seed = model._spec_seed(caption)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sampled:
            gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
            res = generate_text_spec_sampled(model.text, kv, first, pos, gen, 0.5, 0.9,
                                             SPEC_TOKENS, -1, suppress, SPEC_K, bound, seed,
                                             graphed=g)
        else:
            res = generate_text_spec(model.text, kv, first, pos, SPEC_TOKENS, -1, suppress,
                                     SPEC_K, bound, seed, graphed=g)
        ms = sync_ms(t0)
        model._recycle_kv(kv)
        return res.tokens, res.count, ms

    turns(f"spec caption k {SPEC_K}", spec_caption, "tok/s")
    sampled = [spec_caption(g, sampled=True)[0] for g in (False, True)]
    if sampled[0] != sampled[1]:
        raise AssertionError(f"sampled spec caption ({label}): graphed ids differ from eager "
                             "ones from one seed")
    lines.append(f"sampled spec caption: graphed == eager from one seed ({len(sampled[0])} "
                 "tokens)")
    if full:
        tmpl = tok.templates["query"]
        r_prompt = (list(tmpl["prefix"]) + model._encode_text(POOL_QUESTION)
                    + list(tmpl["suffix"]) + [tok.thinking_id])

        def reasoning(g):
            _, hid, first, pos, kv = model._prefill_prompt(
                model.load_encoded_image(enc), r_prompt, enc.pos, 0.0, 0.0)
            bound = model._decode_bound(pos + 65)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = generate_reasoning(model.text, model.region, kv, first, hid, pos, None, 0.0,
                                     0.0, 64, -1, tok.coord_id, (tok.eos_id, tok.size_id),
                                     bound, graphed=g)
            ms = sync_ms(t0)
            model._recycle_kv(kv)
            return (res.tokens, res.is_coord, res.coord_vals), res.count, ms

        turns("reasoning loop (64 steps, answer token off)", reasoning, "tok/s")
        turns("query reasoning", lambda g: (model.query(
            enc, POOL_QUESTION, reasoning=True, settings=GREEDY64), None, None), "ms")
        turns("detect", lambda g: (model.detect(enc, "object"), None, None), "ms")
        turns("point", lambda g: (model.point(enc, "object"), None, None), "ms")
        turns("detect_gaze eye mode", lambda g: (
            model.detect_gaze(enc, eye=MIXED_EYE), None, None), "ms")

        def accuracy(g):
            random.seed(SEED)
            return model.detect_gaze(img, face=FACE, unstable_settings={
                "prioritize_accuracy": True}), None, None

        turns("detect_gaze accuracy mode (2 encodes, 20 rows)", accuracy, "ms")
        encs = model.encode_images(batch_images)
        turns(f"detect_batch of {len(encs)} encoded images", lambda g: (
            model.detect_batch(encs, "object"), None, None), "ms")
        pool_encs = [model.encode_image(im) for im in images]

        def pool(kind):
            def run(g):
                # a sampled pool's admissions draw the first token from the
                # model's generator: the same draws in every turn
                model.generator.manual_seed(SEED)
                res = _pool_run(model, images, {**kind, "graphed": g})
                return res["out"], None, statistics.median(res["step_ms"])
            return run

        turns(f"spec pool k {SPEC_K} (ms per chunk)", pool({"speculative": SPEC_K}), "ms")
        turns(f"spec sampled pool k {SPEC_K} (ms per chunk)", pool(
            {"speculative": SPEC_K, "temperature": 0.5, "top_p": 0.9}), "ms")
        for spec in (0, SPEC_K):
            def mixed(g, spec=spec):
                out, ms = _mixed_run(model, pool_encs, spec, g)
                return out, None, ms

            turns(f"mixed pool{' spec k %d' % spec if spec else ''} (ms per chunk)", mixed, "ms")


def phase_spec_eager_route(model, enc, power: str) -> dict:
    """Speculative decode on a GQA model (k 8, 64 greedy tokens): its verify
    spans take kernel A at a host position, so the span loop runs eagerly
    by configuration, under LOOP_COUNTS "generate_text_spec_eager", one
    host read per span plus one, with exact launches (kernel A on every
    layer for the prompt span and each verify span). Returns the launch
    counts."""
    cfg = model.config
    model.tokenizer = IdTokenizer()
    reset_launch_counts()
    reset_loop_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = _ids(model.caption(enc, "normal", settings={**GREEDY64, "speculative": SPEC_K})[
        "caption"])
    ms = sync_ms(t0)
    loops = {k: dict(v) for k, v in LOOP_COUNTS.items()}
    c = loops.get("generate_text_spec_eager")
    if list(loops) != ["generate_text_spec_eager"] or c["reads"] != c["steps"] + 1:
        raise AssertionError(f"GQA speculative caption: loops {loops}")
    launches = dict(LAUNCHES)
    check_launches(f"GQA spec caption, {len(ids)} tokens in {c['steps']} verify spans",
                   launches, expected_launches(cfg, 0, 1 + c["steps"], 0))
    print(f"2B GQA speculative caption k {SPEC_K} on {power}: the eager span loop "
          f"(generate_text_spec_eager), {len(ids) / (ms / 1e3):.1f} tok/s, {len(ids)} tokens "
          f"in {c['steps']} spans, {c['reads']} host reads")
    return launches


PIPE_BATCH = 8  # BatchPipeline's batch: 20 images give batches of 8, 8 and 4 + 4 padded rows


def _vit_groups(model, images) -> int:
    """The ViT calls encode_images makes: one per (crop count, tiling)."""
    return len({(c.shape[0], t) for c, t in map(model._crops, images)})


def _batches(images, bsz: int, pad: bool) -> list:
    """`images` in batches of `bsz`, the tail padded with its last image
    (as BatchPipeline pads it) or not (a PooledPipeline wave)."""
    out = []
    for start in range(0, len(images), bsz):
        chunk = images[start:start + bsz]
        out.append(chunk + [chunk[-1]] * (bsz - len(chunk)) if pad else chunk)
    return out


def _pipeline_launches(cfg, groups: list, steps: int = 0, spans: int = 0) -> dict:
    """Exact launches of BatchPipeline batches with `groups` ViT groups each:
    the ViT per group and one fused prefill of kernel A per text layer per
    batch, then `steps` lockstep decode steps (kernel B) or `spans`
    lockstep verify spans (kernel C), summed over the batches."""
    L = cfg.text.n_layers
    want = {name: 0 for name in LAUNCHES}
    want[K.FLASH] = sum(g * cfg.vision.enc_n_layers + L for g in groups)
    want[K.DECODE] = L * steps
    want[K.RAGGED] = L * spans
    return want


def phase_pipelines(model, images, power: str) -> list:
    """BatchPipeline on the 2B bf16 model over `images` (three sizes) at
    batch 8, 64 greedy tokens with eos off, in turns with encode_images +
    caption_batch over the same batches (serial, pipeline, pipeline,
    serial): images/s of both; every row's ids against caption_batch's
    (cut at caption_batch's EOS) under _check_margin's rule; exact launch
    counts and host reads of the counted pipeline run, and no new CUDA
    graph capture in the second. Then BatchPipeline(speculative=8): its
    rows against the plain pipeline's under the same rule, exact launches
    (every verify span takes kernel C on every layer), reads at most one
    per run of 8 spans plus one per batch, tok/s and the accept rate."""
    cfg = model.config
    eos, n_img = cfg.tokenizer.eos_id, len(images)
    model.tokenizer = IdTokenizer()
    tmpl = list(cfg.tokenizer.templates["caption"]["normal"])
    groups = [_vit_groups(model, b) for b in _batches(images, PIPE_BATCH, pad=True)]
    plain = BatchPipeline(model, batch_size=PIPE_BATCH, eos_id=-1)
    ms = {"serial": [], "pipeline": []}
    runs, captured = [], []
    for turn in ("serial", "pipeline", "pipeline", "serial"):
        reset_launch_counts()
        reset_loop_counts()
        before = len(graphs.CAPTURES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if turn == "serial":
            serial, encs = [], []
            for chunk in _batches(images, PIPE_BATCH, pad=False):
                encs += model.encode_images(chunk)
                serial += [_ids(t) for t in model.caption_batch(encs[-len(chunk):], "normal",
                                                                settings=GREEDY64)]
        else:
            piped = [_ids(t) for t in plain.caption(images, "normal", settings=GREEDY64)]
        ms[turn].append(sync_ms(t0))
        if turn == "pipeline":
            captured.append(sum(c["label"] == "generate_text_batched"
                                for c in graphs.CAPTURES[before:]))
            loop = dict(LOOP_COUNTS["generate_text_batched"])
            if len(captured) == 1:
                check_launches(f"BatchPipeline (2B bf16), {n_img} images in batches of "
                               f"{PIPE_BATCH}, ViT groups {groups}", dict(LAUNCHES),
                               _pipeline_launches(cfg, groups, steps=loop["steps"]))
                runs.append(dict(LAUNCHES))
            if (loop["calls"] != len(groups) or loop["steps"] != 64 * len(groups)
                    or loop["reads"] > math.ceil(loop["steps"] / DONE_CHECK_EVERY)
                    + loop["calls"]):
                raise AssertionError(f"BatchPipeline loop counts {loop}")
    if captured[1] != 0 or captured[0] > 2:
        raise AssertionError(f"BatchPipeline captured {captured} lockstep graphs in two runs "
                             "(at most one per recycled cache buffer, then none)")
    if len(piped) != n_img or any(len(r) != 64 for r in piped):
        raise AssertionError(f"BatchPipeline rows {[len(r) for r in piped]}")
    cut = lambda r: r[:r.index(eos)] if eos in r else r
    diffs = [_check_margin(f"BatchPipeline row {i}", model, enc, tmpl, want, cut(got), 64)
             for i, (enc, want, got) in enumerate(zip(encs, serial, piped))]
    best = {turn: min(v) for turn, v in ms.items()}
    print(f"2B BatchPipeline (bf16) on {power}: {n_img} images of three sizes, batch "
          f"{PIPE_BATCH}, 64 tokens: {n_img / (best['pipeline'] / 1e3):.2f} images/s "
          f"({ms['pipeline']} ms) vs encode_images + caption_batch "
          f"{n_img / (best['serial'] / 1e3):.2f} images/s ({ms['serial']} ms); lockstep "
          f"graph captures per pipeline run {captured}; vs caption_batch: "
          f"{sum(d is None for d in diffs)} of {n_img} rows equal"
          + "".join(f"; row {i} first differs at token {d[0]} (margin {d[1][0]}, {d[1][1]} "
                    f"bf16 steps)" for i, d in enumerate(diffs) if d))

    # BatchPipeline(speculative=8): the lockstep spec loop per batch
    results = []
    record = batched_engine.generate_text_spec_batched

    def recorded(*args, **kw):
        results.append(record(*args, **kw))
        return results[-1]

    spec = BatchPipeline(model, batch_size=PIPE_BATCH, eos_id=-1, speculative=SPEC_K)
    spec_ms = []
    batched_engine.generate_text_spec_batched = recorded
    try:
        for _ in range(2):
            results.clear()
            reset_launch_counts()
            reset_loop_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spec_ids = [_ids(t) for t in spec.caption(images, "normal", settings=GREEDY64)]
            spec_ms.append(sync_ms(t0))
    finally:
        batched_engine.generate_text_spec_batched = record
    loop = dict(LOOP_COUNTS["generate_text_spec_batched"])
    check_launches(f"BatchPipeline(speculative={SPEC_K}) (2B bf16), {loop['steps']} verify spans",
                   dict(LAUNCHES), _pipeline_launches(cfg, groups, spans=loop["steps"]))
    runs.append(dict(LAUNCHES))
    iters = sum(r.iters for r in results)
    if (loop["calls"] != len(groups) or loop["reads"] > sum(
            math.ceil(r.iters / DONE_CHECK_EVERY) + 1 for r in results)):
        raise AssertionError(f"BatchPipeline(speculative) loop counts {loop}, {iters} iterations")
    emitted = sum(int(r.counts.sum()) for r in results)
    diffs = [_check_margin(f"BatchPipeline(speculative) row {i}", model, enc, tmpl, want, got, 64)
             for i, (enc, want, got) in enumerate(zip(encs, piped, spec_ids))]
    tok = lambda t: n_img * 64 / (t / 1e3)
    print(f"2B BatchPipeline(speculative={SPEC_K}) (bf16) on {power}: {tok(min(spec_ms)):.1f} "
          f"tok/s ({spec_ms} ms) vs plain {tok(best['pipeline']):.1f} tok/s, crops and ViT "
          f"included; accept rate {emitted / (iters * PIPE_BATCH):.3f} tokens per row and "
          f"iteration ({emitted} tokens, {iters} iterations x {PIPE_BATCH} rows), "
          f"{loop['steps']} spans run, {loop['reads']} host reads; vs the plain pipeline: "
          f"{sum(d is None for d in diffs)} of {n_img} rows equal"
          + "".join(f"; row {i} first differs at token {d[0]} (margin {d[1][0]}, {d[1][1]} "
                    f"bf16 steps)" for i, d in enumerate(diffs) if d))
    return runs


def _serial_pool_ids(model, encs, max_tokens: int) -> list:
    """Each EncodedImage's caption through an 8-slot pool (1024, chunk 8,
    eos off), submitted one by one as slots free."""
    eng = ContinuousBatchingEngine(model, n_slots=8, slot_len=1024, chunk=8, eos_id=-1)
    rids = []
    for enc in encs:
        while not eng.free_slots():
            eng.step()
        rids.append(eng.submit(enc, max_tokens=max_tokens))
    out = eng.drain()
    return [_ids(out[r]) for r in rids]


def _pooled_pipeline_run(model, images, spec: int, label: str) -> tuple:
    """A PooledPipeline of 8 slots of 1024 (chunk 8, eos off, waves of 4)
    over `images` on a cold engine (its chunk graphs captured while the
    producer encodes), 64 greedy tokens each: exact launch counts (per
    wave one encode_images, per image a prompt span, per chunk 8 steps or
    verify iterations of kernel C), one read-back per chunk. Returns (ids,
    launches, ms, chunks)."""
    cfg = model.config
    L, quantized = cfg.text.n_layers, cfg.text.kv_int8
    pipe = PooledPipeline(model, n_slots=8, slot_len=1024, chunk=8, speculative=spec,
                          eos_id=-1)
    eng = pipe.engine
    counts = {"dispatch": 0, "read": 0}
    for name, attr in (("dispatch", "_dispatch_chunk"), ("read", "_process_oldest")):
        def counted(_fn=getattr(eng, attr), _name=name):
            counts[_name] += 1
            return _fn()
        setattr(eng, attr, counted)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [_ids(t) for t in pipe.caption(images, "normal", settings=GREEDY64)]
    ms = sync_ms(t0)
    launches = dict(LAUNCHES)
    chunks = counts["dispatch"]
    want = {name: 0 for name in LAUNCHES}
    want[K.FLASH] = sum(_vit_groups(model, w) * cfg.vision.enc_n_layers + L
                        for w in _batches(images, 4, pad=False))
    want[K.DECODE_INT8 if quantized else K.DECODE] = L * len(images)
    want[K.RAGGED_INT8 if quantized else K.RAGGED] = L * 8 * -(-max(spec, 1) // 16) * chunks
    if quantized:
        want[KQ.W4A16] = 4 * L * (len(images) + 8 * chunks)
    check_launches(f"PooledPipeline {label}, {len(images)} images, {chunks} chunks", launches,
                   want)
    if counts["read"] + len(eng._inflight) != chunks or any(len(r) != 64 for r in ids):
        raise AssertionError(f"PooledPipeline {label}: {counts}, rows {[len(r) for r in ids]}")
    return ids, launches, ms, chunks


def phase_pooled_pipelines(model, images, power: str) -> list:
    """PooledPipeline (8 slots of 1024, chunk 8) over `images`, plain and
    speculative k 8, each on a cold engine, against serial submissions of
    the same images to an 8-slot pool (ids under _check_margin's rule);
    tokens/s. Then submit_many of 8 images against 8 submit calls: equal
    ids where the submits take submit_many's encodes (encode_images), the
    margin rule where they encode each image alone, and admission ms of
    both."""
    cfg = model.config
    model.tokenizer = IdTokenizer()
    tmpl = list(cfg.tokenizer.templates["caption"]["normal"])
    encs = [model.encode_image(im) for im in images]
    serial = _serial_pool_ids(model, encs, 64)
    runs, lines = [], []
    for spec in (0, SPEC_K):
        label = f"(bf16, speculative {spec})"
        ids, launches, ms, chunks = _pooled_pipeline_run(model, images, spec, label)
        runs.append(launches)
        diffs = [_check_margin(f"PooledPipeline {label} request {i}", model, enc, tmpl, want,
                               got, 64, slots=1024)
                 for i, (enc, want, got) in enumerate(zip(encs, serial, ids))]
        lines.append(f"speculative {spec}: {len(images) * 64 / (ms / 1e3):.1f} tok/s "
                     f"({ms:.1f} ms, {chunks} chunks, cold engine, encode included); "
                     f"{sum(d is None for d in diffs)} of {len(images)} equal to serial "
                     "submissions" + "".join(
                         f"; request {i} first differs at token {d[0]} (margin {d[1][0]}, "
                         f"{d[1][1]} bf16 steps)" for i, d in enumerate(diffs) if d))
    print(f"2B PooledPipeline on {power}: " + "; ".join(lines))

    # submit_many against 8 submit calls
    burst = images[:8]
    kw = dict(n_slots=8, slot_len=1024, chunk=8, eos_id=-1)
    eng = ContinuousBatchingEngine(model, **kw)
    reset_launch_counts()
    chunks = [0]
    dispatch = eng._dispatch_chunk

    def counted():
        chunks[0] += 1
        dispatch()

    eng._dispatch_chunk = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = eng.submit_many(burst, max_tokens=POOL_TOKENS)
    many_ms = sync_ms(t0)
    out = eng.drain()
    many = [_ids(out[r]) for r in rids]
    L = cfg.text.n_layers
    want = {name: 0 for name in LAUNCHES}
    want[K.FLASH] = _vit_groups(model, burst) * cfg.vision.enc_n_layers + L
    want[K.DECODE] = L * len(burst)
    want[K.RAGGED] = L * 8 * chunks[0]
    check_launches(f"submit_many of {len(burst)} images, {chunks[0]} chunks", dict(LAUNCHES),
                   want)
    runs.append(dict(LAUNCHES))
    same_encs = model.encode_images(burst)
    eng = ContinuousBatchingEngine(model, **kw)
    rids = [eng.submit(enc, max_tokens=POOL_TOKENS) for enc in same_encs]
    out = eng.drain()
    if [_ids(out[r]) for r in rids] != many:
        raise AssertionError("submit_many ids differ from submit of its encodes")
    eng = ContinuousBatchingEngine(model, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(im, max_tokens=POOL_TOKENS) for im in burst]
    single_ms = sync_ms(t0)
    out = eng.drain()
    singles = [_ids(out[r]) for r in rids]
    diffs = [_check_margin(f"submit request {i}", model, enc, tmpl, want, got, POOL_TOKENS,
                           slots=1024)
             for i, (enc, want, got) in enumerate(zip(encs, singles, many))]
    print(f"2B submit_many (bf16) on {power}: {len(burst)} images admitted in {many_ms:.1f} ms "
          f"(one encode_images, {len(burst)} prompt prefills and slot writes) vs "
          f"{single_ms:.1f} ms for {len(burst)} submit calls; ids equal to submit of "
          f"submit_many's encodes; vs submit of each image: "
          f"{sum(d is None for d in diffs)} of {len(burst)} equal"
          + "".join(f"; request {i} first differs at token {d[0]} (margin {d[1][0]}, "
                    f"{d[1][1]} bf16 steps)" for i, d in enumerate(diffs) if d))
    return runs


def phase_int4_pooled_pipeline(model, images, power: str) -> list:
    """One PooledPipeline on the int4 + kv_int8 2B (C-int8, W4A16) over
    `images`, exact launches, tokens/s."""
    model.tokenizer = IdTokenizer()
    ids, launches, ms, chunks = _pooled_pipeline_run(model, images, 0, "(int4 + kv_int8)")
    print(f"2B PooledPipeline (int4 + kv_int8) on {power}: {len(images) * 64 / (ms / 1e3):.1f} "
          f"tok/s ({ms:.1f} ms, {len(images)} images, {chunks} chunks, cold engine)")
    return [launches]


# --------------------------------------------------------------- variants

VARIANT_RANK = 16  # the 2B adapters' rank
VARIANT_POOL_RANK = 8  # the variant pools' second adapter's rank


def write_adapter(path: str, cfg, rank: int, b_scale: float, seed: int) -> str:
    """A seeded LoRA adapter at `cfg`'s text widths, saved as a .pt state
    dict in the training checkpoint's legacy names (text_model.transformer.
    h.{i}.mixer.Wqkv.A, ...), as tests/test_lora.py writes one. A ~ N(0, 1)
    / sqrt(in), B ~ N(0, 1) x b_scale (b_scale 0: the no-op adapter); every
    value bf16-valued, so a bf16 model and an fp32 one hold the same
    factors."""
    tc = cfg.text
    rng = np.random.default_rng(seed)
    sites = {"mixer.Wqkv": (tc.dim, tc.qkv_dim), "mixer.out_proj": (tc.dim, tc.dim),
             "mlp.fc1": (tc.dim, tc.ff_dim), "mlp.fc2": (tc.ff_dim, tc.dim)}
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(BF16).float()
    state = {}
    for i in range(tc.n_layers):
        for site, (fin, fout) in sites.items():
            key = f"text_model.transformer.h.{i}.{site}"
            state[f"{key}.A"] = bf(rng.standard_normal((rank, fin)) / math.sqrt(fin))
            state[f"{key}.B"] = bf(rng.standard_normal((fout, rank)) * b_scale)
    torch.save(state, path)
    return path


def variant_adapters(folder: str) -> dict:
    """The 2B adapters of the variant phases, written into `folder`: "zero"
    (rank 16, B = 0), "real" (rank 16) and "real8" (rank 8)."""
    return {name: write_adapter(f"{folder}/2b-{name}.pt", MOONDREAM_2B, rank, scale, seed)
            for name, rank, scale, seed in (("zero", VARIANT_RANK, 0.0, SEED + 5),
                                            ("real", VARIANT_RANK, 0.02, SEED + 5),
                                            ("real8", VARIANT_POOL_RANK, 0.02, SEED + 6))}


def _device_launches(fn):
    """(fn()'s result, the device kernels and copies torch.profiler saw
    during it), graph replays included (CUPTI traces the kernels inside a
    replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    if not n:
        raise AssertionError("torch.profiler recorded no device events")
    return out, n


def phase_variants(model, img, images, power: str, adapters: dict) -> list:
    """LoRA variants on the 2B bf16 model (published widths, full depth),
    the adapters rank 16 at the 2B widths, loaded through
    settings["variant"] from their .pt files: `adapters["zero"]` (B = 0)
    and `adapters["real"]` (B nonzero). The no-op adapter gives the base
    model's first-step (prompt) logits and a 64-token greedy caption's ids
    bit for bit; the nonzero one changes the logits. Under it the graphed
    answer loop (64 greedy steps, eos off) equals eager at every id, with
    exact kernel launches (the adapter adds cuBLAS products and elementwise
    ops, no kernel of the port); its graphs, and the base model's, replay
    once more under torch.cuda.set_sync_debug_mode("error"); base, adapter,
    base and adapter again capture one new graph, the adapter's. Prints
    base and variant tok/s and ms per graphed step in turns, and the device
    launches per graphed decode step of both (torch.profiler). Then one
    detect and one BatchPipeline run of 4 images under the adapter, with
    exact launches. Returns the launch counts of the counted runs."""
    cfg, tok = model.config, model.config.tokenizer
    kinds = linear_kinds(model)
    model.tokenizer = IdTokenizer()
    tmpl = list(tok.templates["caption"]["normal"])
    suppress = (tok.answer_id,)
    real = {"variant": adapters["real"]}
    zero = {"variant": adapters["zero"]}
    t0 = time.perf_counter()
    lora = model._variant(real)
    if model._variant(real) is not lora or lora["mlp"]["fc2"]["A"].dtype != BF16:
        raise AssertionError("variant_state_dict: the cached bf16 adapter expected")
    load_ms = sync_ms(t0)
    runs = []

    def prompt(s):
        """The encode and the prompt prefill under settings s: (logits,
        first token, position, cache)."""
        enc = model.encode_image(img, settings=s)
        kv = model.load_encoded_image(enc)
        logits, _, first, pos, _ = model._prefill_prompt(kv, tmpl, enc.pos, 0.0, 0.0,
                                                         lora=model._variant(s))
        return logits, first, pos, kv

    def answer(s, graphed, count=False, profiled=False):
        """64 greedy steps (eos off) after the prompt: (ids, ms), or with
        `profiled` (ids, device launches of the 64 steps)."""
        _, first, pos, kv = prompt(s)
        run = lambda: generate_text(model.text, kv, first, pos, None, 0.0, 0.0, 64, -1,
                                    suppress, model._decode_bound(pos + 65), graphed=graphed,
                                    lora=model._variant(s))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res, ms = _device_launches(run) if profiled else (run(), None)
        ms = sync_ms(t0) if ms is None else ms
        if count:
            check_launches(f"answer loop under a variant (graphed {graphed}), 64 steps",
                           dict(LAUNCHES), expected_launches(cfg, 0, 0, 64, prefills=0, **kinds))
            runs.append(dict(LAUNCHES))
        model._recycle_kv(kv)
        return res.tokens, ms

    # the no-op adapter: the base model's bits; the real one: other logits
    logits = {name: prompt(s)[0] for name, s in (("base", None), ("zero", zero), ("real", real))}
    if not torch.equal(logits["zero"], logits["base"]):
        raise AssertionError("a zero-B adapter changed the prompt logits")
    if torch.equal(logits["real"], logits["base"]):
        raise AssertionError("the nonzero adapter left the prompt logits unchanged")
    moved = (logits["real"] - logits["base"]).abs().max().item()
    base_caption = model.caption(img, settings=GREEDY64)["caption"]
    if model.caption(img, settings={**GREEDY64, **zero})["caption"] != base_caption:
        raise AssertionError("a zero-B adapter changed the greedy caption")

    # base, adapter, base, adapter: one new capture, the adapter's
    captured, ids, ms = [], {}, {"base": [], "real": []}
    for name in ("base", "real", "base", "real"):
        before = len(graphs.CAPTURES)
        ids_, t = answer(None if name == "base" else real, True)
        captured.append(len(graphs.CAPTURES) - before)
        if ids.setdefault(name, ids_) != ids_:
            raise AssertionError(f"graphed answer loop ({name}): ids differ between runs")
        ms[name].append(t)
    if captured[1:] != [1, 0, 0]:
        raise AssertionError(f"captures per run base, variant, base, variant: {captured}")
    if ids["real"] == ids["base"]:
        raise AssertionError("the nonzero adapter left the greedy ids unchanged")
    eager, eager_ms = answer(real, False, count=True)
    if eager != ids["real"]:
        raise AssertionError("answer loop under a variant: graphed ids differ from eager")
    answer(real, True, count=True)
    for name in ("base", "real", "real", "base"):  # timed turns
        ms[name].append(answer(None if name == "base" else real, True)[1])

    # the adapter's and the base's graphs of this cache once more, no host sync
    _, _, _, kv = prompt(real)
    key = graphs.tensor_key(kv.k, kv.v, kv.ks, kv.vs)
    mine = [g for k, e in graphs.cache_of(model.text).entries.items()
            if k[-1] == key and k[0] == "generate_text" for g in e.graphs.values()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in mine:
            g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    model._recycle_kv(kv)
    if len(mine) < 2:
        raise AssertionError(f"{len(mine)} answer-loop graphs of this cache, 2 expected")

    per_step = {name: answer(None if name == "base" else real, True, profiled=True)[1]
                for name in ("base", "real")}
    tok_s = {n: statistics.median([64 / (t / 1e3) for t in v[-2:]]) for n, v in ms.items()}
    step_ms = {n: statistics.median(v[-2:]) / 64 for n, v in ms.items()}
    print(f"2B variants (bf16, rank {VARIANT_RANK}, adapter loaded in {load_ms:.1f} ms) on "
          f"{power}: zero-B adapter == base bit for bit (prompt logits, 64-token caption); "
          f"nonzero adapter moves the prompt logits by up to {moved:.4f}; graphed answer loop "
          f"base {tok_s['base']:.1f} tok/s ({step_ms['base']:.3f} ms per step), variant "
          f"{tok_s['real']:.1f} tok/s ({step_ms['real']:.3f} ms per step), in turns; eager "
          f"variant {64 / (eager_ms / 1e3):.1f} tok/s; graphed == eager ids; captures per run "
          f"base, variant, base, variant {captured}; {len(mine)} graphs replayed with no host "
          f"sync; device launches per graphed decode step (torch.profiler, one 64-step "
          f"call / 64): base {per_step['base'] / 64:.1f}, variant {per_step['real'] / 64:.1f}")

    # one detect and one BatchPipeline run under the adapter
    enc = model.encode_image(img, settings=real)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.detect(enc, "object", settings={**real, "max_objects": 8})
    detect_ms = sync_ms(t0)
    rows = out["objects"]
    check_launches("detect under a variant", dict(LAUNCHES),
                   expected_launches(cfg, 0, 1, batched_steps(3 * len(rows), 3 * 8), **kinds))
    runs.append(dict(LAUNCHES))
    if len(rows) > 8 or not all(math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"detect under a variant: {rows[:3]}")
    pipe_images = images[:3] + images[:1]
    groups = [_vit_groups(model, pipe_images)]
    reset_launch_counts()
    reset_loop_counts()
    t0 = time.perf_counter()
    piped = BatchPipeline(model, batch_size=4, eos_id=-1).caption(
        pipe_images, "normal", settings={**GREEDY64, **real})
    pipe_ms = sync_ms(t0)
    loop = LOOP_COUNTS["generate_text_batched"]
    check_launches("BatchPipeline under a variant", dict(LAUNCHES),
                   _pipeline_launches(cfg, groups, steps=loop["steps"]))
    runs.append(dict(LAUNCHES))
    if [len(_ids(t)) for t in piped] != [64] * 4:
        raise AssertionError(f"BatchPipeline under a variant: {[len(_ids(t)) for t in piped]}")
    print(f"2B variants (bf16) on {power}: detect {detect_ms:.1f} ms ({len(rows)} objects of "
          f"at most 8); BatchPipeline of 4 images, 64 tokens each, {pipe_ms:.1f} ms")
    return runs


def phase_variant_caption(model, img, power: str, adapters: dict) -> list:
    """One greedy caption (32 tokens, the prompt's EOS kept) under the
    nonzero adapter on a quantized 2B (int4 + kv_int8: W4A16 and B-int8;
    int8 w8a8: the w8a8 kernels), graphed and eager in turns, ids equal,
    exact launches. Returns the launch counts of the graphed run."""
    cfg = model.config
    label, kinds = format_label(model), linear_kinds(model)
    model.tokenizer = IdTokenizer()
    s = {"temperature": 0.0, "max_tokens": 32, "variant": adapters["real"]}
    enc = model.encode_image(img, settings=s)
    out, ms = {}, {}
    for graphed in (True, False, True):
        model.graphed = graphed
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            text = model.caption(enc, "normal", settings=s)["caption"]
            ms[graphed] = sync_ms(t0)
        finally:
            model.graphed = True
        if out.setdefault(graphed, text) != text:
            raise AssertionError(f"caption under a variant ({label}): ids differ between runs")
    if out[True] != out[False] or not out[True]:
        raise AssertionError(f"caption under a variant ({label}): graphed ids differ from eager")
    steps = batched_steps(len(_ids(out[True])), 32)
    check_launches(f"caption under a variant ({label}), {steps} steps", dict(LAUNCHES),
                   expected_launches(cfg, 0, 1, steps, **kinds))
    n = len(_ids(out[True]))
    print(f"2B variants ({label}) on {power}: caption under the adapter, {n} tokens, graphed "
          f"{ms[True]:.1f} ms, eager {ms[False]:.1f} ms, ids equal")
    return [dict(LAUNCHES)]


# each POOL_REQUESTS row's variant in the variant pools: base rows beside
# rows of the rank-16 ("r16") and rank-8 ("r8") adapters, an image under
# two variants and the base
VARIANT_ROWS = [None, "r16", "r8", None, "r16", "r8", "r16", None]
# a pooled row's first-forward logits may stray from batch-1's step under
# its own adapter by at most this share of the distance from that step to
# the nearest other adapter's (base included) at the same token: the row
# lies nearer its own adapter's step than any other's, by a factor 2
VARIANT_LOGIT_RATIO = 0.5


def _pool_view(loras: dict, vid: int):
    """Variant `vid`'s factors as a pool's chunks hold them: its slice of
    the stacked tree (leaves (L, r_max, d), ranks zero-padded to the
    pool's widest); None for the base (vid 0)."""
    if vid == 0:
        return None
    return {grp: {site: {f: t[:, vid] for f, t in pair.items()} for site, pair in sites.items()}
            for grp, sites in loras.items()}


def _variant_first_logits(model, variants: dict, trees: dict, encs_by: dict, kind: dict,
                          label: str) -> str:
    """Each row's own adapter in a pool's chunk, read at the logits: an eager
    pool of the 8 POOL_REQUESTS under VARIANT_ROWS (`kind`: {} or
    speculative) records the fp32 logits of its first chunk's first forward
    (position 0 of each verify span in a speculative pool), and the same
    forward from the same cache with every row through one vid, for each
    vid (run before the chunk's own). Raises unless every row equals, bit
    for bit, the forward with every row through its own vid (a row reads
    only its own factors; the products reduce alike) and differs from it
    under every other vid. Then each row's batch-1 step at the same token
    and position (its prompt prefilled under its own adapter, as `prepare`
    does) under every vid's factors as the pool holds them (`_pool_view`):
    raises where a row is farther from its own vid's step than
    VARIANT_LOGIT_RATIO of the distance from that step to the nearest
    other vid's (batch-1 reduces in another order, so this one is a
    distance). Returns a summary, with each rank-8 row's distance from its
    step under the unpadded adapter beside it."""
    eng = ContinuousBatchingEngine(model, n_slots=8, slot_len=1024, chunk=8, eos_id=-1,
                                   variants=variants, graphed=False, **kind)
    for (img, q), v in zip(POOL_REQUESTS, VARIANT_ROWS):
        eng.submit(encs_by[img, v], question=q, max_tokens=POOL_TOKENS, variant=v)
    name = "ragged_verify_step" if kind.get("speculative") else "ragged_decode_step"
    inner, seen, uniform = getattr(serving_engine, name), [], {}
    vids, n_layers = [0] + sorted(eng._vid_of.values()), len(model.text.blocks)
    take = lambda out: (out[0][:, 0] if isinstance(out, tuple) else out).float().clone()

    def first_forward(*args, **kwargs):
        if not seen:  # the chunk passes its per-layer adapters last
            for vid in vids:
                one = layer_adapters(eng._loras, n_layers, torch.full_like(eng.vid, vid))
                uniform[vid] = take(inner(*args[:-1], one, **kwargs))
        out = inner(*args, **kwargs)
        if not seen:
            seen.append(take(out))
        return out

    cur, pos0 = eng.cur.tolist(), eng.pos.tolist()
    setattr(serving_engine, name, first_forward)
    try:
        eng._dispatch_chunk()
    finally:
        setattr(serving_engine, name, inner)
    pooled = seen[0]
    errs, seps, unpadded = [], [], []
    for i, ((img, q), v) in enumerate(zip(POOL_REQUESTS, VARIANT_ROWS)):
        own = 0 if v is None else eng._vid_of[v]
        if not torch.equal(pooled[i], uniform[own][i]) or any(
                torch.equal(uniform[own][i], uniform[o][i]) for o in vids if o != own):
            raise AssertionError(
                f"variant pool ({label}) row {i} ({v or 'base'}): first-forward logits differ "
                f"from the forward with every row through vid {own}, or equal another vid's")
        enc = encs_by[img, v]
        _, _, first, pos, kv = model._prefill_prompt(
            model.load_encoded_image(enc, slots=1024), _prompt_of(model, q), enc.pos, 0.0, 0.0,
            lora=trees.get(v))
        if (int(first), pos) != (cur[i], pos0[i]):
            raise AssertionError(f"variant pool ({label}) row {i}: admitted token / position "
                                 f"{cur[i]} / {pos0[i]}, batch-1 {int(first)} / {pos}")
        bound = model._decode_bound(pos + POOL_TOKENS + 1)
        emb = text_encoder(torch.tensor([[int(first)]], device=DEV), model.text)

        def step(lora):
            return decode_step(model.text, kv, emb, pos, bound, lora)[0].reshape(-1).float()

        by_vid = {vid: step(_pool_view(eng._loras, vid)) for vid in vids}
        dist = lambda a, b: (a - b).abs().max().item()
        errs.append(dist(pooled[i], by_vid[own]))
        seps.append(min(dist(by_vid[own], by_vid[o]) for o in vids if o != own))
        if v == "r8":
            unpadded.append(dist(pooled[i], step(trees[v])))
        model._recycle_kv(kv)
        if not errs[-1] <= VARIANT_LOGIT_RATIO * seps[-1]:
            raise AssertionError(
                f"variant pool ({label}) row {i} ({v or 'base'}): first-forward logits "
                f"{errs[-1]:.4g} from batch-1 under its own factors, the nearest other "
                f"adapter {seps[-1]:.4g} (limit {VARIANT_LOGIT_RATIO} of it)")
    ratio = max(e / s for e, s in zip(errs, seps))
    return (f"first-forward logits: every row bit for bit the pool's forward with all rows "
            f"through its vid and unequal under the others; vs batch-1 under each row's pool "
            f"factors max |diff| per row {[round(e, 4) for e in errs]}, nearest other adapter "
            f"{[round(x, 3) for x in seps]} (largest ratio {ratio:.4f}, limit "
            f"{VARIANT_LOGIT_RATIO}); rank-8 rows vs their unpadded adapter "
            f"{[round(e, 4) for e in unpadded]}")


def phase_variant_pools(model, images, power: str, adapters: dict, full: bool = True) -> list:
    """Multi-variant pools on a 2B model at full width and depth: the 8
    POOL_REQUESTS (8 slots of 1024, chunk 8, eos -1, 48 tokens each) over
    VARIANT_ROWS, base rows beside rows of the rank-16 adapter
    `adapters["real"]` and the rank-8 `adapters["real8"]` in one graphed
    pool. A counted run with exact launches (the adapters add cuBLAS
    products, no kernel of the port); every row against the single-stream
    greedy ids under its variant's factors as the pool holds them
    (`_check_margin`'s rule: equal, or a first difference within 8 bf16
    steps of batch-1's logit margin); every row's first-forward logits
    (`_variant_first_logits`) bit for bit the pool's forward with all rows
    through its vid, and nearest batch-1's step under its own adapter.
    With `full` (the bf16 model): graphed equals eager; two chunks
    dispatched under torch.cuda.set_sync_debug_mode("error") (a capture
    and a replay); a pool whose every row runs the zero-B adapter
    `adapters["zero"]` equals a pool without variants bit for bit; a
    speculative variant pool (k 8) under both rules; the base and the
    variant pool timed in turns (base, variant, variant, base: ms per
    chunk, the median of the chunks after the capturing one, read-back
    included, and the full pool's tok/s) and the device launches of one
    replayed chunk of each (torch.profiler). Returns the counted runs'
    launches."""
    cfg, kinds = model.config, linear_kinds(model)
    label = format_label(model)
    L_txt, L_vit, kv8 = cfg.text.n_layers, cfg.vision.enc_n_layers, cfg.text.kv_int8
    model.tokenizer = IdTokenizer()
    trees = {name: model._variant({"variant": adapters[key]})
             for name, key in (("r16", "real"), ("r8", "real8"), ("zero", "zero"))}
    variants = {name: trees[name] for name in ("r16", "r8")}

    def counted(kind, label_, rows=VARIANT_ROWS, vs=variants):
        reset_launch_counts()
        run = _pool_run(model, images, kind, variants=vs, rows=rows)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        spec = kind.get("speculative", 0)
        n_enc, n_req = len(run["encs_by"]), len(POOL_REQUESTS)
        want = {name: 0 for name in LAUNCHES}
        want[K.FLASH] = n_enc * (L_vit + L_txt)  # each encode: ViT + image prefill
        want[K.DECODE_INT8 if kv8 else K.DECODE] = n_req * L_txt  # prompts
        want[K.RAGGED_INT8 if kv8 else K.RAGGED] = L_txt * 8 * -(-max(spec, 1) // 16) * run[
            "chunks"]
        if kinds["int4"]:  # the image prefills' 730 rows take a dense product
            want[KQ.W4A16] = 4 * L_txt * (n_req + 8 * run["chunks"])
        if kinds["int8"]:
            want[KQ.W8A8] += 4 * L_txt * (n_enc + n_req + 8 * run["chunks"])
        if kinds["int8_vit"]:
            want[KQ.W8A8] += 4 * L_vit * n_enc
        want[KQ.W8A8_QUANTIZE] = want[KQ.W8A8]
        check_launches(f"variant pool {label_} ({label}), {run['chunks']} chunks", launches,
                       want)
        return run, launches

    def against_single(run, label_):
        """Each row against the single-stream greedy ids under its variant:
        the prompt under its own adapter (as `prepare` runs it), the decode
        steps under the pool's factors of its vid (`_pool_view`: a rank-8
        adapter zero-padded to rank 16 reduces in the pool's shape)."""
        encs = [run["encs_by"][img, name] for (img, _), name in zip(POOL_REQUESTS, VARIANT_ROWS)]
        loras = [None if name is None else trees[name] for name in VARIANT_ROWS]
        vid_of = run["engine"]._vid_of
        views = [_pool_view(run["engine"]._loras, 0 if name is None else vid_of[name])
                 for name in VARIANT_ROWS]
        requests = [(i, q) for i, (_, q) in enumerate(POOL_REQUESTS)]
        by_index = {i: e for i, e in enumerate(encs)}
        refs = _batch1_refs(model, by_index, requests, POOL_TOKENS, loras=loras,
                            decode_loras=views)
        return [_check_margin(f"variant pool {label_} ({label}) request {i}", model, enc,
                              prompt, ids, got, POOL_TOKENS, slots=1024, lora=loras[i],
                              decode_lora=views[i])
                for i, ((enc, prompt, ids), got) in enumerate(zip(refs, run["out"]))]

    def differs(diffs):
        return "".join(f"; request {i} ({VARIANT_ROWS[i] or 'base'}) first differs at token "
                       f"{d[0]} ({d[1][1]} bf16 steps)" for i, d in enumerate(diffs) if d)

    run, launches = counted({}, "graphed")
    runs = [launches]
    diffs = against_single(run, "graphed")
    logits = _variant_first_logits(model, variants, trees, run["encs_by"], {}, label)
    print(f"2B variant pool ({label}, ranks {VARIANT_RANK} and {VARIANT_POOL_RANK}, rows "
          f"{[name or 'base' for name in VARIANT_ROWS]}) on {power}: {run['chunks']} chunks, "
          f"exact launches; vs single-stream greedy under each row's pool factors: "
          f"{sum(d is None for d in diffs)} of {len(diffs)} requests equal" + differs(diffs)
          + f"; {logits}")
    if not full:
        return runs

    eager = _pool_run(model, images, {"graphed": False}, variants=variants, rows=VARIANT_ROWS)
    checked = _pool_run(model, images, {}, sync_check=True, variants=variants,
                        rows=VARIANT_ROWS)
    if eager["out"] != run["out"] or checked["out"] != run["out"]:
        raise AssertionError(f"variant pool ({label}): graphed ids differ from eager, or "
                             "between runs")
    zero = _pool_run(model, images, {}, variants={"zero": trees["zero"]},
                     rows=["zero"] * len(POOL_REQUESTS))
    timed = {"base": [_pool_run(model, images, {})], "variant": [run]}
    base_out = timed["base"][0]["out"]
    if zero["out"] != base_out:
        raise AssertionError(f"zero-B variant pool ({label}): ids differ from the base pool's")
    # base rows as the base pool's; each adapter changes some row's ids
    same = [a == b for a, b in zip(run["out"], base_out)]
    moved = {name for name, eq in zip(VARIANT_ROWS, same) if not eq}
    if not all(eq for eq, name in zip(same, VARIANT_ROWS) if name is None) or moved != set(
            variants):
        raise AssertionError(f"variant pool ({label}): rows equal to the base pool's {same}")
    spec, spec_launches = counted({"speculative": SPEC_K}, f"spec k {SPEC_K}")
    runs.append(spec_launches)
    spec_diffs = against_single(spec, f"spec k {SPEC_K}")
    spec_logits = _variant_first_logits(model, variants, trees, spec["encs_by"],
                                        {"speculative": SPEC_K}, f"{label}, spec k {SPEC_K}")

    # timed in turns: variant (the counted run), base, variant, base
    timed["variant"].append(_pool_run(model, images, {}, variants=variants, rows=VARIANT_ROWS))
    timed["base"].append(_pool_run(model, images, {}))
    chunk_ms = {name: statistics.median([statistics.median(r["step_ms"][1:]) for r in rs])
                for name, rs in timed.items()}
    per_chunk = {}
    for name, vs in (("base", None), ("variant", variants)):
        eng = timed[name][-1]["engine"]  # its chunk graph is captured
        encs = timed[name][-1]["encs_by"]
        rows = VARIANT_ROWS if vs else [None] * len(POOL_REQUESTS)
        for (img, q), v in zip(POOL_REQUESTS, rows):
            eng.submit(encs[img, v], question=q, max_tokens=POOL_TOKENS, variant=v)
        eng.step()
        per_chunk[name] = _device_launches(eng.step)[1]
        eng.drain()
    print(f"2B variant pools ({label}) on {power}: graphed == eager ids; two chunks under sync "
          f"debug mode; zero-B pool == base pool bit for bit; rows equal to the base pool's "
          f"{same}; "
          f"spec k {SPEC_K} variant pool vs single-stream under the pool's factors: "
          f"{sum(d is None for d in spec_diffs)} of {len(spec_diffs)} requests equal"
          + differs(spec_diffs) + f" ({spec_logits}), accept rate "
          f"{spec['engine'].spec_accept_rate:.3f}; "
          f"in turns (variant, base, variant, base), ms per graphed chunk of 8 steps x 8 slots "
          f"(median, read-back included): base {chunk_ms['base']:.3f} "
          f"({64 / chunk_ms['base'] * 1e3:.1f} tok/s), variant {chunk_ms['variant']:.3f} "
          f"({64 / chunk_ms['variant'] * 1e3:.1f} tok/s); device launches per replayed chunk "
          f"(torch.profiler): base {per_chunk['base']}, variant {per_chunk['variant']}")
    return runs


# ------------------------------------------------------------- finetuning

# The smoke's text finetune LR: large enough that a bf16 weight moves by
# a few ulps per update (the CLI's 3e-6 moves almost none), so the graphed
# caption after training reads visibly trained weights.
FT_TEXT_LR = 1e-3


def _grad_vector(leaves) -> torch.Tensor:
    """Every leaf's gradient (None as zeros) as one fp32 CPU vector."""
    return torch.cat([(t.grad if t.grad is not None else torch.zeros_like(t)).float().cpu().ravel()
                      for _, t in leaves])


def phase_finetune_reference(img: np.ndarray) -> None:
    """One text and one region training step of the tiny config on one set
    of bf16-valued weights and one example (built in fp32 on the CPU): bf16
    on the card and bf16 on the CPU, each against fp32 on the CPU. The
    card's loss and gradient vector (L2, every leaf, the RoPE table
    included) may stray at most SMALL_REF_FACTOR times as far as the CPU's
    bf16 run does."""
    cfg = tiny_test_config()
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    state = {n: t.to(BF16).float() for n, t in state.items()}
    ref_model = MoondreamModel(cfg, build_params(cfg, "cpu", torch.float32), ByteTokenizer(),
                               torch.float32, device="cpu")
    ref_model.params.load_state_dict(state)
    example = finetune_text.build_example(ref_model, img, finetune_text.QUESTION,
                                          "a small test" + finetune_text.ANSWER_EOS)
    emb = ref_model._run_vision_encoder(img)
    rex = finetune_region.build_class_example(ref_model, emb, "thing", [[0.4, 0.5, 0.3, 0.2]])

    def run(device, dtype) -> dict:
        params = build_params(cfg, device, dtype)
        params.load_state_dict(state)
        out = {}
        for part in ("text", "region"):
            leaves = named_leaves(params[part])
            with trainable(leaves):
                if part == "text":
                    loss = finetune_trainer.text_loss(
                        params["text"], example["inputs_embeds"].to(device, dtype),
                        example["labels"].to(device), example["label_mask"].to(device))
                else:
                    with torch.no_grad():
                        hidden = produce_hidden(rex["inputs_embeds"].to(device, dtype),
                                                params["text"])
                    loss = finetune_trainer.region_loss(
                        params["region"], hidden, rex["labels"].to(device),
                        rex["c_idx"].to(device), rex["s_idx"].to(device))
                loss.backward()
            out[part] = (loss.item(), _grad_vector(leaves))
        return out

    ref, cpu, gpu = run("cpu", torch.float32), run("cpu", BF16), run(DEV, BF16)
    for part in ("text", "region"):
        (l_ref, g_ref), (l_cpu, g_cpu), (l_gpu, g_gpu) = ref[part], cpu[part], gpu[part]
        if not (math.isfinite(l_gpu) and torch.isfinite(g_gpu).all()):
            raise AssertionError(f"finetune reference ({part}): non-finite loss or gradient")
        rel = lambda g: float((g - g_ref).norm() / g_ref.norm())
        loss_err = {"card": abs(l_gpu - l_ref), "cpu bf16": abs(l_cpu - l_ref)}
        grad_err = {"card": rel(g_gpu), "cpu bf16": rel(g_cpu)}
        print(f"finetune reference ({part}, tiny, bf16 vs CPU fp32): loss {l_ref:.5f}, "
              f"|loss err| {loss_err}, gradient L2 rel err {grad_err}")
        for name, err in (("loss", loss_err), ("gradient", grad_err)):
            if err["card"] > SMALL_REF_FACTOR * err["cpu bf16"] + 1e-6:
                raise AssertionError(f"finetune reference ({part}) {name}: card {err['card']} "
                                     f"> {SMALL_REF_FACTOR} x CPU bf16 {err['cpu bf16']}")


def _timed_updates(optimizer) -> list:
    """Wrap optimizer.update so that each call's device ms (synchronized)
    and whether it updated the weights are recorded; returns the record."""
    record, inner = [], optimizer.update

    def update(state, leaves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emitted = inner(state, leaves)
        record.append((sync_ms(t0), emitted))
        return emitted

    optimizer.update = update
    return record


def _train_flops(cfg, seq: int) -> float:
    """Matrix-product operations of one text training step (forward and
    backward, 3x the forward) at `seq` positions: the block linears and
    the lm head, 2 per weight per position, and the attention's two
    products over seq^2 positions per head."""
    tc = cfg.text
    per_layer = tc.dim * tc.qkv_dim + tc.dim * tc.dim + 2 * tc.dim * tc.ff_dim
    weights = tc.n_layers * per_layer + tc.dim * tc.vocab_size
    attn = tc.n_layers * 4 * seq * seq * tc.dim
    return 3 * (2 * seq * weights + attn)


def _snapshot(model, parts) -> dict:
    return {p: [t.detach().clone() for _, t in named_leaves(model.params[p])] for p in parts}


def _unchanged(model, snap: dict, label: str) -> None:
    for part, saved in snap.items():
        for (name, t), old in zip(named_leaves(model.params[part]), saved):
            if not torch.equal(t, old):
                raise AssertionError(f"{label}: {part}.{name} changed")


def phase_finetune(power: str) -> list:
    """Finetuning at MOONDREAM_2B's published widths and depth on seeded
    random bf16 weights, through the CLIs' functions (build_example /
    build_class_example, cli_optimizer, the training steps): the text
    finetune over four synthetic 378x378 images (finetune_text.
    synthetic_dataset) at grad-accum 2, two updates at FT_TEXT_LR; the
    region finetune over two samples with one box each at grad-accum 1
    (the CLI's LR). A greedy caption captures its CUDA graphs before the
    training; after it the graphed caption (no new capture) must equal an
    eager one on the same weights. Checks: finite losses; vision and region
    bit for bit unchanged by the text finetune, text and vision by the
    region one; wte moved by weight decay alone (zero moments, the decay
    arithmetic); the saved .pt reloads through load_params to equal
    tensors; exact kernel A launches (27 per ViT call). Prints ms per
    mini-step (forward + backward) and per optimizer call, training
    tokens/s and peak memory. Returns the launch counts of the text
    finetune, the region finetune and the post-training caption."""
    cfg = MOONDREAM_2B
    graphs.reset_graph_counts()
    model = MoondreamModel(cfg, None, ByteTokenizer(), BF16, seed=SEED, device=DEV)
    greedy = {"temperature": 0.0, "max_tokens": 32}
    probe = finetune_text.synthetic_dataset(1)[0]["image"]
    model.tokenizer = IdTokenizer()  # the training examples' ids are the same
    before = model.caption(probe, settings=greedy)["caption"]
    runs = []

    # -- text
    dataset = finetune_text.synthetic_dataset(4)
    grad_accum, epochs = 2, 1
    optimizer = finetune_trainer.cli_optimizer(FT_TEXT_LR, epochs * len(dataset) // grad_accum,
                                               grad_accum)
    updates = _timed_updates(optimizer)
    state = finetune_trainer.init_train_state(model.text, optimizer)
    train_step = finetune_trainer.make_train_step(optimizer)
    frozen = _snapshot(model, ("vision", "region"))
    wte0 = model.text.wte.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    steps, seqs, losses = [], [], []
    for sample in dataset:
        batch = finetune_text.build_example(model, sample["image"], finetune_text.QUESTION,
                                            f"{sample['description']}{finetune_text.ANSWER_EOS}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(state, batch)
        steps.append(sync_ms(t0))
        seqs.append(batch["inputs_embeds"].shape[1])
        losses.append(loss.item())
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launches("text finetune (4 ViT calls)", launches,
                   expected_launches(cfg, len(dataset), 0, 0, prefills=0))
    runs.append(launches)
    if not all(math.isfinite(x) for x in losses) or state.opt_state.count != 2:
        raise AssertionError(f"text finetune: losses {losses}, updates {state.opt_state.count}")
    _unchanged(model, frozen, "text finetune")
    # wte: zero moments, and exactly the decay arithmetic of both updates
    i_wte = [n for n, _ in named_leaves(model.text)].index("wte")
    if state.opt_state.mu[i_wte].any() or state.opt_state.nu[i_wte].any():
        raise AssertionError("text finetune: wte has nonzero moments")
    as_bf16 = lambda x: torch.tensor(x, dtype=torch.float64).to(BF16).item()
    want = wte0
    for count in range(2):  # g = 0: mu = nu = 0, so the update is lr * (wd * p)
        lr = float(optimizer.learning_rate(count))
        want = want + (want * as_bf16(optimizer.weight_decay)) * as_bf16(-lr)
    if not torch.equal(model.text.wte, want):
        raise AssertionError("text finetune: wte moved otherwise than by weight decay")
    mini = [s - u for s, (u, _) in zip(steps, updates)]
    upd = [u for u, emitted in updates if emitted]
    flops = _train_flops(cfg, seqs[0])
    print(f"text finetune (2B bf16, {len(dataset)} examples of {seqs[0]} positions, grad-accum "
          f"{grad_accum}, 2 updates, lr {FT_TEXT_LR}) on {power}: losses "
          f"{[round(x, 4) for x in losses]}; ms per mini-step (forward + backward) "
          f"{[round(x, 1) for x in mini]}; ms per optimizer update {[round(x, 1) for x in upd]} "
          f"(accumulate-only calls {[round(u, 1) for u, e in updates if not e]}); training "
          f"tokens/s {sum(seqs) / (sum(mini) / 1e3):.0f} (padded positions, forward + backward); "
          f"bf16 operations bound per mini-step {flops / PEAK_BF16_FLOP_S * 1e3:.2f} ms; "
          f"max_memory_allocated {peak} bytes; wte elements moved "
          f"{int((model.text.wte != wte0).sum())} of {wte0.numel()}")

    # -- region
    rdata = finetune_region.synthetic_dataset(2)
    roptimizer = finetune_trainer.cli_optimizer(finetune_region.LR, len(rdata), 1)
    rupdates = _timed_updates(roptimizer)
    rstate = finetune_trainer.init_train_state(model.region, roptimizer)
    rstep = finetune_region.make_train_step(roptimizer, model.text)
    frozen = _snapshot(model, ("vision", "text"))
    region0 = _snapshot(model, ("region",))["region"]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rsteps, rseqs, rlosses = [], [], []
    for sample in rdata:
        with torch.no_grad():
            emb = model._run_vision_encoder(sample["image"])
        batch = finetune_region.build_class_example(model, emb, sample["labels"][0],
                                                    sample["boxes"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rstate, loss = rstep(rstate, batch)
        rsteps.append(sync_ms(t0))
        rseqs.append(batch["inputs_embeds"].shape[1])
        rlosses.append(loss.item())
    launches = dict(LAUNCHES)
    rpeak = torch.cuda.max_memory_allocated()
    check_launches("region finetune (2 ViT calls)", launches,
                   expected_launches(cfg, len(rdata), 0, 0, prefills=0))
    runs.append(launches)
    if not all(math.isfinite(x) for x in rlosses) or rstate.opt_state.count != 2:
        raise AssertionError(f"region finetune: losses {rlosses}")
    _unchanged(model, frozen, "region finetune")
    rmoved = {name: int((t != old).sum()) for (name, t), old in
              zip(named_leaves(model.region), region0)}
    if not all(rmoved[f"{d}.fc2.w"] for d in ("coord_decoder", "size_decoder")):
        raise AssertionError(f"region finetune: the decoders did not move {rmoved}")
    rmini = [s - u for s, (u, _) in zip(rsteps, rupdates)]
    print(f"region finetune (2B bf16, {len(rdata)} examples of {rseqs} positions, grad-accum 1, "
          f"lr {finetune_region.LR}) on {power}: losses {[round(x, 4) for x in rlosses]}; ms per "
          f"mini-step (text forward without gradients + region forward and backward) "
          f"{[round(x, 1) for x in rmini]}; ms per optimizer update "
          f"{[round(u, 2) for u, _ in rupdates]}; max_memory_allocated {rpeak} bytes; region "
          f"elements moved {rmoved}")

    # -- save and reload
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/finetuned.pt"
        t0 = time.perf_counter()
        finetune_text.save_params(path, model)
        save_s = time.perf_counter() - t0
        loaded = load_params(path, cfg, BF16, device=DEV)
    for (name, a), (_, b) in zip(loaded.named_parameters(), model.params.named_parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"saved .pt reloads {name} differently")
    del loaded

    # -- the graphed caption on the trained weights
    captures, replays = len(graphs.CAPTURES), sum(graphs.REPLAYS.values())
    reset_launch_counts()
    after = model.caption(probe, settings=greedy)["caption"]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if len(graphs.CAPTURES) != captures or sum(graphs.REPLAYS.values()) == replays:
        raise AssertionError("the post-training caption did not replay the earlier graphs")
    steps = batched_steps(len(_ids(after)), greedy["max_tokens"])
    check_launches(f"caption after finetuning, {steps} steps", launches,
                   expected_launches(cfg, 1, 1, steps))
    runs.append(launches)
    eager = MoondreamModel(cfg, model.params, IdTokenizer(), BF16, device=DEV, graphed=False)
    if eager.caption(probe, settings=greedy)["caption"] != after:
        raise AssertionError("graphed caption after training differs from the eager one")
    print(f"after finetuning on {power}: save_params .pt {save_s:.1f} s, reloads equal; the "
          f"graphed caption (graphs captured before training, replayed) equals the eager one; "
          f"caption ids changed by training: {after != before} "
          f"({len(_ids(before))} -> {len(_ids(after))} tokens)")
    return runs


# ------------------------------------------------------------ steering

STEER_SCALE = 4.2  # the steering phases' scale (repeng.DEFAULT_SCALE)
# A second vector's scale on the 2B: random weights (N(0, 1/fan_in)) carry
# a residual stream of norm ~200, which a unit vector at 4.2 nudges without
# turning a greedy id; at this scale it must turn some.
STEER_SCALE_LARGE = 256.0


def steer_vector(cfg, seed: int) -> np.ndarray:
    """Seeded unit rows (n_layers, dim), bf16-valued, so that a bf16 model
    and an fp32 one add the same vector."""
    vec = torch.randn((cfg.text.n_layers, cfg.text.dim), generator=torch.Generator().manual_seed(seed))
    return (vec / vec.norm(dim=-1, keepdim=True)).to(BF16).float().numpy()


def phase_steer_reference(img: np.ndarray) -> None:
    """The steered caption on the tiny config, on one set of bf16-valued
    weights with lm_head's bias + N(0, 1) (the peaked oracle), a seeded
    unit-row vector at STEER_SCALE: bf16 on the card and bf16 on the CPU,
    each against fp32 on the CPU, for the steered prompt's logits and one
    steered decode step's (SMALL_REF_FACTOR times the CPU's bf16 error);
    then the steered caption's ids (16 greedy tokens, fused and streamed)
    on the card must equal the CPU's fp32 ids, which the vector must have
    changed."""
    cfg = tiny_test_config()
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    b = state["text.lm_head.b"]
    state["text.lm_head.b"] = b + torch.randn(b.shape, generator=torch.Generator().manual_seed(
        SEED + 7))
    state = {n: t.to(BF16).float() for n, t in state.items()}
    steer = {"steer": steer_vector(cfg, SEED + 8), "steer_scale": STEER_SCALE}
    greedy = {"temperature": 0.0, "max_tokens": 16}
    tmpl = list(cfg.tokenizer.templates["caption"]["normal"])

    def run(device, dtype) -> tuple:
        params = build_params(cfg, device, dtype)
        params.load_state_dict(state)
        m = MoondreamModel(cfg, params, IdTokenizer(), dtype, device=device)
        enc = m.encode_image(img)
        vec = m._steer_vectors(steer)
        kv = m.load_encoded_image(enc)
        logits, _, _, pos, kv = m._prefill_prompt(kv, tmpl, enc.pos, 0.0, 0.0, steer=vec)
        emb = text_encoder(torch.tensor([[300]], device=device), m.text)
        step = decode_step(m.text, kv, emb, pos, m._decode_bound(pos + 8), steer=vec)[0]
        ids = {"steered": m.caption(enc, settings={**greedy, **steer})["caption"],
               "streamed": "".join(m.caption(enc, stream=True,
                                             settings={**greedy, **steer})["caption"]),
               "unsteered": m.caption(enc, settings=greedy)["caption"]}
        return {"logits": logits.float().cpu(), "decode logits": step.float().cpu()}, ids

    (ref, want), (cpu, _), (card, got) = run("cpu", torch.float32), run("cpu", BF16), run(DEV, BF16)
    rel = lambda out: {n: ((out[n] - ref[n]).abs().max() / ref[n].abs().max()).item() for n in ref}
    err_card, err_cpu = rel(card), rel(cpu)
    print(f"steer reference (tiny config, scale {STEER_SCALE}, vs fp32 on the cpu), rel max err: "
          f"card bf16 { {n: round(e, 5) for n, e in err_card.items()} }, cpu bf16 "
          f"{ {n: round(e, 5) for n, e in err_cpu.items()} }; steered ids "
          f"{len(_ids(got['steered']))} tokens, card == cpu fp32: {got == want}")
    if not all(err_card[n] <= SMALL_REF_FACTOR * err_cpu[n] for n in ref):
        raise AssertionError(f"steer reference mismatch: {err_card} vs {err_cpu}")
    if want["steered"] == want["unsteered"] or want["streamed"] != want["steered"]:
        raise AssertionError(f"steer reference is not decisive: {want}")
    if got != want:
        raise AssertionError(f"steered ids on the card differ from the cpu's: {got} vs {want}")


def phase_steer(model, img, images, power: str) -> list:
    """Steering on the 2B bf16 model (published widths, full depth), a
    seeded unit-row vector at STEER_SCALE: the steered caption and query
    (64 greedy tokens), graphed and eager in turns, ids equal bit for bit
    and exact launches (steering adds no kernel of the port: one add per
    block); their steered graphs replay once more under
    torch.cuda.set_sync_debug_mode("error"); the streamed caption equals
    the fused one; a zero scale gives the unsteered ids; a speculative
    (k 8) steered caption against plain steered greedy (the logit-margin
    rule) with exact launches; steered and unsteered ms per graphed step
    (64 steps, eos off) in turns and device launches per graphed step
    (torch.profiler); the vector moves the prompt's logits; two vectors and
    scales replay one graph, the second (STEER_SCALE_LARGE) turning greedy
    ids, equal to its eager run. Then
    HiddenStateCollector.collect over two images at 8 greedy tokens for a
    positive and a negative prompt, train_control_vectors, and a caption
    steered by the trained vector. Returns the counted runs' launches."""
    cfg, tok = model.config, model.config.tokenizer
    kinds = linear_kinds(model)
    model.tokenizer = IdTokenizer()
    vec = steer_vector(cfg, SEED + 9)
    steer = {"steer": vec, "steer_scale": STEER_SCALE}
    steered = {**GREEDY64, **steer}
    enc = model.encode_image(img)
    tmpl = cfg.tokenizer.templates
    tasks = {
        "caption": (list(tmpl["caption"]["normal"]),
                    lambda s: model.caption(enc, "normal", settings=s)["caption"]),
        "query": (list(tmpl["query"]["prefix"]) + model._encode_text(POOL_QUESTION)
                  + list(tmpl["query"]["suffix"]),
                  lambda s: model.query(enc, POOL_QUESTION, settings=s)["answer"]),
    }
    runs, lines, ids = [], [], {}
    for task, (prompt, call) in tasks.items():
        base = _ids(call(GREEDY64))
        out, ms = {}, {True: [], False: []}
        for graphed in (True, False, True, False):
            model.graphed = graphed
            try:
                reset_launch_counts()
                t0 = time.perf_counter()
                got = _ids(call(steered))
                ms[graphed].append(sync_ms(t0))
            finally:
                model.graphed = True
            if out.setdefault(graphed, got) != got:
                raise AssertionError(f"steered {task}: ids differ between runs")
            check_launches(f"steered {task} (graphed {graphed}), {len(got)} tokens",
                           dict(LAUNCHES), expected_launches(
                               cfg, 0, 1, batched_steps(len(got), 64), **kinds))
            runs.append(dict(LAUNCHES))
        if out[True] != out[False] or not out[True]:
            raise AssertionError(f"steered {task}: graphed ids differ from eager")
        ids[task] = out[True]
        lines.append(f"{task} {len(out[True])} tokens, graphed {min(ms[True]):.1f} ms, eager "
                     f"{min(ms[False]):.1f} ms, ids equal; ids "
                     + ("equal the unsteered ones" if out[True] == base else
                        f"first differ from unsteered at token {_first_diff(out[True], base)}"))
    caption = tasks["caption"][1]
    streamed = _ids("".join(model.caption(enc, "normal", stream=True, settings=steered)["caption"]))
    if streamed != ids["caption"]:
        raise AssertionError("steered caption: streamed ids differ from fused")
    if _ids(caption({**GREEDY64, "steer": vec, "steer_scale": 0.0})) != _ids(caption(GREEDY64)):
        raise AssertionError("steered caption at scale 0 differs from the unsteered one")

    # the steered graphs (caption and query) once more, no host sync
    mine = [g for k, e in graphs.cache_of(model.text).entries.items()
            if k[0] == "generate_text" and k[6] is True for g in e.graphs.values()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in mine:
            g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not mine:
        raise AssertionError("no steered answer-loop graph")

    # speculative k 8, steered: the first run captures, the second replays
    spec_first = _ids(caption({**steered, "speculative": SPEC_K}))
    reset_launch_counts()
    reset_loop_counts()
    t0 = time.perf_counter()
    spec = _ids(caption({**steered, "speculative": SPEC_K}))
    spec_ms = sync_ms(t0)
    if spec != spec_first:
        raise AssertionError("steered spec caption: ids differ between runs")
    loop = dict(LOOP_COUNTS["generate_text_spec"])
    check_launches(f"steered spec caption, {len(spec)} tokens in {loop['steps']} verify spans",
                   dict(LAUNCHES), expected_launches(cfg, 0, 1 + loop["steps"], 0, **kinds))
    runs.append(dict(LAUNCHES))
    diff = _check_margin("steered spec caption", model, enc, tasks["caption"][0],
                         ids["caption"], spec, 64, steer=model._steer_vectors(steer))
    lines.append(f"spec k {SPEC_K} caption {len(spec) / (spec_ms / 1e3):.1f} tok/s "
                 f"({loop['steps']} verify spans; "
                 + ("ids equal plain steered greedy" if diff is None else
                    f"first differs at token {diff[0]}, margin {diff[1][0]} ({diff[1][1]} bf16 "
                    f"steps)") + ")")

    # 64 eos-off steps, steered and unsteered, in turns
    prompt = tasks["caption"][0]
    suppress = (tok.answer_id,)

    def answer(s, profiled=False, graphed=True):
        vec_t = model._steer_vectors(s)
        kv = model.load_encoded_image(enc)
        logits, _, first, pos, _ = model._prefill_prompt(kv, prompt, enc.pos, 0.0, 0.0,
                                                         steer=vec_t)
        run = lambda: generate_text(model.text, kv, first, pos, None, 0.0, 0.0, 64, -1, suppress,
                                    model._decode_bound(pos + 65), graphed=graphed, steer=vec_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, n = _device_launches(run) if profiled else (run(), None)
        t = sync_ms(t0)
        model._recycle_kv(kv)
        return res.tokens, (n if profiled else t), logits

    captures = len(graphs.CAPTURES)
    other = {"steer": steer_vector(cfg, SEED + 10), "steer_scale": STEER_SCALE_LARGE}
    step_ms = {"unsteered": [], "steered": []}
    seen, logits = {}, {}
    for name, s in (("unsteered", None), ("steered", steer), ("steered", other),
                    ("steered", steer), ("unsteered", None), ("steered", steer),
                    ("steered", steer), ("unsteered", None)):
        got, t, logits[name if s is not other else "other"] = answer(s)
        key = "other" if s is other else name
        if seen.setdefault(key, got) != got:
            raise AssertionError(f"64 steps {key}: ids differ between runs")
        if s is not other:
            step_ms[name].append(t / 64)
    new_captures = len(graphs.CAPTURES) - captures
    if new_captures > 2:
        raise AssertionError(f"two vectors and scales: {new_captures} new captures (at most the "
                             "steered and unsteered graphs of this cache)")
    moved = (logits["steered"] - logits["unsteered"]).abs().max().item()
    if moved == 0.0:
        raise AssertionError("the steering vector left the prompt's logits unchanged")
    if seen["other"] in (seen["steered"], seen["unsteered"]):
        raise AssertionError(f"the vector at scale {STEER_SCALE_LARGE} turned no greedy id")
    if answer(other, graphed=False)[0] != seen["other"]:
        raise AssertionError("the second vector's graph replay differs from its eager run")
    per_step = {name: answer(s, profiled=True)[1] / 64
                for name, s in (("unsteered", None), ("steered", steer))}
    med = {n: statistics.median(v[1:]) for n, v in step_ms.items()}
    lines.append(f"graphed answer loop (64 steps, eos off) ms per step unsteered "
                 f"{med['unsteered']:.4f}, steered {med['steered']:.4f} "
                 f"({100 * (med['steered'] / med['unsteered'] - 1):+.2f}%), in turns; device "
                 f"launches per step (torch.profiler) unsteered {per_step['unsteered']:.1f}, "
                 f"steered {per_step['steered']:.1f}; the vector moves the prompt's logits by up "
                 f"to {moved:.4f}; a second vector at scale {STEER_SCALE_LARGE} replayed the "
                 f"steered graph ({new_captures} new captures in the turns), its ids first "
                 f"differ from the unsteered at token {_first_diff(seen['other'], seen['unsteered'])}"
                 f" and equal its eager run")

    # the collector and the trainer
    reps = HiddenStateCollector(model)
    kw = dict(samples_per_image=1, max_tokens=8, temperature=0.0)
    t0 = time.perf_counter()
    pos_h = reps.collect(images[:2], "Describe this image in a happy tone.", **kw)
    neg_h = reps.collect(images[:2], "Describe this image in a sad tone.", **kw)
    collect_ms = sync_ms(t0)
    t0 = time.perf_counter()
    cv = train_control_vectors(pos_h, neg_h)
    train_ms = (time.perf_counter() - t0) * 1e3
    shapes = {s.shape for s in pos_h + neg_h}
    norms = np.linalg.norm(cv.directions, axis=-1)
    if (shapes != {(cfg.text.n_layers, cfg.text.dim)}
            or not all(np.isfinite(s).all() for s in pos_h + neg_h)
            or not np.allclose(norms, 1.0, atol=1e-4)):
        raise AssertionError(f"collector: shapes {shapes}, direction norms {norms}")
    trained = _ids(caption({**GREEDY64, "steer": cv}))
    if not trained:
        raise AssertionError("the caption steered by the trained vector is empty")
    lines.append(f"collect 2 images x 2 prompts at 8 greedy tokens: {len(pos_h)} + {len(neg_h)} "
                 f"states in {collect_ms:.0f} ms; train_control_vectors {train_ms:.1f} ms; the "
                 f"trained vector's caption {len(trained)} tokens")
    print(f"2B steering (bf16, scale {STEER_SCALE}) on {power}: " + "; ".join(lines))
    return runs


def phase_steer_caption(model, img, power: str) -> list:
    """One steered greedy caption (32 tokens, the prompt's EOS kept) on a
    quantized 2B (int4 + kv_int8: W4A16 and B-int8), graphed and eager in
    turns, ids equal, exact launches. Returns the launch counts of the
    graphed run."""
    cfg = model.config
    label, kinds = format_label(model), linear_kinds(model)
    model.tokenizer = IdTokenizer()
    greedy = {"temperature": 0.0, "max_tokens": 32}
    s = {**greedy, "steer": steer_vector(cfg, SEED + 9), "steer_scale": STEER_SCALE}
    enc = model.encode_image(img)
    out, ms = {}, {}
    for graphed in (True, False, True):
        model.graphed = graphed
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            text = model.caption(enc, "normal", settings=s)["caption"]
            ms[graphed] = sync_ms(t0)
        finally:
            model.graphed = True
        if out.setdefault(graphed, text) != text:
            raise AssertionError(f"steered caption ({label}): ids differ between runs")
    if out[True] != out[False] or not out[True]:
        raise AssertionError(f"steered caption ({label}): graphed ids differ from eager")
    n = len(_ids(out[True]))
    check_launches(f"steered caption ({label}), {batched_steps(n, 32)} steps", dict(LAUNCHES),
                   expected_launches(cfg, 0, 1, batched_steps(n, 32), **kinds))
    print(f"2B steering ({label}) on {power}: steered caption {n} tokens, graphed "
          f"{ms[True]:.1f} ms, eager {ms[False]:.1f} ms, ids equal")
    return [dict(LAUNCHES)]


# ------------------------------------------------------------ LoRA finetuning

LORA_FT_RANK = 16  # the 2B adapter finetune's rank


def _checksum(leaves) -> float:
    """Sum of every element in float64: a fingerprint of the weights' bits
    (equality is checked tensor by tensor besides)."""
    return sum(t.detach().double().sum().item() for _, t in leaves)


def phase_lora_finetune(power: str) -> list:
    """Adapter-only finetuning at MOONDREAM_2B's published widths and depth
    on seeded random bf16 weights, as `finetune_text --lora-rank 16` runs
    it: a rank-16 fp32 adapter (finetune/lora.init_lora_params, A from a
    CPU generator seeded 0) at qkv, proj, fc1 and fc2, the CLI's optimizer
    at FT_TEXT_LR over the four --synthetic examples at grad-accum 2 (four
    mini-steps, two updates). Checks: finite losses, the first example's
    loss moved by training, the base text model bit for bit unchanged (every
    tensor, and a float64 checksum) with no gradient, the optimizer state
    adapter-sized, exact kernel A launches (the ViT; the training forward
    runs no kernel). Prints ms per mini-step and per update and peak memory
    beside two mini-steps of the full text finetune on the same model in
    the same call (an accumulate-only window: the weights do not move).
    Then the adapter saved by save_variant is served by a graphed caption
    (settings["variant"]), equal to the eager one, with exact launches.
    Returns the counted runs' launches."""
    cfg = MOONDREAM_2B
    model = MoondreamModel(cfg, None, IdTokenizer(), BF16, seed=SEED, device=DEV)
    dataset = finetune_text.synthetic_dataset(4)
    grad_accum = 2
    optimizer = finetune_trainer.cli_optimizer(FT_TEXT_LR, len(dataset) // grad_accum,
                                               grad_accum)
    updates = _timed_updates(optimizer)
    lora = ft_lora.init_lora_params(cfg.text, LORA_FT_RANK, torch.Generator().manual_seed(0),
                                    device=DEV)
    n_params = sum(t.numel() for _, t in named_leaves(lora))
    state = finetune_trainer.init_train_state(lora, optimizer)
    step = ft_lora.make_lora_train_step(optimizer, cfg.text)
    base = [(n, t.detach().clone()) for n, t in named_leaves(model.text)]
    checksum = _checksum(base)
    examples = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    steps, losses = [], []
    for sample in dataset:
        batch = finetune_text.build_example(model, sample["image"], finetune_text.QUESTION,
                                            f"{sample['description']}{finetune_text.ANSWER_EOS}")
        examples.append(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, model.text, batch)
        steps.append(sync_ms(t0))
        losses.append(loss.item())
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launches("LoRA finetune (4 ViT calls)", launches,
                   expected_launches(cfg, len(dataset), 0, 0, prefills=0))
    runs = [launches]
    with torch.no_grad():
        after = ft_lora.lora_text_loss(state.params, model.text, examples[0]["inputs_embeds"],
                                       examples[0]["labels"], examples[0]["label_mask"]).item()
    if (not all(math.isfinite(x) for x in losses + [after]) or after == losses[0]
            or state.opt_state.count != 2):
        raise AssertionError(f"LoRA finetune: losses {losses}, after {after}, "
                             f"{state.opt_state.count} updates")
    for (name, t), (_, old) in zip(named_leaves(model.text), base):
        if not torch.equal(t, old) or t.grad is not None or t.requires_grad:
            raise AssertionError(f"LoRA finetune: the base's {name} changed or has a gradient")
    if _checksum(named_leaves(model.text)) != checksum:
        raise AssertionError("LoRA finetune: the base's checksum changed")
    state_numel = sum(t.numel() for t in state.opt_state.mu + state.opt_state.nu
                      + (state.opt_state.acc or []))
    if state_numel != 3 * n_params:
        raise AssertionError(f"LoRA finetune: optimizer state {state_numel} elements, "
                             f"adapter {n_params}")
    mini = [s - u for s, (u, _) in zip(steps, updates)]
    upd = [u for u, emitted in updates if emitted]

    # mini-steps of the adapter and of the full text finetune on the same
    # model and example, in turns, each under an accumulate-only optimizer
    # (its window outlasts the run: nothing moves); the optimizer call is
    # subtracted, as above
    turns = ("full", "lora", "lora", "full", "full", "lora")
    opts = {name: finetune_trainer.cli_optimizer(FT_TEXT_LR, 1, len(turns)) for name in
            ("lora", "full")}
    calls = {name: _timed_updates(opt) for name, opt in opts.items()}
    states = {"lora": finetune_trainer.init_train_state(state.params, opts["lora"]),
              "full": finetune_trainer.init_train_state(model.text, opts["full"])}
    lora_step = ft_lora.make_lora_train_step(opts["lora"], cfg.text)
    steppers = {"lora": lambda st: lora_step(st, model.text, examples[0]),
                "full": lambda st: finetune_trainer.make_train_step(opts["full"])(st, examples[0])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = {"lora": [], "full": []}
    for name in turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[name], _ = steppers[name](states[name])
        timed[name].append(sync_ms(t0) - calls[name][-1][0])
    full_peak = torch.cuda.max_memory_allocated()
    if any(emitted for c in calls.values() for _, emitted in c):
        raise AssertionError("an accumulate-only window updated its tree")
    del states, opts, steppers, lora_step
    for (name, t), (_, old) in zip(named_leaves(model.text), base):
        if not torch.equal(t, old):
            raise AssertionError(f"full finetune window: {name} moved")
    del base
    torch.cuda.empty_cache()
    print(f"LoRA finetune (2B bf16 base, rank {LORA_FT_RANK} fp32 adapter of {n_params} "
          f"parameters, {len(dataset)} examples of {examples[0]['inputs_embeds'].shape[1]} "
          f"positions, grad-accum {grad_accum}, 2 updates, lr {FT_TEXT_LR}) on {power}: losses "
          f"{[round(x, 4) for x in losses]}, example 0 after training {after:.4f}; ms per "
          f"mini-step (forward + backward) {[round(x, 1) for x in mini]}; in turns on example "
          f"0, adapter {[round(x, 1) for x in timed['lora']]} against the full text finetune's "
          f"{[round(x, 1) for x in timed['full']]} (medians "
          f"{statistics.median(timed['lora']):.1f} / {statistics.median(timed['full']):.1f}); ms "
          f"per optimizer update {[round(x, 2) for x in upd]} (accumulate-only calls "
          f"{[round(u, 2) for u, e in updates if not e]}); max_memory_allocated {peak} bytes "
          f"(training) against {full_peak} with the full finetune's turns; base bit for bit "
          f"unchanged (checksum {checksum!r})")

    # the saved adapter served as a variant, graphed against eager
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/adapter.pt"
        ft_lora.save_variant(path, state.params)
        s = {"temperature": 0.0, "max_tokens": 32, "variant": path}
        served = model._variant(s)
        for grp, site in LORA_SITES:
            for f in ("A", "B"):
                if not torch.equal(served[grp][site][f], state.params[grp][site][f].to(BF16)):
                    raise AssertionError(f"saved variant {grp}.{site}.{f} loads differently")
        probe = dataset[0]["image"]
        enc = model.encode_image(probe, settings=s)
        out = {}
        for graphed in (True, False, True):
            model.graphed = graphed
            try:
                reset_launch_counts()
                text = model.caption(enc, settings=s)["caption"]
            finally:
                model.graphed = True
            if out.setdefault(graphed, text) != text:
                raise AssertionError("caption under the trained variant: ids differ between runs")
        if out[True] != out[False] or not out[True]:
            raise AssertionError("caption under the trained variant: graphed ids differ from eager")
        n = len(_ids(out[True]))
        check_launches(f"caption under the trained variant, {batched_steps(n, 32)} steps",
                       dict(LAUNCHES), expected_launches(cfg, 0, 1, batched_steps(n, 32)))
        runs.append(dict(LAUNCHES))
        base_caption = model.caption(probe, settings={"temperature": 0.0, "max_tokens": 32})
    print(f"trained adapter on {power}: save_variant -> settings['variant'] loads the adapter "
          f"bit for bit (bf16), graphed caption == eager ({n} tokens), ids changed from the "
          f"base's: {out[True] != base_caption['caption']}")
    del model
    return runs


def probe_modules() -> str:
    """Which optional host libraries this machine has: the server decodes
    uploads with PIL, a real tokenizer.json is read by `tokenizers` or the
    native BPE, the eval loops show progress with tqdm and read `datasets`
    (the smoke's eval phase replaces it), and the video recipes read and
    write video with cv2."""
    found = []
    for name in ("PIL", "tokenizers", "transformers", "tqdm", "datasets", "cv2"):
        try:
            importlib.import_module(name)
            found.append(f"import {name}: ok")
        except ImportError:
            found.append(f"import {name}: missing")
    return "python modules on this machine: " + ", ".join(found)


SERVE_TOKENS = 32  # every HTTP text request's max_tokens
SERVE_QUESTION = POOL_QUESTION
SERVE_SHAPES = ((756, 1008, 3), (378, 378, 3), (600, 800, 3))
SERVE_CONCURRENT = [0, 1, 2, 0, 1, 2, 0, 1]  # the 8 concurrent captions' images
SERVE_EYE = (0.45, 0.3)


def _png_b64(img: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _http(base: str, path: str, payload=None) -> tuple:
    """(status, JSON body) of a GET (no payload) or a POST over real HTTP."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _ok(base: str, path: str, payload=None):
    code, body = _http(base, path, payload)
    if code != 200:
        raise AssertionError(f"{path}: HTTP {code} {body}")
    return body


def _sse(base: str, path: str, payload) -> list:
    """The `data:` events of a streamed response, [DONE] last."""
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.headers.get("Content-Type") != "text/event-stream":
            raise AssertionError(f"{path}: not an event stream")
        raw = r.read().decode()
    events = [line[len("data: "):] for line in raw.split("\n") if line.startswith("data: ")]
    if not events or events[-1] != "[DONE]":
        raise AssertionError(f"{path}: stream did not end with [DONE]: {events[-2:]}")
    return events[:-1]


def phase_serve(model, power: str) -> list:
    """The HTTP server (serve_http.make_server: 8 slots of 1024, chunk 8,
    greedy, the tokenizer's EOS) over the 2B bf16 model, driven over real
    HTTP on 127.0.0.1 after `warmup()`: /healthz; three sequential
    captions and two queries on PNG uploads of three sizes, each with
    exact launch counts (one ViT call and image prefill, one prompt span,
    kernel C 24 times per pool iteration of the chunks the request
    dispatched) and each equal to the same request on a
    ContinuousBatchingEngine built alike and driven directly; a streamed
    query whose SSE chunks join to the plain answer; 8 concurrent captions
    that share chunks (the most active rows at a dispatch), each equal to
    its image's sequential caption or first differing at a near tie (the
    logit-margin rule); detect, point and gaze equal to model.detect /
    point / detect_gaze; chat completions with an image (== the query
    endpoint, streamed == plain) and text only (== model.query without an
    image; streamed refused as in the JAX package); /metrics. Prints the
    p50 single-caption latency over HTTP against the direct pool request
    and model.caption in turns, and the concurrent run's tok/s. Returns
    the sequential requests' launch counts."""
    cfg = model.config
    L_txt = cfg.text.n_layers
    model.tokenizer = IdTokenizer()
    rng = np.random.default_rng(SEED + 7)
    images = [rng.integers(0, 256, shape, dtype=np.uint8) for shape in SERVE_SHAPES]
    b64 = [_png_b64(im) for im in images]
    greedy = {"temperature": 0.0, "top_p": 0.0, "max_tokens": SERVE_TOKENS}

    t0 = time.perf_counter()
    srv, frontend = serve_http.make_server(model, "127.0.0.1", 0, n_slots=8, slot_len=1024,
                                           chunk=8)
    eng = frontend.engine
    frontend.warmup()
    warm_ms = sync_ms(t0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    dispatched = {"chunks": 0, "most_active": 0}
    dispatch = eng._dispatch_chunk

    def counted_dispatch():
        dispatched["chunks"] += 1
        dispatched["most_active"] = max(dispatched["most_active"],
                                        sum(s.active for s in eng.slots))
        dispatch()

    eng._dispatch_chunk = counted_dispatch

    def settled():
        """Wait until the pool has read back its last chunk."""
        deadline = time.monotonic() + 60
        while eng._inflight or any(s.active for s in eng.slots):
            if time.monotonic() > deadline:
                raise AssertionError("the pool did not settle")
            time.sleep(0.005)
        torch.cuda.synchronize()

    direct = ContinuousBatchingEngine(model, n_slots=8, slot_len=1024, chunk=8, pipeline_depth=2)

    def direct_text(i, question):
        rid = direct.submit(images[i], question=question, max_tokens=SERVE_TOKENS)
        return direct.drain()[rid]

    runs = []
    try:
        health = _ok(base, "/healthz")
        if health != {"ok": True, "slots": 8, "free": 8}:
            raise AssertionError(f"/healthz {health}")

        # sequential requests, each counted and held to the direct pool
        seq = {}
        for i, question in ((0, None), (1, None), (2, None), (0, SERVE_QUESTION),
                            (2, SERVE_QUESTION)):
            path, key = ("/v1/caption", "caption") if question is None else ("/v1/query",
                                                                               "answer")
            payload = {"image_b64": b64[i], "max_tokens": SERVE_TOKENS}
            if question is not None:
                payload["question"] = question
            settled()
            reset_launch_counts()
            dispatched["chunks"] = 0
            text = _ok(base, path, payload)[key]
            settled()
            launches = dict(LAUNCHES)
            want = expected_launches(cfg, 1, 1, 0)
            want[K.RAGGED] = L_txt * 8 * dispatched["chunks"]
            check_launches(f"HTTP {path} (image {i}), {len(_ids(text))} tokens, "
                           f"{dispatched['chunks']} chunks", launches, want)
            runs.append(launches)
            if text != direct_text(i, question):
                raise AssertionError(f"HTTP {path} on image {i} differs from the direct pool")
            seq[i, question] = text

        # the streamed query: its SSE chunks join to the plain answer
        events = _sse(base, "/v1/query", {"image_b64": b64[0], "question": SERVE_QUESTION,
                                          "max_tokens": SERVE_TOKENS, "stream": True})
        if "".join(json.loads(e)["chunk"] for e in events) != seq[0, SERVE_QUESTION]:
            raise AssertionError("streamed /v1/query differs from the plain answer")

        # 8 concurrent captions: rows share chunks; each its sequential caption
        settled()
        before = _ok(base, "/metrics")["generated_tokens"]
        dispatched["most_active"] = 0
        got = {}

        def caption(j, i):
            got[j] = _http(base, "/v1/caption", {"image_b64": b64[i], "max_tokens": SERVE_TOKENS})

        threads = [threading.Thread(target=caption, args=(j, i))
                   for j, i in enumerate(SERVE_CONCURRENT)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or any(got[j][0] != 200 for j in got):
            raise AssertionError(f"concurrent captions failed: {got}")
        if dispatched["most_active"] < 2:
            raise AssertionError("the concurrent captions never shared a chunk")
        settled()
        generated = _ok(base, "/metrics")["generated_tokens"] - before
        encs = {i: model.encode_image(images[i]) for i in set(SERVE_CONCURRENT)}
        prompt = _prompt_of(model, None)
        margins = []
        for j, i in enumerate(SERVE_CONCURRENT):
            single, other = _ids(seq[i, None]), _ids(got[j][1]["caption"])
            m = _check_margin(f"concurrent caption {j}", model, encs[i], prompt, single, other,
                              SERVE_TOKENS, slots=1024)
            if m is not None:
                margins.append((j, m))
        n_tokens = sum(len(_ids(got[j][1]["caption"])) for j in got)
        if generated != n_tokens:
            raise AssertionError(f"/metrics counted {generated} tokens, the bodies {n_tokens}")

        # detect, point and gaze: the model's own single paths
        structured = {}
        for path, payload, want in (
                ("/v1/detect", {"object": "object"}, lambda: model.detect(images[0], "object")),
                ("/v1/point", {"object": "object"}, lambda: model.point(images[0], "object")),
                ("/v1/gaze", {"eye": {"x": SERVE_EYE[0], "y": SERVE_EYE[1]}},
                 lambda: model.detect_gaze(images[0], eye=SERVE_EYE))):
            body = _ok(base, path, {"image_b64": b64[0], **payload})
            settled()
            if body != json.loads(json.dumps(want())):
                raise AssertionError(f"HTTP {path} differs from the model's own call")
            structured[path] = {k: v if v is None or isinstance(v, dict) else len(v)
                                for k, v in body.items()}

        # chat completions: with an image (the pool), text only (no image)
        msg = [{"role": "user", "content": [
            {"type": "text", "text": SERVE_QUESTION},
            {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64[2]}"}}]}]
        chat = _ok(base, "/v1/chat/completions", {"messages": msg, "max_tokens": SERVE_TOKENS})
        content = chat["choices"][0]["message"]["content"]
        if content != seq[2, SERVE_QUESTION]:
            raise AssertionError("chat completion with an image differs from /v1/query")
        events = [json.loads(e) for e in _sse(base, "/v1/chat/completions", {
            "messages": msg, "max_tokens": SERVE_TOKENS, "stream": True})]
        if "".join(e["choices"][0]["delta"].get("content", "") for e in events) != content:
            raise AssertionError("streamed chat completion differs from the plain one")
        text_only = [{"role": "user", "content": SERVE_QUESTION}]
        chat = _ok(base, "/v1/chat/completions",
                   {"messages": text_only, "max_tokens": SERVE_TOKENS})
        settled()
        want = model.query(image=None, question=SERVE_QUESTION, settings=greedy)["answer"]
        if chat["choices"][0]["message"]["content"] != want:
            raise AssertionError("text-only chat completion differs from model.query")
        code, _ = _http(base, "/v1/chat/completions",
                        {"messages": text_only, "max_tokens": SERVE_TOKENS, "stream": True})
        if code != 400:
            raise AssertionError(f"text-only streamed chat answered {code}, not 400")
        metrics = _ok(base, "/metrics")

        # single-caption latency: HTTP, the direct pool, model.caption in turns
        lat = {"http": [], "pool": [], "caption": []}
        for _ in range(5):
            settled()
            t0 = time.perf_counter()
            _ok(base, "/v1/caption", {"image_b64": b64[0], "max_tokens": SERVE_TOKENS})
            lat["http"].append((time.perf_counter() - t0) * 1e3)  # to the response
            settled()
            t0 = time.perf_counter()
            direct_text(0, None)
            lat["pool"].append(sync_ms(t0))
            t0 = time.perf_counter()
            model.caption(images[0], settings=greedy)
            lat["caption"].append(sync_ms(t0))
    finally:
        srv.shutdown()
        srv.server_close()
        frontend.shutdown()
        thread.join(timeout=30)
    p50 = {k: statistics.median(v) for k, v in lat.items()}
    print(f"2B HTTP server (bf16, 8 slots of 1024, chunk 8) on {power}: warmup {warm_ms:.1f} "
          f"ms; single caption p50 over HTTP {p50['http']:.1f} ms, direct pool request "
          f"{p50['pool']:.1f} ms, model.caption {p50['caption']:.1f} ms (in turns, 5 each, "
          f"{len(_ids(seq[0, None]))} tokens, {images[0].shape[1]}x{images[0].shape[0]} PNG); "
          f"8 concurrent captions {wall_s * 1e3:.1f} ms wall, {n_tokens} tokens, "
          f"{n_tokens / wall_s:.1f} tok/s (/metrics counted {generated}), at most "
          f"{dispatched['most_active']} rows in one chunk; structured {structured}; "
          f"/metrics requests {metrics['requests']}")
    print("HTTP concurrent captions vs sequential: " + (
        f"first differences (request, (token, (margin, bf16 steps))) {margins}" if margins
        else "all equal"))
    return runs


def phase_cli(model, power: str) -> None:
    """cli._benchmark on the 2B bf16 model (the demo image, greedy, 32
    tokens: encode ms to the last kernel and the streamed query's rate,
    counted in tokens beside the chunks the CLI counts), then `python3 -m
    moondream_tpu_torch.cli --demo --max-tokens 8` in a subprocess on the
    card, which must exit 0."""
    tokens = []
    step_tokens = model._step_tokens

    def counted(*a, **k):
        n = 0
        for t in step_tokens(*a, **k):
            n += 1
            yield t
        tokens.append(n)

    model._step_tokens = counted
    tokenizer, model.tokenizer = model.tokenizer, ByteTokenizer()  # the CLI's (word chunks)
    try:
        res = cli._benchmark(model, cli.demo_image(), "What is the white shape in this image?",
                             {"max_tokens": SERVE_TOKENS, "temperature": 0.0})
    finally:
        del model._step_tokens
        model.tokenizer = tokenizer
    timed = tokens[-10:]
    tok_s = sum(timed) / sum(res["query_s"])
    print(f"2B CLI --benchmark (bf16, greedy, {SERVE_TOKENS} tokens) on {power}: encode "
          f"{statistics.median(res['encode_ms']):.1f} ms median (min "
          f"{min(res['encode_ms']):.1f}), streamed query {tok_s:.1f} tok/s ({sum(timed)} tokens "
          f"in {sum(res['query_s']):.2f} s over 10 runs; the CLI's own count: "
          f"{statistics.median(res['chunks_per_s']):.1f} chunks/s)")
    if importlib.util.find_spec("PIL") is None:
        print("PIL is not installed: cli --demo (which draws its overlays with PIL) not run")
        return
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "moondream_tpu_torch.cli", "--demo", "--max-tokens", "8"],
            cwd=tmp, env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
            text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli --demo exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        found = [line for line in proc.stdout.splitlines()
                 if line.startswith(("Device:", "Found", "Gaze:"))]
        drawn = sorted(p.name for p in Path(tmp).glob("*.jpg"))
    print(f"cli --demo --max-tokens 8 on {power}: exit 0 in {time.perf_counter() - t0:.1f} "
          f"s, {found}, overlays {drawn}")


def phase_hf(model, power: str) -> None:
    """HfMoondream over the 2B bf16 model: answer_question equals
    model.query (the default sampling, from one generator state); a
    same-shape set_input_embeddings swap changes the graphed answer exactly
    as it changes the eager one (the graph replays, reading the table in
    place), and restoring the table restores the answer."""
    hf = HfMoondream(model)
    img = np.random.default_rng(SEED + 8).integers(0, 256, (600, 800, 3), dtype=np.uint8)
    enc = model.encode_image(img)
    model.generator.manual_seed(SEED)
    got = hf.answer_question(enc, SERVE_QUESTION, max_new_tokens=SERVE_TOKENS)
    model.generator.manual_seed(SEED)
    want = model.query(enc, SERVE_QUESTION, settings={"max_tokens": SERVE_TOKENS})["answer"]
    if got != want.strip():
        raise AssertionError("answer_question differs from model.query")
    greedy = {"temperature": 0.0, "max_tokens": SERVE_TOKENS}

    def answer(graphed: bool) -> str:
        model.graphed = graphed
        try:
            return model.query(enc, SERVE_QUESTION, settings=greedy)["answer"]
        finally:
            model.graphed = True

    before = answer(True), answer(False)
    wte = hf.get_input_embeddings()
    ptr, saved = wte.data_ptr(), wte.detach().clone()
    new = torch.randn(tuple(wte.shape), generator=torch.Generator(device=DEV).manual_seed(SEED + 9),
                      device=DEV).mul_(0.02).to(BF16)
    hf.set_input_embeddings(new)
    captures, replays = len(graphs.CAPTURES), graphs.REPLAYS.get("generate_text", 0)
    after = answer(True)
    if len(graphs.CAPTURES) != captures or graphs.REPLAYS.get("generate_text", 0) == replays:
        raise AssertionError("the swapped table's answer did not replay the captured graph")
    after = after, answer(False)
    if hf.get_input_embeddings().data_ptr() != ptr:
        raise AssertionError("a same-shape swap moved the table")
    if before[0] != before[1] or after[0] != after[1] or after[0] == before[0]:
        raise AssertionError(f"graphed / eager answers before {before} and after {after}")
    hf.set_input_embeddings(saved)
    if answer(True) != before[0]:
        raise AssertionError("restoring the table did not restore the answer")
    print(f"HfMoondream on {power}: answer_question == model.query; a same-shape "
          f"embedding swap changed the graphed answer as the eager one "
          f"({len(_ids(before[0]))} -> {len(_ids(after[0]))} tokens, the graph replayed)")


BPE_TEXTS = ["the cat sat in the sun", "Moondream: café, naïve — 猫!",
             "  two  spaces\nand a line", ""]


def bpe_spec() -> dict:
    """A small byte-level BPE tokenizer.json: the 256 byte symbols and a
    few merges, in the HF library's layout."""
    b2u = native_bpe._B2U
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for a, b in (("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("Ġ", "c"), ("a", "t"), ("Ġc", "at"),
                 ("i", "n"), ("Ġ", "s")):
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab))
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                  "use_regex": True}
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
            "normalizer": None, "pre_tokenizer": byte_level, "post_processor": None,
            "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


def phase_native_bpe(power: str) -> None:
    """The native BPE (built into _build/ by phase_build) on a tokenizer.json
    written here: strings round-trip, the ids equal the HF library's where
    it is installed, and load_tokenizer takes the native route under
    MOONDREAM_NATIVE_BPE."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/tokenizer.json"
        with open(path, "w") as f:
            json.dump(bpe_spec(), f)
        tok = native_bpe.NativeBPETokenizer.from_file(path)
        hf = None
        if importlib.util.find_spec("tokenizers") is not None:
            from tokenizers import Tokenizer

            hf = Tokenizer.from_file(path)
        for text in BPE_TEXTS:
            ids = tok.encode(text)
            if tok.decode(ids) != text:
                raise AssertionError(f"native BPE round trip failed on {text!r}")
            if hf is not None and ids != hf.encode(text).ids:
                raise AssertionError(f"native BPE ids differ from the HF library's on {text!r}")
        os.environ["MOONDREAM_NATIVE_BPE"] = "1"
        try:
            routed = load_tokenizer(path)
        finally:
            del os.environ["MOONDREAM_NATIVE_BPE"]
        if not isinstance(routed, native_bpe.NativeBPETokenizer):
            raise AssertionError(f"MOONDREAM_NATIVE_BPE gave {type(routed).__name__}")
    print(f"native BPE on {power}: {len(BPE_TEXTS)} strings round-trip"
          + (", ids equal the HF tokenizers library's" if hf is not None
             else " (tokenizers missing: no HF comparison)")
          + "; load_tokenizer takes the native route")


EVAL_TOKENS = 16  # every eval answer's decode cap (the `_settings` override)
EVAL_MAX_OBJECTS = 8  # the recipes' detect cap (DEFAULT_MAX_OBJECTS there)
EVAL_SHAPES = ((756, 1008, 3), (378, 378, 3), (600, 800, 3), (480, 640, 3))
# module: (loop function, the dataset path it loads)
EVAL_LOOPS = {
    "chartqa": ("eval_chartqa", "vikhyatk/chartqa"),
    "coco_map": ("eval_coco_map", "moondream/coco-val-2017-bbox-cleaned"),
    "countbenchqa": ("eval_countbenchqa", "vikhyatk/CountBenchQA"),
    "docvqa": ("eval_docvqa", "vikhyatk/docvqa-val"),
    "gazefollow": ("eval_gazefollow", "vikhyatk/gazefollow"),
    "mmstar": ("eval_mmstar", "Lin-Chen/MMStar"),
    "naturalbench": ("eval_naturalbench", "BaiqiL/NaturalBench"),
    "pope": ("evaluate_pope", "vikhyatk/POPE"),
    "realworldqa": ("eval_realworldqa", "lmms-lab/RealWorldQA"),
    "tallyqa": ("eval_tallyqa", "vikhyatk/tallyqa-test"),
    "textvqa": ("eval_textvqa", "vikhyatk/textvqa_val"),
    "waste_detection": ("eval_waste_detection", "moondream/waste_detection"),
}


def eval_rows() -> dict:
    """Stand-in rows for every eval loop, 2 per dataset, with the fields
    each loop reads and images of the EVAL_SHAPES sizes (PIL, as the HF
    datasets give them). They replace the data source only."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 10)
    im = [Image.fromarray(rng.integers(0, 256, s, dtype=np.uint8)) for s in EVAL_SHAPES]
    qa = lambda q, a, **kw: {"question": q, "answer": a, **kw}
    gaze = lambda hb, eye, target: {
        "head_bbox": dict(zip(("xmin", "ymin", "xmax", "ymax"), hb)),
        "eye": {"x": eye[0], "y": eye[1]}, "gaze": {"x": target[0], "y": target[1]}}
    return {
        "vikhyatk/chartqa": [
            {"image": im[0], "qa": [qa("Peak value?", "42", source="human"),
                                    qa("Labels?", '["a", "b"]', source="augmented")]},
            {"image": im[2], "qa": [qa("Lowest year?", "2001", source="human")]}],
        "moondream/coco-val-2017-bbox-cleaned": [
            {"image": im[i], "objects": json.dumps({
                "bbox": [[10.0, 20.0, 100.0, 80.0], [50.0, 40.0, 60.0, 90.0]],
                "label": [1, 3]})} for i in (0, 3)],
        "vikhyatk/CountBenchQA": [{"image": im[i], "question": "How many cats?", "number": n}
                                  for i, n in ((1, 3), (2, 5))],
        "vikhyatk/docvqa-val": [
            {"image": im[i], "qa": [{"question": "What is the title?",
                                     "answers": ["annual report", "report"]}]}
            for i in (0, 3)],
        "vikhyatk/gazefollow": [
            {"image": im[i], "gazes": [gaze((0.1, 0.1, 0.3, 0.3), (0.2, 0.2), (0.6, 0.7)),
                                       gaze((0.1, 0.1, 0.3, 0.3), (0.2, 0.2), (0.5, 0.8)),
                                       gaze((0.6, 0.2, 0.8, 0.4), (0.7, 0.3), (0.1, 0.9))]}
            for i in (2, 3)],
        "Lin-Chen/MMStar": [
            {"image": im[i], "question": "Which? A: cat B: dog", "answer": a,
             "category": "perception", "l2_category": "coarse"} for i, a in ((1, "A"), (3, "B"))],
        "BaiqiL/NaturalBench": [{
            "Question_Type": t, "Image_0": im[i], "Image_1": im[j],
            "Question_0": "Is the sky visible?", "Question_1": "Is it night?",
            "Image_0_Question_0": "yes", "Image_1_Question_0": "no",
            "Image_0_Question_1": "no", "Image_1_Question_1": "yes"}
            for t, i, j in (("yes_no", 0, 1), ("multiple_choice", 2, 3))],
        "vikhyatk/POPE": [
            {"image": im[i], "random": [qa("Is there a dog?", "no")],
             "popular": [qa("Is there a person?", "yes")],
             "adversarial": [qa("Is there a car?", "no")]} for i in (1, 2)],
        "lmms-lab/RealWorldQA": [{"image": im[i], "question": "Where is this?", "answer": a}
                                 for i, a in ((0, "street"), (3, "kitchen"))],
        "vikhyatk/tallyqa-test": [
            {"image": im[i], "qa": [qa("How many chairs?", 2, is_simple=True),
                                    qa("How many red cars?", 0, is_simple=False)]}
            for i in (1, 3)],
        "vikhyatk/textvqa_val": [
            {"image": im[i], "question": "What does the sign say?",
             "answers": ["stop"] * 7 + ["halt"] * 3} for i in (0, 2)],
        "moondream/waste_detection": [
            {"image": im[i], "boxes": [[0.3, 0.3, 0.2, 0.2], [0.7, 0.6, 0.1, 0.3]],
             "labels": ["bottle", "can"]} for i in (2, 3)],
    }


def _launched(label: str, launches: dict, kernels) -> None:
    """Raise unless each of `kernels` was launched in the part."""
    idle = [k for k in kernels if not launches.get(k)]
    if idle:
        raise AssertionError(f"{label}: no launch of {idle} (launches {launches})")


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def _dense(model) -> None:
    blocks = (*model.vision.blocks, *model.text.blocks)
    if not all(type(m) is Linear for b in blocks for m in (b.qkv, b.proj, b.mlp.fc1, b.mlp.fc2)):
        raise AssertionError("building a quantized twin changed the dense model")


def phase_eval(model, power: str) -> list:
    """The eval harness (moondream_tpu_torch/eval/) and the recipe loader's
    path over the 2B bf16 model with seeded random weights, graphed, every
    graph replay under torch.cuda.set_sync_debug_mode("error"). Scores and
    gates mean nothing with random weights: a mechanism check only.

    - The twelve per-benchmark loops on eval_rows' stand-in rows (2 each,
      images of four sizes; `datasets` replaced by a stand-in module for
      the phase), answers capped at EVAL_TOKENS greedy tokens through the
      `_settings` override; kernel A in every loop, kernel B in every loop
      that decodes. GazeFollow runs with EOS id 7: under the 2B's EOS 0,
      force_detect's token 0 is an EOS, every prediction is None and the
      loop raises TypeError, in the JAX package as here. eval_all over one
      loop gives that loop's result.
    - quant_drift: dynamic and static int8-ViT drift (static calibrated on
      normalized crops; w8a8 launches), caption agreement (EVAL_TOKENS
      tokens, the gate corpus) against an int4 + int8 KV twin (W4A16 and
      B-int8) and an int8 w8a8 text + ViT twin (w8a8); the dense model
      stays dense after each twin is built.
    - recipes.common.pipeline.detect_frames over 8 in-memory frames in one
      batch (one lockstep structured loop, no single detect, no fallback
      print), then the gaze recipe's per-face detect_gaze on the shared
      encodings, and with cv2 the gaze recipe's process_video on a
      synthetic 8-frame mp4; detects capped at EVAL_MAX_OBJECTS.
    Prints seconds per loop and ms per row, the drift and agreement
    reports. Returns each part's launch counts."""
    import contextlib
    import types

    from moondream_tpu_torch import recipes as port_recipes
    from moondream_tpu_torch.eval import eval_all, quant_drift
    from moondream_tpu_torch.models import moondream as port_moondream

    rows, runs, lines, results = eval_rows(), [], [], {}
    stand_in = types.ModuleType("datasets")
    stand_in.load_dataset = lambda path, split=None: list(rows[path])
    saved_datasets = sys.modules.get("datasets")
    replay = graphs.StepGraph.replay

    def strict_replay(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            replay(self)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def part(label, fn, kernels):
        reset_launch_counts()
        reset_loop_counts()
        t0 = time.perf_counter()
        out = fn()
        seconds = sync_ms(t0) / 1e3
        launches = dict(LAUNCHES)
        _launched(label, launches, kernels)
        runs.append(launches)
        return out, seconds

    sys.modules["datasets"] = stand_in
    graphs.StepGraph.replay = strict_replay
    model._settings = lambda settings: (EVAL_TOKENS, 0.0, 0.0)
    tok = model.config.tokenizer
    try:
        for name, (fn_name, path) in EVAL_LOOPS.items():
            loop = getattr(importlib.import_module(f"moondream_tpu_torch.eval.{name}"), fn_name)
            if name == "gazefollow":
                model.config = dataclasses.replace(
                    model.config, tokenizer=dataclasses.replace(tok, eos_id=7))
            try:
                res, s = part(f"eval {name}", lambda: loop(model, debug=True), [K.FLASH])
            finally:
                model.config = dataclasses.replace(model.config, tokenizer=tok)
            results[name] = res
            steps = sum(c["steps"] for c in LOOP_COUNTS.values())
            if steps:
                _launched(f"eval {name}", runs[-1], [K.DECODE])
            summary = {k: v for k, v in res.items() if k != "results"}
            lines.append(f"{name} {s:.2f} s, {s * 1e3 / len(rows[path]):.0f} ms/row "
                         f"({steps} decode steps; launches {_nonzero(runs[-1])}): {summary}")
        got, _ = part("eval_all", lambda: eval_all.eval_all(
            model, skip=[n for n in eval_all.EVALS if n != "tallyqa"]), [K.FLASH])
        if got != {"tallyqa": results["tallyqa"]}:
            raise AssertionError(f"eval_all gave {got}, the loop {results['tallyqa']}")
    finally:
        del model._settings
        if saved_datasets is None:
            del sys.modules["datasets"]
        else:
            sys.modules["datasets"] = saved_datasets
    try:
        drift = {}
        for static in (False, True):
            label = "static" if static else "dynamic"
            drift[label], s = part(f"int8 ViT drift ({label})", lambda: quant_drift.
                                   vision_projection_drift(model, static=static),
                                   [K.FLASH, KQ.W8A8, KQ.W8A8_QUANTIZE])
            _dense(model)
            lines.append(f"int8 ViT drift ({label}, {s:.2f} s; launches "
                         f"{_nonzero(runs[-1])}): {drift[label]}")
        agreement = {}
        for label, quant, kernels in (
                ("int4 + kv_int8", {"int4": True, "kv8": True}, [KQ.W4A16, K.DECODE_INT8]),
                ("int8 w8a8 text + dynamic int8 ViT", {"int8_text": True, "vit8": True},
                 [KQ.W8A8, KQ.W8A8_QUANTIZE])):
            twin = quant_drift.quantized_twin(model, **quant)
            _dense(model)
            agreement[label], s = part(
                f"caption agreement ({label})",
                lambda: quant_drift.caption_agreement(model, twin, max_tokens=EVAL_TOKENS),
                [K.FLASH, *kernels])
            del twin
            lines.append(f"caption agreement bf16 vs {label} ({s:.2f} s; launches "
                         f"{_nonzero(runs[-1])}): {agreement[label]}")
        gates = quant_drift.check_gates({**drift["dynamic"], **agreement["int4 + kv_int8"]})
        lines.append(f"gates {gates} (random weights: mechanism only)")

        from recipes.common.pipeline import detect_frames

        frames = [np.random.default_rng(SEED + 20 + i).integers(0, 256, (480, 640, 3),
                                                                dtype=np.uint8)
                  for i in range(8)]
        limit = port_moondream.DEFAULT_MAX_OBJECTS
        port_moondream.DEFAULT_MAX_OBJECTS = EVAL_MAX_OBJECTS

        def batched_route(label, fn, gazes=lambda res, printed: 0):
            """fn() with one lockstep structured loop, no fallback print and
            no single structured loop but `gazes(result, printed)` eye-mode
            gaze points."""
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                res, s = part(label, fn, [K.FLASH, K.DECODE])
            batched = LOOP_COUNTS.get("generate_points_batched", {}).get("calls", 0)
            singles = LOOP_COUNTS.get("generate_points", {}).get("calls", 0)
            if "falling back" in out.getvalue() or batched != 1 or (
                    singles != gazes(res, out.getvalue())):
                raise AssertionError(f"{label} left the batched route: {batched} batched "
                                     f"loops, {singles} single ones, printed "
                                     f"{out.getvalue()[-500:]!r}")
            return res, s, batched, singles

        try:
            boxes, s, _, _ = batched_route(
                "detect_frames", lambda: detect_frames(model, frames, "face", encode_batch=8))
            lines.append(f"detect_frames over 8 frames in one batch {s:.2f} s, "
                         f"{sum(map(len, boxes))} boxes; launches {_nonzero(runs[-1])}")

            def faces_and_gazes():
                """The gaze recipe's inner loop: one detect_batch on the
                shared encodings, then detect_gaze per face."""
                encs = model.encode_images(frames)
                faces = model.detect_batch(encs, "face")
                return [[model.detect_gaze(enc, eye=((f["x_min"] + f["x_max"]) / 2,
                                                     (f["y_min"] + f["y_max"]) / 2))["gaze"]
                         for f in r["objects"]] for enc, r in zip(encs, faces)]

            found, s, _, n = batched_route("gaze recipe's detect_gaze", faces_and_gazes,
                                           gazes=lambda r, printed: sum(map(len, r)))
            lines.append(f"faces + per-face detect_gaze over 8 frames {s:.2f} s, {n} gazes, "
                         f"{sum(g is not None for r in found for g in r)} found; launches "
                         f"{_nonzero(runs[-1])}")
            if importlib.util.find_spec("cv2") is not None:
                import cv2

                with tempfile.TemporaryDirectory() as tmp:
                    video = f"{tmp}/in.mp4"
                    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                                             (640, 480))
                    for f in frames:
                        writer.write(f)
                    writer.release()
                    gaze_recipe = port_recipes.recipe("gaze_detection_video")
                    # the recipe prints "  frame i: N face(s), ..." per frame
                    faces = lambda stats, printed: sum(
                        int(line.split(": ")[1].split()[0]) for line in printed.splitlines()
                        if line.startswith("  frame "))
                    stats, s, _, n = batched_route("gaze recipe process_video", lambda: (
                        gaze_recipe.process_video(model, video, f"{tmp}/out.mp4", every_n=1,
                                                  encode_batch=8)), gazes=faces)
                    if stats["frames"] != 8 or stats["sampled"] != 8:
                        raise AssertionError(f"gaze recipe read {stats}")
                    lines.append(f"gaze recipe process_video on an 8-frame mp4 {s:.2f} s, "
                                 f"{n} gazes; launches {_nonzero(runs[-1])}")
            else:
                lines.append("cv2 missing: no process_video")
        finally:
            port_moondream.DEFAULT_MAX_OBJECTS = limit
    finally:
        graphs.StepGraph.replay = replay
    print(f"2B evals on {power} (seeded random weights, {EVAL_TOKENS}-token answers, every "
          "replay under sync debug mode \"error\"; scores, drift and gates are mechanism "
          "only):\n  " + "\n  ".join(lines))
    return runs


def main() -> None:
    power = card()
    print(power)
    print(probe_modules())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    # 756x1008 tiles 3x4: the 13-crop ViT batch
    img = np.random.default_rng(SEED).integers(0, 256, (756, 1008, 3), dtype=np.uint8)

    seconds = {}

    def phase(name, fn, *args, **kw):
        """Run one phase and keep its wall seconds (printed at the end)."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = round(seconds.get(name, 0.0) + time.perf_counter() - t0, 1)
        return out

    phase("1 build", phase_build)
    summary = phase("2 kernels", phase_kernels, gen)
    summary.update(phase("2 kernels", phase_w8a8_kernels, gen))
    phase("3 small references", phase_small_reference, img)
    phase("3 small references", phase_small_reference, img, int4=True, kv_int8=True)
    phase("3 small references", phase_small_reference, img, n_kv_heads=1)
    phase("3 small references", phase_small_reference, img, kv_int8=True, n_kv_heads=1)
    phase("3 small references", phase_small_reference, img, int8=True)
    # LoRA adapters, written from seeds (nothing is downloaded)
    adapter_dir = tempfile.TemporaryDirectory()
    tiny_adapter = write_adapter(f"{adapter_dir.name}/tiny.pt", tiny_test_config(), 4, 0.5, SEED)
    phase("3 small references", phase_small_reference, img, variant=tiny_adapter)
    rng = np.random.default_rng(SEED + 2)
    images = [rng.integers(0, 256, shape, dtype=np.uint8)
              for shape in ((756, 1008, 3), (378, 378, 3), (600, 800, 3))]
    phase("3 small references", phase_batch_reference, images)
    phase("3 small references", phase_batch_reference, images, n_kv_heads=1)
    phase("3 small references", phase_serving_reference)
    phase("3 small references", phase_structured_reference, img)
    phase("3 spec reference", phase_spec_reference, img)
    phase("3 finetune reference", phase_finetune_reference,
          finetune_text.synthetic_dataset(1)[0]["image"])
    phase("3 steer reference", phase_steer_reference, img)
    # 8 images of three sizes for the lockstep batches: 13, 2 and 7 crops
    batch_images = [rng.integers(0, 256, shape, dtype=np.uint8)
                    for shape in [(756, 1008, 3)] * 3 + [(378, 378, 3)] * 3
                    + [(600, 800, 3)] * 2]
    kv8 = lambda cfg: dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_int8=True))
    runs = []
    launches, model = phase("4 2B bf16 caption/query", phase_main_path, img, power)
    phase("4 2B bf16 graphs", phase_graphs, model, model.encode_image(img), images, batch_images,
          power, lockstep=True, pools=[("bf16 plain", {}), ("bf16 prefix-shared", {
              "prefix_share": True, "prefix_entries": 4})])
    runs += [*launches, *phase("4 2B bf16 lockstep", phase_batch, model, batch_images, power),
             phase("4 2B bf16 pools", phase_pool, model, images, power, "bf16 plain"),
             phase("4 2B bf16 pools", phase_pool, model, images, power,
                   "bf16 prefix-shared depth 2", prefix_share=True, prefix_entries=4,
                   pipeline_depth=2)]
    enc = model.encode_image(img)
    runs += phase("4 2B bf16 structured", phase_structured, model, enc, img, batch_images,
                  power)
    runs += phase("4 2B bf16 speculative", phase_spec, model, enc, power)
    runs += phase("4 2B bf16 spec pools", phase_spec_pools, model, images, power)
    runs += phase("4 2B bf16 mixed pools", phase_mixed_pools, model, images, power)
    phase("4 2B bf16 loop graphs", phase_loop_graphs, model, enc, img, images, batch_images,
          power)
    adapters = variant_adapters(adapter_dir.name)
    runs += phase("4 2B variants", phase_variants, model, img, images, power, adapters)
    runs += phase("4 2B variant pools", phase_variant_pools, model, images, power, adapters)
    runs += phase("4 2B steering", phase_steer, model, img, images, power)
    # 20 images of three sizes for the pipelines: 13, 2 and 7 crops
    pipe_images = [rng.integers(0, 256, shape, dtype=np.uint8)
                   for shape in [(756, 1008, 3), (378, 378, 3), (600, 800, 3)] * 7][:20]
    runs += phase("4 2B bf16 pipelines", phase_pipelines, model, pipe_images, power)
    runs += phase("4 2B bf16 pipelines", phase_pooled_pipelines, model, pipe_images[:16], power)
    runs += phase("4 2B HTTP server", phase_serve, model, power)
    phase("4 2B CLI", phase_cli, model, power)
    phase("4 2B HF wrapper", phase_hf, model, power)
    phase("4 native BPE", phase_native_bpe, power)
    runs += phase("4 2B evals", phase_eval, model, power)
    del model, enc
    launches, model = phase("4 2B int4", phase_main_path, img, power, kv8(MOONDREAM_2B),
                            int4=True)
    phase("4 2B int4 graphs", phase_graphs, model, model.encode_image(img), images,
          batch_images, power, pools=[("int4 + kv_int8", {})])
    runs += [*launches,
             phase("4 2B int4", phase_pool, model, images, power,
                   "int4 + kv_int8 prefix-shared", prefix_share=True, prefix_entries=4)]
    enc = model.encode_image(img)
    runs += phase("4 2B int4", phase_structured, model, enc, img, batch_images, power,
                  int4=True, full=False)
    runs += phase("4 2B int4", phase_int4_pooled_pipeline, model, batch_images, power)
    runs += phase("4 2B int4 speculative", phase_spec, model, enc, power)
    runs += phase("4 2B steering", phase_steer_caption, model, img, power)
    runs += phase("4 2B variants", phase_variant_caption, model, img, power, adapters)
    runs += phase("4 2B variant pools", phase_variant_pools, model, images, power, adapters,
                  full=False)
    phase("4 2B int4 loop graphs", phase_loop_graphs, model, enc, img, images, batch_images,
          power, full=False)
    del model, enc
    launches, model, vits = phase("4 2B int8", phase_int8_main_path, img, images, power)
    phase("4 2B int8", phase_int8_encode, model, img, vits, power)
    enc = model.encode_image(img)
    phase("4 2B int8 graphs", phase_graphs, model, enc, images, batch_images, power)
    runs += [*launches, phase("4 2B int8", phase_pool, model, images, power, "int8 plain")]
    runs += phase("4 2B int8 speculative", phase_spec, model, enc, power)
    runs += phase("4 2B variants", phase_variant_caption, model, img, power, adapters)
    runs += phase("4 2B variant pools", phase_variant_pools, model, images, power, adapters,
                  full=False)
    adapter_dir.cleanup()
    del model, enc, vits
    launches, model = phase("4 2B GQA", phase_main_path, img, power, MOONDREAM_2B_GQA)
    phase("4 2B GQA graphs", phase_graphs, model, model.encode_image(img), images, batch_images,
          power, lockstep=True)
    runs += [*launches, *phase("4 2B GQA", phase_batch, model, batch_images, power)]
    enc = model.encode_image(img)
    runs += phase("4 2B GQA", phase_structured, model, enc, img, batch_images, power,
                  full=False)
    runs.append(phase("4 2B GQA", phase_spec_eager_route, model, enc, power))
    del enc
    params = model.params
    del model
    launches, model = phase("4 2B GQA", phase_main_path, img, power, kv8(MOONDREAM_2B_GQA),
                            params=params)
    phase("4 2B GQA graphs", phase_graphs, model, model.encode_image(img), images, batch_images,
          power)
    runs += [*launches]
    del model, params
    # the 0.5B (published widths, full depth) over one single-tile image
    img05 = np.random.default_rng(SEED + 3).integers(0, 256, (378, 378, 3), dtype=np.uint8)
    launches, model = phase("4 0.5B", phase_main_path, img05, power, MOONDREAM_05B)
    runs += [*launches]
    del model
    runs += phase("5 2B finetune", phase_finetune, power)
    runs += phase("5 2B LoRA finetune", phase_lora_finetune, power)
    print("seconds per phase:", seconds, "total", round(sum(seconds.values()), 1))
    launches = {name: sum(r[name] for r in runs) for name in runs[0]}
    launches[K.DECODE] += launches.pop(K.DECODE_INT8)
    launches[K.RAGGED] += launches.pop(K.RAGGED_INT8)

    decode_src = "moondream_tpu_torch/csrc/decode_attn_stacked.cu"
    sources = {
        K.FLASH: ("moondream_tpu_torch/csrc/flash_attn_fwd.cu",
                  "moondream_tpu/ops/attention.py:47; moondream_tpu/ops/attention.py:110"),
        K.DECODE: (decode_src,
                   "moondream_tpu/ops/attention.py:931; moondream_tpu/ops/attention.py:631; "
                   "moondream_tpu/ops/attention.py:631 (int8 branch)"),
        K.RAGGED: (decode_src,
                   "moondream_tpu/ops/attention.py:963; moondream_tpu/ops/attention.py:631 "
                   "(ragged and prefix-shared branches, bf16 and int8)"),
        K.DECODE_GQA: (decode_src, "moondream_tpu/ops/attention.py:1039"),
        K.DECODE_GQA_LAYER: (decode_src, "moondream_tpu/ops/attention.py:341; "
                             "moondream_tpu/ops/attention.py:380"),
        KQ.W4A16: ("moondream_tpu_torch/csrc/w4a16_matmul.cu",
                   "moondream_tpu/ops/quant.py:147; moondream_tpu/ops/quant.py:116"),
        KQ.W8A8: ("moondream_tpu_torch/csrc/w8a8_matmul.cu",
                  "moondream_tpu/ops/layers.py:38-71 (XLA int8 dot_general, no Pallas kernel)"),
        KQ.W8A8_QUANTIZE: ("moondream_tpu_torch/csrc/w8a8_matmul.cu",
                           "moondream_tpu/ops/layers.py:30-35 (_q8_act); "
                           "moondream_tpu/ops/layers.py:56-59 (static codes; XLA, no Pallas "
                           "kernel)"),
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms")
    # every kernel's headline case has a library call, but the quantize
    # pass: no one PyTorch call makes int8 codes
    missing = [name for name in sources
               if summary[name]["library_ms"] is None and name != KQ.W8A8_QUANTIZE]
    if missing:
        raise AssertionError(f"no library time for {missing}")

    def ratios(s):
        """Device-only kernel time over the library call's (its launch
        times where a CUDA graph could not capture the call; None without
        one) and over the bound."""
        lib = (s["device_ms"] / s["library_device_ms"] if s["library_device_ms"]
               else s["ms"] / s["library_ms"] if s["library_ms"] else None)
        return {"vs_library": lib, "vs_bound": s["device_ms"] / s["bound_ms"]}

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": summary[name]["err"],
         **{key: summary[name][key] for key in keys}, **ratios(summary[name])}
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def main_variants() -> None:
    """The LoRA variant phases alone (`python3 chip_smoke.py --variants`):
    the build, the tiny variant reference, then "4 2B variants" and "4 2B
    variant pools" on fresh 2B models (bf16; int4 + kv_int8; int8 w8a8
    text). Prints the card and the phases' seconds; no kernels line."""
    power = card()
    print(power)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    img = np.random.default_rng(SEED).integers(0, 256, (756, 1008, 3), dtype=np.uint8)
    rng = np.random.default_rng(SEED + 2)
    images = [rng.integers(0, 256, shape, dtype=np.uint8)
              for shape in ((756, 1008, 3), (378, 378, 3), (600, 800, 3))]
    seconds = {}
    t0 = time.perf_counter()
    phase_build()
    seconds["1 build"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phase_small_reference(img, variant=write_adapter(f"{tmp}/tiny.pt", tiny_test_config(),
                                                         4, 0.5, SEED))
        adapters = variant_adapters(tmp)
        model = MoondreamModel(MOONDREAM_2B, None, ByteTokenizer(), BF16, seed=SEED, device=DEV)
        phase_variants(model, img, images, power, adapters)
        t1 = time.perf_counter()
        phase_variant_pools(model, images, power, adapters)
        pool_s = time.perf_counter() - t1
        del model
        kv8 = dataclasses.replace(MOONDREAM_2B, text=dataclasses.replace(
            MOONDREAM_2B.text, kv_int8=True))
        for cfg, quantize in ((kv8, quantize_text_params), (MOONDREAM_2B,
                                                            quantize_text_params_int8)):
            params = init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV, BF16)
            quantize(params["text"])
            model = MoondreamModel(cfg, params, ByteTokenizer(), BF16, seed=SEED, device=DEV)
            phase_variant_caption(model, img, power, adapters)
            t1 = time.perf_counter()
            phase_variant_pools(model, images, power, adapters, full=False)
            pool_s += time.perf_counter() - t1
            del model, params
    torch.cuda.synchronize()
    seconds["4 2B variants"] = round(time.perf_counter() - t0 - pool_s, 1)
    seconds["4 2B variant pools"] = round(pool_s, 1)
    print("seconds per phase:", seconds)


def main_steer() -> None:
    """The steering and adapter-training phases alone (`python3
    chip_smoke.py --steer`): the build, the tiny steer reference, "4 2B
    steering" on fresh 2B models (bf16; int4 + kv_int8) and "5 2B LoRA
    finetune". Prints the card and the phases' seconds; no kernels line."""
    power = card()
    print(power)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    img = np.random.default_rng(SEED).integers(0, 256, (756, 1008, 3), dtype=np.uint8)
    rng = np.random.default_rng(SEED + 2)
    images = [rng.integers(0, 256, shape, dtype=np.uint8)
              for shape in ((756, 1008, 3), (378, 378, 3), (600, 800, 3))]
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        seconds[name] = round(seconds.get(name, 0.0) + time.perf_counter() - t0, 1)

    timed("1 build", phase_build)
    timed("3 steer reference", phase_steer_reference, img)
    model = MoondreamModel(MOONDREAM_2B, None, ByteTokenizer(), BF16, seed=SEED, device=DEV)
    timed("4 2B steering", phase_steer, model, img, images, power)
    del model
    kv8 = dataclasses.replace(MOONDREAM_2B, text=dataclasses.replace(
        MOONDREAM_2B.text, kv_int8=True))
    params = init_params(kv8, torch.Generator(device=DEV).manual_seed(SEED), DEV, BF16)
    quantize_text_params(params["text"])
    model = MoondreamModel(kv8, params, ByteTokenizer(), BF16, seed=SEED, device=DEV)
    timed("4 2B steering", phase_steer_caption, model, img, power)
    del model, params
    timed("5 2B LoRA finetune", phase_lora_finetune, power)
    print("seconds per phase:", seconds)


def main_serve() -> None:
    """The front-end phases alone (`python3 chip_smoke.py --serve`): the
    build, then the HTTP server, the CLI, the HF wrapper and the native BPE
    on a fresh 2B bf16 model. Prints the card, the module probe and the
    phases' seconds; no kernels line."""
    power = card()
    print(power)
    print(probe_modules())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        seconds[name] = round(seconds.get(name, 0.0) + time.perf_counter() - t0, 1)

    timed("1 build", phase_build)
    model = MoondreamModel(MOONDREAM_2B, None, ByteTokenizer(), BF16, seed=SEED, device=DEV)
    timed("4 2B HTTP server", phase_serve, model, power)
    timed("4 2B CLI", phase_cli, model, power)
    timed("4 2B HF wrapper", phase_hf, model, power)
    timed("4 native BPE", phase_native_bpe, power)
    print("seconds per phase:", seconds)


def main_eval() -> None:
    """The eval phase alone (`python3 chip_smoke.py --eval`): the build,
    then "4 2B evals" on a fresh 2B bf16 model. Prints the card, the module
    probe and the phases' seconds; no kernels line."""
    power = card()
    print(power)
    print(probe_modules())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}
    t0 = time.perf_counter()
    phase_build()
    seconds["1 build"] = round(time.perf_counter() - t0, 1)
    model = MoondreamModel(MOONDREAM_2B, None, ByteTokenizer(), BF16, seed=SEED, device=DEV)
    t0 = time.perf_counter()
    phase_eval(model, power)
    seconds["4 2B evals"] = round(time.perf_counter() - t0, 1)
    print("seconds per phase:", seconds)


if __name__ == "__main__":
    flag = sys.argv[1:]
    {"--variants": main_variants, "--steer": main_steer, "--serve": main_serve,
     "--eval": main_eval}.get(flag[0] if len(flag) == 1 else None, main)()
