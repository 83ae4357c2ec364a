"""Drive the PyTorch port's caption path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. build: nvcc-build the attention kernels (A, and B with its int8 entry)
     and the W4A16 kernel from moondream_tpu_torch/csrc and g++-build the
     native crop library, all at once, into moondream_tpu_torch/_build;
  2. kernels vs plain: each kernel against its plain PyTorch version (fp32
     on the same inputs, TF32 off) at the main paths' shapes, with median
     times of both;
  3. a small reference: the tiny config in bf16 on the card and in bf16 on
     the CPU (plain versions), each against fp32 on the CPU, same weights;
     dense, then with int4 text blocks and an int8 KV cache;
  4. the main paths at MOONDREAM_2B widths and depth with seeded random
     weights: the bf16 model, then the same weights with int4 text blocks
     and an int8 KV cache. Each: encode_image and caption, with exact
     kernel launch counts, repeated greedy ids, streamed == plain, one
     sampled caption, and timings.

Prints the card's name and power limit first, a kernels JSON line second to
last, and {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")

from moondream_tpu_torch.config import MOONDREAM_2B, tiny_test_config  # noqa: E402
from moondream_tpu_torch.kernels import attention as K  # noqa: E402
from moondream_tpu_torch.kernels import quant as KQ  # noqa: E402
from moondream_tpu_torch.kernels.build import (  # noqa: E402
    LAUNCHES,
    build_parallel,
    build_seconds,
    reset_launch_counts,
)
from moondream_tpu_torch.models.moondream import MoondreamModel  # noqa: E402
from moondream_tpu_torch.models.text import (  # noqa: E402
    dequantize_kv,
    quantize_kv,
    quantize_text_params,
)
from moondream_tpu_torch.ops.attention import (  # noqa: E402
    decode_attention_cached,
    decode_attention_cached_plain,
    flash_attention,
    flash_attention_plain,
)
from moondream_tpu_torch.ops.image_crops import load_native  # noqa: E402
from moondream_tpu_torch.ops.quant import (  # noqa: E402
    quantize_weight_torch,
    quantized_matmul,
    quantized_matmul_plain,
)
from moondream_tpu_torch.tokenizer import ByteTokenizer  # noqa: E402
from moondream_tpu_torch.utils.streaming import stream_text  # noqa: E402
from moondream_tpu_torch.weights import build_params, init_params  # noqa: E402

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
    build_parallel([*K.LOADERS, *KQ.LOADERS, load_native])
    if load_native() is None:
        raise RuntimeError("native crop library did not build")
    print("build seconds:", {k: round(v, 2) for k, v in build_seconds.items()})


def phase_kernels(gen: torch.Generator) -> dict:
    """Kernel vs plain at the main path's shapes; returns per-kernel summary."""
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEV, dtype=BF16)
    summary = {K.FLASH: {"err": 0.0}, K.DECODE: {"err": 0.0}, KQ.W4A16: {"err": 0.0}}

    def check(name, label, run, plain, args):
        """run(): the kernel on the tensors `args`; plain(*args): the plain
        version, fed them with bf16 ones in fp32 and as they are."""
        got = run().float()
        f32 = lambda: plain(*(a.float() if a.dtype == BF16 else a for a in args))
        want = f32()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        floor = (plain(*args).float() - want).abs().max().item()
        if not (torch.isfinite(got).all() and err <= KERNEL_REL_TOL * scale):
            raise AssertionError(
                f"{name} {label}: max_abs_err {err} > {KERNEL_REL_TOL} * {scale}"
            )
        ms, plain_ms = median_ms(run), median_ms(f32)
        dev_ms, dev_plain_ms = graph_ms(run), graph_ms(f32)
        print(f"{name} {label}: max_abs_err {err:.3e} = {err / scale:.2e} of "
              f"max|plain| {scale:.3f} (tol {KERNEL_REL_TOL}, bf16 plain "
              f"{floor / scale:.2e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
              f"device only: kernel {dev_ms:.4f} ms plain {dev_plain_ms:.4f} ms")
        s = summary[name]
        s["err"] = max(s["err"], err)
        s.setdefault("ms", ms)  # the first case is the headline shape
        s.setdefault("plain_ms", plain_ms)

    # ViT: 13 crops x 16 heads, 768 tokens (729 real), head_dim 72, as head
    # views of the fused QKV projection.
    b, t, h, d = 13, 768, 16, 72
    qkv = randn(b, t, 3 * h * d)
    q, k, v = (x.view(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, -1))
    check(K.FLASH, "vit 13x16x768x768 d72 prefix729",
          lambda: flash_attention(q, k, v, 0, 729),
          lambda q, k, v: flash_attention_plain(q, k, v, 0, 729), (q, k, v))

    # Text cases read k/v as the layer view of a (1, 32, 2048, 64) cache.
    cache_k, cache_v = randn(1, 32, 2048, 64), randn(1, 32, 2048, 64)
    for label, tq, tk, pos, prefix in (
        ("image prefill 32x730x768 d64 prefix730", 730, 768, 0, 730),
        ("span 32x128x1024 pos700 prefix730", 128, 1024, 700, 730),
        ("causal 32x512x512", 512, 512, 0, 0),
        ("kv 2048: 32x2048x2048 prefix730", 2048, 2048, 0, 730),
    ):
        q = randn(1, 32, tq, 64)
        kk, vv = cache_k[:, :, :tk], cache_v[:, :, :tk]
        check(K.FLASH, label,
              lambda: flash_attention(q, kk, vv, pos, prefix),
              lambda q, k, v: flash_attention_plain(q, k, v, pos, prefix), (q, kk, vv))

    # Decode on a stacked (24, 1, 32, 2048, 64) cache, layer 13, kv_bound
    # 1536, garbage (unit normals x 1000) in every slot past the span. In the
    # "diagonal" cases row i's query is the key at pos + i, so that column
    # holds ~70% of the row's weight: a mask off by one moves the output by
    # about max|plain|.
    for tq, pos in ((1, 735), (8, 730)):
        kc, vc = randn(24, 1, 32, 2048, 64), randn(24, 1, 32, 2048, 64)
        kc[:, :, :, pos + tq:] *= 1000
        vc[:, :, :, pos + tq:] *= 1000
        for kind, q in (("random q", randn(1, 32, tq, 64)),
                        ("diagonal q", kc[13, :, :, pos:pos + tq].clone())):
            check(K.DECODE,
                  f"stacked L24 layer13 tq{tq} pos{pos} bound1536 garbage tail, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, 13, pos, 730, 1536),
                  lambda q, k, v: decode_attention_cached_plain(q, k, v, 13, pos, 730, 1536),
                  (q, kc, vc))

    # Kernel B's int8 entry, the same cases on an int8 (24, 1, 32, 2048, 64)
    # cache quantized by the port (a scale per token and head pair), with
    # random codes and scales x1000 in every slot past the span; the
    # diagonal query is the dequantized key at pos + i.
    for tq, pos in ((1, 735), (8, 730)):
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
        for kind, q in (("random q", randn(1, 32, tq, 64)), ("diagonal q", diag)):
            check(K.DECODE,
                  f"int8 stacked L24 layer13 tq{tq} pos{pos} bound1536 garbage tail, {kind}",
                  lambda: decode_attention_cached(q, kc, vc, 13, pos, 730, 1536, ks, vs),
                  lambda q: decode_attention_cached_plain(q, kc, vc, 13, pos, 730, 1536, ks, vs),
                  (q,))
    del codes, scales, kc, vc, ks, vs

    # W4A16 on weights quantized on the card: decode (M 1) and the 8-row
    # prompt span at the 2B text blocks' (K, N), then M 1 on layer 13 of a
    # stacked (24, 2048, 6144) qkv weight, read as a view.
    fp32 = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    for k, n, what in ((2048, 6144, "qkv"), (2048, 2048, "proj"),
                       (2048, 8192, "fc1"), (8192, 2048, "fc2")):
        qw = quantize_weight_torch(fp32(k, n) * k ** -0.5)
        for m in (1, 8):
            x = randn(m, k)
            check(KQ.W4A16, f"{what} M{m} K{k} N{n}",
                  lambda: quantized_matmul(x, qw),
                  lambda x: quantized_matmul_plain(x, qw), (x,))
    stacked = quantize_weight_torch(fp32(24, 2048, 6144) * 2048 ** -0.5)
    qw = {name: t[13] for name, t in stacked.items()}
    x = randn(1, 2048)
    check(KQ.W4A16, "qkv M1 K2048 N6144, layer 13 of a stacked (24, 1024, 6144) view",
          lambda: quantized_matmul(x, qw),
          lambda x: quantized_matmul_plain(x, qw), (x,))
    torch.cuda.synchronize()
    return summary


def phase_small_reference(img: np.ndarray, quantized: bool = False) -> None:
    """Tiny config on one set of bf16-valued weights: bf16 on the card (the
    kernels) and bf16 on the CPU (the plain versions), each against fp32 on
    the CPU, as a fraction of the fp32 run's largest magnitude. With
    `quantized`, every run quantizes the text blocks to int4 from those
    weights (the same codes on both devices, checked) and keeps an int8 KV
    cache, whose snapshot is compared dequantized."""
    cfg = tiny_test_config()
    if quantized:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_int8=True))
    state = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu").state_dict()
    state = {n: t.to(BF16).float() for n, t in state.items()}
    tmpl = list(cfg.tokenizer.templates["caption"]["normal"])

    def run(device, dtype) -> dict:
        params = build_params(cfg, device, dtype)
        params.load_state_dict(state)
        if quantized:
            quantize_text_params(params["text"])
        m = MoondreamModel(cfg, params, ByteTokenizer(), dtype, device=device)
        enc = m.encode_image(img)
        logits = m._prefill_prompt(m.load_encoded_image(enc), tmpl, enc.pos, 0.0, 0.0)[0]
        if not quantized:
            return {"k": enc.k, "v": enc.v, "logits": logits}
        return {"k": dequantize_kv(enc.k, enc.ks, torch.float32),
                "v": dequantize_kv(enc.v, enc.vs, torch.float32), "logits": logits,
                "codes": torch.cat([b.mlp.fc1.packed.flatten().cpu()
                                    for b in params["text"].blocks])}

    ref = run("cpu", torch.float32)
    codes = ref.pop("codes", None)

    def rel(out) -> dict:
        if codes is not None and not torch.equal(out.pop("codes"), codes):
            raise AssertionError("int4 codes differ from the fp32 CPU run's")
        return {n: ((out[n].float().cpu() - ref[n]).abs().max()
                    / ref[n].abs().max()).item() for n in ref}

    card, cpu = rel(run(DEV, BF16)), rel(run("cpu", BF16))
    r5 = lambda d: {n: round(e, 5) for n, e in d.items()}
    what = "int4 text blocks + int8 KV cache" if quantized else "bf16"
    print(f"small reference (tiny config, {what}, vs fp32 on the cpu), rel max err: "
          f"card bf16 {r5(card)}, cpu bf16 {r5(cpu)}, tol {SMALL_REF_FACTOR} x cpu bf16")
    if not all(card[n] <= SMALL_REF_FACTOR * cpu[n] for n in ref):
        raise AssertionError(f"tiny-config reference mismatch: {card} vs {cpu}")


def sync_ms(t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_main_path(img: np.ndarray, power: str, quantized: bool = False,
                    cfg=MOONDREAM_2B) -> dict:
    """The 2B caption path through the entry points. `quantized`: the same
    seeded weights with the text blocks quantized to int4 on the card and
    an int8 KV cache."""
    L_txt, L_vit = cfg.text.n_layers, cfg.vision.enc_n_layers
    t0 = time.perf_counter()
    if quantized:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_int8=True))
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV, BF16)
        lins = lambda: [lin for b in params["text"].blocks
                        for lin in (b.qkv, b.proj, b.mlp.fc1, b.mlp.fc2)]
        dense_bytes = _nbytes(*(lin.w for lin in lins()))
        quantize_text_params(params["text"])
        packed_bytes = _nbytes(*(t for lin in lins() for t in (lin.packed, lin.scale, lin.zero)))
        model = MoondreamModel(cfg, params, ByteTokenizer(), BF16, seed=SEED, device=DEV)
        print(f"2B random init + int4 text blocks on the card: {sync_ms(t0):.1f} ms")
    else:
        model = MoondreamModel(cfg, tokenizer=ByteTokenizer(), dtype=BF16, seed=SEED, device=DEV)
        print(f"2B random init on the card: {sync_ms(t0):.1f} ms")
    label = "int4 + kv_int8" if quantized else "bf16"
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
    kv_dtype = torch.int8 if quantized else BF16
    if enc.k.dtype != kv_dtype or (enc.ks is not None) != quantized:
        raise AssertionError(f"snapshot dtype {enc.k.dtype}, scales {enc.ks is not None}")
    values = (enc.k, enc.v) if not quantized else (enc.ks, enc.vs)
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
        logits, _, first, pos = model._prefill_prompt(kv, tmpl, enc.pos, 0.0, 0.0)
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
    # one decode step per emitted token, each through every text layer; the
    # 730-row image prefill's linears take the dense route (M >= 512)
    steps = L_txt * (1 + len(ids))
    want = {K.FLASH: L_vit + L_txt, K.DECODE: 0, K.DECODE_INT8: 0, KQ.W4A16: 0}
    want[K.DECODE_INT8 if quantized else K.DECODE] = steps
    if quantized:
        want[KQ.W4A16] = 4 * steps
    print(f"main path ({label}) launches:", launches, "expected:", want, "tokens:", len(ids))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if model.caption(enc, "normal", settings=greedy)["caption"] != text:
        raise AssertionError("second greedy caption differs")
    streamed = "".join(model.caption(enc, "normal", stream=True, settings=greedy)["caption"])
    if streamed != text:
        raise AssertionError("streamed caption differs from the plain one")
    sampled = model.caption(enc, "normal", settings={"max_tokens": 64})["caption"]
    if not isinstance(sampled, str):
        raise AssertionError("sampled caption failed")

    prefill_ms = min(r[1] for r in runs)
    tok_s = max(r[2] for r in runs)
    print(f"2B caption path ({label}) on {power}: encode {encode_ms:.1f} ms "
          f"(cold {cold_encode_ms:.1f} ms), prompt prefill {prefill_ms:.2f} ms, "
          f"decode {tok_s:.1f} tok/s over {len(runs[0][0])} tokens "
          "(greedy, batch 1, 13 crops)")
    if quantized:
        kv = model.load_encoded_image(enc)
        print(f"bytes: text block linears int4 {packed_bytes} (packed + scale/zero) "
              f"vs bf16 {dense_bytes}; KV cache int8 {_nbytes(kv.k, kv.v, kv.ks, kv.vs)} "
              f"(codes + scales) vs bf16 {2 * _nbytes(kv.k) * 2}")
    return launches


def main() -> None:
    power = card()
    print(power)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    # 756x1008 tiles 3x4: the 13-crop ViT batch
    img = np.random.default_rng(SEED).integers(0, 256, (756, 1008, 3), dtype=np.uint8)

    phase_build()
    summary = phase_kernels(gen)
    phase_small_reference(img)
    phase_small_reference(img, quantized=True)
    runs = [phase_main_path(img, power), phase_main_path(img, power, quantized=True)]
    launches = {name: sum(r[name] for r in runs) for name in runs[0]}
    launches[K.DECODE] += launches.pop(K.DECODE_INT8)

    sources = {
        K.FLASH: ("moondream_tpu_torch/csrc/flash_attn_fwd.cu",
                  "moondream_tpu/ops/attention.py:47; moondream_tpu/ops/attention.py:110"),
        K.DECODE: ("moondream_tpu_torch/csrc/decode_attn_stacked.cu",
                   "moondream_tpu/ops/attention.py:931; moondream_tpu/ops/attention.py:631; "
                   "moondream_tpu/ops/attention.py:631 (int8 branch)"),
        KQ.W4A16: ("moondream_tpu_torch/csrc/w4a16_matmul.cu",
                   "moondream_tpu/ops/quant.py:147; moondream_tpu/ops/quant.py:116"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": summary[name]["err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
