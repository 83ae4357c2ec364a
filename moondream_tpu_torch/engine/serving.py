"""Continuous batching: one decode forward for a pool of slots, each at its
own position (moondream_tpu/engine/serving.py, the plain-chunk subset:
no LoRA variants, no speculative or structured chunks).

A fixed pool of KV slots; requests are prefilled one by one and copied
into a free slot (`write_slot`); `serve_chunk` then advances every active
slot by up to `chunk` tokens: per-row positions in RoPE, per-row cache
writes, per-row masks in kernel C, per-row EOS and budgets. The chunk's
state (`cur`, `pos`, `active`, `budget`, `pids`) stays in device tensors
for all its steps: no step reads anything back to the host, so the host
syncs once per chunk (models/serve.py) and a chunk can later be captured
in a CUDA graph.

The caches are updated in place (the JAX package returns updated copies).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import TextConfig
from ..models.text import (
    KVCache,
    TextBlock,
    TextModel,
    _split_qkv,
    quantize_kv,
    text_encoder,
)
from ..ops.attention import decode_attention_cached
from ..ops.rope import apply_rotary_emb
from .batched import lm_logits_batched, sample_tokens_batched

NEG_INF = -1e30


def _write_rows(cache: torch.Tensor, layer: int, rows: torch.Tensor,
                cols: torch.Tensor, x: torch.Tensor) -> None:
    """cache[layer, rows[s], :, cols[s, i]] = x[s, :, i] in place, for
    values (L, S, H, T, D) / x (S, H, Tq, D) and scales (L, S, H/g, T) /
    x (S, H/g, Tq). Integer index tensors on the cache's device: no mask,
    no nonzero, no sync."""
    cache[layer].transpose(1, 2).index_put_(
        (rows[:, None], cols), x.transpose(1, 2).to(cache.dtype)
    )


def _ragged_attn(
    x: torch.Tensor,
    block: TextBlock,
    freqs_cis: torch.Tensor,
    kv: KVCache,
    layer: int,
    pos: torch.Tensor,
    config: TextConfig,
    kv_bound: Optional[int],
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """One attention layer of the pool (moondream_tpu/engine/serving.py:
    56-215). x (S, Tq, D): slot s's row i sits at position pos[s] + i
    (pos an int32 (S,) device tensor); its K/V land in the slot's cache at
    that position, in place.

    Prefix-shared mode (`pref` + `pids` + `prefix_len`): `kv` holds SUFFIX
    segments (slot s's column j is position prefix_len + j, so writes land
    at pos[s] - prefix_len, clamped at 0 for idle slots at position 0) and
    `pref` holds the shared [BOS, image] prefixes; slot s reads entry
    pids[s] besides its own suffix. pos stays global.

    Idle and finished slots write too, at their frozen position: those
    columns are rewritten at admission before anything attends them. A
    write starting past the cache's end is clamped back, as
    dynamic_update_slice clamps it in the JAX package."""
    bsz, q_len, _ = x.shape
    q, k, v = _split_qkv(block.qkv(x), config)
    steps = torch.arange(q_len, device=x.device)
    position_ids = pos.long()[:, None] + steps  # (S, Tq)
    # rows past the RoPE table are idle slots' (JAX's gather clamps them)
    rope_ids = position_ids.clamp(max=freqs_cis.shape[0] - 1)
    q = apply_rotary_emb(q, freqs_cis, rope_ids, config.rope_dim)
    k = apply_rotary_emb(k, freqs_cis, rope_ids, config.rope_dim)

    wpos = (pos.long() - prefix_len).clamp(min=0) if prefix_len else pos.long()
    wpos = wpos.clamp(max=kv.k.shape[3] - q_len)
    rows = torch.arange(bsz, device=x.device)
    cols = wpos[:, None] + steps
    if kv.ks is not None:
        g = kv.k.shape[2] // kv.ks.shape[2]
        kc, ksc = quantize_kv(k, g)
        vc, vsc = quantize_kv(v, g)
        _write_rows(kv.k, layer, rows, cols, kc)
        _write_rows(kv.v, layer, rows, cols, vc)
        _write_rows(kv.ks, layer, rows, cols, ksc)
        _write_rows(kv.vs, layer, rows, cols, vsc)
    else:
        _write_rows(kv.k, layer, rows, cols, k)
        _write_rows(kv.v, layer, rows, cols, v)

    segment = (None,) * 4 if pref is None else (pref.k, pref.v, pref.ks, pref.vs)
    out = decode_attention_cached(
        q, kv.k, kv.v, layer, pos, 0, kv_bound, kv.ks, kv.vs, *segment, pids,
        prefix_len,
    )
    return block.proj(out.transpose(1, 2).reshape(bsz, q_len, config.dim))


def ragged_hidden_step(
    model: TextModel,
    kv: KVCache,
    x: torch.Tensor,
    pos: torch.Tensor,
    kv_bound: Optional[int] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """One decoder forward for the whole pool at per-row positions from
    input embeddings x (S, 1, D); returns the (S, D) hidden states. Dense
    and int4 blocks alike (each block's linears are what it holds)."""
    config = model.config
    for layer, block in enumerate(model.blocks):
        ln_in = block.ln(x)
        attn_out = _ragged_attn(
            ln_in, block, model.freqs_cis, kv, layer, pos, config, kv_bound,
            pref, pids, prefix_len,
        )
        x = x + attn_out + block.mlp(ln_in)
    return x[:, 0]


def ragged_decode_step(
    model: TextModel,
    kv: KVCache,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    kv_bound: Optional[int] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """One decode step for the pool: tokens (S,) at positions pos (S,);
    returns (S, V) fp32 logits and updates the caches in place."""
    x = text_encoder(tokens[:, None], model)
    hidden = ragged_hidden_step(model, kv, x, pos, kv_bound, pref, pids, prefix_len)
    return lm_logits_batched(hidden, model)


class ServeChunkResult(NamedTuple):
    tokens: torch.Tensor  # (S, chunk) int32
    emitted: torch.Tensor  # (S, chunk) bool: True where tokens[s, j] is real
    active: torch.Tensor  # (S,) bool: active AFTER the chunk
    pos: torch.Tensor  # (S,) int32
    cur: torch.Tensor  # (S,) int32: each slot's next input token
    budget: torch.Tensor  # (S,) int32: tokens left per slot


def serve_chunk(
    model: TextModel,
    kv: KVCache,
    cur_tokens: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    budget: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature,
    top_p,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    *,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    chunk: int,
    kv_bound: Optional[int] = None,
    prefix_len: int = 0,
) -> ServeChunkResult:
    """Advance every active slot by up to `chunk` tokens
    (moondream_tpu/engine/serving.py:327-389). Each step emits a slot's
    current token, runs one pool forward, samples the next and retires the
    slot on EOS, an exhausted budget or the cache's end. Inactive slots
    keep their position (their writes land on a frozen column that nothing
    attends). `temperature`/`top_p`: floats, or (S,) device tensors of
    per-request settings. Nothing is read back to the host."""
    S = cur_tokens.shape[0]
    dev = cur_tokens.device
    toks = torch.zeros((S, chunk), dtype=torch.int32, device=dev)
    emit = torch.zeros((S, chunk), dtype=torch.bool, device=dev)
    # kv_bound is the SUFFIX capacity under prefix sharing; pos is global
    max_pos = (kv_bound or model.config.max_context) + prefix_len - 1
    cur, act, bud = cur_tokens, active, budget
    for i in range(chunk):
        toks[:, i] = torch.where(act, cur, 0)
        emit[:, i] = act
        logits = ragged_decode_step(model, kv, cur, pos, kv_bound, pref, pids, prefix_len)
        for sid in suppress_ids:
            logits[:, sid] = NEG_INF
        nxt = sample_tokens_batched(logits, generator, temperature, top_p).to(torch.int32)
        bud = bud - act.to(torch.int32)
        new_act = act & (nxt != eos_id) & (bud > 0) & (pos + 1 < max_pos)
        pos = torch.where(act, pos + 1, pos)
        cur = torch.where(act, nxt, cur)
        act = new_act
    return ServeChunkResult(
        tokens=toks, emitted=emit, active=act, pos=pos, cur=cur, budget=bud
    )


def write_slot(kv_pool: KVCache, snap: KVCache, slot: int) -> None:
    """Copy one request's prefilled span into pool slot `slot`, in place
    (moondream_tpu/engine/serving.py:770-778). snap: (L, 1, H, T_span, D)
    values or codes and (L, 1, H/g, T_span) scales."""
    span = snap.k.shape[3]
    kv_pool.k[:, slot, :, :span] = snap.k[:, 0]
    kv_pool.v[:, slot, :, :span] = snap.v[:, 0]
    if snap.ks is not None:
        kv_pool.ks[:, slot, :, :span] = snap.ks[:, 0]
        kv_pool.vs[:, slot, :, :span] = snap.vs[:, 0]
