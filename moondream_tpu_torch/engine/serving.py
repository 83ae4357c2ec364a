"""Continuous batching: one decode forward for a pool of slots, each at its
own position, each row through its own LoRA variant
(moondream_tpu/engine/serving.py).

A fixed pool of KV slots; requests are prefilled one by one and copied
into a free slot (`write_slot`); a chunk then advances every active slot:
per-row positions in RoPE, per-row cache writes, per-row masks in kernel
C, per-row EOS and budgets. Five chunks:
  * `serve_chunk`: one token per slot and step;
  * `serve_chunk_spec` / `serve_chunk_spec_sampled`: per iteration, each
    slot drafts k-1 tokens from its own history (`drafting.
    ngram_draft_rows`), one ragged span forward verifies every slot's k
    rows, and each slot advances by its 1..k accepted tokens;
  * `serve_chunk_mixed`: text rows beside structured (detect / point /
    gaze) rows, which step a coordinate state machine one forward at a
    time through the region heads;
  * `serve_chunk_mixed_spec`: both at once, greedy.
Every chunk takes `loras` (a variant-stacked adapter tree,
`lora.stack_variant_pytrees`: variant 0 the all-zeros base) and `vids`
(S,) int32, row s's variant: each row adds its own adapter's low-rank
residual at qkv, proj, fc1 and fc2 of every forward. The factors of the
rows are gathered and cast to fp32 once per chunk (`models.text.
layer_adapters`), since vids does not change inside one.
The chunk's state stays in device tensors for all its steps: no step reads
anything back to the host (no `.item()`, no `nonzero`, no boolean-mask
indexing; JAX's dropped out-of-range scatters write to a spare column
instead), so the host syncs once per chunk (models/serve.py), and on the
card the plain chunk is captured in a CUDA graph (engine/graphs.chunk).

The caches and the draft histories are updated in place (the JAX package
returns updated copies).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import TextConfig
from ..models import region as region_ops
from ..models.region import RegionModel
from ..models.text import (
    KVCache,
    TextBlock,
    TextModel,
    _split_qkv,
    layer_adapters,
    quantize_kv,
    text_encoder,
    write_rows,
)
from ..ops.attention import decode_attention_cached
from ..ops.layers import lora_add, lora_linear
from ..ops.rope import apply_rotary_emb
from .batched import lm_logits_batched, sample_tokens_batched
from .drafting import ngram_draft_rows
from .generate import greedy_accept, sampled_accept

NEG_INF = -1e30


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
    lora: Optional[dict] = None,
) -> torch.Tensor:
    """One attention layer of the pool (moondream_tpu/engine/serving.py:
    56-215). x (S, Tq, D): slot s's row i sits at position pos[s] + i
    (pos an int32 (S,) device tensor); its K/V land in the slot's cache at
    that position, in place. `lora`: this layer's per-row adapter pairs
    (`layer_adapters(loras, L, vids)`), or None.

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
    lora = lora or {}
    q, k, v = _split_qkv(lora_linear(x, block.qkv, lora.get("qkv")), config)
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
        write_rows(kv.k, layer, rows, cols, kc)
        write_rows(kv.v, layer, rows, cols, vc)
        write_rows(kv.ks, layer, rows, cols, ksc)
        write_rows(kv.vs, layer, rows, cols, vsc)
    else:
        write_rows(kv.k, layer, rows, cols, k)
        write_rows(kv.v, layer, rows, cols, v)

    segment = (None,) * 4 if pref is None else (pref.k, pref.v, pref.ks, pref.vs)
    out = decode_attention_cached(
        q, kv.k, kv.v, layer, pos, 0, kv_bound, kv.ks, kv.vs, *segment, pids,
        prefix_len,
    )
    out = block.proj(out.transpose(1, 2).reshape(bsz, q_len, config.dim))
    # the proj adapter reads the block input x (the shared-LN output), not
    # the attention output (moondream_tpu/engine/serving.py:211-214)
    return lora_add(out, x, lora.get("proj"))


def _ragged_forward(
    model: TextModel,
    kv: KVCache,
    x: torch.Tensor,
    pos: torch.Tensor,
    kv_bound: Optional[int],
    pref: Optional[KVCache],
    pids: Optional[torch.Tensor],
    prefix_len: int,
    adapters: Optional[list] = None,
) -> torch.Tensor:
    """Every block over x (S, Tq, D) at per-row positions; returns the
    (S, Tq, D) hidden states. Dense, int4 and int8 blocks alike (each
    block's linears are what it holds; an adapter's delta is added to the
    linear's rounded output, bias or w8a8 epilogue included). `adapters`:
    per layer, each row's adapter pairs (`layer_adapters(loras, L,
    vids)`), or None."""
    config = model.config
    adapters = adapters or [None] * len(model.blocks)
    for layer, block in enumerate(model.blocks):
        ln_in = block.ln(x)
        attn_out = _ragged_attn(
            ln_in, block, model.freqs_cis, kv, layer, pos, config, kv_bound,
            pref, pids, prefix_len, adapters[layer],
        )
        x = x + attn_out + block.mlp(ln_in, adapters[layer])
    return x


def ragged_hidden_step(
    model: TextModel,
    kv: KVCache,
    x: torch.Tensor,
    pos: torch.Tensor,
    kv_bound: Optional[int] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
    adapters: Optional[list] = None,
) -> torch.Tensor:
    """One decoder forward for the whole pool at per-row positions from
    input embeddings x (S, 1, D); returns the (S, D) hidden states.
    `adapters`: per layer, each row's LoRA pairs (`layer_adapters(loras,
    L, vids)`: row s through variant vids[s]), or None."""
    return _ragged_forward(model, kv, x, pos, kv_bound, pref, pids, prefix_len,
                           adapters)[:, 0]


def ragged_verify_step(
    model: TextModel,
    kv: KVCache,
    q_toks: torch.Tensor,
    pos: torch.Tensor,
    kv_bound: Optional[int] = None,
    x_override: Optional[torch.Tensor] = None,
    x_mask: Optional[torch.Tensor] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
    adapters: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One speculative verify forward for the pool
    (moondream_tpu/engine/serving.py:392-474): slot s feeds the span
    q_toks[s] (S, k) at positions pos[s]..pos[s]+k-1. `x_override` (S, D)
    replaces the embedding at span position 0 of the rows where `x_mask`
    (S,) is True: structured rows feed a coordinate or size embedding.
    `adapters` (`ragged_hidden_step`): each row's adapter applies over its
    whole span, an overridden row included. Returns ((S, k, V) fp32
    logits, (S, k, D) hidden states)."""
    x = text_encoder(q_toks, model)
    if x_override is not None:
        first = torch.arange(x.shape[1], device=x.device) == 0
        x = torch.where(x_mask[:, None, None] & first[None, :, None],
                        x_override[:, None, :].to(x.dtype), x)
    hidden = _ragged_forward(model, kv, x, pos, kv_bound, pref, pids, prefix_len, adapters)
    s_, k, d = hidden.shape
    return lm_logits_batched(hidden.reshape(s_ * k, d), model).reshape(s_, k, -1), hidden


def ragged_decode_step(
    model: TextModel,
    kv: KVCache,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    kv_bound: Optional[int] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
    adapters: Optional[list] = None,
) -> torch.Tensor:
    """One decode step for the pool: tokens (S,) at positions pos (S,);
    returns (S, V) fp32 logits and updates the caches in place.
    `adapters`: as in `ragged_hidden_step`."""
    x = text_encoder(tokens[:, None], model)
    hidden = ragged_hidden_step(model, kv, x, pos, kv_bound, pref, pids, prefix_len, adapters)
    return lm_logits_batched(hidden, model)


class ServeChunkResult(NamedTuple):
    tokens: torch.Tensor  # (S, W) int32; W = chunk, or n_iter * k for spec chunks
    emitted: torch.Tensor  # (S, W) bool: True where tokens[s, j] is real
    active: torch.Tensor  # (S,) bool: active AFTER the chunk
    pos: torch.Tensor  # (S,) int32
    cur: torch.Tensor  # (S,) int32: each slot's next input token
    budget: torch.Tensor  # (S,) int32: tokens left per slot
    # (S,) int32: draft history entries per slot (spec chunks; the
    # histories are updated in place)
    hist_cnt: Optional[torch.Tensor] = None


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
    loras: Optional[dict] = None,
    vids: Optional[torch.Tensor] = None,
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
    per-request settings. `loras`/`vids`: per-row LoRA variants (the
    module docstring), or None. Nothing is read back to the host."""
    S = cur_tokens.shape[0]
    dev = cur_tokens.device
    toks = torch.zeros((S, chunk), dtype=torch.int32, device=dev)
    emit = torch.zeros((S, chunk), dtype=torch.bool, device=dev)
    # kv_bound is the SUFFIX capacity under prefix sharing; pos is global
    max_pos = (kv_bound or model.config.max_context) + prefix_len - 1
    adapters = layer_adapters(loras, len(model.blocks), vids)
    cur, act, bud = cur_tokens, active, budget
    for i in range(chunk):
        toks[:, i] = torch.where(act, cur, 0)
        emit[:, i] = act
        logits = ragged_decode_step(model, kv, cur, pos, kv_bound, pref, pids, prefix_len,
                                    adapters)
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


def _put(buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
         vals: torch.Tensor, valid: torch.Tensor) -> None:
    """buf[rows, cols] = vals where `valid`, in place, with no sync. buf's
    last column is a spare that nothing reads: invalid entries write there
    (JAX's scatter with mode="drop" at an out-of-range index). rows (S,);
    cols, vals and valid (S,) or (S, n)."""
    spare = buf.shape[1] - 1
    if cols.dim() == 2:
        rows = rows[:, None]
    buf[rows, torch.where(valid, cols.long(), spare)] = vals.to(buf.dtype)


def _spec_chunk(model, kv, cur, pos, active, budget, hist, hist_cnt, loras, vids, pref, pids,
                *, eos_id, suppress_ids, n_iter, spec_k, kv_bound, prefix_len,
                accept, is_text=None, struct=None) -> tuple:
    """The speculative chunk loop (moondream_tpu/engine/serving.py:
    489-602, 1003-1205). Per iteration: each active text row emits its
    current token and appends it to its history, drafts spec_k - 1 tokens,
    one ragged span forward verifies all rows, and `accept(draft, logits)`
    gives each row's emitted span (S, k) and count m (S,). `hist` is
    (S, H + 1): H history columns and a spare. With `struct` (a
    _StructState) and `is_text`, structured rows step their state machine
    instead: they feed their coordinate or size embedding at span position
    0 and always advance by one. Each row verifies through its own LoRA
    variant (`loras`/`vids`, or None). Returns (tokens, emitted, active,
    pos, cur, budget, hist_cnt)."""
    S, dev = cur.shape[0], cur.device
    W, H = n_iter * spec_k, hist.shape[1] - 1
    toks = torch.zeros((S, W + 1), dtype=torch.int32, device=dev)
    emit = torch.zeros((S, W + 1), dtype=torch.bool, device=dev)
    col = torch.zeros((S,), dtype=torch.long, device=dev)
    rows = torch.arange(S, device=dev)
    steps = torch.arange(spec_k - 1, device=dev)
    max_pos = (kv_bound or model.config.max_context) + prefix_len
    cnt, act, bud = hist_cnt.long(), active, budget.long()
    adapters = layer_adapters(loras, len(model.blocks), vids)
    for _ in range(n_iter):
        x_override = x_mask = None
        if struct is not None:
            act, x_override = struct.consume(act, pos, bud, stop_margin=spec_k + 3)
            x_mask = ~is_text
        text_act = act if is_text is None else act & is_text
        # emit cur and append it to the history
        _put(toks, rows, col, cur, text_act)
        _put(emit, rows, col, torch.ones_like(text_act), text_act)
        _put(hist, rows, cnt.clamp(max=H - 1), cur, text_act)
        cnt1 = cnt + text_act.long()
        draft, _ = ngram_draft_rows(hist[:, :H], cnt1, cur, spec_k)
        q_toks = torch.cat([cur[:, None], draft.to(cur.dtype)], dim=1)
        logits, hidden = ragged_verify_step(model, kv, q_toks, pos, kv_bound, x_override,
                                            x_mask, pref, pids, prefix_len, adapters)
        if struct is not None:
            # structured rows hold span position 0's hidden state and its
            # unsuppressed greedy token
            struct.hold(act, hidden[:, 0], logits[:, 0])
        for sid in suppress_ids:
            logits[:, :, sid] = NEG_INF
        g, m = accept(draft, logits, act)
        m = torch.minimum(m, bud)
        if struct is not None:
            m = torch.where(is_text, m, 1)  # structured rows advance by one
        m = torch.where(act, m, 0)
        # the accepted span's interior g[:, :m-1] -> tokens and history
        valid = text_act[:, None] & (steps[None, :] + 1 < m[:, None])
        _put(toks, rows, col[:, None] + 1 + steps, g[:, :-1], valid)
        _put(emit, rows, col[:, None] + 1 + steps, valid, valid)
        _put(hist, rows, (cnt1[:, None] + steps).clamp(max=H - 1), g[:, :-1], valid)
        nxt = g[rows, (m - 1).clamp(min=0)].to(cur.dtype)
        cur = torch.where(text_act, nxt, cur)
        pos = pos + m.to(pos.dtype)
        bud = bud - m
        cnt = cnt1 + (m - 1).clamp(min=0) * text_act.long()
        col = col + m
        done = (cur == eos_id) | (bud <= 0)
        if is_text is not None:
            done = done & is_text
        act = act & ~done & (pos + spec_k <= max_pos)
    return (toks[:, :W], emit[:, :W], act, pos, cur, bud.to(budget.dtype),
            cnt.to(hist_cnt.dtype))


def _greedy_accept_fn(eos_id):
    def accept(draft, logits, act):
        g = torch.argmax(logits, dim=-1)
        return g, greedy_accept(draft, g, eos_id)
    return accept


def serve_chunk_spec(
    model: TextModel,
    kv: KVCache,
    cur_tokens: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    budget: torch.Tensor,
    hist: torch.Tensor,
    hist_cnt: torch.Tensor,
    loras: Optional[dict] = None,
    vids: Optional[torch.Tensor] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    *,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    n_iter: int,
    spec_k: int,
    kv_bound: Optional[int] = None,
    prefix_len: int = 0,
) -> ServeChunkResult:
    """The greedy speculative chunk (moondream_tpu/engine/serving.py:
    489-602): `n_iter` verify iterations, each advancing every active slot
    by 1..spec_k tokens for one pass over the weights, from per-slot n-gram
    drafts over `hist` (S, H + 1; H history columns and a spare) with
    `hist_cnt` (S,) valid entries. Token for token `serve_chunk` at
    temperature 0 (span and step accumulate in another order, so a near
    tie could flip, as in the JAX package). The pool admits requests with
    budget <= slot_len - pos - spec_k, so every span fits its slot."""
    out = _spec_chunk(model, kv, cur_tokens, pos, active, budget, hist, hist_cnt, loras, vids,
                      pref, pids, eos_id=eos_id, suppress_ids=suppress_ids, n_iter=n_iter,
                      spec_k=spec_k, kv_bound=kv_bound, prefix_len=prefix_len,
                      accept=_greedy_accept_fn(eos_id))
    return ServeChunkResult(*out)


def serve_chunk_spec_sampled(
    model: TextModel,
    kv: KVCache,
    cur_tokens: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    budget: torch.Tensor,
    hist: torch.Tensor,
    hist_cnt: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature,
    top_p,
    loras: Optional[dict] = None,
    vids: Optional[torch.Tensor] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    *,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    n_iter: int,
    spec_k: int,
    kv_bound: Optional[int] = None,
    prefix_len: int = 0,
) -> ServeChunkResult:
    """The speculative sampling chunk (moondream_tpu/engine/serving.py:
    618-767): serve_chunk_spec with each row's drafts accepted by the
    rejection test against its own target nucleus (`temperature`/`top_p`
    floats, or (S,) per-request tensors; a greedy row's temperature 0
    becomes a point mass at its argmax, so it stays exact). The emitted
    streams are distributed as the plain sampled chunks', not draw for
    draw."""
    t = temperature[:, None, None] if isinstance(temperature, torch.Tensor) else temperature
    p_lim = top_p[:, None, None] if isinstance(top_p, torch.Tensor) else top_p

    def accept(draft, logits, act):
        return sampled_accept(logits, draft, generator, t, p_lim, eos_id)

    out = _spec_chunk(model, kv, cur_tokens, pos, active, budget, hist, hist_cnt, loras, vids,
                      pref, pids, eos_id=eos_id, suppress_ids=suppress_ids, n_iter=n_iter,
                      spec_k=spec_k, kv_bound=kv_bound, prefix_len=prefix_len, accept=accept)
    return ServeChunkResult(*out)


# ---------------------------------------------------------------- mixed pool
# Per-slot modes of the mixed chunks (moondream_tpu/engine/serving.py:
# 787-790). Structured rows cycle XN -> Y (-> SIZE) -> XN, one decoder
# forward per transition, beside free-text rows.
MODE_TEXT = 0
MODE_XN = 1  # the held hidden state gives both the continue/EOS token and the next x
MODE_Y = 2
MODE_SIZE = 3


class _StructState:
    """The structured rows' device state of a mixed chunk, updated in place:
    `mode` (S,) int32, `hid` (S, D) the held hidden state, `pending` (S,)
    its greedy token, `xbuf`/`ybuf` (S,) fp32, `boxes` (S, max_objects, 4)
    fp32, `nobj` (S,) int32 and `is_box` (S,) bool (detect rows; point and
    gaze rows record [x, y, 0, 0]). `max_pos` is the chunk's position
    limit that the stop margin counts from."""

    def __init__(self, region: RegionModel, eos_id: int, max_objects: int, max_pos: int,
                 mode, hid, pending, xbuf, ybuf, boxes, nobj, is_box, emb_dtype):
        self.region, self.eos_id, self.max_objects = region, eos_id, max_objects
        self.max_pos = max_pos
        self.mode, self.hid, self.pending = mode, hid, pending
        self.xbuf, self.ybuf, self.boxes, self.nobj = xbuf, ybuf, boxes, nobj
        self.is_box, self.emb_dtype = is_box, emb_dtype
        self.is_text = mode == MODE_TEXT
        self.slot = torch.arange(max_objects, device=mode.device)

    def consume(self, act, pos, bud, stop_margin: int):
        """Structured rows consume their held hidden state
        (moondream_tpu/engine/serving.py:873-935): an XN row stops at EOS,
        at max_objects, within `stop_margin` of the cache's end or with its
        budget spent, and otherwise decodes x; a Y row decodes y (a point
        row records its point); a SIZE row decodes (w, h) and records its
        box. The coordinate and size heads run over every row (the argmaxes
        of `points_loop`, in fp32). Returns (act with stopped rows cleared,
        the (S, D) coordinate or size embedding each row feeds next)."""
        region, is_struct = self.region, ~self.is_text
        val = region_ops.coordinate_value(region_ops.decode_coordinate(self.hid, region))
        wh = region_ops.size_bin_to_value(
            torch.argmax(region_ops.decode_size(self.hid, region), dim=-1))
        xn = is_struct & (self.mode == MODE_XN) & act
        stop = ((self.pending == self.eos_id) | (self.nobj >= self.max_objects)
                | (pos + stop_margin >= self.max_pos) | (bud <= 0))
        act = act & ~(xn & stop)
        xn = xn & ~stop
        yrow = is_struct & (self.mode == MODE_Y) & act
        srow = is_struct & (self.mode == MODE_SIZE) & act
        xb, yb = self.xbuf, self.ybuf
        zero = torch.zeros_like(xb)
        point_row = torch.stack([xb, val, zero, zero], -1)
        w, h = wh[:, 0], wh[:, 1]
        box_row = torch.stack([xb - w / 2, yb - h / 2, xb + w / 2, yb + h / 2], -1)
        rec = (yrow & ~self.is_box) | srow
        row = torch.where(srow[:, None], box_row, point_row)
        upd = (self.slot[None, :] == self.nobj[:, None]) & rec[:, None]
        self.boxes.copy_(torch.where(upd[..., None], row[:, None, :], self.boxes))
        self.nobj.add_(rec.to(self.nobj.dtype))
        self.xbuf.copy_(torch.where(xn, val, xb))
        self.ybuf.copy_(torch.where(yrow, val, yb))
        self.new_mode = torch.where(
            xn, MODE_Y,
            torch.where(yrow, torch.where(self.is_box, MODE_SIZE, MODE_XN),
                        torch.where(srow, MODE_XN, self.mode))).to(self.mode.dtype)
        emb_coord = region_ops.encode_coordinate(val[:, None].to(self.emb_dtype), region)
        emb_size = region_ops.encode_size(wh.to(self.emb_dtype), region)
        return act, torch.where(srow[:, None], emb_size, emb_coord).to(self.emb_dtype)

    def hold(self, act, hidden, logits) -> None:
        """Structured rows hold the forward's hidden state (S, D) and its
        greedy token from the (S, V) unsuppressed logits, and move on to
        the mode `consume` chose."""
        is_struct = ~self.is_text
        self.hid.copy_(torch.where(is_struct[:, None], hidden.to(self.hid.dtype), self.hid))
        self.pending.copy_(torch.where(is_struct, torch.argmax(logits, dim=-1).to(
            self.pending.dtype), self.pending))
        self.mode.copy_(torch.where(act & is_struct, self.new_mode, self.mode))


def serve_chunk_mixed(
    model: TextModel,
    region: RegionModel,
    kv: KVCache,
    cur_tokens: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    budget: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature,
    top_p,
    mode: torch.Tensor,
    hid: torch.Tensor,
    pending: torch.Tensor,
    xbuf: torch.Tensor,
    ybuf: torch.Tensor,
    boxes: torch.Tensor,
    nobj: torch.Tensor,
    is_box: torch.Tensor,
    loras: Optional[dict] = None,
    vids: Optional[torch.Tensor] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    *,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    chunk: int,
    max_objects: int,
    kv_bound: Optional[int] = None,
    prefix_len: int = 0,
) -> ServeChunkResult:
    """A chunk over a pool that mixes text rows (caption / query) with
    structured rows (detect / point / gaze) (moondream_tpu/engine/
    serving.py:811-981): every active row takes one decoder forward per
    step; text rows sample tokens as in serve_chunk, structured rows step
    their coordinate state machine (_StructState.consume) and feed its
    coordinate or size embedding, so a pooled detect equals the
    single-request one; each row through its own LoRA variant
    (`loras`/`vids`), structured rows too. The structured state (`mode`
    ... `nobj`) is updated in place."""
    S, dev = cur_tokens.shape[0], cur_tokens.device
    toks = torch.zeros((S, chunk), dtype=torch.int32, device=dev)
    emit = torch.zeros((S, chunk), dtype=torch.bool, device=dev)
    max_pos = (kv_bound or model.config.max_context) + prefix_len - 1
    st = _StructState(region, eos_id, max_objects, max_pos, mode, hid, pending, xbuf, ybuf,
                      boxes, nobj, is_box, model.wte.dtype)
    is_text = st.is_text
    adapters = layer_adapters(loras, len(model.blocks), vids)
    cur, act, bud = cur_tokens, active, budget
    for i in range(chunk):
        act, emb_struct = st.consume(act, pos, bud, stop_margin=4)
        emb = torch.where(is_text[:, None], text_encoder(cur, model).to(st.emb_dtype),
                          emb_struct)
        toks[:, i] = torch.where(act & is_text, cur, 0)
        emit[:, i] = act & is_text
        hid_new = ragged_hidden_step(model, kv, emb[:, None, :], pos, kv_bound, pref, pids,
                                     prefix_len, adapters)
        logits = lm_logits_batched(hid_new, model)
        st.hold(act, hid_new, logits)
        for sid in suppress_ids:
            logits[:, sid] = NEG_INF
        nxt = sample_tokens_batched(logits, generator, temperature, top_p).to(torch.int32)
        bud = bud - act.to(bud.dtype)
        text_done = is_text & ((nxt == eos_id) | (bud <= 0))
        new_act = act & ~text_done & (pos + 1 < max_pos)
        pos = torch.where(act, pos + 1, pos)
        cur = torch.where(act & is_text, nxt, cur)
        act = new_act
    return ServeChunkResult(tokens=toks, emitted=emit, active=act, pos=pos, cur=cur,
                            budget=bud)


def serve_chunk_mixed_spec(
    model: TextModel,
    region: RegionModel,
    kv: KVCache,
    cur_tokens: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    budget: torch.Tensor,
    hist: torch.Tensor,
    hist_cnt: torch.Tensor,
    mode: torch.Tensor,
    hid: torch.Tensor,
    pending: torch.Tensor,
    xbuf: torch.Tensor,
    ybuf: torch.Tensor,
    boxes: torch.Tensor,
    nobj: torch.Tensor,
    is_box: torch.Tensor,
    loras: Optional[dict] = None,
    vids: Optional[torch.Tensor] = None,
    pref: Optional[KVCache] = None,
    pids: Optional[torch.Tensor] = None,
    *,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    n_iter: int,
    spec_k: int,
    max_objects: int,
    kv_bound: Optional[int] = None,
    prefix_len: int = 0,
) -> ServeChunkResult:
    """The greedy speculative mixed chunk (moondream_tpu/engine/serving.py:
    1003-1205): text rows draft and verify k-row spans as in
    serve_chunk_spec, while structured rows, inside the same span forward,
    feed their coordinate or size embedding at span position 0 and accept
    exactly that one position; their span rows 1..k-1 write K/V past their
    position that later forwards overwrite before anything attends them,
    as rejected drafts do. Structured rows stop while pos + spec_k + 3
    still fits. Text rows equal serve_chunk_spec's, structured rows
    serve_chunk_mixed's."""
    st = _StructState(region, eos_id, max_objects,
                      (kv_bound or model.config.max_context) + prefix_len, mode, hid, pending,
                      xbuf, ybuf, boxes, nobj, is_box, model.wte.dtype)
    out = _spec_chunk(model, kv, cur_tokens, pos, active, budget, hist, hist_cnt, loras, vids,
                      pref, pids, eos_id=eos_id, suppress_ids=suppress_ids, n_iter=n_iter,
                      spec_k=spec_k, kv_bound=kv_bound, prefix_len=prefix_len,
                      accept=_greedy_accept_fn(eos_id), is_text=st.is_text, struct=st)
    return ServeChunkResult(*out)
