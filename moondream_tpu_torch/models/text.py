"""Phi-style text decoder (moondream_tpu/models/text.py).

Each block is a parallel attention + MLP residual on one LayerNorm,
``x = x + attn(ln(x)) + mlp(ln(x))``, with fused-QKV attention, partial
RoPE, and attention bidirectional over the first `prefix_len` positions
(730 after an image) and causal after.

The KV cache is the plain (L, B, H_kv, T, D) layout only; the JAX package's
head-paired layout exists for TPU lanes and is not ported, but its int8
scale granularity is: one scale per token per cache row, and a cache row
of the JAX package holds `kv_scale_group` adjacent heads.

With int4 runtime weights (`quantize_text_params`), each block's qkv, proj,
fc1 and fc2 are `Int4Linear`s; with int8 w8a8 weights
(`quantize_text_params_int8`) they are `ops.layers.Int8Linear`s
(per-output-channel codes, activations quantized per row at run time).
wte, lm_head, norms and biases stay dense either way.

A LoRA adapter (`lora.variant_state_dict`'s stacked layout, `lora=` of
`text_decoder` and `produce_hidden`) adds (x @ A^T) @ B^T at qkv, proj,
fc1 and fc2 of every block, on every weight format: the delta in fp32,
rounded to the activation dtype, added to the linear's rounded output
(moondream_tpu/models/text.py:194-198, :324-331, :411-416, :484-505). The
proj adapter reads the block's input (the LayerNorm output), not the
attention output.

A steering vector (`steer=` of `text_decoder`, (n_layers, dim): a control
vector times its scale, `repeng.ControlVector`) adds its row l to block
l's output, after ``x + attn + mlp``, in the activation dtype
(moondream_tpu/models/text.py:505-508), on every weight format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..config import TextConfig, TextShardConfig
from ..ops.attention import decode_attention, decode_attention_cached, flash_attention
from ..ops.layers import _INV127, MLP, Int8Linear, LayerNorm, Linear, lora_add, lora_linear, sdpa
from ..ops.quant import quantize_weight_torch, quantized_matmul
from ..ops.rope import apply_rotary_emb, precompute_freqs_cis

# Spans up to this many query rows go to the stacked-cache decode kernel.
DECODE_SPAN_MAX = 16


def kv_scale_group(config: TextConfig) -> int:
    """How many adjacent KV heads share one int8 scale per token: the JAX
    package's `kv_pair_factor` (moondream_tpu/models/text.py:41-55), whose
    cache row holds that many heads side by side. 2 for the 2B, 0.5B and
    tiny configs; 1 for a tensor-parallel rank's config, as the JAX
    package's is 1 under a mesh (xla_attn), where the head axis splits."""
    if isinstance(config, TextShardConfig) or config.n_kv_heads != config.n_heads:
        return 1
    if config.n_kv_heads % 2 or config.head_dim * 2 > 128:
        return 1
    return 2


@dataclass
class KVCache:
    """Stacked caches, each (L, B, H_kv, T, D). Updated in place.

    With config.kv_int8, `k`/`v` hold int8 codes and `ks`/`vs` fp32 scales
    (L, B, H_kv/g, T), g = kv_scale_group(config): x ~ code * scale, with
    head h on scale row h // g."""

    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls, config: TextConfig, batch: int = 1, dtype=torch.bfloat16,
        device=None, slots: Optional[int] = None,
    ) -> "KVCache":
        t = slots if slots is not None else config.max_context
        shape = (config.n_layers, batch, config.n_kv_heads, t, config.head_dim)
        if config.kv_int8:
            sshape = (*shape[:2], config.n_kv_heads // kv_scale_group(config), t)
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                ks=torch.zeros(sshape, dtype=torch.float32, device=device),
                vs=torch.zeros(sshape, dtype=torch.float32, device=device),
            )
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def slice_cache_span(kv: KVCache, span: int) -> KVCache:
    """Views of [0, span) of the time axis of every cache tensor
    (moondream_tpu/models/text.py:148-156)."""
    return slice_cache_span_from(kv, 0, span)


def slice_cache_span_from(kv: KVCache, start: int, span: int) -> KVCache:
    """Views of [start, start + span) of the time axis of every cache tensor
    (moondream_tpu/models/text.py:159-170): the prompt SUFFIX of a
    prefilled buffer under prefix-shared serving. A span that runs past the
    buffer's end keeps what is there, as the JAX package's slot write
    (dynamic_update_slice) then writes only that."""
    sl = lambda a: None if a is None else a[..., start:start + span, :]
    sls = lambda a: None if a is None else a[..., start:start + span]
    return KVCache(k=sl(kv.k), v=sl(kv.v), ks=sls(kv.ks), vs=sls(kv.vs))


def quantize_kv(x: torch.Tensor, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per token and group of g adjacent heads: x (B, H, T, D)
    -> codes int8 (B, H, T, D) and scale fp32 (B, H/g, T); x ~ codes *
    scale. The amax runs over the g * D values of one JAX cache row
    (moondream_tpu/models/text.py:132-139 on `pair_kv` rows)."""
    b, h, t, d = x.shape
    xg = x.float().reshape(b, h // g, g, t, d)
    amax = xg.abs().amax(dim=(2, 4))
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-8)
    codes = torch.round(xg / scale[:, :, None, :, None]).clamp(-127, 127)
    return codes.reshape(b, h, t, d).to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """codes (..., H, T, D) * scale (..., H/g, T) in `dtype` directly: the
    scale is cast before the product (moondream_tpu/models/text.py:142-145)."""
    g = codes.shape[-3] // scale.shape[-2]
    s = scale.to(dtype).repeat_interleave(g, dim=-2)
    return codes.to(dtype) * s[..., None]


class Int4Linear(nn.Module):
    """The JAX package's `_q_lin` (moondream_tpu/models/text.py:178-199):
    y = quantized_matmul(x, W) rounded to x.dtype, then + b in fp32 and
    rounded again (bias outside the product, in that order). `packed` (K/2,
    N) uint8 and `scale`/`zero` (K/group, N) fp32 are buffers that must stay
    fp32: do not cast the module with `.to(dtype)`."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)
        self.register_buffer("zero", zero)
        self.b = nn.Parameter(b, requires_grad=False)

    @classmethod
    def from_linear(cls, lin: Linear) -> "Int4Linear":
        qw = quantize_weight_torch(lin.w)
        return cls(qw["packed"], qw["scale"], qw["zero"], lin.b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        qw = {"packed": self.packed, "scale": self.scale, "zero": self.zero}
        y = quantized_matmul(x.reshape(-1, x.shape[-1]), qw).reshape(*lead, -1)
        return (y.float() + self.b.float()).to(x.dtype)


class TextBlock(nn.Module):
    def __init__(self, config: TextConfig, device=None, dtype=None):
        super().__init__()
        d = config.dim
        self.ln = LayerNorm(d, device, dtype)
        self.qkv = Linear(d, config.qkv_dim, device, dtype)
        self.proj = Linear(d, d, device, dtype)
        self.mlp = MLP(d, config.ff_dim, d, device, dtype)


class TextModel(nn.Module):
    def __init__(self, config: TextConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.wte = nn.Parameter(
            torch.empty(config.vocab_size, config.dim, device=device, dtype=dtype),
            requires_grad=False,
        )
        self.blocks = nn.ModuleList(
            TextBlock(config, device, dtype) for _ in range(config.n_layers)
        )
        self.post_ln = LayerNorm(config.dim, device, dtype)
        self.lm_head = Linear(config.dim, config.vocab_size, device, dtype)
        self.register_buffer(
            "freqs_cis",
            precompute_freqs_cis(config.rope_dim, config.max_context, device=device),
            persistent=False,
        )


@torch.no_grad()
def quantize_text_params(model: TextModel) -> TextModel:
    """Convert the blocks' qkv, proj, fc1 and fc2 to int4 in place, on their
    device, with the JAX package's group choice and packing
    (moondream_tpu/models/text.py:202-232); returns the model."""
    for blk in model.blocks:
        blk.qkv = Int4Linear.from_linear(blk.qkv)
        blk.proj = Int4Linear.from_linear(blk.proj)
        blk.mlp.fc1 = Int4Linear.from_linear(blk.mlp.fc1)
        blk.mlp.fc2 = Int4Linear.from_linear(blk.mlp.fc2)
    return model


@torch.no_grad()
def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 codes of a dense (K, N) weight, on
    its device, bit-identical to the jitted quantizer of the JAX package's
    `quantize_text_params_int8` (moondream_tpu/models/text.py:254-259):
    s = max(column amax, 1e-8) * fp32(1/127) (XLA's form of the division
    by 127), codes = round_half_even(w / s). Returns (codes (K, N) int8,
    scale (N,) fp32)."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    s = amax.clamp_min(1e-8) * torch.full_like(amax, _INV127)
    return torch.round(wf / s).to(torch.int8), s


def _int8_from_linear(lin: Linear) -> Int8Linear:
    codes, scale = quantize_weight_int8(lin.w)
    return Int8Linear(codes, scale, lin.b)


@torch.no_grad()
def quantize_text_params_int8(model: TextModel) -> TextModel:
    """Convert the blocks' qkv, proj, fc1 and fc2 to the int8 w8a8 format in
    place, on their device, with the JAX package's codes and scales
    (moondream_tpu/models/text.py:235-262); returns the model. wte,
    lm_head, norms and biases stay dense, as do the region heads."""
    for blk in model.blocks:
        blk.qkv = _int8_from_linear(blk.qkv)
        blk.proj = _int8_from_linear(blk.proj)
        blk.mlp.fc1 = _int8_from_linear(blk.mlp.fc1)
        blk.mlp.fc2 = _int8_from_linear(blk.mlp.fc2)
    return model


def text_encoder(input_ids: torch.Tensor, model: TextModel) -> torch.Tensor:
    """Token embedding lookup: (B, T) -> (B, T, D)."""
    return model.wte[input_ids]


def _split_qkv(
    qkv: torch.Tensor, config: TextConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, qkv_dim) -> q (B, H, T, Dh), k and v (B, H_kv, T, Dh)."""
    b, t, _ = qkv.shape
    q_dim = config.n_heads * config.head_dim
    kv_dim = config.n_kv_heads * config.head_dim
    q, k, v = qkv.split([q_dim, kv_dim, kv_dim], dim=-1)
    return (
        q.reshape(b, t, config.n_heads, config.head_dim).transpose(1, 2),
        k.reshape(b, t, config.n_kv_heads, config.head_dim).transpose(1, 2),
        v.reshape(b, t, config.n_kv_heads, config.head_dim).transpose(1, 2),
    )


def write_rows(cache: torch.Tensor, layer: int, rows: torch.Tensor,
               cols: torch.Tensor, x: torch.Tensor) -> None:
    """cache[layer, rows[s], :, cols[s, i]] = x[s, :, i] in place, for
    values (L, S, H, T, D) / x (S, H, Tq, D) and scales (L, S, H/g, T) /
    x (S, H/g, Tq). Integer index tensors on the cache's device: no mask,
    no nonzero, no sync, and no host position (a CUDA graph may replay
    it)."""
    cache[layer].transpose(1, 2).index_put_(
        (rows[:, None], cols), x.transpose(1, 2).to(cache.dtype)
    )


# The adapter's sites: (group, name) in the stacked tree's layout.
LORA_SITES = (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2"))


def layer_adapters(lora: Optional[dict], n_layers: int,
                   vids: Optional[torch.Tensor] = None) -> list:
    """Per layer, the adapter's pairs {name: {"A": (r, in), "B": (out, r)}}
    of a stacked tree (A (L, r, in), B (L, out, r); a group or site may be
    absent, as in `lora.merge_variant`'s residual), or None for every layer
    without an adapter. The factors are cast to fp32 once per forward, not
    once per layer and site; each layer's pair is a view of that copy.

    With `vids` (S,) int32, `lora` is a variant-stacked tree (A (L, V + 1,
    r, in), B (L, V + 1, out, r); `lora.stack_variant_pytrees`) and each
    pair holds row s's factors of variant vids[s]: A (S, r, in), B (S, out,
    r), gathered on the device once, for every layer and step of a chunk
    (`ops.layers.lora_delta` then applies row s's pair to row s)."""
    if lora is None:
        return [None] * n_layers
    pick = (lambda t: t) if vids is None else (lambda t: t.index_select(1, vids))
    sites = {}
    for grp, name in LORA_SITES:
        pair = (lora.get(grp) or {}).get(name)
        if pair is not None:
            sites[name] = (pick(pair["A"]).float(), pick(pair["B"]).float())
    return [{name: {"A": a[layer], "B": b[layer]} for name, (a, b) in sites.items()}
            for layer in range(n_layers)]


def attn_with_cache(
    x: torch.Tensor,
    block: TextBlock,
    freqs_cis: torch.Tensor,
    kv: KVCache,
    layer: int,
    pos: Union[int, torch.Tensor],
    prefix_len: int,
    config: TextConfig,
    kv_bound: Optional[int] = None,
    lora: Optional[dict] = None,
) -> torch.Tensor:
    """One attention layer reading and updating the stacked cache.

    x: (B, T, D) pre-normed input at positions pos..pos+T-1. `pos` is a
    host int, or a (B,) int32 device tensor whose rows hold the loop's one
    position, for a decode token or a span of any length (a speculative
    verify span), as the JAX package takes a traced position. The decode
    loops' steps, which a CUDA graph replays, take that form: RoPE, the
    cache writes and the attention kernels (B's and A's device forms) then
    read it on the device. RoPE rows past the table are clamped to its
    last row, and a span's write starts at min(pos, T - Tq), as JAX's
    gather and dynamic_update_slice clamp them; such rows belong to a loop
    that is done and are never attended. Routed as the JAX package routes
    it (moondream_tpu/models/text.py:377-406), whatever the position's form:
      * MHA spans of up to 16 rows (decode tokens, short prompt prefills,
        verify spans of k <= 16), and GQA decode tokens over a bf16 cache,
        go to the stacked-cache decode attention;
      * a GQA decode token over an int8 cache dequantizes the layer's
        [0, kv_bound) span and goes to the single-layer decode attention;
      * longer spans (and GQA spans) read cache[layer][:, :, :kv_bound],
        dequantized for int8, with KV heads repeated under GQA, and go to
        flash attention.
    `lora`: this layer's adapter pairs (`layer_adapters`), or None."""
    bsz, q_len, _ = x.shape
    mha = config.n_kv_heads == config.n_heads
    lora = lora or {}
    q, k, v = _split_qkv(lora_linear(x, block.qkv, lora.get("qkv")), config)
    on_device = isinstance(pos, torch.Tensor)
    write_ids = None
    if on_device and q_len == 1:
        position_ids = pos.long()[:, None]  # (B, 1)
    elif on_device:
        steps = torch.arange(q_len, device=x.device)
        # (B, Tq); rows past the RoPE table, and the write start, clamped
        position_ids = (pos.long()[:, None] + steps).clamp(max=freqs_cis.shape[0] - 1)
        write_ids = pos.long().clamp(max=kv.k.shape[3] - q_len)[:, None] + steps
    else:
        position_ids = torch.arange(pos, pos + q_len, device=x.device)
    q = apply_rotary_emb(q, freqs_cis, position_ids, config.rope_dim)
    k = apply_rotary_emb(k, freqs_cis, position_ids, config.rope_dim)

    # In-place cache write at [layer, :, :, pos:pos+T] (the JAX package
    # returns an updated copy through dynamic_update_slice instead); by
    # index on the device for a device position.
    int8 = kv.ks is not None
    if int8:
        g = kv.k.shape[2] // kv.ks.shape[2]
        kc, ksc = quantize_kv(k, g)
        vc, vsc = quantize_kv(v, g)
        writes = ((kv.k, kc), (kv.v, vc), (kv.ks, ksc), (kv.vs, vsc))
    else:
        writes = ((kv.k, k), (kv.v, v))
    if on_device:
        rows = torch.arange(bsz, device=x.device)
        cols = position_ids if write_ids is None else write_ids
        for cache, val in writes:
            write_rows(cache, layer, rows, cols, val)
    else:
        for cache, val in writes:
            cache[layer, :, :, pos:pos + q_len] = val

    if (q_len <= DECODE_SPAN_MAX and mha) or (q_len == 1 and not int8):
        out = decode_attention_cached(
            q, kv.k, kv.v, layer, pos, prefix_len, kv_bound, kv.ks, kv.vs,
            lockstep=on_device,
        )
    else:
        tk = kv.k.shape[3] if kv_bound is None else kv_bound
        k_l = kv.k[layer, :, :, :tk]
        v_l = kv.v[layer, :, :, :tk]
        if int8:
            # moondream_tpu/models/text.py:390-406: dequantize the span
            k_l = dequantize_kv(k_l, kv.ks[layer, :, :, :tk], q.dtype)
            v_l = dequantize_kv(v_l, kv.vs[layer, :, :, :tk], q.dtype)
        if q_len == 1:
            # GQA over an int8 cache (moondream_tpu/ops/attention.py:1083)
            out = decode_attention(q, k_l, v_l, pos, prefix_len)
        else:
            if not mha:  # heads repeated, as moondream_tpu/ops/attention.py:1085-1089
                rep = config.n_heads // config.n_kv_heads
                k_l = k_l.repeat_interleave(rep, dim=1)
                v_l = v_l.repeat_interleave(rep, dim=1)
            out = flash_attention(q, k_l, v_l, pos, prefix_len)
    out = block.proj(out.transpose(1, 2).reshape(bsz, q_len, config.dim))
    # the proj adapter reads the block input x, not the attention output
    return lora_add(out, x, lora.get("proj"))


def text_decoder(
    x: torch.Tensor,
    model: TextModel,
    kv: KVCache,
    pos: Union[int, torch.Tensor],
    prefix_len: int,
    kv_bound: Optional[int] = None,
    lora: Optional[dict] = None,
    steer: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run every block over x (B, T, D) at positions pos.., writing the cache
    in place; returns the final hidden states (B, T, D). `pos`: a host int,
    or a (B,) int32 device tensor holding one position for every row
    (attn_with_cache). `lora`: a stacked adapter tree
    (`lora.variant_state_dict`), layer l's factors applied in block l.
    `steer`: an (n_layers, dim) steering vector, cast to x's dtype once
    (JAX casts each row: the same values) and its row l added to block l's
    output as a separate add, so that the sum rounds as JAX's does; None
    runs no add."""
    config = model.config
    adapters = layer_adapters(lora, len(model.blocks))
    if steer is not None:
        steer = steer.to(x.dtype)
    for layer, block in enumerate(model.blocks):
        ln_in = block.ln(x)
        attn_out = attn_with_cache(
            ln_in, block, model.freqs_cis, kv, layer, pos, prefix_len, config,
            kv_bound, adapters[layer],
        )
        x = x + attn_out + block.mlp(ln_in, adapters[layer])
        if steer is not None:
            x = x + steer[layer]
    return x


# ------------------------------------------------------------- training


def prefix_attn_mask(q_len: int, prefix: int, device=None) -> torch.Tensor:
    """Training mask: bidirectional over the first `prefix` positions, causal
    after (moondream_tpu/models/text.py:516-523). (1, 1, q_len, q_len)
    bool, True = attend."""
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(q_len, device=device)[None, :]
    causal = cols <= rows
    prefix_block = (rows < prefix) & (cols < prefix)
    return (causal | prefix_block)[None, None]


def _require_dense(model: TextModel, op: str) -> None:
    """The cache-free training and capture paths read the dense block
    weights, which quantize_text_params / quantize_text_params_int8 replace
    with quantized runtime formats (moondream_tpu/models/text.py:526-536)."""
    if not all(type(blk.qkv) is Linear for blk in model.blocks):
        raise ValueError(
            f"{op} is not supported with quantized runtime text params: the "
            "dense block weights were replaced by packed int4 / int8 codes. "
            "Load the checkpoint with runtime_int4=False / runtime_int8=False "
            "for finetuning / hidden-state capture."
        )


def attn_uncached(
    x: torch.Tensor, block: TextBlock, freqs_cis: torch.Tensor,
    attn_mask: torch.Tensor, config: TextConfig, lora: Optional[dict] = None,
    seq=None,
) -> torch.Tensor:
    """Cache-free attention of the training path at positions 0..T-1
    (moondream_tpu/models/text.py:420-450), through the plain `sdpa`; under
    GQA each KV head is repeated for its query heads. Differentiable.
    `lora`: this layer's qkv and proj adapter pairs, or None. `seq`: x holds
    one sequence-parallel rank's block of positions (`parallel.mesh.
    BatchShard`): RoPE at the block's global positions, and K and V
    gathered over the sequence group (`parallel.grad.gather_seq`) before
    the GQA repeat; `attn_mask` is then the block's rows of the whole
    sequence's mask."""
    bsz, q_len, _ = x.shape
    lora = lora or {}
    q, k, v = _split_qkv(lora_linear(x, block.qkv, lora.get("qkv")), config)
    start = 0 if seq is None else seq.seq_offset
    position_ids = torch.arange(start, start + q_len, device=x.device)
    q = apply_rotary_emb(q, freqs_cis, position_ids, config.rope_dim)
    k = apply_rotary_emb(k, freqs_cis, position_ids, config.rope_dim)
    if seq is not None:
        from ..parallel.grad import gather_seq

        k, v = gather_seq(k, seq.seq_group, 2), gather_seq(v, seq.seq_group, 2)
    if config.n_kv_heads != config.n_heads:
        rep = config.n_heads // config.n_kv_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    out = sdpa(q, k, v, attn_mask)
    out = block.proj(out.transpose(1, 2).reshape(bsz, q_len, config.dim))
    return lora_add(out, x, lora.get("proj"))


def _tp_group(model: TextModel):
    """The tp group of a rank's `parallel.mesh.shard_text_model`, else None."""
    return getattr(getattr(model, "shard", None), "tp_group", None)


def _uncached_blocks(inputs_embeds: torch.Tensor, model: TextModel,
                     lora: Optional[dict] = None, seq=None):
    """The residual stream after each block of the cache-free forward. On a
    tensor-parallel shard the LayerNorm output that qkv and fc1 read passes
    `parallel.grad.copy_to` (its gradient summed over tp)."""
    config = model.config
    t = inputs_embeds.shape[1]
    if seq is None:
        mask = prefix_attn_mask(t, config.prefix_attn, inputs_embeds.device)
    else:
        mask = prefix_attn_mask(seq.seq_len, config.prefix_attn, inputs_embeds.device)
        mask = mask[:, :, seq.seq_offset:seq.seq_offset + t]
    adapters = layer_adapters(lora, len(model.blocks))
    tp = _tp_group(model)
    if tp is not None:
        from ..parallel.grad import copy_to
    h = inputs_embeds
    for block, ad in zip(model.blocks, adapters):
        ln_in = block.ln(h)
        if tp is not None:
            ln_in = copy_to(ln_in, tp)
        h = (h + attn_uncached(ln_in, block, model.freqs_cis, mask, config, ad, seq)
             + block.mlp(ln_in, ad))
        yield h


def produce_hidden(inputs_embeds: torch.Tensor, model: TextModel,
                   lora: Optional[dict] = None, seq=None) -> torch.Tensor:
    """Full-sequence cache-free forward for training, (B, T, D) -> (B, T, D)
    (moondream_tpu/models/text.py:539-564): every block under
    prefix_attn_mask(T, config.prefix_attn), with an optional stacked
    adapter tree at qkv, proj, fc1 and fc2. Differentiable by autograd;
    raises ValueError for int4 or int8 text blocks. `seq`: inputs_embeds is
    one sequence-parallel rank's block of positions (`attn_uncached`). A
    pipeline stage's model (`parallel.pipeline.shard_params_pp`) runs its
    own slab of blocks."""
    _require_dense(model, "produce_hidden")
    h = inputs_embeds
    for h in _uncached_blocks(inputs_embeds, model, lora, seq):
        pass
    return h


def produce_hidden_layers(inputs_embeds: torch.Tensor, model: TextModel) -> torch.Tensor:
    """The cache-free forward's residual stream after EVERY block, (n_layers,
    B, T, D) (moondream_tpu/models/text.py:567-592): hidden-state capture in
    one full-sequence pass."""
    _require_dense(model, "produce_hidden_layers")
    return torch.stack(list(_uncached_blocks(inputs_embeds, model)))


def lm_head_full(hidden: torch.Tensor, model: TextModel) -> torch.Tensor:
    """Full-sequence logits for training, in the weights' dtype
    (moondream_tpu/models/text.py:601-603). On a tensor-parallel shard the
    head's input passes `parallel.grad.copy_to` and the ranks' vocabulary
    slices are gathered by `parallel.grad.gather_cols`, so every rank holds
    the whole row."""
    tp = _tp_group(model)
    if tp is None:
        return model.lm_head(model.post_ln(hidden))
    from ..parallel.grad import copy_to, gather_cols

    return gather_cols(model.lm_head(copy_to(model.post_ln(hidden), tp)), tp)
