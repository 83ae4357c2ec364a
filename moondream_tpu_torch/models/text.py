"""Phi-style text decoder (moondream_tpu/models/text.py).

Each block is a parallel attention + MLP residual on one LayerNorm,
``x = x + attn(ln(x)) + mlp(ln(x))``, with fused-QKV attention, partial
RoPE, and attention bidirectional over the first `prefix_len` positions
(730 after an image) and causal after.

The KV cache is the plain (L, B, H_kv, T, D) layout only; the JAX package's
head-paired layout exists for TPU lanes and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import TextConfig
from ..ops.attention import decode_attention_cached, flash_attention
from ..ops.layers import MLP, LayerNorm, Linear
from ..ops.rope import apply_rotary_emb, precompute_freqs_cis

# Spans up to this many query rows go to the stacked-cache decode kernel.
DECODE_SPAN_MAX = 16


@dataclass
class KVCache:
    """Stacked caches, each (L, B, H_kv, T, D). Updated in place."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(
        cls, config: TextConfig, batch: int = 1, dtype=torch.bfloat16,
        device=None, slots: Optional[int] = None,
    ) -> "KVCache":
        shape = (
            config.n_layers, batch, config.n_kv_heads,
            slots if slots is not None else config.max_context, config.head_dim,
        )
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


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


def attn_with_cache(
    x: torch.Tensor,
    block: TextBlock,
    freqs_cis: torch.Tensor,
    kv: KVCache,
    layer: int,
    pos: int,
    prefix_len: int,
    config: TextConfig,
    kv_bound: Optional[int] = None,
) -> torch.Tensor:
    """One attention layer reading and updating the stacked cache.

    x: (B, T, D) pre-normed input at positions pos..pos+T-1. Spans of up to
    16 rows (decode tokens, short prompt prefills) go to the stacked-cache
    decode attention; longer spans read cache[layer][:, :, :kv_bound] and go
    to flash attention (moondream_tpu/models/text.py:377-406)."""
    bsz, q_len, _ = x.shape
    q, k, v = _split_qkv(block.qkv(x), config)
    position_ids = torch.arange(pos, pos + q_len, device=x.device)
    q = apply_rotary_emb(q, freqs_cis, position_ids, config.rope_dim)
    k = apply_rotary_emb(k, freqs_cis, position_ids, config.rope_dim)

    # In-place cache write at [layer, :, :, pos:pos+T] (the JAX package
    # returns an updated copy through dynamic_update_slice instead).
    kv.k[layer, :, :, pos : pos + q_len] = k
    kv.v[layer, :, :, pos : pos + q_len] = v

    mha = config.n_kv_heads == config.n_heads
    if q_len <= DECODE_SPAN_MAX and mha:
        out = decode_attention_cached(q, kv.k, kv.v, layer, pos, prefix_len, kv_bound)
    else:
        tk = kv.k.shape[3] if kv_bound is None else kv_bound
        k_l = kv.k[layer, :, :, :tk]
        v_l = kv.v[layer, :, :, :tk]
        if not mha:
            rep = config.n_heads // config.n_kv_heads
            k_l = k_l.repeat_interleave(rep, dim=1)
            v_l = v_l.repeat_interleave(rep, dim=1)
        out = flash_attention(q, k_l, v_l, pos, prefix_len)
    return block.proj(out.transpose(1, 2).reshape(bsz, q_len, config.dim))


def text_decoder(
    x: torch.Tensor,
    model: TextModel,
    kv: KVCache,
    pos: int,
    prefix_len: int,
    kv_bound: Optional[int] = None,
) -> torch.Tensor:
    """Run every block over x (B, T, D) at positions pos.., writing the cache
    in place; returns the final hidden states (B, T, D)."""
    config = model.config
    for layer, block in enumerate(model.blocks):
        ln_in = block.ln(x)
        attn_out = attn_with_cache(
            ln_in, block, model.freqs_cis, kv, layer, pos, prefix_len, config,
            kv_bound,
        )
        x = x + attn_out + block.mlp(ln_in)
    return x
