"""Prefill, decode step and the answer loop (moondream_tpu/engine/generate.py).

Mask model: row i (position pos+i) may attend column j iff j <= pos+i or
(pos+i < prefix_len and j < prefix_len); prefix_len is 730 after an image
and 0 for decode steps, which are causal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.text import KVCache, TextModel, text_decoder, text_encoder
from ..ops.layers import layer_norm
from .sampling import sample_token

NEG_INF = -1e30


def _lm_logits(h: torch.Tensor, model: TextModel) -> torch.Tensor:
    """Final LayerNorm + vocab projection of hidden vectors (..., D) with
    fp32 accumulation, rounded through bf16 (as the JAX package does for
    greedy parity) and returned as fp32."""
    hn = layer_norm(h, model.post_ln.weight, model.post_ln.bias)
    lead = hn.shape[:-1]
    logits = torch.addmm(
        model.lm_head.b, hn.reshape(-1, hn.shape[-1]), model.lm_head.w
    )
    return logits.reshape(*lead, -1).to(torch.bfloat16).float()


def prefill(
    model: TextModel,
    kv: KVCache,
    embeds: torch.Tensor,
    pos: int,
    length: int,
    prefix_len: int,
    kv_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill a right-padded span embeds (1, T_pad, D) at pos, of which the
    first `length` rows are real. Padding rows write K/V past pos+length;
    those slots are overwritten before they are ever attended. Returns
    (logits (V,) and hidden (D,) of the last real row)."""
    hidden = text_decoder(embeds, model, kv, pos, prefix_len, kv_bound)
    h_last = hidden[0, length - 1]
    return _lm_logits(h_last, model), h_last


def decode_step(
    model: TextModel,
    kv: KVCache,
    emb: torch.Tensor,
    pos: int,
    kv_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step for emb (1, 1, D) at pos. Returns (logits, hidden)."""
    hidden = text_decoder(emb, model, kv, pos, 0, kv_bound)
    h = hidden[0, 0]
    return _lm_logits(h, model), h


def suppress(logits: torch.Tensor, ids: Tuple[int, ...]) -> torch.Tensor:
    if ids:
        logits[list(ids)] = NEG_INF
    return logits


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (count,) int64 on the device
    count: int  # tokens emitted, one decode step each
    pos: int


def generate_text(
    model: TextModel,
    kv: KVCache,
    first_token: torch.Tensor,
    pos: int,
    generator: torch.Generator,
    temperature: float,
    top_p: float,
    max_tokens: int,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    kv_bound: Optional[int] = None,
) -> GenerateResult:
    """Answer generation from first_token (a 0-d device tensor) at pos, as
    the JAX package's loop runs it: while the token is not EOS and the limit
    is not reached, emit it, run one decode step and sample the next.

    The limit is max_tokens, the context end or kv_bound; EOS is not
    emitted. `suppress_ids` are masked from every step's logits. Tokens stay
    in a device buffer; the EOS check reads one id to the host per step."""
    limit = min(max_tokens, model.config.max_context - pos)
    if kv_bound is not None:
        limit = min(limit, kv_bound - pos)
    limit = max(limit, 0)
    toks = torch.empty(limit, dtype=torch.long, device=first_token.device)
    tok, count = first_token, 0
    while count < limit and int(tok) != eos_id:
        toks[count] = tok
        emb = text_encoder(tok.view(1, 1), model)
        logits, _ = decode_step(model, kv, emb, pos + count, kv_bound)
        suppress(logits, suppress_ids)
        tok = sample_token(logits, generator, temperature, top_p)
        count += 1
    return GenerateResult(tokens=toks[:count], count=count, pos=pos + count)
