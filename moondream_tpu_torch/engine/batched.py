"""Batched logits and sampling, one row per serving slot or per image, and
the lockstep batched engine (moondream_tpu/engine/batched.py:32-180).

Sampling stays on the device: greedy rows take an argmax, sampled rows the
nucleus draw of `sampling.sample_token`, with per-row uniforms from an
explicit `torch.Generator`. Nothing is read back to the host, so a serving
chunk can run many steps without a sync.

Lockstep batching runs B symmetric requests (the same prompt over B
images) at one shared position with per-row EOS: `prefill_batched`,
`decode_step_batched`, `generate_text_batched` and the structured
`generate_points_batched`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..models.region import RegionModel
from ..models.text import KVCache, TextModel, text_decoder, text_encoder
from .generate import DONE_CHECK_EVERY, NEG_INF, PointsResult, _lm_logits, points_loop
from .sampling import apply_top_p_mask


def lm_logits_batched(h: torch.Tensor, model: TextModel) -> torch.Tensor:
    """(S, D) hidden -> (S, V) fp32 logits: fp32 accumulation, rounded
    through bf16 (see generate._lm_logits)."""
    return _lm_logits(h, model)


def _nucleus(logits, generator, temperature, top_p) -> torch.Tensor:
    """One draw per row of (S, V) logits under per-row or shared settings,
    as sample_token draws one."""
    t = temperature[:, None] if isinstance(temperature, torch.Tensor) else temperature
    p_lim = top_p[:, None] if isinstance(top_p, torch.Tensor) else top_p
    safe_t = t.clamp_min(1e-6) if isinstance(t, torch.Tensor) else max(t, 1e-6)
    probs = torch.softmax(logits / safe_t, dim=-1)
    probs_desc, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    cdf = torch.cumsum(apply_top_p_mask(probs_desc, p_lim), dim=-1)
    u = torch.rand(
        (logits.shape[0], 1), generator=generator, device=logits.device
    ) * cdf[:, -1:]
    idx = torch.searchsorted(cdf, u).clamp_(max=cdf.shape[1] - 1)
    return order.gather(1, idx)[:, 0]


def sample_tokens_batched(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: Union[float, torch.Tensor],
    top_p: Union[float, torch.Tensor],
) -> torch.Tensor:
    """(S,) int64 token ids from (S, V) logits. `temperature`/`top_p` are
    Python floats (one setting for the pool: a greedy pool takes the argmax
    with no vocabulary sort) or (S,) device tensors (per-request settings:
    every row is drawn and greedy rows then take their argmax through a
    per-row where, so they stay exact in a mixed pool)."""
    logits = logits.float()
    if not isinstance(temperature, torch.Tensor):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return _nucleus(logits, generator, temperature, top_p)
    return torch.where(
        temperature <= 0.0,
        torch.argmax(logits, dim=-1),
        _nucleus(logits, generator, temperature, top_p),
    )


def prefill_batched(
    model: TextModel,
    kv: KVCache,
    embeds: torch.Tensor,
    pos: int,
    length: int,
    prefix_len: int,
    kv_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill right-padded spans embeds (B, T_pad, D) at a shared `pos`, of
    which the first `length` rows are real, writing `kv` in place. Returns
    ((B, V) logits, (B, D) hidden) of the last real row."""
    hidden = text_decoder(embeds, model, kv, pos, prefix_len, kv_bound)
    h_last = hidden[:, length - 1]
    return lm_logits_batched(h_last, model), h_last


def decode_step_batched(
    model: TextModel,
    kv: KVCache,
    emb: torch.Tensor,
    pos: int,
    kv_bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lockstep decode step for emb (B, 1, D) at the shared `pos`.
    Returns ((B, V) logits, (B, D) hidden)."""
    hidden = text_decoder(emb, model, kv, pos, 0, kv_bound)
    h = hidden[:, 0]
    return lm_logits_batched(h, model), h


def batched_steps(max_count: int, limit: int) -> int:
    """The decode steps generate_text_batched runs when its longest row
    emits `max_count` tokens (every row ends at EOS, or one reaches
    `limit`): it stops at the first flag read after the last EOS. The same
    holds for generate.generate_text, generate_reasoning and the
    structured loops, counted in their own steps."""
    return min(limit, -(-max_count // DONE_CHECK_EVERY) * DONE_CHECK_EVERY)


class BatchedGenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, steps) int64 on the device, 0 after a row's EOS
    counts: torch.Tensor  # (B,) int64 on the device: valid tokens per row
    pos: int  # the shared position after the last step


def generate_text_batched(
    model: TextModel,
    kv: KVCache,
    first_tokens: torch.Tensor,
    pos: int,
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: float,
    max_tokens: int,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    kv_bound: Optional[int] = None,
) -> BatchedGenerateResult:
    """Lockstep generation from first_tokens (B,) at the shared `pos`, as
    the JAX package's loop runs it: while some row is not done and the
    limit (max_tokens, the context end or kv_bound) is not reached, emit
    each live row's token, run one decode step for all rows and sample the
    next. A row is done once it samples EOS (not emitted); done rows keep
    stepping, their tokens masked to 0 and their K/V written at positions
    only they attend. Tokens and counts stay in device buffers. The host
    reads the all-done flag once every DONE_CHECK_EVERY steps, so the loop
    may run up to DONE_CHECK_EVERY - 1 steps past the last row's EOS: those
    steps emit nothing (their token columns are 0 and no count moves), and
    `pos` counts them."""
    limit = min(max_tokens, model.config.max_context - pos)
    if kv_bound is not None:
        limit = min(limit, kv_bound - pos)
    limit = max(limit, 0)
    bsz, dev = first_tokens.shape[0], first_tokens.device
    toks = torch.zeros((bsz, limit), dtype=torch.long, device=dev)
    counts = torch.zeros((bsz,), dtype=torch.long, device=dev)
    cur = first_tokens.long()
    done = cur == eos_id
    steps = 0
    while steps < limit and (steps % DONE_CHECK_EVERY or not bool(done.all())):
        toks[:, steps] = cur.masked_fill(done, 0)
        counts += (~done).long()
        logits, _ = decode_step_batched(
            model, kv, text_encoder(cur[:, None], model), pos + steps, kv_bound
        )
        if suppress_ids:
            logits[:, list(suppress_ids)] = NEG_INF
        cur = sample_tokens_batched(logits, generator, temperature, top_p)
        done = done | (cur == eos_id)
        steps += 1
    return BatchedGenerateResult(tokens=toks[:, :steps], counts=counts, pos=pos + steps)


def generate_points_batched(
    model: TextModel,
    region: RegionModel,
    kv: KVCache,
    first_hidden: torch.Tensor,
    first_tokens: torch.Tensor,
    pos: int,
    eos_id: int,
    include_size: bool,
    max_objects: int,
    kv_bound: Optional[int] = None,
) -> PointsResult:
    """Lockstep structured decode (moondream_tpu/engine/batched.py:190-288):
    the same object over B images from their prompts' last hidden states
    (B, D) and greedy tokens (B,), per-row object counts and EOS; rows that
    are done freeze until every row is (generate.points_loop). Returns
    boxes (B, max_objects, 4) float64 and counts."""
    return points_loop(model, region, kv, first_hidden, first_tokens, pos, eos_id,
                       include_size, max_objects, kv_bound, "generate_points_batched")
