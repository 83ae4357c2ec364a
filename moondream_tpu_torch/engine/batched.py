"""Batched logits and sampling, one row per serving slot or per image, and
the lockstep batched engine (moondream_tpu/engine/batched.py:32-180).

Sampling stays on the device (`sampling.sample_tokens_batched`): greedy
rows take an argmax, sampled rows the nucleus draw of
`sampling.sample_token`, with per-row uniforms from an explicit
`torch.Generator`. Nothing is read back to the host, so a serving chunk
can run many steps without a sync.

Lockstep batching runs B symmetric requests (the same prompt over B
images) at one shared position with per-row EOS: `prefill_batched`,
`decode_step_batched`, `generate_text_batched` and the structured
`generate_points_batched`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.region import RegionModel
from ..models.text import KVCache, TextModel, text_decoder
from .generate import (
    DONE_CHECK_EVERY,
    PointsResult,
    _lm_logits,
    _record,
    answer_loop,
    points_loop,
)
from .sampling import sample_tokens_batched  # noqa: F401 (the pool's and lockstep's sampler)


def lm_logits_batched(h: torch.Tensor, model: TextModel) -> torch.Tensor:
    """(S, D) hidden -> (S, V) fp32 logits: fp32 accumulation, rounded
    through bf16 (see generate._lm_logits)."""
    return _lm_logits(h, model)


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
    graphed: bool = True,
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
    `pos` counts them. The steps are generate.answer_step's: on the card
    each full run of them replays a CUDA graph; `graphed=False` runs them
    eagerly."""
    limit = min(max_tokens, model.config.max_context - pos)
    if kv_bound is not None:
        limit = min(limit, kv_bound - pos)
    limit = max(limit, 0)
    bsz, dev = first_tokens.shape[0], first_tokens.device
    st, run = answer_loop(model, kv, first_tokens, pos, generator, temperature, top_p,
                          eos_id, suppress_ids, kv_bound, graphed, "generate_text_batched")
    toks = torch.zeros((bsz, limit), dtype=torch.long, device=dev)
    steps = reads = 0
    while steps < limit:
        reads += 1
        if bool(st.done.all()):
            break
        n = min(DONE_CHECK_EVERY, limit - steps)
        run(n)
        toks[:, steps:steps + n] = st.run[:, :n]
        steps += n
    _record("generate_text_batched", steps, reads)
    return BatchedGenerateResult(tokens=toks[:, :steps], counts=st.count.clone(),
                                 pos=pos + steps)


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
    graphed: bool = True,
) -> PointsResult:
    """Lockstep structured decode (moondream_tpu/engine/batched.py:190-288):
    the same object over B images from their prompts' last hidden states
    (B, D) and greedy tokens (B,), per-row object counts and EOS; rows that
    are done freeze until every row is (generate.points_loop, graphed on
    the card unless `graphed` is False). Returns boxes (B, max_objects, 4)
    float64 and counts."""
    return points_loop(model, region, kv, first_hidden, first_tokens, pos, eos_id,
                       include_size, max_objects, kv_bound, "generate_points_batched", graphed)
