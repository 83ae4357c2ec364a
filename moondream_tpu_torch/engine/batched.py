"""Batched logits and sampling, one row per serving slot or per image, and
the lockstep batched engine (moondream_tpu/engine/batched.py).

Sampling stays on the device (`sampling.sample_tokens_batched`): greedy
rows take an argmax, sampled rows the nucleus draw of
`sampling.sample_token`, with per-row uniforms from an explicit
`torch.Generator`. Nothing is read back to the host, so a serving chunk
can run many steps without a sync.

Lockstep batching runs B symmetric requests (the same prompt over B
images) at one shared position with per-row EOS: `prefill_batched`,
`decode_step_batched`, `generate_text_batched`, the structured
`generate_points_batched` and the speculative `generate_text_spec_batched`,
whose rows start at one position and desync as their drafts are accepted.
All but the speculative loop take an optional LoRA adapter, `lora`, as
the JAX package's do (moondream_tpu/engine/batched.py:78-223).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.region import RegionModel
from ..models.text import KVCache, TextModel, text_decoder
from . import graphs
from .drafting import ngram_draft_rows
from .generate import (
    DONE_CHECK_EVERY,
    NEG_INF,
    PointsResult,
    _lm_logits,
    _record,
    answer_loop,
    greedy_accept,
    points_loop,
)
from .graphs import tensor_key
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
    lora: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill right-padded spans embeds (B, T_pad, D) at a shared `pos`, of
    which the first `length` rows are real, writing `kv` in place. Returns
    ((B, V) logits, (B, D) hidden) of the last real row."""
    hidden = text_decoder(embeds, model, kv, pos, prefix_len, kv_bound, lora)
    h_last = hidden[:, length - 1]
    return lm_logits_batched(h_last, model), h_last


def decode_step_batched(
    model: TextModel,
    kv: KVCache,
    emb: torch.Tensor,
    pos: int,
    kv_bound: Optional[int] = None,
    lora: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lockstep decode step for emb (B, 1, D) at the shared `pos`.
    Returns ((B, V) logits, (B, D) hidden)."""
    hidden = text_decoder(emb, model, kv, pos, 0, kv_bound, lora)
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
    lora: Optional[dict] = None,
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
                          eos_id, suppress_ids, kv_bound, graphed, "generate_text_batched", lora)
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
    lora: Optional[dict] = None,
) -> PointsResult:
    """Lockstep structured decode (moondream_tpu/engine/batched.py:190-288):
    the same object over B images from their prompts' last hidden states
    (B, D) and greedy tokens (B,), per-row object counts and EOS; rows that
    are done freeze until every row is (generate.points_loop, graphed on
    the card unless `graphed` is False). Returns boxes (B, max_objects, 4)
    float64 and counts."""
    return points_loop(model, region, kv, first_hidden, first_tokens, pos, eos_id,
                       include_size, max_objects, kv_bound, "generate_points_batched", graphed,
                       lora)


class BatchedSpecState(NamedTuple):
    """The device state of the lockstep speculative loop between verify
    spans (the carry of moondream_tpu/engine/batched.py:351-410), at fixed
    addresses so that a CUDA graph can capture a run of
    `spec_batched_step`s. JAX's dropped scatters write the spare last
    column of `hist` and `toks` (engine/serving._put)."""

    cur: torch.Tensor  # (B,) int64: each row's current token
    pos: torch.Tensor  # (B,) int32: each row's next verify span position
    act: torch.Tensor  # (B,) bool: the row is still generating
    bud: torch.Tensor  # (B,) int64: tokens each row may still emit
    hist: torch.Tensor  # (B, H + 1) int64: draft histories, then a spare
    cnt: torch.Tensor  # (B,) int64: valid history entries per row
    toks: torch.Tensor  # (B, W + 1) int64: emitted tokens, then a spare
    counts: torch.Tensor  # (B,) int64: tokens emitted per row
    iters: torch.Tensor  # (1,) int64: verify spans run while a row was active
    suppress: torch.Tensor  # (n,) int64: ids masked from every span's logits

    @classmethod
    def create(cls, bsz: int, width: int, dev, suppress_ids: Tuple[int, ...]
               ) -> "BatchedSpecState":
        z = lambda *shape, dtype=torch.long: torch.zeros(shape, dtype=dtype, device=dev)
        return cls(cur=z(bsz), pos=z(bsz, dtype=torch.int32), act=z(bsz, dtype=torch.bool),
                   bud=z(bsz), hist=z(bsz, width + 1), cnt=z(bsz), toks=z(bsz, width + 1),
                   counts=z(bsz), iters=z(1),
                   suppress=torch.tensor(suppress_ids, dtype=torch.long, device=dev))

    def reset(self, first: torch.Tensor, pos: int, budget: int, eos_id: int,
              hist_init: Optional[torch.Tensor], hist_cnt_init) -> None:
        """Start every row from its first token at the shared `pos` with
        `budget` tokens, its history seeded from `hist_init` (B, S), in
        place."""
        width = self.hist.shape[1] - 1
        self.cur.copy_(first)
        self.pos.fill_(pos)
        self.bud.fill_(budget)
        torch.logical_and(self.cur != eos_id, self.bud > 0, out=self.act)
        self.hist.zero_()
        self.cnt.zero_()
        if hist_init is not None:
            seed = hist_init[:, :width]
            self.hist[:, :seed.shape[1]] = seed
            self.cnt.copy_(torch.as_tensor(hist_cnt_init, device=self.cnt.device)
                           .clamp(max=width).expand_as(self.cnt))
        self.toks.zero_()
        self.counts.zero_()
        self.iters.zero_()


def spec_batched_step(model: TextModel, kv: KVCache, st: BatchedSpecState, spec_k: int,
                      eos_id: int, kv_bound: Optional[int], max_pos: int) -> None:
    """One verify span of the lockstep speculative loop
    (moondream_tpu/engine/batched.py:356-410), in place on `st`: each
    active row emits its token and appends it to its history, drafts
    spec_k - 1 tokens (`ngram_draft_rows`), one ragged forward verifies
    every row's [token; draft] at its own position (kernel C), and the
    greedy acceptance gives m, clamped to the budget. A row stops at EOS,
    an empty budget or when its next span would pass max_pos; a stopped
    row's m is 0, and its span's K/V land at its frozen position, which
    nothing it emitted attends. It reads nothing on the host, so a run of
    spans is what a CUDA graph captures."""
    from .serving import _put, ragged_verify_step

    width = st.hist.shape[1] - 1
    rows = torch.arange(st.cur.shape[0], device=st.cur.device)
    steps = torch.arange(spec_k - 1, device=st.cur.device)
    act = st.act  # updated in place only by the last line
    _put(st.toks, rows, st.counts, st.cur, act)
    _put(st.hist, rows, st.cnt.clamp(max=width - 1), st.cur, act)
    cnt1 = st.cnt + act.long()
    draft, _ = ngram_draft_rows(st.hist[:, :width], cnt1, st.cur, spec_k)
    q_toks = torch.cat([st.cur[:, None], draft], dim=1)
    logits, _ = ragged_verify_step(model, kv, q_toks, st.pos, kv_bound)
    g = torch.argmax(logits.index_fill_(-1, st.suppress, NEG_INF), dim=-1)
    m = torch.where(act, torch.minimum(greedy_accept(draft, g, eos_id), st.bud), 0)
    valid = act[:, None] & (steps + 1 < m[:, None])
    _put(st.toks, rows, st.counts[:, None] + 1 + steps, g[:, :-1], valid)
    _put(st.hist, rows, (cnt1[:, None] + steps).clamp(max=width - 1), g[:, :-1], valid)
    st.cur.copy_(torch.where(act, g[rows, (m - 1).clamp(min=0)], st.cur))
    st.pos.add_(m.to(st.pos.dtype))
    st.bud.sub_(m)
    st.cnt.copy_(cnt1 + (m - 1).clamp(min=0) * act.long())
    st.counts.add_(m)
    st.iters.add_(act.any().long())
    st.act.logical_and_((st.cur != eos_id) & (st.bud > 0) & (st.pos + spec_k <= max_pos))


class BatchedSpecGenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, limit) int64 on the device, 0 past each row's count
    counts: torch.Tensor  # (B,) int64 on the device
    pos: torch.Tensor  # (B,) int32 on the device: rows desync as acceptance varies
    iters: int  # verify spans run while a row was active: the accept rate is
    #     counts.sum() / (iters * rows)


def generate_text_spec_batched(
    model: TextModel,
    kv: KVCache,
    first_tokens: torch.Tensor,
    pos: int,
    max_tokens: int,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    spec_k: int = 8,
    kv_bound: Optional[int] = None,
    hist_init: Optional[torch.Tensor] = None,
    hist_cnt_init=None,
    graphed: bool = True,
) -> BatchedSpecGenerateResult:
    """Speculative lockstep generation, greedy and exact
    (moondream_tpu/engine/batched.py:300-422): every row starts from
    first_tokens (B,) at the shared `pos`; per verify span each active row
    drafts from its own history and advances by the 1..spec_k tokens the
    greedy acceptance gives, so the rows' positions desync. The ids equal
    generate_text_batched's at temperature 0 (span and step accumulate in
    another order, so a near tie could flip, as in the JAX package). A row
    may emit min(max_tokens, max_pos - pos - spec_k) tokens, max_pos being
    kv_bound or the context end. `hist_init` (B, S) and `hist_cnt_init`
    (an int or (B,)): prompt-seeded draft histories (prompt lookup); by
    default they start empty.

    The state stays on the device (`BatchedSpecState`); the host reads
    whether a row is active once per run of DONE_CHECK_EVERY spans, plus
    once before the first (LOOP_COUNTS "generate_text_spec_batched"). On the
    card each full run replays a CUDA graph keyed by the batch, spec_k,
    kv_bound, the cache, eos and the suppressed ids; `graphed=False` runs
    the same spans eagerly. Kernel C takes the spans (MHA only: a GQA model
    raises a ValueError); a span of more than 16 rows goes in launches of
    16 (ops.attention.decode_attention_cached)."""
    cfg = model.config
    if cfg.n_kv_heads != cfg.n_heads:
        raise ValueError(
            f"generate_text_spec_batched needs an MHA text config, got n_kv_heads "
            f"{cfg.n_kv_heads} < n_heads {cfg.n_heads}: its ragged verify spans are MHA only"
        )
    bsz, dev = first_tokens.shape[0], first_tokens.device
    max_pos = kv_bound or cfg.max_context
    limit = max(min(max_tokens, max_pos - pos - spec_k), 0)
    label = "generate_text_spec_batched"
    key = (label, bsz, spec_k, kv_bound, eos_id, tuple(suppress_ids),
           tensor_key(kv.k, kv.v, kv.ks, kv.vs))
    st, run = graphs.loop(
        model, key,
        lambda: BatchedSpecState.create(bsz, cfg.max_context, dev, tuple(suppress_ids)),
        lambda st, j: spec_batched_step(model, kv, st, spec_k, eos_id, kv_bound, max_pos),
        DONE_CHECK_EVERY, graphed and graphs.enabled(dev), label)
    st.reset(first_tokens, pos, limit, eos_id, hist_init, hist_cnt_init)
    # a live row emits at least one token per span: `limit` spans end every row
    spans = reads = 0
    while True:
        host = torch.cat([st.act.any().long().view(1), st.iters]).tolist()
        reads += 1
        if not host[0] or spans >= limit:
            break
        n = min(DONE_CHECK_EVERY, limit - spans)
        run(n)
        spans += n
    _record(label, spans, reads)
    return BatchedSpecGenerateResult(tokens=st.toks[:, :limit].clone(),
                                     counts=st.counts.clone(), pos=st.pos.clone(),
                                     iters=host[1])
