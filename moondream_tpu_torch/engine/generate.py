"""Prefill, decode step and the decode loops (moondream_tpu/engine/generate.py):
the answer loop, its speculative forms (greedy and sampled, fused or
streamed span by span), the reasoning loop with inline
grounding, and the structured coordinate (detect / point) loop.

Mask model: row i (position pos+i) may attend column j iff j <= pos+i or
(pos+i < prefix_len and j < prefix_len); prefix_len is 730 after an image
and 0 for decode steps, which are causal.

The JAX package runs each loop as one device-resident `lax.while_loop`.
Here the loop state (token buffers, counts, a `done` flag) stays on the
device and the host reads it once per run of DONE_CHECK_EVERY decode steps,
in one transfer that also carries the run's results; it stops at the first
read that finds the loop done, or at a limit the host knows. Steps run past
the stop emit nothing and write K/V only at positions before that limit.
The answer loop's state also holds its position on the device
(`AnswerState`), so on the card each full run of its steps is one CUDA
graph replay (engine/graphs.py); the other loops issue their steps from
Python.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import region as region_ops
from ..models.region import RegionModel
from ..models.text import KVCache, TextModel, text_decoder, text_encoder
from ..ops.layers import layer_norm
from . import graphs
from .drafting import ngram_draft
from .graphs import tensor_key
from .sampling import sample_token, sample_tokens_batched, target_probs

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


# The decode loops read the device once per run of this many steps (one
# sync each), not once per step.
DONE_CHECK_EVERY = 8

# Per decode loop: calls, decode steps run and device-to-host reads since
# the last reset_loop_counts(). Each call reads at most
# ceil(steps / DONE_CHECK_EVERY) + 1 times.
LOOP_COUNTS: Dict[str, Dict[str, int]] = {}


def reset_loop_counts() -> None:
    LOOP_COUNTS.clear()


def _record(loop: str, steps: int, reads: int) -> None:
    c = LOOP_COUNTS.setdefault(loop, {"calls": 0, "steps": 0, "reads": 0})
    c["calls"] += 1
    c["steps"] += steps
    c["reads"] += reads


def _limit(model: TextModel, pos: int, max_tokens: int, kv_bound: Optional[int]) -> int:
    """Decode steps an answer or reasoning loop may run from pos: max_tokens,
    the context end or kv_bound, whichever comes first."""
    limit = min(max_tokens, model.config.max_context - pos)
    if kv_bound is not None:
        limit = min(limit, kv_bound - pos)
    return max(limit, 0)


class GenerateResult(NamedTuple):
    tokens: List[int]  # the emitted ids, read to the host
    count: int  # tokens emitted, one decode step each
    pos: int


class AnswerState(NamedTuple):
    """The device state of an answer loop (batch 1, or the lockstep batch)
    between steps: B rows at one shared position. Every tensor keeps its
    address for the loop's life, so a CUDA graph can capture a run of
    `answer_step`s over it (engine/graphs.py)."""

    tok: torch.Tensor  # (B,) int64: each row's next input token
    done: torch.Tensor  # (B,) bool: the row sampled EOS
    count: torch.Tensor  # (B,) int64: tokens emitted
    pos: torch.Tensor  # (B,) int32: the next step's position, one value
    run: torch.Tensor  # (B, DONE_CHECK_EVERY) int64: this run's tokens, 0 once done
    suppress: torch.Tensor  # (n,) int64: ids masked from every step's logits
    temperature: Optional[torch.Tensor]  # (B,) fp32 of a sampled loop; None: greedy
    top_p: Optional[torch.Tensor]

    @classmethod
    def create(cls, bsz: int, dev, suppress_ids: Tuple[int, ...], sampled: bool
               ) -> "AnswerState":
        z = lambda dtype: torch.zeros((bsz,), dtype=dtype, device=dev)
        return cls(tok=z(torch.long), done=z(torch.bool), count=z(torch.long),
                   pos=z(torch.int32),
                   run=torch.zeros((bsz, DONE_CHECK_EVERY), dtype=torch.long, device=dev),
                   suppress=torch.tensor(suppress_ids, dtype=torch.long, device=dev),
                   temperature=z(torch.float32) if sampled else None,
                   top_p=z(torch.float32) if sampled else None)

    def reset(self, first: torch.Tensor, pos: int, eos_id: int, temperature: float,
              top_p: float) -> None:
        """Start a loop from first tokens (B,) at `pos`, in place."""
        self.tok.copy_(first.reshape(-1))
        torch.eq(self.tok, eos_id, out=self.done)
        self.count.zero_()
        self.pos.fill_(pos)
        if self.temperature is not None:
            self.temperature.fill_(temperature)
            self.top_p.fill_(top_p)


def answer_step(model: TextModel, kv: KVCache, st: AnswerState, j: int, eos_id: int,
                kv_bound: Optional[int], generator: Optional[torch.Generator]) -> None:
    """One step of the answer loops (moondream_tpu/engine/generate.py:
    139-170 at B 1, batched.py:140-180), in place on `st`: each live row
    emits its token into run column j, one decode step runs at the shared
    position on the device, the next token is sampled (the argmax for a
    greedy state) and EOS marks the row done. It reads nothing on the host
    and every tensor it writes keeps its address, so a run of steps is
    what a CUDA graph captures."""
    st.run[:, j] = st.tok.masked_fill(st.done, 0)
    st.count.add_((~st.done).long())
    emb = text_encoder(st.tok[:, None], model)
    hidden = text_decoder(emb, model, kv, st.pos, 0, kv_bound)[:, 0]
    logits = _lm_logits(hidden, model).index_fill_(-1, st.suppress, NEG_INF)
    if st.temperature is None:
        nxt = torch.argmax(logits, dim=-1)
    else:
        nxt = sample_tokens_batched(logits, generator, st.temperature, st.top_p)
    st.tok.copy_(nxt)
    st.done.logical_or_(nxt == eos_id)
    st.pos.add_(1)


def answer_loop(model: TextModel, kv: KVCache, first: torch.Tensor, pos: int,
                generator: Optional[torch.Generator], temperature: float, top_p: float,
                eos_id: int, suppress_ids: Tuple[int, ...], kv_bound: Optional[int],
                graphed: bool, label: str):
    """(state, run) of an answer loop over B = len(first) rows from `pos`:
    run(n) advances it n steps of `answer_step`. On the card (unless
    `graphed` is False) a full run of DONE_CHECK_EVERY steps replays a CUDA
    graph keyed by the batch, kv_bound, the cache, eos, the suppressed ids
    and greedy or sampled (engine/graphs.py); a shorter last run, which
    must not step past the limit, runs eagerly."""
    sampled = temperature > 0
    bsz, dev = first.shape[0], first.device
    key = (label, bsz, kv_bound, eos_id, tuple(suppress_ids),
           id(generator) if sampled else None, tensor_key(kv.k, kv.v, kv.ks, kv.vs))
    gen = generator if sampled else None
    st, run = graphs.loop(
        model, key, lambda: AnswerState.create(bsz, dev, tuple(suppress_ids), sampled),
        lambda st, j: answer_step(model, kv, st, j, eos_id, kv_bound, gen),
        DONE_CHECK_EVERY, graphed and graphs.enabled(dev), label, gen)
    st.reset(first, pos, eos_id, temperature, top_p)
    return st, run


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
    graphed: bool = True,
) -> GenerateResult:
    """Answer generation from first_token (a 0-d device tensor) at pos, with
    the JAX package's semantics: while the token is not EOS and the limit
    is not reached, emit it, run one decode step and sample the next.

    The limit is max_tokens, the context end or kv_bound; EOS is not
    emitted. `suppress_ids` are masked from every step's logits. Tokens,
    the count and the done flag stay on the device (`AnswerState`); the
    host reads them once per DONE_CHECK_EVERY steps and once at the limit.
    Steps after EOS emit nothing (with temperature > 0 they still draw from
    `generator`); `pos` counts emitted tokens only, as JAX's does. On the
    card each full run of steps replays a CUDA graph (`answer_loop`);
    `graphed=False` runs the same steps eagerly."""
    limit = _limit(model, pos, max_tokens, kv_bound)
    st, run = answer_loop(model, kv, first_token.reshape(1), pos, generator, temperature,
                          top_p, eos_id, suppress_ids, kv_bound, graphed, "generate_text")
    out: List[int] = []
    steps = reads = 0
    while True:
        # the flag, the count and the last run's tokens in one transfer
        host = torch.cat([st.done.long(), st.count,
                          st.run[0, :steps - len(out)]]).tolist()
        reads += 1
        out += host[2:]
        if host[0] or steps == limit:
            break
        n = min(DONE_CHECK_EVERY, limit - steps)
        run(n)
        steps += n
    _record("generate_text", steps, reads)
    n = host[1]
    return GenerateResult(tokens=out[:n], count=n, pos=pos + n)


def stream_tokens(
    model: TextModel,
    kv: KVCache,
    first_token: torch.Tensor,
    pos: int,
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: float,
    max_tokens: int,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    kv_bound: Optional[int] = None,
) -> Iterator[int]:
    """The answer loop one token at a time, for streaming: yields each
    emitted id as a host int, one eager `answer_step` and one host read per
    token. The steps are generate_text's (the same kernels and split plans),
    so a streamed answer equals the fused one."""
    limit = _limit(model, pos, max_tokens, kv_bound)
    st, run = answer_loop(model, kv, first_token.reshape(1), pos, generator, temperature,
                          top_p, eos_id, suppress_ids, kv_bound, False, "stream")
    for _ in range(limit):
        tok = int(st.tok[0])
        if tok == eos_id:
            return
        yield tok
        run(1)


def _spec_limit(model: TextModel, pos: int, max_tokens: int, spec_k: int,
                kv_bound: Optional[int]) -> int:
    """Tokens a speculative loop may emit from pos: as `_limit`, but every
    verify span of spec_k rows must fit, so it stops spec_k - 1 tokens
    before the context end or kv_bound, as the JAX package does."""
    limit = min(max_tokens, model.config.max_context - spec_k + 1 - pos)
    if kv_bound is not None:
        limit = min(limit, kv_bound - spec_k + 1 - pos)
    return max(limit, 0)


def _verify_logits(model: TextModel, kv: KVCache, q_toks: torch.Tensor, pos: int,
                   kv_bound: Optional[int], suppress_ids: Tuple[int, ...]) -> torch.Tensor:
    """One verify forward: the (k,) span q_toks = [current, draft...] at
    positions pos..pos+k-1, written to the cache in place. Returns the
    span's (k, V) logits with `suppress_ids` masked. Rows past what the
    loop accepts leave K/V at positions the next span overwrites before
    anything attends them."""
    hidden = text_decoder(text_encoder(q_toks[None], model), model, kv, pos, 0, kv_bound)
    logits = _lm_logits(hidden[0], model)
    if suppress_ids:
        logits[:, list(suppress_ids)] = NEG_INF
    return logits


def greedy_accept(draft: torch.Tensor, g: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Tokens a greedy verify emits per row (moondream_tpu/engine/
    generate.py:255-265): 1 plus the longest draft prefix equal to the
    greedy continuations g, cut so that the first EOS in g becomes the
    carried token. draft (..., k-1), g (..., k) -> m (...) int64 in 1..k."""
    ok = (draft.long() == g[..., :-1].long()).long()
    m = 1 + torch.cumprod(ok, dim=-1).sum(dim=-1)
    return _cut_at_eos(m, g == eos_id)


def _cut_at_eos(m: torch.Tensor, is_eos: torch.Tensor) -> torch.Tensor:
    """m cut to (first EOS position) + 1 where an EOS lies before m - 1."""
    eos_pos = is_eos.long().argmax(dim=-1)
    return torch.where(is_eos.any(dim=-1) & (eos_pos + 1 < m), eos_pos + 1, m)


def speculative_sample(p: torch.Tensor, draft: torch.Tensor,
                       generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection test of deterministic drafts against target probabilities
    (moondream_tpu/engine/generate.py:345-370): draft j is accepted with
    probability p[j, draft[j]] while all before it were; at the first
    rejection the token comes from p with the draft's column removed, and
    after k-1 acceptances a bonus token from p[k-1]. The emitted sequence is
    then distributed exactly as the plain sampled loop's. p (..., k, V),
    draft (..., k-1) -> (emitted (..., k): drafts [:n], the drawn token at
    n; m = n + 1 (...) int64). Draws come from `generator`."""
    k, vocab = p.shape[-2], p.shape[-1]
    lead = p.shape[:-2]
    d = draft.long()
    u = torch.rand((*lead, k - 1), generator=generator, device=p.device)
    p_draft = p[..., :k - 1, :].gather(-1, d[..., None])[..., 0]
    n_acc = torch.cumprod((u < p_draft).long(), dim=-1).sum(dim=-1)
    p_res = p.clone()
    p_res[..., :k - 1, :].scatter_(-1, d[..., None], 0.0)
    # JAX draws categorical(log(max(p, 1e-30))): weights max(p, 1e-30)
    cdf = torch.cumsum(p_res.clamp_min(1e-30), dim=-1)
    v = torch.rand((*lead, k, 1), generator=generator, device=p.device) * cdf[..., -1:]
    samp = torch.searchsorted(cdf, v).clamp_(max=vocab - 1)[..., 0]
    tail = samp.gather(-1, n_acc[..., None])
    steps = torch.arange(k, device=p.device)
    emitted = torch.where(steps == n_acc[..., None], tail,
                          torch.cat([d, tail], dim=-1))
    return emitted, n_acc + 1


def sampled_accept(logits: torch.Tensor, draft: torch.Tensor,
                   generator: Optional[torch.Generator], temperature, top_p,
                   eos_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampled loops' acceptance (moondream_tpu/engine/generate.py:
    345-381): the rejection test of `draft` (..., k-1) against the target
    nucleus of the span's logits (..., k, V) (`temperature`/`top_p` floats,
    or tensors that broadcast against (..., 1, 1)), cut so that the first
    EOS among the emitted tokens is carried. Returns (emitted (..., k),
    m (...))."""
    emitted, m = speculative_sample(target_probs(logits, temperature, top_p), draft, generator)
    steps = torch.arange(emitted.shape[-1], device=emitted.device)
    return emitted, _cut_at_eos(m, (emitted == eos_id) & (steps < m[..., None]))


def spec_spans(
    model: TextModel,
    kv: KVCache,
    first_token: torch.Tensor,
    pos: int,
    max_tokens: int,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    spec_k: int = 8,
    kv_bound: Optional[int] = None,
    seed: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_p: float = 0.0,
) -> Iterator[List[int]]:
    """The speculative answer loop, one verify span at a time: while the
    token is not EOS and the limit is not reached, draft spec_k - 1 tokens
    from [seed; emitted] (ngram_draft), verify [token; draft] in one forward
    and advance by the m tokens the acceptance gives: greedy
    (`greedy_accept`) at temperature 0, else the rejection test against the
    target nucleus (`sampled_accept`). Yields each span's m emitted tokens
    (the span's token and its accepted drafts) as host ints. The host reads
    m and the span's tokens in one transfer per span (it needs m for the
    next position), and the first token once before the loop; the reads are
    recorded under LOOP_COUNTS "generate_text_spec" (or
    "generate_text_spec_sampled") when the loop ends. The fused loops and
    the speculative stream both run it."""
    sampled = temperature > 0

    def accept(draft, q_toks, at):
        logits = _verify_logits(model, kv, q_toks, at, kv_bound, suppress_ids)
        if sampled:
            return sampled_accept(logits, draft, generator, temperature, top_p, eos_id)
        g = torch.argmax(logits, dim=-1)
        return g, greedy_accept(draft, g, eos_id)

    limit = _spec_limit(model, pos, max_tokens, spec_k, kv_bound)
    dev = first_token.device
    s0 = 0 if seed is None else seed.shape[0]
    # the draft history [seed; emitted], JAX's width (seed + max_context)
    hist = torch.zeros(s0 + model.config.max_context, dtype=torch.long, device=dev)
    if seed is not None:
        hist[:s0] = seed
    tok = first_token.reshape(()).long()
    t = int(tok)
    reads, iters, i = 1, 0, 0
    while t != eos_id and i < limit:
        hist[s0 + i] = tok
        draft, _ = ngram_draft(hist, s0 + i + 1, tok, spec_k)
        emitted, m = accept(draft, torch.cat([tok.view(1), draft]), pos + i)
        m = m.clamp(max=limit - i)
        host = torch.cat([m.view(1), emitted]).tolist()
        reads += 1
        iters += 1
        n = host[0]
        if n > 1:
            hist[s0 + i + 1:s0 + i + n] = emitted[:n - 1]
        yield [t] + host[1:n]
        tok, t = emitted[n - 1], host[n]
        i += n
    _record("generate_text_spec_sampled" if sampled else "generate_text_spec", iters, reads)


def _collect(spans: Iterator[List[int]], pos: int) -> GenerateResult:
    out = [t for span in spans for t in span]
    return GenerateResult(tokens=out, count=len(out), pos=pos + len(out))


def generate_text_spec(
    model: TextModel,
    kv: KVCache,
    first_token: torch.Tensor,
    pos: int,
    max_tokens: int,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    spec_k: int = 8,
    kv_bound: Optional[int] = None,
    seed: Optional[torch.Tensor] = None,
) -> GenerateResult:
    """Speculative greedy generation (moondream_tpu/engine/generate.py:
    176-293): n-gram drafts verified in one spec_k-row forward per
    iteration, each emitting 1..spec_k tokens; the ids equal
    `generate_text`'s at temperature 0 (a draft is accepted only where it
    equals the greedy continuation; span and step accumulate in another
    order, so a near tie could flip, as in the JAX package). The first
    in-span EOS is carried and never emitted. `kv_bound` must cover pos +
    max_tokens + spec_k; the loop stops spec_k - 1 tokens before the
    context end or kv_bound. `seed`: a (S0,) prompt tail, left-padded with
    -1, ahead of the draft history (prompt lookup; it changes drafts only).
    Reads the device once per iteration plus once (`spec_spans`)."""
    return _collect(spec_spans(model, kv, first_token, pos, max_tokens, eos_id, suppress_ids,
                               spec_k, kv_bound, seed), pos)


def generate_text_spec_sampled(
    model: TextModel,
    kv: KVCache,
    first_token: torch.Tensor,
    pos: int,
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: float,
    max_tokens: int,
    eos_id: int,
    suppress_ids: Tuple[int, ...],
    spec_k: int = 8,
    kv_bound: Optional[int] = None,
    seed: Optional[torch.Tensor] = None,
) -> GenerateResult:
    """Speculative sampling at temperature > 0 (moondream_tpu/engine/
    generate.py:296-417): the drafts of generate_text_spec accepted by the
    rejection test against the target nucleus (`speculative_sample`), so
    the emitted sequence is distributed as the plain sampled loop's,
    though not draw for draw. The first EOS among an iteration's emitted
    tokens is carried. Same limits, seed and reads as generate_text_spec."""
    return _collect(spec_spans(model, kv, first_token, pos, max_tokens, eos_id, suppress_ids,
                               spec_k, kv_bound, seed, generator, temperature, top_p), pos)


class ReasoningResult(NamedTuple):
    tokens: List[int]
    is_coord: List[bool]  # token i was a grounding coordinate
    coord_vals: List[float]  # its decoded coordinate (0.0 where not)
    count: int
    pos: int


def generate_reasoning(
    model: TextModel,
    region: RegionModel,
    kv: KVCache,
    first_token: torch.Tensor,
    first_hidden: torch.Tensor,
    pos: int,
    generator: torch.Generator,
    temperature: float,
    top_p: float,
    max_tokens: int,
    answer_id: int,
    coord_id: int,
    suppress_ids: Tuple[int, ...],
    kv_bound: Optional[int] = None,
) -> ReasoningResult:
    """The reasoning loop with inline grounding
    (moondream_tpu/engine/generate.py:516-591): as generate_text, with
    `answer_id` ending the phase, except that a `coord_id` token feeds
    enc(argmax(decode_coordinate(previous hidden)) / 1024) to the next
    step in place of its token embedding. Both embeddings are computed
    every step and one is selected on the device (JAX's `lax.cond`).
    Records per token whether it was a coordinate and its value."""
    limit = _limit(model, pos, max_tokens, kv_bound)
    dev = first_token.device
    toks = torch.zeros(limit, dtype=torch.long, device=dev)
    is_coord = torch.zeros(limit, dtype=torch.bool, device=dev)
    coord_vals = torch.zeros(limit, dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.long, device=dev)
    tok, hid = first_token.reshape(()).long(), first_hidden
    done = tok == answer_id
    emb_dtype = model.wte.dtype
    out: List[List[float]] = [[], [], []]
    steps = reads = 0
    while True:
        run = slice(len(out[0]), steps)
        host = torch.cat([
            torch.stack([done.double(), count.double()]),
            toks[run].double(), is_coord[run].double(), coord_vals[run].double(),
        ]).tolist()
        reads += 1
        k = steps - run.start
        for j in range(3):
            out[j] += host[2 + j * k:2 + (j + 1) * k]
        if host[0] or steps == limit:
            break
        for _ in range(min(DONE_CHECK_EVERY, limit - steps)):
            toks[steps] = tok
            coord = tok == coord_id
            val = region_ops.coordinate_value(region_ops.decode_coordinate(hid, region))
            c_emb = region_ops.encode_coordinate(val.view(1).to(emb_dtype), region)
            emb = torch.where(coord, c_emb, model.wte[tok].to(emb_dtype))
            coord_vals[steps] = torch.where(coord, val, 0.0)
            is_coord[steps] = coord
            count += (~done).long()
            logits, hid = decode_step(model, kv, emb.view(1, 1, -1), pos + steps, kv_bound)
            suppress(logits, suppress_ids)
            tok = sample_token(logits, generator, temperature, top_p)
            done = done | (tok == answer_id)
            steps += 1
    _record("generate_reasoning", steps, reads)
    n = int(host[1])
    return ReasoningResult(
        tokens=[int(t) for t in out[0][:n]], is_coord=[bool(c) for c in out[1][:n]],
        coord_vals=out[2][:n], count=n, pos=pos + n,
    )


def objects_that_fit(pos: int, pos_limit: int, steps_per_object: int, max_objects: int) -> int:
    """How many objects the structured loop may start from pos: object k
    starts at pos + k * steps_per_object, and starts only while that is
    below pos_limit - 4 (JAX's loop condition) and k < max_objects."""
    room = pos_limit - 4 - pos
    return 0 if room <= 0 else min(max_objects, -(-room // steps_per_object))


class PointsResult(NamedTuple):
    boxes: np.ndarray  # (B, max_objects, 4) float64; [x, y, 0, 0] rows for points
    counts: List[int]  # objects found per row


def points_loop(
    model: TextModel,
    region: RegionModel,
    kv: KVCache,
    first_hidden: torch.Tensor,
    first_tokens: torch.Tensor,
    pos: int,
    eos_id: int,
    include_size: bool,
    max_objects: int,
    kv_bound: Optional[int],
    loop: str,
) -> PointsResult:
    """The structured coordinate loop over B rows at a shared position
    (moondream_tpu/engine/generate.py:601-671 at B 1, and
    moondream_tpu/engine/batched.py:190-288): per object, x from the
    hidden state, one step on enc(x) gives y; with sizes, one more step
    gives (w, h) log-bins; a last step on the object's last embedding gives
    the next token, EOS or not. All greedy. A row is done at EOS (its first
    token included) or at max_objects, and then freezes: no box, no count.

    Every object takes exactly steps_per_object (3 with sizes, else 2)
    decode steps, so the host knows how many objects fit before
    pos_limit - 4 and runs the steps flat, reading the done flag, counts
    and boxes once per DONE_CHECK_EVERY steps; only the last step of an
    object projects to the vocabulary."""
    spo = 3 if include_size else 2
    pos_limit = model.config.max_context if kv_bound is None else kv_bound
    total = objects_that_fit(pos, pos_limit, spo, max_objects) * spo
    assert pos + total <= pos_limit - 2, (pos, total, pos_limit)
    bsz, dev = first_tokens.shape[0], first_tokens.device
    emb_dtype = model.wte.dtype
    boxes = torch.zeros((bsz, max_objects, 4), dtype=torch.float32, device=dev)
    slot = torch.arange(max_objects, device=dev)
    n = torch.zeros(bsz, dtype=torch.long, device=dev)
    done = first_tokens.reshape(bsz) == eos_id
    hid = first_hidden.reshape(bsz, -1)
    steps = reads = 0
    while True:
        host = torch.cat([done.all().view(1).float(), n.float(), boxes.flatten()])
        host = host.double().cpu().numpy()
        reads += 1
        if host[0] or steps == total:
            break
        for _ in range(min(DONE_CHECK_EVERY, total - steps)):
            phase = steps % spo
            if phase == 0:
                x = region_ops.coordinate_value(region_ops.decode_coordinate(hid, region))
                emb = region_ops.encode_coordinate(x[:, None].to(emb_dtype), region)
            elif phase == 1:
                y = region_ops.coordinate_value(region_ops.decode_coordinate(hid, region))
                emb = region_ops.encode_coordinate(y[:, None].to(emb_dtype), region)
                if not include_size:
                    row = torch.stack([x, y, torch.zeros_like(x), torch.zeros_like(x)], -1)
            else:
                bins = torch.argmax(region_ops.decode_size(hid, region), dim=-1)
                wh = region_ops.size_bin_to_value(bins)
                emb = region_ops.encode_size(wh.to(emb_dtype), region)
                w, h = wh[:, 0], wh[:, 1]
                row = torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)
            last = phase == spo - 1
            if last:
                active = ~done
                upd = (slot[None, :] == n[:, None]) & active[:, None]
                boxes = torch.where(upd[..., None], row[:, None, :], boxes)
                n = n + active.long()
            hid = text_decoder(emb[:, None, :], model, kv, pos + steps, 0, kv_bound)[:, 0]
            if last:
                tok = torch.argmax(_lm_logits(hid, model), dim=-1)
                done = done | (tok == eos_id) | (n >= max_objects)
            steps += 1
    _record(loop, steps, reads)
    return PointsResult(boxes=host[1 + bsz:].reshape(bsz, max_objects, 4),
                        counts=[int(c) for c in host[1:1 + bsz]])


def generate_points(
    model: TextModel,
    region: RegionModel,
    kv: KVCache,
    first_hidden: torch.Tensor,
    first_token: torch.Tensor,
    pos: int,
    eos_id: int,
    include_size: bool,
    max_objects: int,
    kv_bound: Optional[int] = None,
) -> np.ndarray:
    """Structured decode of one row from the prompt's last hidden state
    (D,) and its greedy token: the found boxes (count, 4) as float64
    ([x_min, y_min, x_max, y_max], or [x, y, 0, 0] without sizes)."""
    res = points_loop(model, region, kv, first_hidden, first_token.reshape(1), pos,
                      eos_id, include_size, max_objects, kv_bound, "generate_points")
    return res.boxes[0, :res.counts[0]]
