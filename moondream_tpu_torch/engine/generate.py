"""Prefill, decode step and the decode loops (moondream_tpu/engine/generate.py):
the answer loop, its speculative forms (greedy and sampled, fused or
streamed span by span), the reasoning loop with inline
grounding, and the structured coordinate (detect / point) loop.

Mask model: row i (position pos+i) may attend column j iff j <= pos+i or
(pos+i < prefix_len and j < prefix_len); prefix_len is 730 after an image
and 0 for decode steps, which are causal.

The JAX package runs each loop as one device-resident `lax.while_loop`.
Here each loop's state (token buffers, counts, a `done` flag, the
position) stays in device tensors of fixed address and the host reads it
once per run of DONE_CHECK_EVERY decode steps or verify spans, in one
transfer that also carries the run's results; it stops at the first read
that finds the loop done, or at a limit the host knows. Steps run past the
stop emit nothing and write K/V only at positions nothing emitted attends.
A step reads nothing on the host, so on the card each full run of steps is
one CUDA graph replay (engine/graphs.py): the answer loop (`AnswerState`),
the speculative loop (`SpecState`, verify spans at a device position), the
reasoning loop (`ReasoningState`), the structured loop (`PointsState`, one
graph per start phase) and the accuracy-mode gaze step (`GazeState`). The
speculative stream replays a graph of one span per read and the plain
token stream a graph of one step per token. Every model and every spec_k
runs its verify spans at the device position: MHA spans of up to 16 rows
take kernel B's device form, GQA spans and longer ones kernel A's, as the
JAX package runs them all inside its loops at a traced position.

Every forward takes an optional stacked LoRA adapter, `lora`
(`lora.variant_state_dict`), applied in every block as the JAX package
threads it (moondream_tpu/engine/generate.py:60-125, :176, :296,
:420-460, :516, :601); a loop's graph key names its factors
(`graphs.adapter_key`).

The answer loops take an optional steering vector, `steer` ((n_layers,
dim), a control vector times its scale; `models.text.text_decoder` adds
row l to block l's output), as the JAX package threads it through its
answer, speculative and streamed loops (moondream_tpu/engine/generate.py:
60-125, :139-170, :176-417). A graphed loop keeps the vector in its state,
copied in by `reset`: its key names only whether the loop is steered, so
one graph serves every vector and scale.
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
from .drafting import ngram_draft_rows
from .graphs import adapter_key, tensor_key
from .sampling import sample_tokens_batched, target_probs

NEG_INF = -1e30


def _lm_logits(h: torch.Tensor, model: TextModel) -> torch.Tensor:
    """Final LayerNorm + vocab projection of hidden vectors (..., D) with
    fp32 accumulation, rounded through bf16 (as the JAX package does for
    greedy parity) and returned as fp32. A tensor-parallel rank's head
    (`ops.layers.VocabParallelLinear`) computes its vocabulary slice and
    gathers the whole row from the tp group before the bf16 rounding:
    each column is one product rounded once, so the gathered row is the
    unsharded one."""
    hn = layer_norm(h, model.post_ln.weight, model.post_ln.bias)
    lead = hn.shape[:-1]
    logits = torch.addmm(
        model.lm_head.b, hn.reshape(-1, hn.shape[-1]), model.lm_head.w
    )
    gather = getattr(model.lm_head, "gather", None)
    if gather is not None:
        logits = gather(logits)
    return logits.reshape(*lead, -1).to(torch.bfloat16).float()


def prefill(
    model: TextModel,
    kv: KVCache,
    embeds: torch.Tensor,
    pos: int,
    length: int,
    prefix_len: int,
    kv_bound: Optional[int] = None,
    lora: Optional[dict] = None,
    steer: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill a right-padded span embeds (1, T_pad, D) at pos, of which the
    first `length` rows are real. Padding rows write K/V past pos+length;
    those slots are overwritten before they are ever attended. Returns
    (logits (V,) and hidden (D,) of the last real row)."""
    hidden = text_decoder(embeds, model, kv, pos, prefix_len, kv_bound, lora, steer)
    h_last = hidden[0, length - 1]
    return _lm_logits(h_last, model), h_last


def decode_step(
    model: TextModel,
    kv: KVCache,
    emb: torch.Tensor,
    pos: int,
    kv_bound: Optional[int] = None,
    lora: Optional[dict] = None,
    steer: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step for emb (1, 1, D) at pos. Returns (logits, hidden)."""
    hidden = text_decoder(emb, model, kv, pos, 0, kv_bound, lora, steer)
    h = hidden[0, 0]
    return _lm_logits(h, model), h


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
    steer: Optional[torch.Tensor] = None  # (L, D) in the model's dtype of a steered loop

    @classmethod
    def create(cls, bsz: int, dev, suppress_ids: Tuple[int, ...], sampled: bool,
               steer_like: Optional[torch.Tensor] = None) -> "AnswerState":
        """`steer_like`: a tensor of the steering buffer's shape and dtype
        for a steered loop, else None."""
        z = lambda dtype: torch.zeros((bsz,), dtype=dtype, device=dev)
        return cls(tok=z(torch.long), done=z(torch.bool), count=z(torch.long),
                   pos=z(torch.int32),
                   run=torch.zeros((bsz, DONE_CHECK_EVERY), dtype=torch.long, device=dev),
                   suppress=torch.tensor(suppress_ids, dtype=torch.long, device=dev),
                   temperature=z(torch.float32) if sampled else None,
                   top_p=z(torch.float32) if sampled else None,
                   steer=None if steer_like is None else torch.zeros_like(steer_like))

    def reset(self, first: torch.Tensor, pos: int, eos_id: int, temperature: float,
              top_p: float, steer: Optional[torch.Tensor] = None) -> None:
        """Start a loop from first tokens (B,) at `pos`, in place; a steered
        state takes `steer`, cast to its buffer's dtype."""
        self.tok.copy_(first.reshape(-1))
        torch.eq(self.tok, eos_id, out=self.done)
        self.count.zero_()
        self.pos.fill_(pos)
        if self.temperature is not None:
            self.temperature.fill_(temperature)
            self.top_p.fill_(top_p)
        if self.steer is not None:
            self.steer.copy_(steer)


def answer_step(model: TextModel, kv: KVCache, st: AnswerState, j: int, eos_id: int,
                kv_bound: Optional[int], generator: Optional[torch.Generator],
                lora: Optional[dict] = None) -> None:
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
    hidden = text_decoder(emb, model, kv, st.pos, 0, kv_bound, lora, st.steer)[:, 0]
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
                graphed: bool, label: str, lora: Optional[dict] = None,
                steer: Optional[torch.Tensor] = None, run_len: int = DONE_CHECK_EVERY):
    """(state, run) of an answer loop over B = len(first) rows from `pos`:
    run(n) advances it n steps of `answer_step`. On the card (unless
    `graphed` is False) a full run of `run_len` steps (DONE_CHECK_EVERY; 1
    for the stream) replays a CUDA graph keyed by the batch, kv_bound,
    steered or not, the adapter, run_len, the cache, eos, the suppressed
    ids and greedy or sampled (engine/graphs.py); a shorter last run, which
    must not step past the limit, runs eagerly. `steer` goes into the
    state's buffer."""
    sampled = temperature > 0
    bsz, dev = first.shape[0], first.device
    like = _steer_like(model, steer)
    key = (label, bsz, kv_bound, eos_id, tuple(suppress_ids),
           id(generator) if sampled else None, steer is not None, adapter_key(lora), run_len,
           tensor_key(kv.k, kv.v, kv.ks, kv.vs))
    gen = generator if sampled else None
    st, run = graphs.loop(
        model, key, lambda: AnswerState.create(bsz, dev, tuple(suppress_ids), sampled, like),
        lambda st, j: answer_step(model, kv, st, j, eos_id, kv_bound, gen, lora),
        run_len, graphed and graphs.enabled(dev), label, gen)
    st.reset(first, pos, eos_id, temperature, top_p, steer)
    return st, run


def _steer_like(model: TextModel, steer: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A steered loop's buffer template: the vector's shape and device in
    the activations' dtype (the embeddings'); None for an unsteered loop."""
    return None if steer is None else torch.empty_like(steer, dtype=model.wte.dtype)


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
    lora: Optional[dict] = None,
    steer: Optional[torch.Tensor] = None,
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
    `graphed=False` runs the same steps eagerly. `steer`: a steering
    vector (n_layers, dim) added in every step."""
    limit = _limit(model, pos, max_tokens, kv_bound)
    st, run = answer_loop(model, kv, first_token.reshape(1), pos, generator, temperature,
                          top_p, eos_id, suppress_ids, kv_bound, graphed, "generate_text", lora,
                          steer)
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
    lora: Optional[dict] = None,
    steer: Optional[torch.Tensor] = None,
    graphed: bool = True,
) -> Iterator[int]:
    """The answer loop one token at a time, for streaming: yields each
    emitted id as a host int, one `answer_step` and one host read per
    token, as the JAX package's jitted step reads one. On the card each
    step replays a CUDA graph of one step (`answer_loop`, run_len 1, label
    "stream"); `graphed=False` runs it eagerly. The steps are
    generate_text's (the same kernels and split plans), so a streamed
    answer equals the fused one. The reads are recorded under LOOP_COUNTS
    "stream" when the stream ends or is closed."""
    limit = _limit(model, pos, max_tokens, kv_bound)
    st, run = answer_loop(model, kv, first_token.reshape(1), pos, generator, temperature,
                          top_p, eos_id, suppress_ids, kv_bound, graphed, "stream", lora, steer,
                          run_len=1)
    steps = reads = 0
    try:
        while steps < limit:
            tok = int(st.tok[0])
            reads += 1
            if tok == eos_id:
                return
            yield tok
            run(1)
            steps += 1
    finally:
        _record("stream", steps, reads)


def _spec_limit(model: TextModel, pos: int, max_tokens: int, spec_k: int,
                kv_bound: Optional[int]) -> int:
    """Tokens a speculative loop may emit from pos: as `_limit`, but every
    verify span of spec_k rows must fit, so it stops spec_k - 1 tokens
    before the context end or kv_bound, as the JAX package does."""
    limit = min(max_tokens, model.config.max_context - spec_k + 1 - pos)
    if kv_bound is not None:
        limit = min(limit, kv_bound - spec_k + 1 - pos)
    return max(limit, 0)


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


class SpecState(NamedTuple):
    """The device state of the batch-1 speculative loop between verify
    spans. Every tensor keeps its address for the loop's life, so a CUDA
    graph can capture a run of `spec_step`s over it (engine/graphs.py)."""

    tok: torch.Tensor  # (1,) int64: the current token
    pos: torch.Tensor  # (1,) int32: the next verify span's position
    count: torch.Tensor  # (1,) int64: tokens emitted
    done: torch.Tensor  # (1,) bool: the token is EOS or the limit is reached
    limit: torch.Tensor  # (1,) int64: tokens the loop may emit
    hist: torch.Tensor  # (S0 + max_context + 1,) int64: [seed; emitted], then a spare
    run: torch.Tensor  # (DONE_CHECK_EVERY, spec_k) int64: each span's [token; accepted]
    run_m: torch.Tensor  # (DONE_CHECK_EVERY,) int64: tokens each span emitted
    suppress: torch.Tensor  # (n,) int64: ids masked from every span's logits
    temperature: Optional[torch.Tensor]  # (1,) fp32 of a sampled loop; None: greedy
    top_p: Optional[torch.Tensor]
    steer: Optional[torch.Tensor] = None  # (L, D) in the model's dtype of a steered loop

    @classmethod
    def create(cls, width: int, spec_k: int, dev, suppress_ids: Tuple[int, ...],
               sampled: bool, steer_like: Optional[torch.Tensor] = None) -> "SpecState":
        z = lambda *shape, dtype=torch.long: torch.zeros(shape, dtype=dtype, device=dev)
        return cls(tok=z(1), pos=z(1, dtype=torch.int32), count=z(1),
                   done=z(1, dtype=torch.bool), limit=z(1), hist=z(width + 1),
                   run=z(DONE_CHECK_EVERY, spec_k), run_m=z(DONE_CHECK_EVERY),
                   suppress=torch.tensor(suppress_ids, dtype=torch.long, device=dev),
                   temperature=z(1, dtype=torch.float32) if sampled else None,
                   top_p=z(1, dtype=torch.float32) if sampled else None,
                   steer=None if steer_like is None else torch.zeros_like(steer_like))

    def reset(self, first: torch.Tensor, pos: int, limit: int, seed: Optional[torch.Tensor],
              eos_id: int, temperature: float, top_p: float,
              steer: Optional[torch.Tensor] = None) -> None:
        """Start a loop from the first token at `pos`, in place."""
        self.tok.copy_(first.reshape(1))
        self.pos.fill_(pos)
        self.count.zero_()
        self.limit.fill_(limit)
        torch.logical_or(self.tok == eos_id, self.limit <= 0, out=self.done)
        self.hist.zero_()
        if seed is not None:
            self.hist[:seed.shape[0]] = seed
        self.run_m.zero_()
        if self.temperature is not None:
            self.temperature.fill_(temperature)
            self.top_p.fill_(top_p)
        if self.steer is not None:
            self.steer.copy_(steer)


def spec_step(model: TextModel, kv: KVCache, st: SpecState, j: int, s0: int, eos_id: int,
              kv_bound: Optional[int], generator: Optional[torch.Generator],
              lora: Optional[dict] = None) -> None:
    """One verify span of the speculative loop (moondream_tpu/engine/
    generate.py:238-290 greedy, :367-414 sampled), in place on `st`: the
    token joins the draft history at S0 + count, ngram_draft_rows drafts
    spec_k - 1 tokens from it, one forward verifies [token; draft] at the
    device position (kernel B's device form for an MHA span of up to 16
    rows, kernel A's for a GQA or longer one), and the acceptance (greedy,
    or the rejection test from `generator`) gives m, clamped to the limit.
    Run row j records the span's [token; accepted] and m; the accepted
    interior joins the history by a masked write (JAX's dropped scatter
    lands on the spare last column). Once done, m is 0: position, count,
    token and history freeze, and the span's K/V land at the frozen
    position, which nothing emitted attends. It reads nothing on the host,
    so a run of spans is what a CUDA graph captures."""
    spare = st.hist.shape[0] - 1
    k = st.run.shape[1]
    live = ~st.done
    at = s0 + st.count  # (1,): where the token joins the history
    st.hist[torch.where(live, at, spare)] = st.tok
    draft = ngram_draft_rows(st.hist[None, :spare], at + 1, st.tok, k)[0][0]
    q_toks = torch.cat([st.tok, draft])
    hidden = text_decoder(text_encoder(q_toks[None], model), model, kv, st.pos, 0, kv_bound,
                          lora, st.steer)
    logits = _lm_logits(hidden[0], model).index_fill_(-1, st.suppress, NEG_INF)
    if st.temperature is None:
        emitted = torch.argmax(logits, dim=-1)
        m = greedy_accept(draft, emitted, eos_id)
    else:
        emitted, m = sampled_accept(logits, draft, generator, st.temperature, st.top_p, eos_id)
    m = torch.where(live, torch.minimum(m.reshape(1), st.limit - st.count), 0)
    st.run[j].copy_(torch.cat([st.tok, emitted[:-1]]))
    st.run_m[j:j + 1].copy_(m)
    steps = torch.arange(k - 1, device=m.device)
    st.hist[torch.where(steps + 1 < m, at + 1 + steps, spare)] = emitted[:-1]
    st.tok.copy_(torch.where(live, emitted[(m - 1).clamp(min=0)], st.tok))
    st.pos.add_(m.to(st.pos.dtype))
    st.count.add_(m)
    st.done.logical_or_((st.tok == eos_id) | (st.count >= st.limit))


def spec_loop(model: TextModel, kv: KVCache, first_token: torch.Tensor, pos: int, limit: int,
              eos_id: int, suppress_ids: Tuple[int, ...], spec_k: int,
              kv_bound: Optional[int], seed: Optional[torch.Tensor],
              generator: Optional[torch.Generator], temperature: float, top_p: float,
              graphed: bool, label: str, run_len: int = DONE_CHECK_EVERY,
              lora: Optional[dict] = None, steer: Optional[torch.Tensor] = None):
    """(state, run) of the speculative loop from `pos`: run(n) advances it
    n verify spans of `spec_step`. On the card (unless `graphed` is False)
    a full run of `run_len` spans (DONE_CHECK_EVERY; 1 for the stream)
    replays a CUDA graph keyed by run_len, spec_k, the seed's width,
    kv_bound, steered or not, the adapter, the cache, eos, the suppressed
    ids and greedy or sampled (engine/graphs.py); a shorter run is eager.
    `steer` goes into the state's buffer."""
    sampled = temperature > 0
    dev = first_token.device
    s0 = 0 if seed is None else seed.shape[0]
    gen = generator if sampled else None
    like = _steer_like(model, steer)
    key = (label, run_len, spec_k, s0, kv_bound, eos_id, tuple(suppress_ids),
           id(generator) if sampled else None, steer is not None, adapter_key(lora),
           tensor_key(kv.k, kv.v, kv.ks, kv.vs))
    st, run = graphs.loop(
        model, key,
        lambda: SpecState.create(s0 + model.config.max_context, spec_k, dev,
                                 tuple(suppress_ids), sampled, like),
        lambda st, j: spec_step(model, kv, st, j, s0, eos_id, kv_bound, gen, lora),
        run_len, graphed and graphs.enabled(dev), label, gen)
    st.reset(first_token, pos, limit, seed, eos_id, temperature, top_p, steer)
    return st, run


def _spec_label(sampled: bool) -> str:
    return "generate_text_spec_sampled" if sampled else "generate_text_spec"


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
    graphed: bool = True,
    lora: Optional[dict] = None,
    steer: Optional[torch.Tensor] = None,
) -> Iterator[List[int]]:
    """The speculative answer loop one verify span at a time, for the
    speculative stream: while the token is not EOS and the limit is not
    reached, draft spec_k - 1 tokens from [seed; emitted] (ngram_draft_rows),
    verify [token; draft] in one forward and advance by the m tokens the
    acceptance gives: greedy (`greedy_accept`) at temperature 0, else the
    rejection test against the target nucleus (`sampled_accept`). Yields
    each span's m emitted tokens (the span's token and its accepted
    drafts) as host ints. The spans are the fused loops' `spec_step`s, one
    host read each plus one before the first, for every model and spec_k;
    on the card each span replays a CUDA graph of one span
    (`graphed=False`: eager). The reads are recorded under LOOP_COUNTS
    "generate_text_spec" (or "generate_text_spec_sampled") when the loop
    ends."""
    limit = _spec_limit(model, pos, max_tokens, spec_k, kv_bound)
    label = _spec_label(temperature > 0)
    st, run = spec_loop(model, kv, first_token, pos, limit, eos_id, suppress_ids, spec_k,
                        kv_bound, seed, generator, temperature, top_p, graphed, label, 1,
                        lora, steer)
    reads, spans = 1, 0
    done = bool(st.done)
    while not done:
        run(1)
        host = torch.cat([st.done.long(), st.run_m[:1], st.run[0]]).tolist()
        reads += 1
        spans += 1
        done = bool(host[0])
        yield host[2:2 + host[1]]
    _record(label, spans, reads)


def _fused_spec(model, kv, first_token, pos, max_tokens, eos_id, suppress_ids, spec_k,
                kv_bound, seed, generator, temperature, top_p, graphed,
                lora=None, steer=None) -> "GenerateResult":
    """The fused speculative loops: runs of DONE_CHECK_EVERY verify spans
    over the device state, the host reading the done flag, the count and
    the last run's spans once per run (and once before the first), so at
    most ceil(spans / 8) + 1 times; on the card each full run replays a
    CUDA graph. A run never steps past the limit: each live span emits at
    least one token, so limit - count spans always reach it."""
    limit = _spec_limit(model, pos, max_tokens, spec_k, kv_bound)
    label = _spec_label(temperature > 0)
    st, run = spec_loop(model, kv, first_token, pos, limit, eos_id, suppress_ids, spec_k,
                        kv_bound, seed, generator, temperature, top_p, graphed, label,
                        lora=lora, steer=steer)
    out: List[int] = []
    spans = reads = n = 0
    while True:
        host = torch.cat([st.done.long(), st.count, st.run_m[:n],
                          st.run[:n].flatten()]).tolist()
        reads += 1
        for i, m in enumerate(host[2:2 + n]):
            out += host[2 + n + i * spec_k:2 + n + i * spec_k + m]
        if host[0]:
            break
        n = min(DONE_CHECK_EVERY, limit - host[1])
        run(n)
        spans += n
    _record(label, spans, reads)
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
    graphed: bool = True,
    lora: Optional[dict] = None,
    steer: Optional[torch.Tensor] = None,
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
    The spans are `spec_step`s over a device state (`SpecState`), read once
    per run of DONE_CHECK_EVERY spans plus once, on every model (MHA or
    GQA) and every spec_k; on the card each full run replays a CUDA graph,
    and `graphed=False` runs the same spans eagerly."""
    return _fused_spec(model, kv, first_token, pos, max_tokens, eos_id, suppress_ids, spec_k,
                       kv_bound, seed, None, 0.0, 0.0, graphed, lora, steer)


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
    graphed: bool = True,
    lora: Optional[dict] = None,
    steer: Optional[torch.Tensor] = None,
) -> GenerateResult:
    """Speculative sampling at temperature > 0 (moondream_tpu/engine/
    generate.py:296-417): the drafts of generate_text_spec accepted by the
    rejection test against the target nucleus (`speculative_sample`), so
    the emitted sequence is distributed as the plain sampled loop's,
    though not draw for draw. The first EOS among an iteration's emitted
    tokens is carried. Same limits, seed, reads and graphs as
    generate_text_spec; the graph's replays advance `generator` as the
    eager spans do."""
    return _fused_spec(model, kv, first_token, pos, max_tokens, eos_id, suppress_ids, spec_k,
                       kv_bound, seed, generator, temperature, top_p, graphed, lora, steer)


class ReasoningResult(NamedTuple):
    tokens: List[int]
    is_coord: List[bool]  # token i was a grounding coordinate
    coord_vals: List[float]  # its decoded coordinate (0.0 where not)
    count: int
    pos: int


class ReasoningState(NamedTuple):
    """The device state of the reasoning loop between steps, at fixed
    addresses (a CUDA graph captures a run of `reasoning_step`s)."""

    tok: torch.Tensor  # (1,) int64: the next input token
    hid: torch.Tensor  # (1, D): the last hidden state (a coordinate's source)
    done: torch.Tensor  # (1,) bool: the answer token was sampled
    count: torch.Tensor  # (1,) int64: tokens emitted
    pos: torch.Tensor  # (1,) int32: the next step's position
    run: torch.Tensor  # (1, DONE_CHECK_EVERY) int64: this run's tokens
    run_coord: torch.Tensor  # (1, DONE_CHECK_EVERY) bool: token j was a coordinate
    run_val: torch.Tensor  # (1, DONE_CHECK_EVERY) fp32: its value (0.0 where not)
    suppress: torch.Tensor  # (n,) int64
    temperature: Optional[torch.Tensor]  # (1,) fp32 of a sampled loop; None: greedy
    top_p: Optional[torch.Tensor]

    @classmethod
    def create(cls, hidden: torch.Tensor, suppress_ids: Tuple[int, ...], sampled: bool
               ) -> "ReasoningState":
        dev = hidden.device
        z = lambda *shape, dtype=torch.long: torch.zeros(shape, dtype=dtype, device=dev)
        run = lambda dtype: z(1, DONE_CHECK_EVERY, dtype=dtype)
        return cls(tok=z(1), hid=z(1, hidden.shape[-1], dtype=hidden.dtype),
                   done=z(1, dtype=torch.bool), count=z(1), pos=z(1, dtype=torch.int32),
                   run=run(torch.long), run_coord=run(torch.bool), run_val=run(torch.float32),
                   suppress=torch.tensor(suppress_ids, dtype=torch.long, device=dev),
                   temperature=z(1, dtype=torch.float32) if sampled else None,
                   top_p=z(1, dtype=torch.float32) if sampled else None)

    def reset(self, first: torch.Tensor, hidden: torch.Tensor, pos: int, answer_id: int,
              temperature: float, top_p: float) -> None:
        self.tok.copy_(first.reshape(1))
        self.hid.copy_(hidden.reshape(1, -1))
        torch.eq(self.tok, answer_id, out=self.done)
        self.count.zero_()
        self.pos.fill_(pos)
        if self.temperature is not None:
            self.temperature.fill_(temperature)
            self.top_p.fill_(top_p)


def reasoning_step(model: TextModel, region: RegionModel, kv: KVCache, st: ReasoningState,
                   j: int, answer_id: int, coord_id: int, kv_bound: Optional[int],
                   generator: Optional[torch.Generator], lora: Optional[dict] = None) -> None:
    """One step of the reasoning loop (moondream_tpu/engine/generate.py:
    548-581), in place on `st`: the token goes to run column j; a
    `coord_id` token feeds enc(argmax(decode_coordinate(hidden)) / 1024) in
    place of its embedding (both computed, one selected by torch.where:
    JAX's `lax.cond`) and records the value; one decode step at the device
    position; the next token sampled (the argmax for a greedy state), the
    answer token marking the loop done. Reads nothing on the host."""
    emb_dtype = model.wte.dtype
    st.run[:, j] = st.tok
    coord = st.tok == coord_id
    val = region_ops.coordinate_value(region_ops.decode_coordinate(st.hid, region))
    c_emb = region_ops.encode_coordinate(val[:, None].to(emb_dtype), region)
    emb = torch.where(coord[:, None], c_emb, model.wte[st.tok].to(emb_dtype))
    st.run_val[:, j] = torch.where(coord, val, 0.0)
    st.run_coord[:, j] = coord
    st.count.add_((~st.done).long())
    hidden = text_decoder(emb[:, None], model, kv, st.pos, 0, kv_bound, lora)[:, 0]
    logits = _lm_logits(hidden, model).index_fill_(-1, st.suppress, NEG_INF)
    if st.temperature is None:
        nxt = torch.argmax(logits, dim=-1)
    else:
        nxt = sample_tokens_batched(logits, generator, st.temperature, st.top_p)
    st.hid.copy_(hidden)
    st.tok.copy_(nxt)
    st.done.logical_or_(nxt == answer_id)
    st.pos.add_(1)


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
    graphed: bool = True,
    lora: Optional[dict] = None,
) -> ReasoningResult:
    """The reasoning loop with inline grounding
    (moondream_tpu/engine/generate.py:516-591): as generate_text, with
    `answer_id` ending the phase, except that a `coord_id` token feeds
    enc(argmax(decode_coordinate(previous hidden)) / 1024) to the next
    step in place of its token embedding. Records per token whether it was
    a coordinate and its value. The state stays on the device
    (`ReasoningState`); the host reads it once per run of DONE_CHECK_EVERY
    steps and once at the limit. On the card each full run replays a CUDA
    graph keyed like the answer loop's plus the answer and coordinate ids;
    `graphed=False` runs the same steps eagerly."""
    limit = _limit(model, pos, max_tokens, kv_bound)
    sampled = temperature > 0
    dev = first_token.device
    gen = generator if sampled else None
    key = ("generate_reasoning", kv_bound, answer_id, coord_id, tuple(suppress_ids), id(region),
           id(generator) if sampled else None, adapter_key(lora),
           tensor_key(kv.k, kv.v, kv.ks, kv.vs))
    st, run = graphs.loop(
        model, key, lambda: ReasoningState.create(first_hidden, tuple(suppress_ids), sampled),
        lambda st, j: reasoning_step(model, region, kv, st, j, answer_id, coord_id, kv_bound,
                                     gen, lora),
        DONE_CHECK_EVERY, graphed and graphs.enabled(dev), "generate_reasoning", gen)
    st.reset(first_token, first_hidden, pos, answer_id, temperature, top_p)
    out: List[List[float]] = [[], [], []]
    steps = reads = 0
    while True:
        k = steps - len(out[0])
        host = torch.cat([st.done.double(), st.count.double(), st.run[0, :k].double(),
                          st.run_coord[0, :k].double(), st.run_val[0, :k].double()]).tolist()
        reads += 1
        for i in range(3):
            out[i] += host[2 + i * k:2 + (i + 1) * k]
        if host[0] or steps == limit:
            break
        n = min(DONE_CHECK_EVERY, limit - steps)
        run(n)
        steps += n
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


class PointsState(NamedTuple):
    """The device state of the structured loop between steps, B rows at one
    shared position, at fixed addresses (a CUDA graph captures a run of
    `points_step`s)."""

    hid: torch.Tensor  # (B, D): the last hidden state
    x: torch.Tensor  # (B,) fp32: the object's x, from its first step
    y: torch.Tensor  # (B,) fp32: its y, from its second
    boxes: torch.Tensor  # (B, max_objects, 4) fp32
    n: torch.Tensor  # (B,) int64: objects found
    done: torch.Tensor  # (B,) bool
    pos: torch.Tensor  # (B,) int32: the next step's position, one value
    slot: torch.Tensor  # (max_objects,) int64: 0 .. max_objects - 1

    @classmethod
    def create(cls, hidden: torch.Tensor, max_objects: int) -> "PointsState":
        bsz, dev = hidden.shape[0], hidden.device
        z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)
        return cls(hid=z(*hidden.shape, dtype=hidden.dtype), x=z(bsz), y=z(bsz),
                   boxes=z(bsz, max_objects, 4), n=z(bsz, dtype=torch.long),
                   done=z(bsz, dtype=torch.bool), pos=z(bsz, dtype=torch.int32),
                   slot=torch.arange(max_objects, device=dev))

    def reset(self, hidden: torch.Tensor, first: torch.Tensor, pos: int, eos_id: int) -> None:
        self.hid.copy_(hidden)
        self.boxes.zero_()
        self.n.zero_()
        torch.eq(first.reshape(-1), eos_id, out=self.done)
        self.pos.fill_(pos)


def points_step(model: TextModel, region: RegionModel, kv: KVCache, st: PointsState,
                phase: int, eos_id: int, include_size: bool, max_objects: int,
                kv_bound: Optional[int], lora: Optional[dict] = None) -> None:
    """One step of the structured loop, in place on `st`. Phase 0 decodes
    x from the hidden state and feeds enc(x); phase 1 decodes y and feeds
    enc(y); with sizes, phase 2 decodes the (w, h) log-bins and feeds
    their encoding. The object's last phase records its row in each live
    row's next box slot before the step and, after it, projects to the
    vocabulary: EOS, or max_objects reached, marks the row done. `phase`
    is a host int, static in a captured run (the run's start phase is in
    its graph's key). Reads nothing on the host."""
    spo = 3 if include_size else 2
    emb_dtype = model.wte.dtype
    if phase == 0:
        x = region_ops.coordinate_value(region_ops.decode_coordinate(st.hid, region))
        st.x.copy_(x)
        emb = region_ops.encode_coordinate(x[:, None].to(emb_dtype), region)
    elif phase == 1:
        y = region_ops.coordinate_value(region_ops.decode_coordinate(st.hid, region))
        st.y.copy_(y)
        emb = region_ops.encode_coordinate(y[:, None].to(emb_dtype), region)
        if not include_size:
            zero = torch.zeros_like(y)
            row = torch.stack([st.x, y, zero, zero], -1)
    else:
        bins = torch.argmax(region_ops.decode_size(st.hid, region), dim=-1)
        wh = region_ops.size_bin_to_value(bins)
        emb = region_ops.encode_size(wh.to(emb_dtype), region)
        w, h = wh[:, 0], wh[:, 1]
        row = torch.stack([st.x - w / 2, st.y - h / 2, st.x + w / 2, st.y + h / 2], -1)
    last = phase == spo - 1
    if last:
        active = ~st.done
        upd = (st.slot[None, :] == st.n[:, None]) & active[:, None]
        st.boxes.copy_(torch.where(upd[..., None], row[:, None, :], st.boxes))
        st.n.add_(active.long())
    hidden = text_decoder(emb[:, None, :], model, kv, st.pos, 0, kv_bound, lora)[:, 0]
    st.hid.copy_(hidden)
    if last:
        tok = torch.argmax(_lm_logits(hidden, model), dim=-1)
        st.done.logical_or_((tok == eos_id) | (st.n >= max_objects))
    st.pos.add_(1)


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
    graphed: bool = True,
    lora: Optional[dict] = None,
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
    pos_limit - 4 and runs the steps flat (`points_step` over a
    `PointsState` on the device), reading the done flag, counts and boxes
    once per DONE_CHECK_EVERY steps; only the last step of an object
    projects to the vocabulary. A run's phases follow from its start
    phase, steps % steps_per_object: on the card each run replays the CUDA
    graph of its start phase (one for points, three for boxes) and, for
    the last run of fewer steps, its length, keyed by the batch, sizes,
    max_objects, eos, kv_bound and the cache; `graphed=False` runs the
    same steps eagerly."""
    spo = 3 if include_size else 2
    pos_limit = model.config.max_context if kv_bound is None else kv_bound
    total = objects_that_fit(pos, pos_limit, spo, max_objects) * spo
    assert pos + total <= pos_limit - 2, (pos, total, pos_limit)
    bsz, dev = first_tokens.shape[0], first_tokens.device
    hidden = first_hidden.reshape(bsz, -1)
    key = (loop, bsz, include_size, max_objects, eos_id, kv_bound, id(region),
           adapter_key(lora), tensor_key(kv.k, kv.v, kv.ks, kv.vs))
    st, run = graphs.loop(
        model, key, lambda: PointsState.create(hidden, max_objects),
        lambda st, t: points_step(model, region, kv, st, t % spo, eos_id, include_size,
                                  max_objects, kv_bound, lora),
        DONE_CHECK_EVERY, graphed and graphs.enabled(dev), loop, tails=True)
    st.reset(hidden, first_tokens, pos, eos_id)
    steps = reads = 0
    while True:
        host = torch.cat([st.done.all().view(1).float(), st.n.float(), st.boxes.flatten()])
        host = host.double().cpu().numpy()
        reads += 1
        if host[0] or steps == total:
            break
        n = min(DONE_CHECK_EVERY, total - steps)
        run(n, steps % spo)
        steps += n
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
    graphed: bool = True,
    lora: Optional[dict] = None,
) -> np.ndarray:
    """Structured decode of one row from the prompt's last hidden state
    (D,) and its greedy token: the found boxes (count, 4) as float64
    ([x_min, y_min, x_max, y_max], or [x, y, 0, 0] without sizes)."""
    res = points_loop(model, region, kv, first_hidden, first_token.reshape(1), pos,
                      eos_id, include_size, max_objects, kv_bound, "generate_points", graphed,
                      lora)
    return res.boxes[0, :res.counts[0]]


class GazeState(NamedTuple):
    """The device state of the accuracy-mode gaze step, B rows at one
    shared position, at fixed addresses (a CUDA graph captures the step)."""

    hid: torch.Tensor  # (B, D): the gaze prompts' last hidden states
    x: torch.Tensor  # (B,) fp32
    y: torch.Tensor  # (B,) fp32
    pos: torch.Tensor  # (B,) int32: the step's position, one value


def gaze_step(model: TextModel, region: RegionModel, kv: KVCache, st: GazeState,
              kv_bound: Optional[int]) -> None:
    """x from each row's prompt hidden state, one lockstep decode step on
    enc(x) at the device position, y from its hidden state: the two ops
    the structured loop runs for one point (moondream_tpu/models/
    moondream.py:1748-1766). Reads nothing on the host."""
    x = region_ops.coordinate_value(region_ops.decode_coordinate(st.hid, region))
    emb = region_ops.encode_coordinate(x[:, None, None].to(model.wte.dtype), region)
    hidden = text_decoder(emb, model, kv, st.pos, 0, kv_bound)[:, 0]
    st.x.copy_(x)
    st.y.copy_(region_ops.coordinate_value(region_ops.decode_coordinate(hidden, region)))


def gaze_points_batched(model: TextModel, region: RegionModel, kv: KVCache,
                        hidden: torch.Tensor, tokens: torch.Tensor, pos: int,
                        kv_bound: Optional[int], graphed: bool = True) -> List[List[float]]:
    """The accuracy-mode gaze rows (moondream_tpu/models/moondream.py:
    1699-1782) after their batched prompt prefill: `gaze_step` over a
    `GazeState`, then one host read of (token, x, y) per row. On the card
    the step replays a CUDA graph keyed by the batch, kv_bound and the
    cache; `graphed=False` runs it eagerly. It runs no LoRA adapter, as the
    JAX package's detect_gaze runs none. Recorded under LOOP_COUNTS
    "gaze_points_batched" (one step, one read)."""
    bsz, dev = hidden.shape[0], hidden.device
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    key = ("gaze_points_batched", bsz, kv_bound, id(region), tensor_key(kv.k, kv.v, kv.ks, kv.vs))
    st, run = graphs.loop(
        model, key,
        lambda: GazeState(hid=torch.zeros_like(hidden), x=z(bsz), y=z(bsz),
                          pos=torch.zeros((bsz,), dtype=torch.int32, device=dev)),
        lambda st, j: gaze_step(model, region, kv, st, kv_bound),
        1, graphed and graphs.enabled(dev), "gaze_points_batched")
    st.hid.copy_(hidden)
    st.pos.fill_(pos)
    run(1)
    rows = torch.stack([tokens.double(), st.x.double(), st.y.double()], dim=1).tolist()
    _record("gaze_points_batched", 1, 1)
    return rows
