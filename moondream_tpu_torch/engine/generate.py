"""Prefill, decode step and the decode loops (moondream_tpu/engine/generate.py):
the answer loop, the reasoning loop with inline grounding, and the
structured coordinate (detect / point) loop.

Mask model: row i (position pos+i) may attend column j iff j <= pos+i or
(pos+i < prefix_len and j < prefix_len); prefix_len is 730 after an image
and 0 for decode steps, which are causal.

The JAX package runs each loop as one device-resident `lax.while_loop`.
Here the loop state (token buffers, counts, a `done` flag) stays on the
device and the host reads it once per run of DONE_CHECK_EVERY decode steps,
in one transfer that also carries the run's results; it stops at the first
read that finds the loop done, or at a limit the host knows. Steps run past
the stop emit nothing and write K/V only at positions before that limit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import region as region_ops
from ..models.region import RegionModel
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
    """Answer generation from first_token (a 0-d device tensor) at pos, with
    the JAX package's semantics: while the token is not EOS and the limit
    is not reached, emit it, run one decode step and sample the next.

    The limit is max_tokens, the context end or kv_bound; EOS is not
    emitted. `suppress_ids` are masked from every step's logits. Tokens,
    the count and the done flag stay on the device; the host reads them
    once per DONE_CHECK_EVERY steps and once at the limit. Steps after EOS
    emit nothing (with temperature > 0 they still draw from `generator`);
    `pos` counts emitted tokens only, as JAX's does."""
    limit = _limit(model, pos, max_tokens, kv_bound)
    dev = first_token.device
    toks = torch.zeros(limit, dtype=torch.long, device=dev)
    count = torch.zeros((), dtype=torch.long, device=dev)
    tok = first_token.reshape(()).long()
    done = tok == eos_id
    out: List[int] = []
    steps = reads = 0
    while True:
        # the flag, the count and this run's tokens in one transfer
        host = torch.cat([done.view(1).long(), count.view(1),
                          toks[len(out):steps]]).tolist()
        reads += 1
        out += host[2:]
        if host[0] or steps == limit:
            break
        for _ in range(min(DONE_CHECK_EVERY, limit - steps)):
            toks[steps] = tok
            count += (~done).long()
            emb = text_encoder(tok.view(1, 1), model)
            logits, _ = decode_step(model, kv, emb, pos + steps, kv_bound)
            suppress(logits, suppress_ids)
            tok = sample_token(logits, generator, temperature, top_p)
            done = done | (tok == eos_id)
            steps += 1
    _record("generate_text", steps, reads)
    n = host[1]
    return GenerateResult(tokens=out[:n], count=n, pos=pos + n)


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
