"""ContinuousBatchingEngine: the host-side scheduler over the slot pool
(moondream_tpu/models/serve.py, the plain-chunk subset).

Requests with different images, prompts and lengths are admitted whenever
a slot is free, prefilled one by one, and advanced together by fused
ragged decode chunks (engine/serving.py). One device-to-host transfer per
chunk, not per token.

    eng = ContinuousBatchingEngine(model, n_slots=8)
    r1 = eng.submit(image1)                          # caption
    r2 = eng.submit(image2, question="What is it?")  # VQA
    results = eng.drain()                            # {req_id: text}

`slot_len` bounds prompt + generated tokens per request; an encoded image
alone occupies 730 KV positions, so slot_len must cover image + question
+ expected output. Submissions whose prompt already fills the slot raise
ValueError; token budgets are clamped to the room left in the slot.

Not ported yet: speculative chunks and LoRA variants (the arguments
`speculative`, `spec_adaptive`, `variants` and `variant=` raise
NotImplementedError), the structured detect/point/gaze requests with their
mixed chunks, and `submit_many`. A GQA text config (n_kv_heads < n_heads)
is refused: the pool's ragged decode is MHA only, as in the JAX package
(moondream_tpu/ops/attention.py:608).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from ..engine import serving
from ..utils.streaming import TokenStreamer, stream_text
from .moondream import EncodedImage, MoondreamModel
from .text import KVCache, slice_cache_span, slice_cache_span_from

DEFAULT_MAX_TOKENS = 512
# Finished-request history kept in results/token_counts; oldest entries are
# evicted past this so long-lived consumers that never pop stay bounded.
RESULTS_CAP = 10_000


@dataclass
class _Slot:
    req_id: int = -1
    tokens: List[int] = field(default_factory=list)
    active: bool = False
    on_text: Optional[Any] = None  # callback(req_id, chunk) per text chunk
    streamer: Optional[TokenStreamer] = None  # when on_text is set


@dataclass
class PreparedRequest:
    """An encoded and prefilled request not yet in a pool slot: `prepare()`
    makes it, `admit_prepared()` moves it into a slot and
    `release_prepared()` returns its buffer. Lets a server run the costly
    part of admission (crops, ViT, prefill) without holding up the pool's
    chunks; only the slot write needs the pool."""

    kv1: KVCache  # single-row prefilled cache (a recycled model buffer)
    next_token: torch.Tensor  # 0-d device tensor
    pos: int
    prompt: List[int]
    temperature: float
    top_p: float
    released: bool = False
    # the EncodedImage the request was prefilled from: prefix-shared pools
    # key their shared-prefix entries on its identity
    enc: Optional[EncodedImage] = None


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to moondream_tpu_torch yet (ROADMAP.md)"
    )


class ContinuousBatchingEngine:
    def __init__(
        self,
        model: MoondreamModel,
        n_slots: int = 8,
        slot_len: int = 1024,
        chunk: int = 8,
        temperature: float = 0.0,
        top_p: float = 0.0,
        pipeline_depth: int = 1,
        speculative: int = 0,
        spec_adaptive: float = 0.0,
        variants: Optional[Dict[str, Any]] = None,
        eos_id: Optional[int] = None,
        prefix_share: bool = False,
        prefix_entries: Optional[int] = None,
    ):
        """`pipeline_depth` > 1 dispatches chunk i+1 before reading chunk
        i's tokens back, so the device does not wait on the host's
        callbacks; results and streams lag one chunk and a request's tail
        may cost depth-1 idle chunks.

        `prefix_share`: slots hold only the SUFFIX (prompt and generated
        tokens past the [BOS, image] prefix); each distinct EncodedImage
        holds ONE shared read-only prefix entry (of `prefix_entries`,
        default n_slots), so N requests on one encode store its 730-token
        image KV once and admission copies only the prompt suffix.

        `eos_id`: overrides the tokenizer's (-1 forces fixed-length
        generation, for timing)."""
        if speculative or spec_adaptive:
            raise _not_ported("speculative serving")
        if variants:
            raise _not_ported("multi-variant (LoRA) serving")
        tc = model.config.text
        if tc.n_kv_heads != tc.n_heads:
            raise ValueError(
                f"ContinuousBatchingEngine needs an MHA text config, got "
                f"n_kv_heads {tc.n_kv_heads} < n_heads {tc.n_heads}: the ragged "
                "pool decode is MHA only"
            )
        self.model = model
        self.config = model.config.text
        self.eos_id = model.config.tokenizer.eos_id if eos_id is None else eos_id
        self.n_slots = n_slots
        self.slot_len = min(slot_len, self.config.max_context)
        self.chunk = chunk
        self.temperature = temperature
        self.top_p = top_p
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._inflight: List[Any] = []
        dev = model.device

        self.prefix_share = bool(prefix_share)
        self.prefix_len = 0
        self.kv_pref: Optional[KVCache] = None
        self.pids: Optional[torch.Tensor] = None
        if self.prefix_share:
            self.prefix_len = int(self.config.prefix_attn)  # BOS + image
            if self.slot_len <= self.prefix_len:
                raise ValueError(
                    f"slot_len {self.slot_len} must exceed the image "
                    f"prefix ({self.prefix_len}) under prefix_share"
                )
            pad = lambda n: -(-n // 128) * 128
            self._suffix_slots = pad(self.slot_len - self.prefix_len)
            n_pref = int(prefix_entries) if prefix_entries else n_slots
            self.kv_pref = KVCache.create(
                self.config, n_pref, model.dtype, dev, pad(self.prefix_len)
            )
            self.pids = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
            self._pref_refs = [0] * n_pref
            self._pref_pid_of: Dict[int, int] = {}  # id(enc) -> pid
            self._pref_enc: List[Optional[EncodedImage]] = [None] * n_pref
        else:
            self._suffix_slots = self.slot_len
        self.kv = KVCache.create(
            self.config, n_slots, model.dtype, dev, self._suffix_slots
        )
        S = n_slots
        self.cur = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((S,), dtype=torch.bool, device=dev)
        self.budget = torch.zeros((S,), dtype=torch.int32, device=dev)
        # per-slot sampling settings; once a request overrides the pool's,
        # chunks take these (S,) rows (greedy rows stay exact), until then
        # the pool's floats keep the greedy fast path (no vocabulary sort)
        self.temp_row = torch.full((S,), float(temperature), device=dev)
        self.topp_row = torch.full((S,), float(top_p), device=dev)
        self._row_overrides = False
        # sampled rows draw from the pool's own generator (the JAX engine
        # starts from PRNGKey(0))
        self.generator = torch.Generator(device=dev).manual_seed(0)

        self.slots = [_Slot() for _ in range(S)]
        self._slot_pid: List[Optional[int]] = [None] * S
        self.results: Dict[int, str] = {}
        self.token_counts: Dict[int, int] = {}  # per finished request
        self._next_req = 0

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    # ------------------------------------------------- prefix-shared image KV
    def _acquire_prefix(self, enc: EncodedImage) -> int:
        """The shared prefix entry holding `enc`'s [BOS, image] KV, written
        into a free entry on first sight. Keyed by object identity, so
        requests submitted with one EncodedImage share one entry. Raises
        when every entry is held by an active slot."""
        if enc.pos != self.prefix_len:
            raise ValueError(
                f"EncodedImage prefill spans {enc.pos} positions but the "
                f"pool's shared prefix is {self.prefix_len} "
                "(config.text.prefix_attn)"
            )
        pid = self._pref_pid_of.get(id(enc))
        if pid is not None:
            self._pref_refs[pid] += 1
            return pid
        free = [i for i, r in enumerate(self._pref_refs) if r == 0]
        if not free:
            raise RuntimeError(
                f"prefix pool exhausted: all {len(self._pref_refs)} "
                "entries held by active slots; raise prefix_entries "
                "(default n_slots) or drain first"
            )
        pid = free[0]
        old = self._pref_enc[pid]
        if old is not None:
            self._pref_pid_of.pop(id(old), None)
        serving.write_slot(self.kv_pref, enc.as_cache(), pid)
        self._pref_pid_of[id(enc)] = pid
        self._pref_enc[pid] = enc  # keeps id(enc) from being reused
        self._pref_refs[pid] = 1
        return pid

    def _release_prefix(self, slot: int) -> None:
        """Drop `slot`'s hold on its prefix entry. Entries stay mapped at
        refcount 0, so a later request on the same encode hits them; they
        are evicted lazily by _acquire_prefix."""
        pid = self._slot_pid[slot]
        if pid is None:
            return
        self._slot_pid[slot] = None
        self._pref_refs[pid] = max(0, self._pref_refs[pid] - 1)

    # --------------------------------------------------------------- public
    def submit(
        self,
        image,
        question: Optional[str] = None,
        caption_length: str = "normal",
        max_tokens: int = DEFAULT_MAX_TOKENS,
        on_text=None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        variant: Optional[str] = None,
    ) -> int:
        """Admit one request (caption by default, VQA with `question`).
        `image`: an image or an EncodedImage to reuse. Raises RuntimeError
        when no slot is free: step() first. `temperature`/`top_p`: this
        request's sampling (default: the pool's). `on_text(req_id, chunk)`:
        streaming callback, called from step() with word-boundary-safe
        text, as the single-stream API flushes it."""
        if not self.free_slots():
            raise RuntimeError("no free slot; step() or drain() first")
        prep = self.prepare(
            image, question=question, caption_length=caption_length,
            temperature=temperature, top_p=top_p, variant=variant,
        )
        return self.admit_prepared(prep, max_tokens=max_tokens, on_text=on_text)

    def prepare(
        self,
        image,
        question: Optional[str] = None,
        caption_length: str = "normal",
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        variant: Optional[str] = None,
    ) -> PreparedRequest:
        """Encode and prefill a request without touching the pool's state.
        Calls must be serialised among themselves and with other use of the
        model; the PreparedRequest holds a model buffer: admit or release
        it."""
        if variant is not None:
            raise _not_ported("multi-variant (LoRA) serving")
        model = self.model
        tok_cfg = model.config.tokenizer
        temp = self.temperature if temperature is None else temperature
        topp = self.top_p if top_p is None else top_p
        enc = model.encode_image(image)
        kv1 = model.load_encoded_image(enc, slots=self.slot_len)
        if question is None:
            prompt = list(tok_cfg.templates["caption"][caption_length])
        else:
            t = tok_cfg.templates["query"]
            prompt = list(t["prefix"]) + model._encode_text(question) + list(t["suffix"])
        _, _, next_token, pos, kv1 = model._prefill_prompt(kv1, prompt, enc.pos, temp, topp)
        return PreparedRequest(kv1, next_token, pos, prompt, temp, topp, enc=enc)

    def admit_prepared(
        self, prep: PreparedRequest, max_tokens: int = DEFAULT_MAX_TOKENS,
        on_text=None,
    ) -> int:
        """Move a PreparedRequest into a free slot (one slot write). Raises
        RuntimeError when no slot is free (the request stays valid for a
        retry) and ValueError when it was already admitted or released."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot; step() or drain() first")
        if prep.released:
            raise ValueError("PreparedRequest was already admitted/released")
        prep.released = True  # _admit consumes (or recycles) the buffer
        return self._admit(
            prep.kv1, prep.next_token, prep.pos, free[0], max_tokens, on_text,
            prep.temperature, prep.top_p, prep.enc,
        )

    def release_prepared(self, prep: PreparedRequest) -> None:
        """Return an unadmitted request's buffer to the model (idempotent)."""
        if not prep.released:
            prep.released = True
            self.model._recycle_kv(prep.kv1)

    def _admit(
        self, kv1: KVCache, next_token: torch.Tensor, pos: int, slot: int,
        max_tokens: int, on_text, temperature: float, top_p: float,
        enc: Optional[EncodedImage],
    ) -> int:
        """Copy a prefilled request into `slot` and arm it. Rejects prompts
        that leave no room to generate; clamps the budget so decode never
        writes past the slot."""
        model = self.model
        if pos + 1 > self.slot_len:
            model._recycle_kv(kv1)
            raise ValueError(
                f"prompt occupies {pos} KV positions but slot_len is "
                f"{self.slot_len}; no room to generate. Size slot_len >= "
                "prompt length (image is 730 tokens) + expected output."
            )
        budget = min(max_tokens, self.slot_len - pos)
        if self.prefix_share:
            if enc is None:
                raise ValueError("prefix_share pools need the request's EncodedImage")
            pid = self._acquire_prefix(enc)
            try:
                # only the prompt SUFFIX is copied into the slot; the image
                # prefix is the shared entry
                suf = max(pos - self.prefix_len, 1)
                span = min(-(-suf // 128) * 128, self._suffix_slots)
                serving.write_slot(
                    self.kv, slice_cache_span_from(kv1, self.prefix_len, span), slot
                )
            except Exception:
                self._pref_refs[pid] = max(0, self._pref_refs[pid] - 1)
                model._recycle_kv(kv1)
                raise
            self._slot_pid[slot] = pid
            self.pids[slot] = pid
        else:
            span = min(model._kv_bound(pos) or self.config.max_context, self.slot_len)
            serving.write_slot(self.kv, slice_cache_span(kv1, span), slot)
        model._recycle_kv(kv1)

        req_id = self._next_req
        self._next_req += 1
        streamer = TokenStreamer(model._decode_tokens) if on_text is not None else None
        self.slots[slot] = _Slot(
            req_id=req_id, tokens=[], active=True, on_text=on_text, streamer=streamer
        )
        self.temp_row[slot] = temperature
        self.topp_row[slot] = top_p
        if temperature != self.temperature or top_p != self.top_p:
            self._row_overrides = True
        self.cur[slot] = next_token
        self.pos[slot] = pos
        self.active[slot] = True
        self.budget[slot] = budget
        return req_id

    def step(self) -> List[int]:
        """Advance all active slots by one chunk. Returns the req_ids that
        finished (with pipeline_depth > 1, a chunk late)."""
        have_active = any(s.active for s in self.slots)
        if have_active:
            self._dispatch_chunk()
        if self._inflight and (
            len(self._inflight) >= self.pipeline_depth or not have_active
        ):
            return self._process_oldest()
        return []

    def _dispatch_chunk(self) -> None:
        """Enqueue one chunk on the device state and start copying its
        tokens to the host; nothing waits for the device here."""
        if self._row_overrides:
            temp, topp = self.temp_row, self.topp_row
        else:
            temp, topp = self.temperature, self.top_p
        res = serving.serve_chunk(
            self.model.text, self.kv, self.cur, self.pos, self.active,
            self.budget, self.generator, temp, topp, self.kv_pref, self.pids,
            eos_id=self.eos_id,
            suppress_ids=(self.model.config.tokenizer.answer_id,),
            chunk=self.chunk, kv_bound=self._suffix_slots,
            prefix_len=self.prefix_len,
        )
        self.cur, self.pos = res.cur, res.pos
        self.active, self.budget = res.active, res.budget
        # ONE host transfer per chunk: tokens, emitted flags and the active
        # rows packed into one int32 tensor, copied without blocking
        packed = torch.cat(
            [res.tokens, res.emitted.to(torch.int32), res.active.to(torch.int32)[:, None]],
            dim=1,
        )
        if packed.is_cuda:
            host = packed.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = packed, None
        # who owned each row at dispatch: a cancel and resubmit while this
        # chunk is in flight hands the slot to a new req_id, which must not
        # be credited with the old rows
        owners = {i: s.req_id for i, s in enumerate(self.slots) if s.active}
        self._inflight.append((host, done, owners))

    def _process_oldest(self) -> List[int]:
        host, done, owners = self._inflight.pop(0)
        if done is not None:
            done.synchronize()
        rows = host.tolist()
        c = self.chunk
        finished = []
        for i, slot in enumerate(self.slots):
            if not slot.active or owners.get(i) != slot.req_id:
                continue
            toks, emitted, still_active = rows[i][:c], rows[i][c:2 * c], rows[i][2 * c]
            new = [t for t, e in zip(toks, emitted) if e]
            slot.tokens.extend(new)
            if slot.on_text is not None:
                for t in new:
                    text = slot.streamer.feed(t)
                    if text:
                        slot.on_text(slot.req_id, text)
            if not still_active:
                self._retire(i)
                finished.append(slot.req_id)
        self._trim_history()
        return finished

    def _retire(self, i: int) -> None:
        """Mark slot i done: release its prefix, flush its stream, record
        its text."""
        slot = self.slots[i]
        slot.active = False
        self._release_prefix(i)
        if slot.on_text is not None:
            tail = slot.streamer.finish()
            if tail:
                slot.on_text(slot.req_id, tail)
        self.results[slot.req_id] = "".join(
            stream_text(slot.tokens, self.model._decode_tokens)
        )
        self.token_counts[slot.req_id] = len(slot.tokens)

    def _trim_history(self) -> None:
        while len(self.results) > RESULTS_CAP:
            self.results.pop(next(iter(self.results)))
        while len(self.token_counts) > RESULTS_CAP:
            self.token_counts.pop(next(iter(self.token_counts)))

    def cancel(self, req_id: int) -> bool:
        """Cancel an active request: its slot frees at once and the text
        decoded so far becomes its result. False when the request is not
        active (finished or unknown)."""
        for i, slot in enumerate(self.slots):
            if slot.active and slot.req_id == req_id:
                self.active[i] = False
                self._retire(i)
                self._trim_history()
                return True
        return False

    def drain(self) -> Dict[int, str]:
        """Step until every admitted request completes; returns all results
        so far."""
        while any(s.active for s in self.slots) or self._inflight:
            self.step()
        return dict(self.results)
