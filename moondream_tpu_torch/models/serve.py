"""ContinuousBatchingEngine: the host-side scheduler over the slot pool
(moondream_tpu/models/serve.py).

Requests with different images, prompts and lengths are admitted whenever
a slot is free, prefilled one by one, and advanced together by fused
ragged decode chunks (engine/serving.py). One device-to-host transfer per
chunk, not per token.

    eng = ContinuousBatchingEngine(model, n_slots=8)
    r1 = eng.submit(image1)                          # caption
    r2 = eng.submit(image2, question="What is it?")  # VQA
    r3 = eng.submit_detect(image3, "person")         # boxes
    results = eng.drain()     # {req_id: text, or {"objects": [...]} for r3}

`slot_len` bounds prompt + generated tokens per request; an encoded image
alone occupies 730 KV positions, so slot_len must cover image + question
+ expected output. Submissions whose prompt already fills the slot raise
ValueError; token budgets are clamped to the room left in the slot.

Detect, point and gaze requests (`submit_detect`, `submit_point`,
`submit_gaze`) share the pool with text requests through the mixed chunks;
`speculative=k` drafts and verifies k tokens per slot and iteration, also
beside structured rows in a greedy pool.

`submit_many` admits a burst of requests over one batched image encode.

LoRA variants: `ContinuousBatchingEngine(model, variants={name: tree})`
serves base rows and rows of different adapters in one pool, each row
through its own adapter in every text forward; requests pick one with
`variant=name`:

    eng = ContinuousBatchingEngine(model, variants={"a": tree_a, "b": tree_b})
    r4 = eng.submit(image4, variant="a")

A GQA text config (n_kv_heads < n_heads) is refused: the pool's ragged
decode is MHA only, as in the JAX package
(moondream_tpu/ops/attention.py:608).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..engine import graphs, serving
from ..lora import stack_variant_pytrees
from ..utils.streaming import TokenStreamer, stream_text
from .moondream import EncodedImage, MoondreamModel, _prompt_pad
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
    structured: Optional[str] = None  # None (text), "detect", "point" or "gaze"


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
    # structured requests carry their state machine's start
    structured: Optional[str] = None  # "detect", "point" or "gaze"
    hidden: Optional[torch.Tensor] = None  # the prompt's last hidden state
    include_size: bool = False
    n_objects: int = 0
    vid: int = 0  # the request's LoRA variant in the pool (0: the base weights)


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
        max_objects: int = 50,
        variants: Optional[Dict[str, Any]] = None,
        eos_id: Optional[int] = None,
        prefix_share: bool = False,
        prefix_entries: Optional[int] = None,
        graphed: bool = True,
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
        generation, for timing).

        `speculative=k`: each chunk iteration drafts k-1 tokens per slot
        from its own history, verifies them in one ragged span forward and
        advances each slot by 1..k tokens; greedy pools emit the plain
        chunks' tokens, sampled pools draw by the rejection test against
        each row's nucleus (the same distribution). Budgets are clamped k
        tokens earlier so that every span fits its slot. `spec_adaptive`:
        when > 0, speculation turns off for the engine's life once the
        accept rate (`spec_accept_rate`) is below it after 8 spec chunks.

        `max_objects`: the most objects a detect or point request may ask
        for (the size of each slot's box buffer).

        `variants`: multi-variant (LoRA) serving, {name: stacked adapter
        tree} (`lora.variant_state_dict`'s layout). A request picks one by
        name (`variant=` on every submission and prepare; None is the base
        weights) and decodes through it beside base rows and rows of other
        adapters in the same chunks: each row adds its own adapter's
        low-rank residual in every text forward (the [BOS, image] and
        prompt prefills, every decode step, verify span and structured
        step), on every base format and chunk kind. The adapters are
        stacked once (`lora.stack_variant_pytrees`) on the model's device
        in its dtype: variant 0 the all-zeros base, ranks zero-padded to
        the widest. An unknown name raises KeyError, also in a pool built
        without variants.

        On the card every chunk (plain, speculative greedy and sampled,
        mixed, mixed speculative) replays a CUDA graph, one per (kind,
        chunk, spec_k, max_objects, sampling) of this pool, captured at its
        first chunk (engine/graphs.py; `spec_adaptive` falls back to the
        plain chunk's graph); `graphed=False` runs them eagerly, for
        comparison."""
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
        self.spec_k = max(0, int(speculative))
        self.spec_adaptive = float(spec_adaptive)
        self._spec_tokens = 0  # tokens emitted by spec chunks
        self._spec_slot_iters = 0  # active slots x iterations of spec chunks
        self._spec_chunks = 0
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
                model.cache_config, n_pref, model.dtype, dev, pad(self.prefix_len)
            )
            self.pids = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
            self._pref_refs = [0] * n_pref
            self._pref_pid_of: Dict[int, int] = {}  # id(enc) -> pid
            self._pref_enc: List[Optional[EncodedImage]] = [None] * n_pref
        else:
            self._suffix_slots = self.slot_len
        # the slots this process computes: all of them here, a dp group's
        # share in a sharded pool (parallel.serving)
        lo, hi = self._slot_range(n_slots)
        self.kv = KVCache.create(
            model.cache_config, hi - lo, model.dtype, dev, self._suffix_slots
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
        # sticky once any request samples: routes spec chunks to the
        # sampled form and a pool with structured rows to the plain mixed one
        self._sampling_used = temperature > 0
        # sampled rows draw from the pool's own generator (the JAX engine
        # starts from PRNGKey(0))
        self.generator = torch.Generator(device=dev).manual_seed(0)
        # per-slot LoRA variants: each variant's own tree (the prefills run
        # it unpadded, as JAX's do, so a prefill is the single-stream one;
        # `.to` copies only a tree on another device or dtype), the stacked
        # factors of the chunks (leaves (L, V + 1, r, d), variant 0 the zero
        # base), name -> index, and each slot's index, written in place (a
        # chunk's graph reads it where it is)
        to_model = lambda t: t.to(device=dev, dtype=model.dtype)
        self._variants: Dict[str, dict] = {
            name: {grp: {site: {f: to_model(t) for f, t in pair.items()}
                         for site, pair in sites.items()} for grp, sites in tree.items()}
            for name, tree in (variants or {}).items()}
        self._vid_of: Dict[str, int] = {name: i + 1 for i, name in enumerate(self._variants)}
        self._loras = (stack_variant_pytrees(list(self._variants.values()))
                       if self._variants else None)
        self.vid = torch.zeros((S,), dtype=torch.int32, device=dev)
        if self.spec_k:
            # per-slot draft histories, plus the spare column of the chunks'
            # masked writes (engine.serving._put)
            self.hist = torch.zeros((S, self.slot_len + 1), dtype=torch.int32, device=dev)
            self.hist_cnt = torch.zeros((S,), dtype=torch.int32, device=dev)
        # structured rows' state machine (engine.serving._StructState),
        # allocated up front so that structured and text requests mix freely
        self.max_objects = int(max_objects)
        self.mode = torch.zeros((S,), dtype=torch.int32, device=dev)  # MODE_TEXT
        self.hidS = torch.zeros((S, self.config.dim), dtype=model.dtype, device=dev)
        self.pending = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.xbuf = torch.zeros((S,), dtype=torch.float32, device=dev)
        self.ybuf = torch.zeros((S,), dtype=torch.float32, device=dev)
        self.sboxes = torch.zeros((S, self.max_objects, 4), dtype=torch.float32, device=dev)
        self.nobj = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.is_box = torch.zeros((S,), dtype=torch.bool, device=dev)

        self.graphs = graphs.GraphCache() if graphed and graphs.enabled(dev) else None
        self.slots = [_Slot() for _ in range(S)]
        self._slot_pid: List[Optional[int]] = [None] * S
        self.results: Dict[int, str] = {}
        self.token_counts: Dict[int, int] = {}  # per finished request
        self._next_req = 0

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    # ------------------------------------------- the slots this process runs
    # A sharded pool (parallel.serving.ShardedBatchingEngine) overrides these
    # four: its KV cache holds its dp group's slots only, its chunks run
    # their rows and gather every slot's results.
    def _slot_range(self, n_slots: int):
        """[lo, hi): the slots whose KV this process holds and computes."""
        return 0, n_slots

    def _rows(self, t):
        """A per-slot (S, ...) tensor's rows that this process's chunks run."""
        return t

    def _gather(self, res: "serving.ServeChunkResult",
                mixed: bool) -> "serving.ServeChunkResult":
        """Every slot's results of a chunk that ran `_rows`."""
        return res

    def _write_slot(self, snap: KVCache, slot: int) -> None:
        """Copy a prefilled request's KV into pool slot `slot`."""
        serving.write_slot(self.kv, snap, slot)

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
        it. `variant`: a name given to the constructor, or None."""
        lora, vid = self._resolve_variant(variant)
        prompt = self._text_prompt(question, caption_length)
        temp, topp = self._sampling(temperature, top_p)
        enc = self.encode_for(image, variant)
        return self._prepare_encoded(enc, prompt, temp, topp, lora, vid)

    def encode_for(self, image, variant: Optional[str] = None) -> EncodedImage:
        """The model's EncodedImage of `image` under the named variant (its
        image prefill runs through the adapter; None: the base weights)."""
        lora, _ = self._resolve_variant(variant)
        return self.model.encode_image(image, self._variant_settings(lora, variant))

    def _resolve_variant(self, variant: Optional[str]):
        """A variant's name -> (its adapter tree, its index in the pool);
        (None, 0) for None. An unknown name raises KeyError naming the
        registered ones (moondream_tpu/models/serve.py:471-480)."""
        if variant is None:
            return None, 0
        if variant not in self._variants:
            raise KeyError(
                f"unknown variant {variant!r}; registered: {sorted(self._variants)}"
            )
        return self._variants[variant], self._vid_of[variant]

    @staticmethod
    def _variant_settings(lora: Optional[dict], variant: Optional[str]):
        """The encode settings of a request under `lora`: the image prefill
        runs through the adapter, and the EncodedImage carries its label (a
        pre-encoded image of another label raises ValueError)."""
        if lora is None:
            return None
        return {"variant_tree": lora, "variant_label": variant}

    def _text_prompt(self, question: Optional[str], caption_length: str) -> List[int]:
        """A caption prompt, or a query prompt around `question`."""
        tok_cfg = self.model.config.tokenizer
        if question is None:
            return list(tok_cfg.templates["caption"][caption_length])
        t = tok_cfg.templates["query"]
        return list(t["prefix"]) + self.model._encode_text(question) + list(t["suffix"])

    def _sampling(self, temperature: Optional[float], top_p: Optional[float]):
        """A request's (temperature, top_p): its own, else the pool's."""
        return (self.temperature if temperature is None else temperature,
                self.top_p if top_p is None else top_p)

    def _prepare_encoded(self, enc: EncodedImage, prompt: List[int], temp: float,
                         topp: float, lora: Optional[dict], vid: int) -> PreparedRequest:
        """Prefill `prompt` after an encoded image on a single-row buffer,
        under the adapter `lora` (variant `vid`) when given."""
        kv1 = self._prefill_buffer(enc, len(prompt))
        _, _, next_token, pos, kv1 = self.model._prefill_prompt(kv1, prompt, enc.pos, temp, topp,
                                                                lora=lora)
        return PreparedRequest(kv1, next_token, pos, prompt, temp, topp, enc=enc, vid=vid)

    def submit_many(
        self,
        images,
        question: Optional[str] = None,
        caption_length: str = "normal",
        max_tokens: int = DEFAULT_MAX_TOKENS,
        on_text=None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        variant: Optional[str] = None,
    ) -> List[int]:
        """Admit a burst of requests with one prompt kind over ONE batched
        image encode (`encode_images`) instead of one ViT call each
        (moondream_tpu/models/serve.py:626-678); each is then prefilled and
        admitted as `submit` does. Raises RuntimeError when fewer slots are
        free than there are images. Every request of the burst runs under
        `variant`. Returns the req_ids in image order."""
        lora, vid = self._resolve_variant(variant)
        images = list(images)
        free = self.free_slots()
        if len(free) < len(images):
            raise RuntimeError(f"{len(images)} requests but only {len(free)} free slots")
        prompt = self._text_prompt(question, caption_length)
        temp, topp = self._sampling(temperature, top_p)
        encs = self.model.encode_images(images, settings=self._variant_settings(lora, variant))
        return [self.admit_prepared(self._prepare_encoded(enc, prompt, temp, topp, lora, vid),
                                    max_tokens=max_tokens, on_text=on_text)
                for enc in encs]

    def _prefill_buffer(self, enc: EncodedImage, prompt_len: int) -> KVCache:
        """A single-row buffer holding `enc` with room for the prompt's
        padded prefill: slot_len slots, more when the padded prompt runs
        past them (admission then refuses the request with a ValueError)."""
        end = enc.pos + _prompt_pad(prompt_len)
        return self.model.load_encoded_image(enc, slots=max(self.slot_len, end))

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
        slot = free[0]
        if prep.structured is None:
            return self._admit(
                prep.kv1, prep.next_token, prep.pos, slot, max_tokens, on_text,
                prep.prompt, prep.temperature, prep.top_p, prep.enc, prep.vid,
            )
        # a structured row's budget: every object's steps and two more
        steps = (3 if prep.include_size else 2) * prep.n_objects + 2
        req_id = self._admit(prep.kv1, prep.next_token, prep.pos, slot, steps, None,
                             prep.prompt, 0.0, 0.0, prep.enc, prep.vid)
        # its state machine starts at XN from the prompt's hidden state and token
        self.slots[slot].structured = prep.structured
        self.mode[slot] = serving.MODE_XN
        self.hidS[slot] = prep.hidden.reshape(-1)[-self.config.dim:]
        self.pending[slot] = prep.next_token
        self.nobj[slot] = 0
        self.is_box[slot] = bool(prep.include_size)
        return req_id

    def release_prepared(self, prep: PreparedRequest) -> None:
        """Return an unadmitted request's buffer to the model (idempotent)."""
        if not prep.released:
            prep.released = True
            self.model._recycle_kv(prep.kv1)

    def _admit(
        self, kv1: KVCache, next_token: torch.Tensor, pos: int, slot: int,
        max_tokens: int, on_text, prompt: List[int], temperature: float, top_p: float,
        enc: Optional[EncodedImage], vid: int,
    ) -> int:
        """Copy a prefilled request into `slot` and arm it. Rejects prompts
        that leave no room to generate; clamps the budget so decode never
        writes past the slot: speculative verify spans write spec_k rows
        from the slot's position, so with speculation on the budget keeps
        pos + budget + spec_k within the slot."""
        model = self.model
        margin = self.spec_k
        if pos + 1 + margin > self.slot_len:
            model._recycle_kv(kv1)
            raise ValueError(
                f"prompt occupies {pos} KV positions but slot_len is "
                f"{self.slot_len}; no room to generate"
                + (f" (speculative margin {margin})" if margin else "")
                + ". Size slot_len >= prompt length (image is 730 tokens) + "
                "expected output."
            )
        budget = min(max_tokens, self.slot_len - pos - margin)
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
            self._write_slot(slice_cache_span(kv1, span), slot)
        model._recycle_kv(kv1)

        req_id = self._next_req
        self._next_req += 1
        streamer = TokenStreamer(model._decode_tokens) if on_text is not None else None
        self.slots[slot] = _Slot(
            req_id=req_id, tokens=[], active=True, on_text=on_text, streamer=streamer
        )
        # a text row; admit_prepared turns structured ones over afterwards
        # (else a text request would inherit a structured one's mode)
        self.mode[slot] = serving.MODE_TEXT
        self.vid[slot] = vid
        self.temp_row[slot] = temperature
        self.topp_row[slot] = top_p
        if temperature > 0:
            self._sampling_used = True
        if temperature != self.temperature or top_p != self.top_p:
            self._row_overrides = True
        self.cur[slot] = next_token
        self.pos[slot] = pos
        self.active[slot] = True
        self.budget[slot] = budget
        if self.spec_k:
            # the prompt's tail seeds the slot's draft history (prompt
            # lookup: answers that copy from the question draft from it)
            seed = list(prompt)[-(self.slot_len // 2):]
            row = torch.zeros((self.slot_len + 1,), dtype=torch.int32)
            row[:len(seed)] = torch.tensor(seed, dtype=torch.int32)
            self.hist[slot] = row.to(self.hist.device, non_blocking=True)
            self.hist_cnt[slot] = len(seed)
        return req_id

    def submit_detect(self, image, object: str, max_objects: Optional[int] = None,
                      variant: Optional[str] = None) -> int:
        """Admit a detect request (boxes of `object`) into the pool beside
        text requests; its result is {"objects": [{x_min, y_min, x_max,
        y_max}, ...]}, as `MoondreamModel.detect` gives."""
        return self._submit_structured(image, object, "detect", True, max_objects, variant)

    def submit_point(self, image, object: str, max_objects: Optional[int] = None,
                     variant: Optional[str] = None) -> int:
        """Admit a point request; its result is {"points": [{x, y}, ...]}, as
        `MoondreamModel.point` gives."""
        return self._submit_structured(image, object, "point", False, max_objects, variant)

    def submit_gaze(self, image, eye, force_detect: bool = False,
                    variant: Optional[str] = None) -> int:
        """Admit a gaze request for the eye at `eye` (x, y): the gaze prompt
        is prefilled once, then its one point rides the mixed chunks. The
        result is {"gaze": {"x", "y"} or None}, as `MoondreamModel.
        detect_gaze` gives in eye mode."""
        if not self.free_slots():
            raise RuntimeError("no free slot; step() or drain() first")
        return self.admit_prepared(self.prepare_gaze(image, eye, force_detect, variant))

    def prepare_gaze(self, image, eye, force_detect: bool = False,
                     variant: Optional[str] = None) -> PreparedRequest:
        """Encode and prefill a gaze request without touching the pool (the
        same contract as prepare()), under `variant` as prepare() takes
        it."""
        lora, vid = self._resolve_variant(variant)
        model = self.model
        enc = model.encode_image(image, self._variant_settings(lora, variant))
        embeds, length = model._gaze_embeds([tuple(eye)])
        kv1 = self._prefill_buffer(enc, length)
        hidden, next_token, pos = model._gaze_prefill(kv1, enc.pos, embeds, length, lora=lora)
        if force_detect:
            next_token = torch.zeros_like(next_token)
        return PreparedRequest(kv1, next_token, pos, [], 0.0, 0.0, enc=enc,
                               structured="gaze", hidden=hidden, n_objects=1, vid=vid)

    def _submit_structured(self, image, object: str, template_key: str,
                           include_size: bool, max_objects: Optional[int],
                           variant: Optional[str] = None) -> int:
        if not self.free_slots():
            raise RuntimeError("no free slot; step() or drain() first")
        return self.admit_prepared(self.prepare_structured(
            image, object, template_key, include_size, max_objects, variant))

    def prepare_structured(self, image, object: str, template_key: str,
                           include_size: bool, max_objects: Optional[int] = None,
                           variant: Optional[str] = None) -> PreparedRequest:
        """Encode and prefill a detect (`template_key` "detect", with
        sizes) or point request without touching the pool (the same
        contract as prepare()), under `variant` as prepare() takes it.
        Raises ValueError when `max_objects` exceeds the pool's."""
        lora, vid = self._resolve_variant(variant)
        n_obj = self.max_objects if max_objects is None else int(max_objects)
        if n_obj > self.max_objects:
            raise ValueError(
                f"max_objects={n_obj} exceeds the pool's max_objects="
                f"{self.max_objects} (set at engine construction)"
            )
        model = self.model
        prompt = model._structured_prompt(template_key, object)
        enc = model.encode_image(image, self._variant_settings(lora, variant))
        kv1 = self._prefill_buffer(enc, len(prompt))
        _, hidden, next_token, pos, kv1 = model._prefill_prompt(kv1, prompt, enc.pos, 0.0, 0.0,
                                                                lora=lora)
        return PreparedRequest(kv1, next_token, pos, prompt, 0.0, 0.0, enc=enc,
                               structured=template_key, hidden=hidden,
                               include_size=include_size, n_objects=n_obj, vid=vid)

    def step(self, launch_lock=None) -> List[int]:
        """Advance all active slots by one chunk. Returns the req_ids that
        finished (with pipeline_depth > 1, a chunk late). `launch_lock`: a
        lock held while the chunk is launched (or its graph captured) and
        not while the host waits for an earlier chunk's tokens (a server
        passes `graphs.lock()`, which its other threads hold while they
        launch)."""
        have_active = any(s.active for s in self.slots)
        if have_active:
            with launch_lock if launch_lock is not None else contextlib.nullcontext():
                self._dispatch_chunk()
        if self._inflight and (
            len(self._inflight) >= self.pipeline_depth or not have_active
        ):
            return self._process_oldest()
        return []

    def _dispatch_chunk(self) -> None:
        """Enqueue one chunk on the device state and start copying its
        results to the host; nothing waits for the device here. Five chunks
        (moondream_tpu/models/serve.py:791-876): with structured rows
        active, the mixed chunk, speculative in a greedy pool (a sampled
        pool with structured rows takes the plain mixed chunk: its text rows
        do not draft meanwhile); otherwise the speculative chunk, sampled
        once any request sampled, or the plain one."""
        if self._row_overrides:
            temp, topp = self.temp_row, self.topp_row
        else:
            temp, topp = self.temperature, self.top_p
        use_mixed = any(s.active and s.structured for s in self.slots)
        use_mixed_spec = use_mixed and self.spec_k and not self._sampling_used
        was_spec = bool(self.spec_k) and (not use_mixed or use_mixed_spec)
        if use_mixed_spec:
            res = self._chunk("serve_chunk_mixed_spec", temp, topp)
        elif use_mixed:
            res = self._chunk("serve_chunk_mixed", temp, topp)
        elif self.spec_k and self._sampling_used:
            res = self._chunk("serve_chunk_spec_sampled", temp, topp)
        elif self.spec_k:
            res = self._chunk("serve_chunk_spec", temp, topp)
        else:
            res = self._chunk("serve_chunk", temp, topp)
        self.cur, self.pos = res.cur, res.pos
        self.active, self.budget = res.active, res.budget
        if res.hist_cnt is not None:
            self.hist_cnt = res.hist_cnt
        # ONE host transfer per chunk: tokens, emitted flags, the active
        # rows and, after a mixed chunk, the object counts and the boxes
        # (their fp32 bits) packed into one int32 tensor, copied without
        # blocking
        parts = [res.tokens, res.emitted.to(torch.int32), res.active.to(torch.int32)[:, None]]
        if use_mixed:
            parts += [self.nobj[:, None], self.sboxes.flatten(1).view(torch.int32)]
        packed = torch.cat(parts, dim=1)
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
        self._inflight.append((host, done, owners, res.tokens.shape[1], use_mixed, was_spec))

    def _chunk(self, kind: str, temp, topp) -> serving.ServeChunkResult:
        """One chunk of `kind` (a function of engine.serving) on the pool's
        state. On the card it goes through the CUDA graph of its (kind,
        chunk, spec_k, max_objects, sampling), which reads the
        per-chunk inputs (tokens, positions, active rows, budgets and, for
        spec chunks, the history counts) from static copies and whose
        outputs are copied out before the next replay. The draft histories,
        the structured rows' state, the per-row sampling settings and the
        rows' variants are this pool's own buffers, allocated once and
        written in place, so the graph reads and writes them where they
        are."""
        sampled = isinstance(temp, torch.Tensor) or temp > 0
        spec, mixed = "spec" in kind, "mixed" in kind
        text = self.model.text
        region = self.model.region if mixed else None
        kw = dict(eos_id=self.eos_id, suppress_ids=(self.model.config.tokenizer.answer_id,),
                  kv_bound=self._suffix_slots, prefix_len=self.prefix_len,
                  pref=self.kv_pref, pids=self.pids, loras=self._loras, vids=self.vid)
        struct = (self.mode, self.hidS, self.pending, self.xbuf, self.ybuf, self.sboxes,
                  self.nobj, self.is_box)
        if spec:
            kw.update(n_iter=self.chunk, spec_k=self.spec_k)
        else:
            kw.update(chunk=self.chunk)
        if mixed:
            kw.update(max_objects=self.max_objects)

        rows = self._rows
        kw.update(pids=rows(self.pids), vids=rows(self.vid))
        struct = tuple(rows(t) for t in struct)
        hist = rows(self.hist) if spec else None
        sampling = (self.generator, rows(temp) if isinstance(temp, torch.Tensor) else temp,
                    rows(topp) if isinstance(topp, torch.Tensor) else topp)

        def chunk_rows(cur, pos, active, budget, hist_cnt):
            state = (self.kv, cur, pos, active, budget)
            if kind == "serve_chunk":
                return serving.serve_chunk(text, *state, *sampling, **kw)
            if kind == "serve_chunk_spec":
                return serving.serve_chunk_spec(text, *state, hist, hist_cnt, **kw)
            if kind == "serve_chunk_spec_sampled":
                return serving.serve_chunk_spec_sampled(text, *state, hist, hist_cnt,
                                                        *sampling, **kw)
            if kind == "serve_chunk_mixed":
                return serving.serve_chunk_mixed(text, region, *state, *sampling, *struct, **kw)
            return serving.serve_chunk_mixed_spec(text, region, *state, hist, hist_cnt,
                                                  *struct, **kw)

        def run(cur, pos, active, budget, hist_cnt=None):
            return self._gather(chunk_rows(rows(cur), rows(pos), rows(active), rows(budget),
                                           rows(hist_cnt)), mixed)

        inputs = (self.cur, self.pos, self.active, self.budget) + (
            (self.hist_cnt,) if spec else ())
        if self.graphs is None:
            return run(*inputs)
        key = (kind, self.chunk, self.spec_k if spec else None,
               self.max_objects if mixed else None,
               "per row" if isinstance(temp, torch.Tensor) else (temp, topp))
        if graphs.group_key(text) is not None:
            key += (graphs.group_key(text),)
        return graphs.chunk(self.graphs, key, run, inputs, kind,
                            self.generator if sampled else None)

    @property
    def spec_accept_rate(self) -> Optional[float]:
        """Mean tokens emitted per active slot and iteration of the
        speculative chunks (1.0: no draft accepted; spec_k: all accepted;
        below 1.0 when requests end inside a chunk, whose rows count for the
        whole chunk). None before a spec chunk has been read back."""
        if not self._spec_slot_iters:
            return None
        return self._spec_tokens / self._spec_slot_iters

    def _process_oldest(self) -> List[int]:
        host, done, owners, width, mixed, was_spec = self._inflight.pop(0)
        if done is not None:
            done.synchronize()
        rows = host.numpy()
        toks, emitted = rows[:, :width], rows[:, width:2 * width].astype(bool)
        still_active = rows[:, 2 * width]
        if mixed:
            nobj = rows[:, 2 * width + 1]
            boxes = np.ascontiguousarray(rows[:, 2 * width + 2:]).view(np.float32)
            boxes = boxes.reshape(len(rows), self.max_objects, 4)
        if was_spec and owners:
            self._spec_tokens += int(emitted.sum())
            self._spec_slot_iters += len(owners) * self.chunk
            self._spec_chunks += 1
            if (self.spec_adaptive and self.spec_k and self._spec_chunks >= 8
                    and self.spec_accept_rate < self.spec_adaptive):
                self.spec_k = 0  # plain chunks from here on
        finished = []
        for i, slot in enumerate(self.slots):
            if not slot.active or owners.get(i) != slot.req_id:
                continue
            new = toks[i][emitted[i]].tolist()
            slot.tokens.extend(new)
            if slot.on_text is not None:
                for t in new:
                    text = slot.streamer.feed(t)
                    if text:
                        slot.on_text(slot.req_id, text)
            if not still_active[i]:
                self._retire(i, boxes[i][:nobj[i]] if mixed else None)
                finished.append(slot.req_id)
        self._trim_history()
        return finished

    def _retire(self, i: int, boxes: Optional[np.ndarray] = None) -> None:
        """Mark slot i done: release its prefix, flush its stream, record
        its text, or for a structured row its objects `boxes` (n, 4)."""
        slot = self.slots[i]
        slot.active = False
        self._release_prefix(i)
        if slot.on_text is not None:
            tail = slot.streamer.finish()
            if tail:
                slot.on_text(slot.req_id, tail)
        if slot.structured is not None and boxes is not None:
            self.results[slot.req_id] = self._format_structured(slot.structured, boxes)
            self.token_counts[slot.req_id] = 0
            return
        self.results[slot.req_id] = "".join(
            stream_text(slot.tokens, self.model._decode_tokens)
        )
        self.token_counts[slot.req_id] = len(slot.tokens)

    @staticmethod
    def _format_structured(kind: str, rows) -> dict:
        """A structured row's objects (n, 4) as `detect`, `point` or
        `detect_gaze` format them."""
        if kind == "detect":
            return {"objects": [{"x_min": float(b[0]), "y_min": float(b[1]),
                                 "x_max": float(b[2]), "y_max": float(b[3])} for b in rows]}
        if kind == "gaze":
            if len(rows) == 0:
                return {"gaze": None}
            return {"gaze": {"x": float(rows[0][0]), "y": float(rows[0][1])}}
        return {"points": [{"x": float(b[0]), "y": float(b[1])} for b in rows]}

    def _trim_history(self) -> None:
        while len(self.results) > RESULTS_CAP:
            self.results.pop(next(iter(self.results)))
        while len(self.token_counts) > RESULTS_CAP:
            self.token_counts.pop(next(iter(self.token_counts)))

    def cancel(self, req_id: int) -> bool:
        """Cancel an active request: its slot frees at once and the text
        decoded so far (a structured request: the objects found so far)
        becomes its result. False when the request is not
        active (finished or unknown)."""
        for i, slot in enumerate(self.slots):
            if slot.active and slot.req_id == req_id:
                self.active[i] = False
                boxes = None
                if slot.structured is not None:  # the objects found so far
                    n = int(self.nobj[i])
                    boxes = self.sboxes[i, :n].cpu().numpy()
                self._retire(i, boxes)
                self._trim_history()
                return True
        return False

    def drain(self) -> Dict[int, str]:
        """Step until every admitted request completes; returns all results
        so far."""
        while any(s.active for s in self.slots) or self._inflight:
            self.step()
        return dict(self.results)
