"""Pipelined multi-image engines (moondream_tpu/engine/pipeline.py): a
producer thread overlaps the host's work for the next images with the
card's work for the current ones.

`BatchPipeline` runs lockstep batches of one shared prompt. Its producer
groups each batch's images by (crop count, tiling), puts the raw images
(or, where the crop route says host, their host crops: the native C++
path, which releases the GIL) in pinned host memory and copies them to the
card on a side stream that only copies; it launches no kernel. The
consumer makes its stream wait on the batch's copy event, launches the
crop kernel per group of raw images right before that group's ViT (as the
JAX package's consumer dispatches its crop graph), runs the ViT and the
stitch + projection per group, then ONE
fused [BOS, image, prompt] prefill straight into the decode-sized cache
(no per-image snapshot and reload, as `encode_images` + `caption_batch`
pay) and the lockstep decode loop, plain or speculative
(engine/batched.py). The JAX package dispatches batch i+1's whole device
program before collecting batch i; here the lockstep loops read their
done flag every DONE_CHECK_EVERY steps, so the consumer is busy until its
batch ends, and what overlaps the decode is the next batch's host work
and its copy. `_dispatch` / `_collect` keep JAX's split all the same.

`PooledPipeline` streams images through the continuous-batching pool: the
producer thread runs one `encode_images` per wave and the prompt prefills
(`prepare`) on a stream of its own, under the lock that CUDA graph
captures take (engine/graphs.lock), and hands each wave over with an
event; the main thread admits the prepared requests into free slots and
steps the pool.

Tensors that cross from one stream to the other are marked with
`record_stream`, so the caching allocator does not reuse their memory
while the other stream may still read it; the model's recycled KV buffers
carry an event of the stream that returned them
(MoondreamModel._recycle_kv). A producer error reaches the caller, and
the thread is joined before `run` returns.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models.moondream import _n_crops, _prompt_pad, _refuse_dropped
from ..models.text import text_encoder
from ..utils.streaming import stream_text
from . import batched as batched_engine
from . import graphs


def _side_stream(dev: torch.device) -> Optional[torch.cuda.Stream]:
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


def _record(stream: Optional[torch.cuda.Stream]) -> Optional[torch.cuda.Event]:
    """An event recorded on `stream` (None on the CPU)."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _adopt(event: Optional[torch.cuda.Event], tensors) -> None:
    """Let the current stream use tensors another stream wrote: wait for
    that stream's `event`, and keep the allocator from reusing their memory
    before the current stream is done with them."""
    if event is None:
        return
    cur = torch.cuda.current_stream()
    cur.wait_event(event)
    for t in tensors:
        if t is not None:
            t.record_stream(cur)


def _stop(producer: threading.Thread, stop: threading.Event, work: "queue.Queue",
          release=lambda item: None) -> None:
    """Stop the producer and join it, emptying the queue until it has ended
    (so that it never blocks on a full one), each item it held passed to
    `release`."""
    stop.set()
    while True:
        alive = producer.is_alive()
        while True:
            try:
                item = work.get(timeout=0.01)
            except queue.Empty:
                break
            if item is not None and not isinstance(item, Exception):
                release(item)
        if not alive:
            break
    producer.join()


class _Batch(NamedTuple):
    """One producer -> consumer work item: raw images or host crops on their
    way to the card."""

    # tiling, crops per image, rows, crop segments (MoondreamModel._build_crop_segments)
    groups: List[Tuple[Tuple[int, int], int, List[int], List[Tuple[str, torch.Tensor]]]]
    n_images: int  # real images; the rest pad the tail batch
    copied: Optional[torch.cuda.Event]  # the copy stream's event after the segments' copies


class BatchPipeline:
    def __init__(self, model, batch_size: int = 8, prefetch: int = 2,
                 eos_id: Optional[int] = None, speculative: int = 0):
        """`eos_id=None` uses the model's EOS; benchmarks pass -1 to force
        fixed-length generation. `prefetch`: batches of images that may be in
        flight to the card. `speculative=k` (greedy settings only): decode
        each batch with the lockstep speculative loop
        (batched.generate_text_spec_batched, prompt-seeded histories, the
        plain loop's greedy ids); MHA only: on a GQA model a greedy run
        raises a ValueError. Sampled settings, and a LoRA variant (which the
        speculative loop does not take, as in the JAX package), take the
        plain loop."""
        self.model = model
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.spec_k = max(0, int(speculative))
        self.eos_id = model.config.tokenizer.eos_id if eos_id is None else eos_id

    def caption(self, images, length: str = "normal",
                settings: Optional[Dict[str, Any]] = None) -> List[str]:
        prompt = list(self.model.config.tokenizer.templates["caption"][length])
        return self.run(images, prompt, settings)

    def query(self, images, question: str,
              settings: Optional[Dict[str, Any]] = None) -> List[str]:
        t = self.model.config.tokenizer.templates["query"]
        prompt = list(t["prefix"]) + self.model._encode_text(question) + list(t["suffix"])
        return self.run(images, prompt, settings)

    def run(self, images, prompt_tokens: List[int], settings=None) -> List[str]:
        """Caption or answer every image with ONE shared prompt; returns the
        texts in input order. The tail batch is padded with the last image
        (its padded rows decode, their outputs are dropped), so every batch
        has the same shapes and graph keys. A settings variant applies in
        the fused prefill and the decode loop."""
        _refuse_dropped(settings, "BatchPipeline")
        images = list(images)
        if not images:
            return []
        sampling = self.model._settings(settings)
        lora = self.model._variant(settings)
        work: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        producer = threading.Thread(target=self._produce, args=(images, work, stop),
                                    daemon=True)
        producer.start()
        texts: List[str] = []
        pending = None  # (the dispatched batch's result, its real images)
        try:
            while True:
                item = work.get()
                if isinstance(item, Exception):
                    raise item
                if item is None:
                    break
                res = self._dispatch(item, prompt_tokens, *sampling, lora)
                if pending is not None:
                    texts.extend(self._collect(*pending))
                pending = (res, item.n_images)
            if pending is not None:
                texts.extend(self._collect(*pending))
        finally:
            _stop(producer, stop, work)
        return texts

    def _produce(self, images, work: "queue.Queue", stop: threading.Event) -> None:
        """Each batch's raw images (host crops where the route says host)
        and their copy to the card, batch by batch; no kernel is launched
        here (moondream_tpu/engine/pipeline.py:160-210)."""
        model, bsz = self.model, self.batch_size
        copies = _side_stream(model.device)
        try:
            for start in range(0, len(images), bsz):
                chunk = images[start:start + bsz]
                n_real = len(chunk)
                chunk = chunk + [chunk[-1]] * (bsz - n_real)
                prepped = model._prep_crop_groups(chunk)
                rows: Dict[Tuple[int, Tuple[int, int]], List[int]] = {}
                for i, (item, tiling) in enumerate(prepped):
                    rows.setdefault((_n_crops(item, tiling), tiling), []).append(i)
                groups = []
                with torch.cuda.stream(copies) if copies is not None else contextlib.nullcontext():
                    for (n, tiling), idxs in rows.items():
                        segs = model._build_crop_segments([prepped[i][0] for i in idxs])
                        groups.append((tiling, n, idxs, segs))
                if stop.is_set():
                    return
                work.put(_Batch(groups, n_real, _record(copies)))
            work.put(None)
        except Exception as e:  # raised again by the consumer
            work.put(e)

    def _dispatch(self, batch: _Batch, prompt_tokens: List[int], max_tokens: int,
                  temperature: float, top_p: float, lora: Optional[dict] = None):
        """The batch's ViT per group, ONE fused [BOS, image, prompt]
        prefill into the decode-sized cache, the first tokens and the
        decode loop (moondream_tpu/engine/pipeline.py:190-275). Returns
        (the loop's result, the cache); the tokens stay on the card."""
        model, cfg, bsz = self.model, self.model.config, self.batch_size
        _adopt(batch.copied, [t for *_, segs in batch.groups for _, t in segs])
        img_embs: List[Optional[torch.Tensor]] = [None] * bsz
        for tiling, n, idxs, segs in batch.groups:
            # the crop kernel runs here, on the compute stream right before
            # the group's ViT, never on the producer's copy stream
            crops = model._materialize_crop_segments(segs, tiling)
            for i, emb in zip(idxs, model._embed_group(crops, n, tiling)):
                img_embs[i] = emb

        ids = list(prompt_tokens)
        length = len(ids)
        pad = _prompt_pad(length)
        toks = torch.tensor([cfg.tokenizer.bos_id] + ids + [0] * (pad - length),
                            device=model.device)
        emb = text_encoder(toks, model.text)
        embeds = torch.stack([torch.cat([emb[:1], e, emb[1:]]) for e in img_embs]).to(model.dtype)
        seq = embeds.shape[1] - pad  # [BOS, image]: the attention prefix
        bound = model._decode_bound(seq + pad + max_tokens + 1)
        kv = model._take_kv_buffer(bsz, bound)
        # logits of the last real prompt row; the pad rows' K/V sit past it
        # and are rewritten before anything attends them
        logits, _ = batched_engine.prefill_batched(
            model.text, kv, embeds, 0, seq + length, cfg.text.prefix_attn,
            kv_bound=model._kv_bound(seq + pad), lora=lora)
        first = batched_engine.sample_tokens_batched(logits, model.generator, temperature, top_p)
        suppress = (cfg.tokenizer.answer_id,)
        if self.spec_k and temperature <= 0 and lora is None:
            seed = torch.tensor(ids[-(cfg.text.max_context // 2):], device=model.device)
            res = batched_engine.generate_text_spec_batched(
                model.text, kv, first, seq + length, max_tokens, self.eos_id, suppress,
                self.spec_k, bound, seed.expand(bsz, -1), seed.shape[0], graphed=model.graphed)
        else:
            res = batched_engine.generate_text_batched(
                model.text, kv, first, seq + length, model.generator, temperature, top_p,
                max_tokens, self.eos_id, suppress, kv_bound=bound, graphed=model.graphed,
                lora=lora)
        return res, kv

    def _collect(self, dispatched, n_real: int) -> List[str]:
        """One device-to-host read of the batch's tokens and counts."""
        res, kv = dispatched
        rows = torch.cat([res.counts[:, None], res.tokens], dim=1)[:n_real].tolist()
        self.model._recycle_kv(kv)
        decode = self.model._decode_tokens
        return ["".join(stream_text(r[1:1 + r[0]], decode)) for r in rows]


class PooledPipeline:
    def __init__(self, model, n_slots: int = 16, slot_len: int = 1024, chunk: int = 8,
                 speculative: int = 0, wave: Optional[int] = None, prefetch: int = 1,
                 eos_id: Optional[int] = None, prefix_share: bool = False):
        """Captions or answers through a continuous-batching pool of
        `n_slots` (pipeline_depth 2), with a producer thread encoding and
        prefilling `wave` images at a time (default n_slots // 2) while the
        pool decodes (moondream_tpu/engine/pipeline.py:292-444). `prefetch`:
        prepared waves that may wait for admission; each prepared request
        holds a slot_len cache buffer. Greedy pools give the ids of
        submitting every image to the pool one by one."""
        from ..models.serve import ContinuousBatchingEngine

        self.engine = ContinuousBatchingEngine(
            model, n_slots=n_slots, slot_len=slot_len, chunk=chunk, pipeline_depth=2,
            speculative=speculative, eos_id=eos_id, prefix_share=prefix_share)
        self.wave = max(1, wave if wave is not None else n_slots // 2)
        self.prefetch = prefetch

    def caption(self, images, length: str = "normal",
                settings: Optional[Dict[str, Any]] = None) -> List[str]:
        return self.run(images, question=None, length=length, settings=settings)

    def query(self, images, question: str,
              settings: Optional[Dict[str, Any]] = None) -> List[str]:
        return self.run(images, question=question, settings=settings)

    def run(self, images, question: Optional[str] = None, length: str = "normal",
            settings: Optional[Dict[str, Any]] = None) -> List[str]:
        """Every image's text, in input order. The LoRA variant settings
        are refused: the JAX package's PooledPipeline builds its pool
        without variants and drops them (moondream_tpu/engine/pipeline.py:
        332-336, :354-444), so there is no variant path to match."""
        _refuse_dropped(settings, "PooledPipeline", variants=True)
        eng = self.engine
        model = eng.model
        images = list(images)
        if not images:
            return []
        max_tokens, temperature, top_p = model._settings(settings)
        work: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def release(item):
            preps, prepared = item
            _adopt(prepared, [t for _, p in preps for t in _tensors(p)])
            for _, prep in preps:
                eng.release_prepared(prep)

        def produce():
            stream = _side_stream(model.device)
            on_stream = (torch.cuda.stream(stream) if stream is not None
                         else contextlib.nullcontext())
            try:
                for start in range(0, len(images), self.wave):
                    # no launch of this thread may fall inside a capture of
                    # the pool's chunk graphs (their launch counts and
                    # memory pool are the capturing thread's)
                    with graphs.lock(), on_stream:
                        encs = model.encode_images(images[start:start + self.wave])
                        preps = [(start + j, eng.prepare(enc, question=question,
                                                         caption_length=length,
                                                         temperature=temperature, top_p=top_p))
                                 for j, enc in enumerate(encs)]
                        item = (preps, _record(stream))
                        if stop.is_set():
                            release(item)
                            return
                    work.put(item)
                work.put(None)
            except Exception as e:  # raised again by the consumer
                work.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        texts: List[Optional[str]] = [None] * len(images)
        rid2idx: Dict[int, int] = {}
        ready: List[Any] = []  # (index, prepared request) awaiting a free slot
        producer_done = False
        done = 0
        try:
            while done < len(images):
                # block for the producer only when the pool has nothing to do
                if not producer_done:
                    idle = not any(s.active for s in eng.slots) and not eng._inflight
                    try:
                        item = work.get(block=idle and not ready)
                    except queue.Empty:
                        item = ()
                    if item is None:
                        producer_done = True
                    elif isinstance(item, Exception):
                        raise item
                    elif item:
                        preps, prepared = item
                        _adopt(prepared, [t for _, p in preps for t in _tensors(p)])
                        ready.extend(preps)
                while ready and eng.free_slots():
                    idx, prep = ready.pop(0)
                    rid2idx[eng.admit_prepared(prep, max_tokens=max_tokens)] = idx
                for rid in eng.step():
                    texts[rid2idx[rid]] = eng.results.pop(rid)
                    eng.token_counts.pop(rid, None)
                    done += 1
        finally:
            _stop(producer, stop, work, release)
            for _, prep in ready:
                eng.release_prepared(prep)
        return texts  # type: ignore[return-value]


def _tensors(prep) -> List[Optional[torch.Tensor]]:
    """The device tensors a PreparedRequest brings: its cache, first token
    and encoded image."""
    enc = prep.enc
    return [prep.kv1.k, prep.kv1.v, prep.kv1.ks, prep.kv1.vs, prep.next_token,
            enc.k, enc.v, enc.ks, enc.vs]
