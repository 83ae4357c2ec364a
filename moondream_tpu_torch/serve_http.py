"""Dependency-free HTTP serving front end over the port's
ContinuousBatchingEngine (moondream_tpu/serve_http.py).

    python -m moondream_tpu_torch.serve_http --model model.safetensors --port 8080

Endpoints (JSON in, JSON out; images as base64 in the request body):

  POST /v1/caption   {"image_b64": ..., "length": "normal", "max_tokens": N}
  POST /v1/query     {"image_b64": ..., "question": ..., "max_tokens": N}
    both take "temperature" / "top_p" (per-request sampling) and
    "stream": true (server-sent events: data: {"chunk": ...} ... [DONE]);
    /v1/query also "reasoning": true and "spatial_refs": [[x, y] | [x1, y1, x2, y2]]
  POST /v1/detect    {"image_b64": ..., "object": ...}
  POST /v1/point     {"image_b64": ..., "object": ...}
  POST /v1/gaze      {"image_b64": ..., "eye": {"x": ..., "y": ...}}
  POST /v1/chat/completions   OpenAI-compatible chat (text and image_url
    content parts with data: URIs; "stream": true sends
    chat.completion.chunk events)
  GET  /healthz      liveness and slot occupancy
  GET  /metrics      request counters, latency percentiles, token rates

Text requests decode in the continuous-batching pool: a stepper thread
advances it while any request is active, so concurrent requests share one
ragged chunk (one CUDA graph replay on the card) instead of queueing.
detect / point take the single or lockstep batched model paths (same-object
requests arriving within a short window share one batch), or with
`struct_pool` ride the pool's mixed chunks.

The model runs on the card (`--device cpu` for the plain versions). One
rule keeps the server's threads apart on it: every thread holds
`engine.graphs.lock()` while it launches kernels (an encode, a prefill, a
slot write, a pool chunk, a detect), because any of them may be capturing
a CUDA graph, whose launch counts and memory pool would take in another
thread's launches. Waiting for a chunk's tokens, sleeping and socket I/O
happen outside it. So an admission's encode does not overlap the pool's
decode on the host, as the JAX package's does; on one CUDA stream the
card would run them one after the other anyway.

Built on stdlib http.server (ThreadingHTTPServer): no web framework.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import io
import json
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from .engine import graphs


class _Metrics:
    """Cheap cumulative serving metrics: per-endpoint request/error
    counts, a bounded reservoir of recent latencies for percentiles, and
    generated-token totals for aggregate throughput."""

    RESERVOIR = 512

    def __init__(self):
        self._lock = threading.Lock()
        self.started = time.monotonic()
        self.requests: Dict[str, int] = {}
        self.errors: Dict[str, int] = {}
        self.latencies: Dict[str, list] = {}
        self.tokens_out = 0

    def observe(self, endpoint: str, seconds: float, ok: bool,
                tokens: int = 0):
        with self._lock:
            self.requests[endpoint] = self.requests.get(endpoint, 0) + 1
            if not ok:
                self.errors[endpoint] = self.errors.get(endpoint, 0) + 1
            buf = self.latencies.setdefault(endpoint, [])
            buf.append(seconds)
            if len(buf) > self.RESERVOIR:
                del buf[: len(buf) - self.RESERVOIR]
            self.tokens_out += tokens

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            up = time.monotonic() - self.started
            out: Dict[str, Any] = {
                "uptime_s": round(up, 1),
                "requests": dict(self.requests),
                "errors": dict(self.errors),
                "generated_tokens": self.tokens_out,
                "tokens_per_sec_lifetime": round(self.tokens_out / up, 2)
                if up > 0 else 0.0,
                "latency_ms": {},
            }
            for ep, buf in self.latencies.items():
                if not buf:
                    continue
                s = sorted(buf)
                out["latency_ms"][ep] = {
                    "p50": round(1000 * s[len(s) // 2], 1),
                    "p95": round(1000 * s[min(len(s) - 1,
                                              int(len(s) * 0.95))], 1),
                    "max": round(1000 * s[-1], 1),
                    "n": len(s),
                }
            return out


class _StructuredBatcher:
    """Coalesces concurrent detect/point requests for the SAME object
    string into one lockstep batched decode (`detect_batch`/`point_batch`).
    Requests wait `window_s` for peers to arrive; the first waiter whose
    item is still pending becomes the group leader and executes the batch.
    Different objects (or kinds) never mix: the batched path needs a shared
    prompt."""

    def __init__(self, run_batch, window_s: float = 0.02,
                 max_batch: int = 8):
        self._run = run_batch  # fn(kind, [images], obj) -> [results]
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._pending: list = []
        self.coalesced = 0  # requests served via a >1-image batch

    def request(self, kind: str, image, obj: str,
                timeout_s: float = 600.0) -> Any:
        item = {
            "kind": kind, "obj": obj, "image": image,
            "ev": threading.Event(), "result": None, "error": None,
        }
        with self._lock:
            self._pending.append(item)
        if self.window_s > 0:
            time.sleep(self.window_s)
        batch = []
        with self._lock:
            if any(i is item for i in self._pending):
                # still unserved: lead a group of everything compatible
                batch = [
                    i for i in self._pending
                    if i["kind"] == kind and i["obj"] == obj
                ][: self.max_batch]
                taken = set(map(id, batch))
                self._pending = [
                    i for i in self._pending if id(i) not in taken
                ]
        if batch:
            try:
                results = self._run(kind, [i["image"] for i in batch], obj)
                for i, r in zip(batch, results):
                    i["result"] = r
            except Exception as e:
                for i in batch:
                    i["error"] = e
            if len(batch) > 1:
                with self._lock:
                    self.coalesced += len(batch)
            for i in batch:
                i["ev"].set()
        if not item["ev"].wait(timeout=timeout_s):
            raise TimeoutError("structured request timed out")
        if item["error"] is not None:
            raise item["error"]
        return item["result"]


def _parse_bool(v) -> bool:
    """JSON bool or its common string forms ("true"/"false"); clients that
    serialize booleans as strings must not silently enable streaming."""
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def _parse_chat(payload: Dict[str, Any]):
    """OpenAI chat-completions request -> (image array | None, content key
    | None, question text). The last user message's text parts concatenate
    into the question; the most recent image_url part (a data: URI) of any
    user message is the image, so a follow-up without an image still
    answers about the one sent earlier. Remote http(s) image URLs are
    refused (the server fetches nothing)."""
    msgs = payload.get("messages")
    if not isinstance(msgs, list) or not msgs:
        raise ValueError("missing 'messages'")

    def parts_of(m):
        content = m.get("content")
        if isinstance(content, str):
            return [{"type": "text", "text": content}]
        return [p for p in (content or []) if isinstance(p, dict)]

    users = [m for m in msgs if isinstance(m, dict) and m.get("role") == "user"]
    if not users:
        raise ValueError("no user message")

    texts = [
        p.get("text", "") for p in parts_of(users[-1])
        if p.get("type") == "text"
    ]
    question = " ".join(t for t in texts if t).strip()
    if not question:
        raise ValueError("no text content in user message")

    image, key = None, None
    for m in reversed(users):
        for part in reversed(parts_of(m)):
            if part.get("type") == "image_url":
                url = (part.get("image_url") or {}).get("url", "")
                if not url.startswith("data:"):
                    raise ValueError(
                        "only data: image URLs are supported (no egress)"
                    )
                b64 = url.split(",", 1)[1] if "," in url else ""
                image, key = _image_from_bytes(base64.b64decode(b64))
                break
        if image is not None:
            break
    return image, key, question


def _image_from_bytes(raw: bytes):
    """bytes -> (uint8 (H, W, 3) RGB array, content key); the key addresses
    the server's optional EncodedImage cache. Undecodable bytes are a
    client error."""
    from PIL import Image

    key = hashlib.sha256(raw).hexdigest()
    try:
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")), key
    except Exception as e:
        raise ValueError(f"could not decode image: {e}") from e


def _decode_image(payload: Dict[str, Any]):
    if "image_b64" not in payload:
        raise ValueError("missing 'image_b64'")
    return _image_from_bytes(base64.b64decode(payload["image_b64"]))


class ServingFrontend:
    """Bridges synchronous HTTP handlers to the continuous-batching engine.

    Text requests (caption/query) are encoded and prefilled by their
    handler thread and admitted into the pool; one stepper thread advances
    the pool while anything is active, and handlers wait on a per-request
    event. detect / point go to the model's single or lockstep batched
    paths, or with `struct_pool` into the pool. Every launch holds
    `graphs.lock()` (see the module's docstring)."""

    def __init__(self, model, n_slots: int = 8, slot_len: int = 1024,
                 chunk: int = 8, temperature: float = 0.0, top_p: float = 0.0,
                 speculative: int = 0, spec_adaptive: float = 0.0,
                 struct_window_s: float = 0.02, encode_cache: int = 0,
                 encode_window_s: float = 0.0, mesh=None,
                 struct_pool: bool = False, variants=None,
                 prefix_share: bool = False):
        from .models.serve import ContinuousBatchingEngine

        engine_kw = _engine_kwargs(n_slots, slot_len, chunk, temperature, top_p,
                                   speculative, spec_adaptive, variants)
        self._ctl = None
        if mesh is not None:
            # multi-GPU serving: this is rank 0; every call on the engine
            # (and on its model, the rank's sharded twin) that changes state
            # is mirrored to the other ranks (parallel.comm.Controller,
            # comm.MIRRORED), under the launch lock
            from .parallel import comm

            group, engine = _sharded_engine(model, mesh,
                                            dict(engine_kw, prefix_share=prefix_share))
            self._ctl = comm.Controller(group, {"engine": engine}, lock=graphs.lock())
            self.engine = self._ctl.proxy("engine")
            model = self.engine.model
        else:
            self.engine = ContinuousBatchingEngine(model, prefix_share=prefix_share, **engine_kw)
        self.model = model
        # detect/point through the pool's mixed chunks instead of the single
        # path and the same-object coalescer
        self.struct_pool = bool(struct_pool)
        self._lock = threading.Lock()  # pool state: step / admit / results
        self._done: Dict[int, threading.Event] = {}
        self.metrics = _Metrics()
        # concurrent same-object detect/point share one batched decode;
        # struct_window_s=0 disables coalescing (pure single-image paths)
        self._batcher = _StructuredBatcher(
            self._run_structured, window_s=struct_window_s
        )
        # content-addressed EncodedImage LRU: repeat images skip crops, ViT
        # and image prefill. Each entry pins a [BOS, image] KV snapshot in
        # device memory (~140 MB at 2B bf16), so it is off by default.
        self.encode_cache = int(encode_cache)
        self._enc_cache: "OrderedDict[str, Any]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self.encode_cache_hits = 0
        # batched admissions (opt-in): arrivals within the window share one
        # encode_images ViT pass, whose reduction order differs from the
        # single path's, so near-tie greedy tokens can differ
        self.encode_window_s = float(encode_window_s)
        self._enc_batcher = _StructuredBatcher(
            self._run_encode, window_s=self.encode_window_s
        ) if self.encode_window_s > 0 else None
        self._wake = threading.Event()
        # admission backpressure: each request between prepare() and
        # admit_prepared() pins a single-row KV buffer on the device, so at
        # most 2 may be in that window; later arrivals wait here holding none
        self._admission_sem = threading.BoundedSemaphore(2)
        self._slot_freed = threading.Event()  # stepper signals admitters
        self._stop = False
        self._stepper = threading.Thread(target=self._step_loop, daemon=True)
        self._stepper.start()

    def _cache_get(self, key: Optional[str]):
        if not self.encode_cache or key is None:
            return None
        with self._cache_lock:
            enc = self._enc_cache.get(key)
            if enc is not None:
                self._enc_cache.move_to_end(key)
                self.encode_cache_hits += 1
            return enc

    def _cache_put(self, key: Optional[str], enc) -> None:
        if not self.encode_cache or key is None:
            return
        with self._cache_lock:
            self._enc_cache[key] = enc
            while len(self._enc_cache) > self.encode_cache:
                self._enc_cache.popitem(last=False)

    def _run_encode(self, kind, images, obj):
        with graphs.lock():
            return self.engine.model.encode_images(list(images))

    def _resolve_image(self, image, key: Optional[str],
                       variant: Optional[str] = None):
        """An EncodedImage for `image`: the content cache first, then the
        (optional) shared-window batched encode, else a single encode. With
        neither cache nor batching configured the image passes through (the
        path downstream encodes it).

        `variant`: an adapter applies to the image prefill too, so the
        cache keys by (variant, content); variant encodes skip the batched
        encode (one settings per batch)."""
        from .models.moondream import EncodedImage

        if isinstance(image, EncodedImage):
            return image
        if variant is not None and key is not None:
            key = f"{variant}\x00{key}"
        enc = self._cache_get(key)
        if enc is not None:
            return enc
        if self._enc_batcher is not None and variant is None:
            enc = self._enc_batcher.request("encode", image, "")
        elif self.encode_cache and key is not None:
            with graphs.lock():
                enc = self.engine.encode_for(image, variant)
        else:
            return image
        self._cache_put(key, enc)
        return enc

    # ----------------------------------------------------------- text pool
    def _step_loop(self):
        while not self._stop:
            self._wake.wait(timeout=0.2)
            with self._lock:
                active = (any(s.active for s in self.engine.slots)
                          or bool(self.engine._inflight))
                finished = self.engine.step(graphs.lock()) if active else []
                if not (any(s.active for s in self.engine.slots)
                        or self.engine._inflight):
                    self._wake.clear()
            if finished:
                self._slot_freed.set()
            for rid in finished:
                ev = self._done.pop(rid, None)
                if ev:
                    ev.set()

    def text_request(self, image, question: Optional[str], length: str,
                     max_tokens: int, timeout_s: float = 300.0,
                     temperature: Optional[float] = None,
                     top_p: Optional[float] = None,
                     image_key: Optional[str] = None,
                     variant: Optional[str] = None) -> str:
        endpoint = "caption" if question is None else "query"
        t0 = time.monotonic()
        try:
            out, n_tokens = self._text_request(
                image, question, length, max_tokens, timeout_s,
                temperature, top_p, image_key, variant,
            )
        except Exception:
            self.metrics.observe(endpoint, time.monotonic() - t0, ok=False)
            raise
        self.metrics.observe(
            endpoint, time.monotonic() - t0, ok=True, tokens=n_tokens
        )
        return out

    def _wait_and_admit(self, prep, deadline, ev, max_tokens, on_text):
        """Spin (stepper-signaled) for a free slot, then admit. Raises
        TimeoutError past the deadline, releasing the prepared buffer."""
        while True:
            with self._lock:
                if self.engine.free_slots():
                    with graphs.lock():
                        rid = self.engine.admit_prepared(
                            prep, max_tokens=max_tokens, on_text=on_text
                        )
                    self._done[rid] = ev
                    self._wake.set()
                    return rid
                self._slot_freed.clear()
            if time.monotonic() > deadline:
                with graphs.lock():
                    self.engine.release_prepared(prep)
                raise TimeoutError("no free slot before timeout")
            # woken by the stepper when a request finishes (50ms
            # fallback covers cancel-freed slots)
            self._slot_freed.wait(timeout=0.05)

    def _prepare_and_admit(self, image, question, length, max_tokens,
                           deadline, ev, temperature, top_p, on_text=None,
                           image_key=None, structured=None, obj=None,
                           variant=None):
        """Shared admission: encode and prefill outside the pool lock, then
        wait for a free slot. Returns the req_id; raises TimeoutError past
        the deadline (releasing the prepared KV buffer). With `structured`
        ("detect" / "point" / "gaze") the request becomes a pooled
        structured row for `obj` (the eye position for gaze)."""
        if not self._admission_sem.acquire(
            timeout=max(0.0, deadline - time.monotonic())
        ):
            raise TimeoutError("admission queue full before timeout")
        try:
            image = self._resolve_image(image, image_key, variant=variant)
            with graphs.lock():
                if structured == "gaze":
                    prep = self.engine.prepare_gaze(image, obj,
                                                    variant=variant)
                elif structured is not None:
                    prep = self.engine.prepare_structured(
                        image, obj, structured, structured == "detect",
                        variant=variant,
                    )
                else:
                    prep = self.engine.prepare(
                        image, question=question, caption_length=length,
                        temperature=temperature, top_p=top_p,
                        variant=variant,
                    )
            return self._wait_and_admit(prep, deadline, ev, max_tokens,
                                        on_text)
        finally:
            self._admission_sem.release()

    def _pop_result(self, rid):
        """Fetch and forget a finished request (the engine's results must
        not grow for the life of a long-running server)."""
        with self._lock:
            out = self.engine.results.pop(rid, "")
            return out, self.engine.token_counts.pop(rid, 0)

    def _abandon(self, rid):
        with self._lock:
            with graphs.lock():
                self.engine.cancel(rid)
            self.engine.results.pop(rid, None)
            self.engine.token_counts.pop(rid, None)
        self._done.pop(rid, None)

    def _text_request(self, image, question, length, max_tokens, timeout_s,
                      temperature, top_p, image_key=None, variant=None):
        ev = threading.Event()
        deadline = time.monotonic() + timeout_s
        rid = self._prepare_and_admit(
            image, question, length, max_tokens, deadline, ev,
            temperature, top_p, image_key=image_key, variant=variant,
        )
        if not ev.wait(timeout=max(0.0, deadline - time.monotonic())):
            self._abandon(rid)
            raise TimeoutError("generation timed out (partial discarded)")
        return self._pop_result(rid)

    def text_request_stream(self, image, question: Optional[str],
                            length: str, max_tokens: int,
                            timeout_s: float = 300.0,
                            temperature: Optional[float] = None,
                            top_p: Optional[float] = None,
                            image_key: Optional[str] = None,
                            endpoint: Optional[str] = None,
                            variant: Optional[str] = None):
        """Generator of word-boundary-safe text chunks for one request
        (the engine's per-request on_text callback bridged through a
        queue). Concatenated chunks equal the non-streaming result.
        Closing the generator early (client disconnect) cancels the
        request and frees its slot."""
        import queue as _queue

        if endpoint is None:
            endpoint = ("caption" if question is None else "query") + "_stream"
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        ev = threading.Event()
        q: _queue.Queue = _queue.Queue()
        try:
            rid = self._prepare_and_admit(
                image, question, length, max_tokens, deadline, ev,
                temperature, top_p,
                on_text=lambda _rid, chunk: q.put(chunk),
                image_key=image_key, variant=variant,
            )
        except Exception:
            self.metrics.observe(endpoint, time.monotonic() - t0, ok=False)
            raise
        try:
            # chunks are enqueued inside step() BEFORE the stepper sets
            # ev, so "ev set and queue empty" can't drop a tail chunk
            while not (ev.is_set() and q.empty()):
                try:
                    yield q.get(timeout=0.05)
                except _queue.Empty:
                    if time.monotonic() > deadline:
                        self._abandon(rid)
                        self.metrics.observe(
                            endpoint, time.monotonic() - t0, ok=False
                        )
                        raise TimeoutError(
                            "generation timed out (partial discarded)"
                        )
            _, n_tokens = self._pop_result(rid)
            self.metrics.observe(
                endpoint, time.monotonic() - t0, ok=True, tokens=n_tokens
            )
        except GeneratorExit:
            # consumer went away mid-stream: free the slot immediately
            self._abandon(rid)
            self.metrics.observe(endpoint, time.monotonic() - t0, ok=False)
            raise

    def chat_request(self, image, question, max_tokens, temperature, top_p,
                     image_key=None):
        """OpenAI-compatible completion: returns (text, completion_tokens).
        Image requests ride the continuous-batching pool; text-only
        requests run the model's no-image query path."""
        t0 = time.monotonic()
        try:
            if image is not None:
                out, n = self._text_request(
                    image, question, "normal", max_tokens, 300.0,
                    temperature, top_p, image_key,
                )
            else:
                settings = {
                    "max_tokens": max_tokens,
                    "temperature": 0.0 if temperature is None else temperature,
                    "top_p": 0.0 if top_p is None else top_p,
                }
                with graphs.lock():
                    out = self.model.query(
                        image=None, question=question, settings=settings
                    )["answer"]
                # no pool bookkeeping on this path: re-encoding the
                # answer gives the completion token count for usage
                n = len(self.model._encode_text(out)) if out else 0
        except Exception:
            self.metrics.observe("chat", time.monotonic() - t0, ok=False)
            raise
        self.metrics.observe(
            "chat", time.monotonic() - t0, ok=True, tokens=n
        )
        return out, n

    def query_direct(self, image, question, max_tokens, temperature, top_p,
                     reasoning=False, spatial_refs=None, image_key=None):
        """Reasoning / spatial-ref queries run the model's own loops
        (single-stream): they interleave coordinate decoding with text and
        do not fit the ragged text pool. Returns the model's whole dict
        ({"answer"}, and "reasoning" with its grounding)."""
        t0 = time.monotonic()
        ep = "query_reasoning" if reasoning else "query_spatial"
        try:
            if image is not None:
                image = self._resolve_image(image, image_key)
            settings = {
                "max_tokens": max_tokens,
                "temperature": 0.0 if temperature is None else temperature,
                "top_p": 0.0 if top_p is None else top_p,
            }
            with graphs.lock():
                out = self.model.query(
                    image=image, question=question, reasoning=reasoning,
                    spatial_refs=spatial_refs, settings=settings,
                )
        except Exception:
            self.metrics.observe(ep, time.monotonic() - t0, ok=False)
            raise
        self.metrics.observe(ep, time.monotonic() - t0, ok=True)
        return out

    # ----------------------------------------------------- structured path
    def _run_structured(self, kind: str, images, obj: str):
        with graphs.lock():
            if len(images) == 1:
                fn = (
                    self.model.detect if kind == "detect" else self.model.point
                )
                return [fn(images[0], obj)]
            fn = (
                self.model.detect_batch if kind == "detect"
                else self.model.point_batch
            )
            return fn(images, obj)

    def gaze_request(self, image, eye, image_key: Optional[str] = None,
                     variant: Optional[str] = None):
        t0 = time.monotonic()
        try:
            if self.struct_pool:
                out = self._structured_via_pool(
                    "gaze", image, eye, image_key, variant=variant
                )
            elif variant is not None:
                # refuse rather than silently serving base weights
                raise ValueError(
                    "gaze with a variant requires --struct-pool "
                    "(pooled structured decode)"
                )
            else:
                image = self._resolve_image(image, image_key)
                with graphs.lock():
                    out = self.model.detect_gaze(image, eye=eye)
        except Exception:
            self.metrics.observe("gaze", time.monotonic() - t0, ok=False)
            raise
        self.metrics.observe("gaze", time.monotonic() - t0, ok=True)
        return out

    def _structured_via_pool(self, kind, image, obj, image_key,
                             timeout_s: float = 300.0, variant=None):
        ev = threading.Event()
        deadline = time.monotonic() + timeout_s
        rid = self._prepare_and_admit(
            image, None, None, 0, deadline, ev, None, None,
            image_key=image_key, structured=kind, obj=obj, variant=variant,
        )
        if not ev.wait(timeout=max(0.0, deadline - time.monotonic())):
            self._abandon(rid)
            raise TimeoutError("structured request timed out")
        out, _ = self._pop_result(rid)
        return out

    def structured_request(self, kind: str, image, obj: str,
                           image_key: Optional[str] = None,
                           variant: Optional[str] = None) -> Any:
        t0 = time.monotonic()
        try:
            if self.struct_pool:
                out = self._structured_via_pool(
                    kind, image, obj, image_key, variant=variant
                )
            elif variant is not None:
                raise ValueError(
                    "detect/point with a variant requires --struct-pool "
                    "(pooled structured decode)"
                )
            else:
                image = self._resolve_image(image, image_key)
                out = self._batcher.request(kind, image, obj)
        except Exception:
            self.metrics.observe(kind, time.monotonic() - t0, ok=False)
            raise
        self.metrics.observe(kind, time.monotonic() - t0, ok=True)
        return out

    def occupancy(self) -> Dict[str, Any]:
        with self._lock:
            free = len(self.engine.free_slots())
        out: Dict[str, Any] = {"slots": self.engine.n_slots, "free": free}
        if self.engine._variants:
            out["variants"] = sorted(self.engine._variants)
        if self.engine.spec_k or self.engine.spec_accept_rate is not None:
            out["speculative"] = self.engine.spec_k
            rate = self.engine.spec_accept_rate
            out["spec_accept_rate"] = (
                round(rate, 3) if rate is not None else None
            )
        return out

    def warmup(self) -> None:
        """Warm the serving path before traffic: one dummy request through
        encode, prefill, admission and the chunk loop (the speculative chunk
        too when enabled). On the card the kernels build at their first
        launch and the pool captures its chunk's CUDA graph at its first
        chunk; without this the first request pays both."""
        img = np.zeros((64, 64, 3), dtype=np.uint8)
        out = self.text_request(
            img, None, "normal", max_tokens=self.engine.chunk + 1,
            timeout_s=3600.0,  # kernel builds and graph captures
        )
        if not isinstance(out, str):
            raise RuntimeError(f"warmup request returned {type(out).__name__}, not text")
        # drop the dummy encode from the cache so it never serves a hit
        with self._cache_lock:
            self._enc_cache.clear()

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._stepper.join(timeout=5)
        if self._ctl is not None:
            self._ctl.close()  # the other ranks' make_server returns


def _engine_kwargs(n_slots, slot_len, chunk, temperature, top_p, speculative,
                   spec_adaptive, variants) -> Dict[str, Any]:
    """The pool's settings, alike on every rank of a mesh."""
    return dict(
        n_slots=n_slots, slot_len=slot_len, chunk=chunk,
        temperature=temperature, top_p=top_p, speculative=speculative,
        spec_adaptive=spec_adaptive,
        # dispatch chunk i+1 before reading chunk i's tokens back;
        # costs one chunk of streaming latency
        pipeline_depth=2,
        # multi-tenant LoRA: {name: stacked adapter tree}; requests pick
        # one with {"variant": name} and decode beside base rows
        variants=variants,
    )


def _sharded_engine(model, mesh, engine_kw: Dict[str, Any]):
    """(the control plane's gloo group, this rank's sharded pool with the
    crop-parallel ViT), made alike on every rank (moondream_tpu/
    serve_http.py:257-282). A prefix-shared pool raises ValueError
    (`make_sharded_serving_engine`), before the mesh or the process group
    is read."""
    from .parallel import comm
    from .parallel.serving import make_sharded_serving_engine

    engine = make_sharded_serving_engine(model, mesh, shard_vision=True, **engine_kw)
    return comm.control_group(), engine


class _Handler(BaseHTTPRequestHandler):
    frontend: ServingFrontend = None  # set by make_server

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, payload: Dict[str, Any]):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _chat_completions(self, payload):
        image, key, question = _parse_chat(payload)
        max_tokens = int(payload.get("max_tokens")
                         or payload.get("max_completion_tokens") or 512)
        temp = payload.get("temperature")
        top_p = payload.get("top_p")
        temp = None if temp is None else float(temp)
        top_p = None if top_p is None else float(top_p)
        model_name = payload.get("model", "moondream")
        rid = f"chatcmpl-{int(time.time() * 1000)}"
        created = int(time.time())

        if _parse_bool(payload.get("stream")):
            if image is None:
                raise ValueError("streaming requires an image message")
            gen = self.frontend.text_request_stream(
                image, question, "normal", max_tokens,
                temperature=temp, top_p=top_p, image_key=key,
                endpoint="chat_stream",
            )
            it = iter(gen)
            try:
                first = next(it)
            except StopIteration:
                first = None
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def event(delta, finish=None):
                return ("data: " + json.dumps({
                    "id": rid, "object": "chat.completion.chunk",
                    "created": created, "model": model_name,
                    "choices": [{
                        "index": 0, "delta": delta,
                        "finish_reason": finish,
                    }],
                }) + "\n\n").encode()

            try:
                self.wfile.write(event({"role": "assistant"}))
                if first is not None:
                    self.wfile.write(event({"content": first}))
                for chunk in it:
                    self.wfile.write(event({"content": chunk}))
                    self.wfile.flush()
                self.wfile.write(event({}, finish="stop"))
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                gen.close()
            except Exception as e:
                try:
                    self.wfile.write(
                        f"data: {json.dumps({'error': str(e)})}\n\n".encode()
                    )
                    self.wfile.flush()
                except OSError:
                    pass
            return

        out, n_tokens = self.frontend.chat_request(
            image, question, max_tokens, temp, top_p, image_key=key
        )
        self._json(200, {
            "id": rid, "object": "chat.completion", "created": created,
            "model": model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": out},
                "finish_reason": "stop",
            }],
            "usage": {
                "prompt_tokens": 0, "completion_tokens": n_tokens,
                "total_tokens": n_tokens,
            },
        })

    def _stream_sse(self, image, question, length, max_tokens, temp,
                    top_p, image_key=None, variant=None):
        """`"stream": true` responses: text/event-stream of
        `data: {"chunk": ...}` events, terminated by `data: [DONE]`.
        The first chunk is pulled BEFORE headers go out so admission
        errors (bad prompt, no slot) still return proper status codes."""
        gen = self.frontend.text_request_stream(
            image, question, length, max_tokens,
            temperature=temp, top_p=top_p, image_key=image_key,
            variant=variant,
        )
        it = iter(gen)
        try:
            first = next(it)
        except StopIteration:
            first = None
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            if first is not None:
                self.wfile.write(
                    f"data: {json.dumps({'chunk': first})}\n\n".encode()
                )
                self.wfile.flush()
            for chunk in it:
                self.wfile.write(
                    f"data: {json.dumps({'chunk': chunk})}\n\n".encode()
                )
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            gen.close()  # GeneratorExit inside -> cancel + free the slot
        except Exception as e:
            # headers are already out: a second HTTP response would
            # corrupt the stream, so surface the error as an SSE event
            # (no [DONE]) and end the body
            try:
                self.wfile.write(
                    f"data: {json.dumps({'error': str(e)})}\n\n".encode()
                )
                self.wfile.flush()
            except OSError:
                pass

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, {"ok": True, **self.frontend.occupancy()})
        elif self.path == "/metrics":
            self._json(
                200,
                {**self.frontend.metrics.snapshot(),
                 **self.frontend.occupancy(),
                 "structured_coalesced": self.frontend._batcher.coalesced,
                 "encode_cache_hits": self.frontend.encode_cache_hits,
                 "encode_cache_entries": len(self.frontend._enc_cache)},
            )
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/v1/chat/completions":
                self._chat_completions(payload)
                return
            image, image_key = _decode_image(payload)
            max_tokens = int(payload.get("max_tokens", 512))
            temp = payload.get("temperature")
            top_p = payload.get("top_p")
            temp = None if temp is None else float(temp)
            top_p = None if top_p is None else float(top_p)
            stream = _parse_bool(payload.get("stream"))
            variant = payload.get("variant")
            if self.path == "/v1/caption":
                if stream:
                    self._stream_sse(
                        image, None, payload.get("length", "normal"),
                        max_tokens, temp, top_p, image_key, variant=variant,
                    )
                    return
                out = self.frontend.text_request(
                    image, None, payload.get("length", "normal"), max_tokens,
                    temperature=temp, top_p=top_p, image_key=image_key,
                    variant=variant,
                )
                self._json(200, {"caption": out})
            elif self.path == "/v1/query":
                reasoning = _parse_bool(payload.get("reasoning"))
                spatial_refs = payload.get("spatial_refs")
                if (reasoning or spatial_refs) and stream:
                    raise ValueError(
                        "streaming is not supported with reasoning or "
                        "spatial_refs (the response carries a structured "
                        "reasoning/grounding dict, not a chunk stream)"
                    )
                if reasoning or spatial_refs:
                    if spatial_refs is not None:
                        spatial_refs = [
                            [float(v) for v in ref] for ref in spatial_refs
                        ]
                        if not all(len(r) in (2, 4) for r in spatial_refs):
                            raise ValueError(
                                "spatial_refs entries must be [x, y] points"
                                " or [x1, y1, x2, y2] boxes"
                            )
                    out = self.frontend.query_direct(
                        image, payload["question"], max_tokens, temp, top_p,
                        reasoning=reasoning, spatial_refs=spatial_refs,
                        image_key=image_key,
                    )
                    # grounding values may be numpy scalars
                    self._json(
                        200, json.loads(json.dumps(out, default=float))
                    )
                    return
                if stream:
                    self._stream_sse(
                        image, payload["question"], "normal",
                        max_tokens, temp, top_p, image_key, variant=variant,
                    )
                    return
                out = self.frontend.text_request(
                    image, payload["question"], "normal", max_tokens,
                    temperature=temp, top_p=top_p, image_key=image_key,
                    variant=variant,
                )
                self._json(200, {"answer": out})
            elif self.path == "/v1/detect":
                self._json(
                    200,
                    self.frontend.structured_request(
                        "detect", image, payload["object"],
                        image_key=image_key, variant=variant,
                    ),
                )
            elif self.path == "/v1/gaze":
                eye = payload["eye"]
                out = self.frontend.gaze_request(
                    image, (float(eye["x"]), float(eye["y"])),
                    image_key=image_key, variant=variant,
                )
                self._json(200, out)
            elif self.path == "/v1/point":
                self._json(
                    200,
                    self.frontend.structured_request(
                        "point", image, payload["object"],
                        image_key=image_key, variant=variant,
                    ),
                )
            else:
                self._json(404, {"error": "not found"})
        except (ValueError, KeyError) as e:
            self._json(400, {"error": str(e)})
        except TimeoutError as e:
            self._json(503, {"error": str(e)})
        except Exception as e:  # surface, don't kill the worker thread
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(model, host: str = "127.0.0.1", port: int = 8080,
                n_slots: int = 8, slot_len: int = 1024, chunk: int = 8,
                temperature: float = 0.0, top_p: float = 0.0,
                speculative: int = 0, spec_adaptive: float = 0.0,
                struct_window_s: float = 0.02, encode_cache: int = 0,
                encode_window_s: float = 0.0, mesh=None,
                struct_pool: bool = False, variants=None,
                prefix_share: bool = False):
    """Build (server, frontend); call server.serve_forever() to run.

    `mesh=` (a `parallel.mesh.create_mesh` DeviceMesh; every rank of the
    world calls make_server with its own copy of the same model and the
    same settings): rank 0 builds the server over the sharded pool (slots
    on dp, heads on tp, the ViT crop-parallel) and its frontend mirrors
    the engine calls that change state to the other ranks; on every other
    rank make_server follows those calls and returns (None, None) once
    rank 0's frontend shuts down. `prefix_share` with a mesh raises
    ValueError."""
    import torch.distributed as dist

    if mesh is not None and dist.is_initialized() and dist.get_rank() != 0:
        from .parallel import comm

        group, engine = _sharded_engine(model, mesh, dict(
            _engine_kwargs(n_slots, slot_len, chunk, temperature, top_p, speculative,
                           spec_adaptive, variants), prefix_share=prefix_share))
        comm.follow(group, {"engine": engine})
        return None, None
    frontend = ServingFrontend(
        model, n_slots=n_slots, slot_len=slot_len, chunk=chunk,
        temperature=temperature, top_p=top_p, speculative=speculative,
        spec_adaptive=spec_adaptive, struct_window_s=struct_window_s,
        encode_cache=encode_cache, encode_window_s=encode_window_s,
        mesh=mesh, struct_pool=struct_pool, variants=variants,
        prefix_share=prefix_share,
    )
    handler = type("Handler", (_Handler,), {"frontend": frontend})
    server = ThreadingHTTPServer((host, port), handler)
    return server, frontend


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default=None)
    parser.add_argument("--config", default=None,
                        help="None/'2b'/'05b'/'tiny' or a JSON path")
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--slot-len", type=int, default=1024)
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--int4", action="store_true",
                        help="text weights packed int4 through the W4A16 kernel")
    parser.add_argument("--int8-text", action="store_true",
                        help="int8 w8a8 text weights (best with --spec, where the "
                             "verify runs B*k rows)")
    parser.add_argument("--spec", type=int, default=0, metavar="K",
                        help="speculative serving chunks with K-token drafts "
                             "(greedy pools: exact token match; sampled pools: "
                             "exact distribution via rejection sampling)")
    parser.add_argument("--spec-adaptive", type=float, default=1.2,
                        metavar="RATE",
                        help="with --spec: turn speculation off when the measured "
                             "accept rate (tokens per slot-iteration) stays below "
                             "RATE after warm-up; 0 disables the fallback")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="pool-wide sampling temperature (0 = greedy; "
                             "requests may override per call)")
    parser.add_argument("--top-p", type=float, default=0.0)
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the startup warmup request (the first real "
                             "request then builds the kernels and captures the "
                             "pool's graph)")
    parser.add_argument("--tp", type=int, default=0, metavar="N",
                        help="serve over every GPU of the host, one process per "
                             "GPU: heads split over N of them (tensor parallel), "
                             "the pool's slots over the rest (data parallel); N "
                             "must divide the GPU count (with --device cpu: N gloo "
                             "ranks). 0 = one device, one process")
    parser.add_argument("--encode-cache", type=int, default=0, metavar="N",
                        help="LRU-cache the N most recent images' encodes "
                             "(content-addressed): repeat images skip crops, ViT "
                             "and prefill. Each entry pins an image KV snapshot "
                             "in device memory (~140MB at 2B bf16); 0 disables")
    parser.add_argument("--encode-window", type=float, default=0.0,
                        metavar="S",
                        help="coalesce concurrent admissions' image encodes into "
                             "one batched ViT pass (arrival window in seconds). "
                             "Off by default: the batched ViT reduces in another "
                             "order than the single path, so near-tie greedy "
                             "tokens can differ")
    parser.add_argument("--prefix-share", action="store_true",
                        help="slots hold only the prompt/answer SUFFIX; repeat "
                             "images (encode-cache hits) share ONE read-only "
                             "image-prefix KV entry (pair with --encode-cache)")
    parser.add_argument("--struct-pool", action="store_true",
                        help="route detect/point/gaze through the continuous "
                             "batching pool (mixed text+structured chunks)")
    parser.add_argument("--struct-window", type=float, default=0.02,
                        metavar="S",
                        help="coalescing window for concurrent same-object "
                             "detect/point requests (one batched decode per "
                             "group); 0 disables")
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=PATH_OR_ID",
                        help="register a LoRA adapter for multi-tenant serving "
                             "(repeatable): a local adapter checkpoint, or a "
                             "variant id cached under the HF cache. Requests "
                             'select one with {"variant": NAME}')
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    return parser


def _build_model(args, device):
    """The model of the command line, on `device`: a checkpoint or random
    weights from seed 0 (alike on every rank)."""
    from .finetune import resolve_config
    from .models.moondream import MoondreamModel
    from .tokenizer import load_tokenizer
    from .weights import load_params

    config = resolve_config(args.config)
    params = (
        load_params(args.model, config, runtime_int4=args.int4,
                    runtime_int8=args.int8_text, device=device)
        if args.model
        else None
    )
    model = MoondreamModel(config, params=params,
                           tokenizer=load_tokenizer(args.tokenizer), device=device)
    if params is None:
        print("WARNING: no --model; serving random weights (smoke mode)")
        if args.int4 or args.int8_text:
            from .models.text import quantize_text_params, quantize_text_params_int8

            (quantize_text_params if args.int4 else quantize_text_params_int8)(model.text)
    return model


def _serve(args, model, mesh=None) -> None:
    """Build the server over `model` (sharded over `mesh` when given), warm it
    up and serve until interrupted; a follower rank returns when rank 0
    stops."""
    variants = None
    if args.variant:
        from .lora import variant_state_dict

        variants = {}
        for spec in args.variant:
            name, _, src = spec.partition("=")
            if not src:
                raise SystemExit(f"--variant {spec!r}: expected NAME=PATH")
            variants[name] = variant_state_dict(src, model.config.text.n_layers, model.dtype,
                                                model.device)
        print(f"variants registered: {sorted(variants)}")
    server, frontend = make_server(
        model, args.host, args.port,
        n_slots=args.slots, slot_len=args.slot_len, chunk=args.chunk,
        temperature=args.temperature, top_p=args.top_p,
        speculative=args.spec, spec_adaptive=args.spec_adaptive,
        struct_window_s=args.struct_window, encode_cache=args.encode_cache,
        encode_window_s=args.encode_window, mesh=mesh,
        struct_pool=args.struct_pool, variants=variants,
        prefix_share=args.prefix_share,
    )
    if server is None:
        return
    if not args.no_warmup:
        print("warming up (building the kernels, capturing the pool's graph)...")
        t0 = time.monotonic()
        frontend.warmup()
        print(f"warmup done in {time.monotonic() - t0:.1f}s")
    print(f"serving on http://{args.host}:{server.server_address[1]}")

    # graceful SIGTERM (container orchestration): stop accepting, let the
    # pool drain, then exit
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down (draining in-flight requests)...")
    finally:
        server.shutdown()
        frontend.shutdown()


def _serve_rank(rank: int, args, world: int) -> None:
    """One rank of `--tp`: the same model on this rank's device, the dp x tp
    mesh, then rank 0 serves and the others follow."""
    from .parallel import comm
    from .parallel.mesh import create_mesh

    model = _build_model(args, comm.process_device())
    _serve(args, model, create_mesh({"dp": world // args.tp, "tp": args.tp}))


def main(argv=None):
    args = _parser().parse_args(argv)

    from .weights import checked_device

    device = checked_device(args.device)
    if args.tp:
        import torch

        from .parallel import comm

        world = torch.cuda.device_count() if device.type == "cuda" else args.tp
        if world % args.tp:
            raise SystemExit(f"--tp {args.tp} does not divide {world} devices")
        comm.launch(world, _serve_rank, args, world, device=device.type, timeout_s=None,
                    threads=max(1, (os.cpu_count() or 1) // world))
        return
    _serve(args, _build_model(args, device))


if __name__ == "__main__":
    main()
