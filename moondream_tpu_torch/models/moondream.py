"""MoondreamModel: caption, query (without reasoning), the lockstep batched
paths and what the serving pool needs of the model (a subset of
moondream_tpu/models/moondream.py).

encode_image: host overlap crops -> ViT over a bucketed crop batch ->
stitch + projection -> [BOS, image] prefill -> KV snapshot. caption and
query: the template prompt prefill over the restored snapshot (query also
without an image), then greedy or top-p decode, plain or streamed.
encode_images: one ViT call per (crop count, tiling) group of images, one
stitch + projection per group and one batched [BOS, image] prefill;
caption_batch / query_batch: one shared prompt over many images, decoded in
lockstep. `models.serve.ContinuousBatchingEngine` prefills its requests
through load_encoded_image (on recycled buffers) and _prefill_prompt.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Literal, Optional, Tuple

import numpy as np
import torch

from ..config import MoondreamConfig
from ..engine import batched as batched_engine
from ..engine import generate as engine
from ..engine.sampling import sample_token
from ..ops.image_crops import overlap_crop_image, reconstruct_from_crops
from ..tokenizer import TokenizerBase, load_tokenizer
from ..utils.streaming import TokenStreamer, stream_text
from ..weights import checked_device, init_params
from .text import KVCache, text_encoder
from .vision import vision_encoder, vision_projection

DEFAULT_MAX_TOKENS = 768
DEFAULT_TEMPERATURE = 0.5
DEFAULT_TOP_P = 0.3

# Crop-count buckets for the ViT batch (1 global + up to 12 local crops).
CROP_BUCKETS = (2, 5, 9, 13)
# Prompt prefills pad to multiples of this.
PROMPT_PAD = 8


@dataclass(frozen=True)
class EncodedImage:
    """KV snapshot after prefilling [BOS, image]: k/v (L, 1, H_kv, pos, Dh).
    With config.text.kv_int8, k/v hold int8 codes and ks/vs the fp32
    scales (L, 1, H_kv/g, pos) (models.text.KVCache)."""

    pos: int
    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None

    def as_cache(self) -> KVCache:
        return KVCache(k=self.k, v=self.v, ks=self.ks, vs=self.vs)


def _snap_enc(kv: KVCache, pos: int, b: Optional[int] = None) -> EncodedImage:
    """The snapshot [0, pos) of batch row b of a cache (of its only row when
    b is None)."""
    rows = slice(None) if b is None else slice(b, b + 1)
    cut = lambda a: None if a is None else a[:, rows, :, :pos].clone()
    return EncodedImage(pos=pos, k=cut(kv.k), v=cut(kv.v), ks=cut(kv.ks), vs=cut(kv.vs))


def _concat_enc_kv(encs: List[EncodedImage]) -> KVCache:
    """Per-image snapshots stacked on the batch axis
    (moondream_tpu/models/moondream.py:106-114)."""
    cat = lambda xs: None if xs[0] is None else torch.cat(xs, dim=1)
    return KVCache(
        k=cat([e.k for e in encs]), v=cat([e.v for e in encs]),
        ks=cat([e.ks for e in encs]), vs=cat([e.vs for e in encs]),
    )


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _bucket(n: int, buckets=CROP_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class MoondreamModel:
    def __init__(
        self,
        config: MoondreamConfig,
        params: Optional[torch.nn.ModuleDict] = None,
        tokenizer: Optional[TokenizerBase] = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device="cuda",
    ):
        """`params`: from `weights.params_from_jax`, `weights.load_params`
        or `weights.init_params` (int4 text blocks: `load_params(...,
        runtime_int4=True)`, or `models.text.quantize_text_params` on
        dense ones); None draws random weights on `device` from `seed`. An
        int8 KV cache comes from config.text.kv_int8. `device` is the card
        unless the caller asks for the CPU (device="cpu", the plain
        versions); without a card the default raises. On a CUDA device the
        kernels take bf16 activations only."""
        self.config = config
        self.dtype = dtype
        self.device = checked_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if params is None:
            params = init_params(config, self.generator, self.device, dtype)
        self.params = params
        self.tokenizer = tokenizer if tokenizer is not None else load_tokenizer()
        # Recycled KV buffers, by (batch, slot count) (the JAX package's
        # pool, moondream_tpu/models/moondream.py:151-159): the serving pool
        # returns each prefilled request's buffer once its slot write is
        # done, so the next load_encoded_image costs only the snapshot
        # copy. Stale slots past a snapshot are overwritten before they are
        # attended. Servers recycle from other threads: hence the lock.
        self._kv_pool: Dict[Tuple[int, int], List[KVCache]] = {}
        self._kv_pool_lock = threading.Lock()

    @property
    def vision(self):
        return self.params["vision"]

    @property
    def text(self):
        return self.params["text"]

    def _encode_text(self, text: str) -> List[int]:
        return self.tokenizer.encode(text)

    def _decode_tokens(self, ids) -> str:
        return self.tokenizer.decode([int(i) for i in ids])

    # ------------------------------------------------------------- bounds
    def _kv_bound(self, end_pos: int) -> Optional[int]:
        """KV-read bound for a prefill ending at end_pos: rounded up to 256;
        None (the whole cache) past 3/4 of the context."""
        max_ctx = self.config.text.max_context
        bound = _ceil_to(max(end_pos, 1), 256)
        return bound if bound <= (3 * max_ctx) // 4 else None

    def _decode_bound(self, end_pos: int) -> Optional[int]:
        """KV-read bound for a decode session ending by end_pos: rounded up
        to 256; None when within 256 of the context end."""
        max_ctx = self.config.text.max_context
        bound = _ceil_to(min(end_pos, max_ctx), 256)
        return None if bound >= max_ctx else bound

    # ------------------------------------------------------------- vision
    def _crops(self, image) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Host overlap crops (n, 378, 378, 3) uint8 and the tiling of a PIL
        image or a uint8 (H, W, 3) array."""
        cfg = self.config.vision
        if isinstance(image, np.ndarray):
            np_image = image
        else:
            np_image = np.asarray(image.convert("RGB"))
        if np_image.dtype != np.uint8 or np_image.ndim != 3 or np_image.shape[2] != 3:
            raise ValueError("image must be uint8 (H, W, 3)")
        out = overlap_crop_image(
            np_image, overlap_margin=cfg.overlap_margin, max_crops=cfg.max_crops
        )
        return out["crops"], tuple(out["tiling"])

    def _vision_features(self, crops: torch.Tensor) -> torch.Tensor:
        """(N, 378, 378, 3) uint8 crops on the host -> (N, 729, enc_dim)."""
        x = crops.to(self.device).to(self.dtype) / 255.0
        return vision_encoder((x - 0.5) / 0.5, self.vision)

    def _stitch_project(self, feats: torch.Tensor, tiling) -> torch.Tensor:
        """(..., n, 729, enc_dim) features of each image's global crop and n - 1
        local crops -> (..., 729, text_dim) image embeddings."""
        cfg = self.config.vision
        g = cfg.grid_size
        local = feats[..., 1:, :, :].reshape(*feats.shape[:-3], -1, g, g, cfg.enc_dim)
        recon = reconstruct_from_crops(
            local, tiling, overlap_margin=cfg.overlap_margin, patch_size=1
        )
        return vision_projection(feats[..., 0, :, :], recon, self.vision)

    def _run_vision_encoder(self, image) -> torch.Tensor:
        """PIL image or uint8 (H, W, 3) array -> (729, text_dim) image
        embedding, the ViT over the crops padded to a crop-count bucket."""
        crops, tiling = self._crops(image)
        n = crops.shape[0]
        x = torch.zeros((_bucket(n), *crops.shape[1:]), dtype=torch.uint8)
        x[:n] = torch.from_numpy(crops)
        return self._stitch_project(self._vision_features(x)[:n], tiling)

    def encode_image(self, image, settings: Optional[Dict[str, Any]] = None) -> EncodedImage:
        """Encode an image and prefill [BOS, image] through the text model."""
        if isinstance(image, EncodedImage):
            return image
        img_emb = self._run_vision_encoder(image)
        bos = self.config.tokenizer.bos_id
        bos_emb = text_encoder(torch.tensor([[bos]], device=self.device), self.text)
        embeds = torch.cat([bos_emb, img_emb[None]], dim=1).to(self.dtype)
        seq = embeds.shape[1]
        kv = KVCache.create(self.config.text, 1, self.dtype, self.device)
        engine.prefill(
            self.text, kv, embeds, 0, seq, seq, kv_bound=self._kv_bound(seq)
        )
        return _snap_enc(kv, seq)

    def _take_kv_buffer(self, batch: int = 1, slots: Optional[int] = None) -> KVCache:
        """A (batch, slots) cache buffer, recycled when the pool has one;
        its contents are stale."""
        slots = slots or self.config.text.max_context
        with self._kv_pool_lock:
            pool = self._kv_pool.get((batch, slots))
            if pool:
                return pool.pop()
        return KVCache.create(self.config.text, batch, self.dtype, self.device, slots)

    def _recycle_kv(self, kv: Optional[KVCache]) -> None:
        """Return a buffer to the pool (at most two kept per batch and
        size); the caller must not use it afterwards."""
        if kv is None:
            return
        with self._kv_pool_lock:
            pool = self._kv_pool.setdefault((int(kv.k.shape[1]), int(kv.k.shape[3])), [])
            if len(pool) < 2:
                pool.append(kv)

    def _load_snapshot(self, snap: KVCache, slots: Optional[int]) -> KVCache:
        """A working cache holding `snap` (its batch rows) from column 0, on
        a recycled buffer when the pool has one."""
        kv = self._take_kv_buffer(int(snap.k.shape[1]), slots)
        n = snap.k.shape[3]  # the whole snapshot, as the JAX package writes it
        kv.k[:, :, :, :n] = snap.k
        kv.v[:, :, :, :n] = snap.v
        if kv.ks is not None:
            kv.ks[..., :n] = snap.ks
            kv.vs[..., :n] = snap.vs
        return kv

    def load_encoded_image(
        self, encoded: EncodedImage, slots: Optional[int] = None
    ) -> KVCache:
        """A working cache holding the snapshot, on a recycled buffer when
        the pool has one. `slots` bounds its token capacity (default
        max_context): serving pools pass their slot_len."""
        return self._load_snapshot(encoded.as_cache(), slots)

    # ------------------------------------------------------------ prefill
    def _prefill_prompt(
        self, kv: KVCache, prompt_tokens: List[int], pos: int,
        temperature: float, top_p: float, prefix_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, KVCache]:
        """Embed and prefill a prompt into `kv` (in place), sample the first
        token. Returns (logits, hidden, next_token (0-d device tensor),
        new_pos, kv), as the JAX package does."""
        ids = list(prompt_tokens)
        length = len(ids)
        pad = max(_ceil_to(length, PROMPT_PAD), PROMPT_PAD)
        ids_t = torch.tensor([ids + [0] * (pad - length)], device=self.device)
        emb = text_encoder(ids_t, self.text).to(self.dtype)
        if prefix_len is None:
            prefix_len = self.config.text.prefix_attn
        logits, hidden = engine.prefill(
            self.text, kv, emb, pos, length, prefix_len,
            kv_bound=self._kv_bound(pos + pad),
        )
        next_token = sample_token(logits, self.generator, temperature, top_p)
        return logits, hidden, next_token, pos + length, kv

    # --------------------------------------------------------- generation
    def _settings(self, settings) -> Tuple[int, float, float]:
        s = settings or {}
        return (
            s.get("max_tokens", DEFAULT_MAX_TOKENS),
            s.get("temperature", DEFAULT_TEMPERATURE),
            s.get("top_p", DEFAULT_TOP_P),
        )

    def _generate_answer_tokens(
        self, kv, next_token, pos, settings, eos_id=None
    ) -> List[int]:
        max_tokens, temperature, top_p = self._settings(settings)
        eos = eos_id if eos_id is not None else self.config.tokenizer.eos_id
        result = engine.generate_text(
            self.text, kv, next_token, pos, self.generator, temperature, top_p,
            max_tokens, eos, (self.config.tokenizer.answer_id,),
            kv_bound=self._decode_bound(pos + max_tokens + 1),
        )
        return result.tokens.tolist()

    def _stream_answer(
        self, kv, next_token, pos, settings, eos_id=None
    ) -> Iterator[str]:
        """Incremental streaming: one decode step and one host sync per
        token, text flushed on word boundaries."""
        max_tokens, temperature, top_p = self._settings(settings)
        eos = eos_id if eos_id is not None else self.config.tokenizer.eos_id
        suppress = (self.config.tokenizer.answer_id,)
        streamer = TokenStreamer(self._decode_tokens)
        max_ctx = self.config.text.max_context
        bound = self._decode_bound(pos + max_tokens + 1)
        tok = int(next_token)
        generated = 0
        while tok != eos and generated < max_tokens and pos < max_ctx:
            chunk = streamer.feed(tok)
            if chunk:
                yield chunk
            emb = text_encoder(torch.tensor([[tok]], device=self.device), self.text)
            logits, _ = engine.decode_step(self.text, kv, emb, pos, bound)
            engine.suppress(logits, suppress)
            tok = int(sample_token(logits, self.generator, temperature, top_p))
            pos += 1
            generated += 1
        tail = streamer.finish()
        if tail:
            yield tail

    # -------------------------------------------------------------- query
    def query(
        self,
        image=None,
        question: Optional[str] = None,
        reasoning: bool = False,
        spatial_refs=None,
        stream: bool = False,
        settings: Optional[Dict[str, Any]] = None,
    ):
        """Visual question answering, plain or streamed, with or without an
        image (moondream_tpu/models/moondream.py:1156-1250, no reasoning).
        Without an image the prompt starts with BOS at position 0 and is
        causal throughout."""
        templates = self.config.tokenizer.templates["query"]
        if templates is None:
            raise NotImplementedError("Model does not support querying.")
        if question is None:
            raise ValueError("question must be provided.")
        if spatial_refs and image is None:
            raise ValueError("spatial_refs can only be used with an image.")
        if reasoning or spatial_refs:
            raise NotImplementedError(
                "query with reasoning or spatial_refs needs the region heads, "
                "not ported to moondream_tpu_torch yet (ROADMAP.md Queue 1 #8)"
            )
        tok_cfg = self.config.tokenizer
        if image is not None:
            enc = self.encode_image(image, settings)
            kv, pos = self.load_encoded_image(enc), enc.pos
            prompt = list(templates["prefix"])
            prefix_len = self.config.text.prefix_attn
        else:
            kv, pos = self._take_kv_buffer(1), 0
            prompt = [tok_cfg.bos_id] + list(templates["prefix"])
            prefix_len = 0
        prompt += self._encode_text(question) + list(templates["suffix"])
        _, temperature, top_p = self._settings(settings)
        _, _, next_token, pos, kv = self._prefill_prompt(
            kv, prompt, pos, temperature, top_p, prefix_len=prefix_len
        )
        if stream:
            return {"answer": self._stream_answer(kv, next_token, pos, settings)}
        tokens = self._generate_answer_tokens(kv, next_token, pos, settings)
        return {"answer": "".join(stream_text(tokens, self._decode_tokens))}

    # ------------------------------------------------------------ caption
    def caption(
        self,
        image,
        length: Literal["normal", "short", "long"] = "normal",
        stream: bool = False,
        settings: Optional[Dict[str, Any]] = None,
    ):
        templates = self.config.tokenizer.templates["caption"]
        if templates is None:
            raise NotImplementedError("Model does not support captioning.")
        if length not in templates:
            raise ValueError(f"Model does not support caption length '{length}'.")

        enc = self.encode_image(image, settings)
        _, temperature, top_p = self._settings(settings)
        kv = self.load_encoded_image(enc)
        _, _, next_token, pos, kv = self._prefill_prompt(
            kv, list(templates[length]), enc.pos, temperature, top_p
        )
        if not stream:
            tokens = self._generate_answer_tokens(kv, next_token, pos, settings)
            return {"caption": "".join(stream_text(tokens, self._decode_tokens))}
        return {"caption": self._stream_answer(kv, next_token, pos, settings)}

    # ------------------------------------------------------------ batching
    def encode_images(self, images, settings=None) -> List[EncodedImage]:
        """Batched encode (moondream_tpu/models/moondream.py:1401-1452): host
        crops per image, ONE ViT call per (crop count, tiling) group over the
        group's concatenated crops, one stitch + projection per group, and
        ONE batched [BOS, image] prefill for all images."""
        prepped = [self._crops(im) for im in images]
        groups: Dict[Tuple[int, Tuple[int, int]], List[int]] = {}
        for i, (crops, tiling) in enumerate(prepped):
            groups.setdefault((crops.shape[0], tiling), []).append(i)
        img_embs: List[Optional[torch.Tensor]] = [None] * len(images)
        for (n, tiling), idxs in groups.items():
            crops = torch.from_numpy(np.concatenate([prepped[i][0] for i in idxs]))
            feats = self._vision_features(crops)
            embs = self._stitch_project(feats.reshape(len(idxs), n, *feats.shape[1:]), tiling)
            for j, i in enumerate(idxs):
                img_embs[i] = embs[j]

        bos = self.config.tokenizer.bos_id
        bos_emb = text_encoder(torch.tensor([bos], device=self.device), self.text)
        embeds = torch.stack([torch.cat([bos_emb, e]) for e in img_embs]).to(self.dtype)
        bsz, seq, _ = embeds.shape
        bound = self._kv_bound(seq)
        kv = self._take_kv_buffer(bsz, bound)
        batched_engine.prefill_batched(self.text, kv, embeds, 0, seq, seq, kv_bound=bound)
        encs = [_snap_enc(kv, seq, b) for b in range(bsz)]
        self._recycle_kv(kv)
        return encs

    def caption_batch(
        self,
        images,
        length: Literal["normal", "short", "long"] = "normal",
        settings: Optional[Dict[str, Any]] = None,
    ) -> List[str]:
        """Lockstep batched captioning: one prompt for every image, a shared
        position, per-row EOS."""
        return self._symmetric_batch_generate(
            images, list(self.config.tokenizer.templates["caption"][length]),
            settings,
        )

    def query_batch(
        self, images, question: str, settings: Optional[Dict[str, Any]] = None
    ) -> List[str]:
        """Batched VQA: ONE question over every image, decoded in lockstep."""
        templates = self.config.tokenizer.templates["query"]
        prompt = (
            list(templates["prefix"])
            + self._encode_text(question)
            + list(templates["suffix"])
        )
        return self._symmetric_batch_generate(images, prompt, settings)

    def _batched_prompt_prefill(self, images, ids, settings, session_end):
        """The symmetric batched paths' scaffold
        (moondream_tpu/models/moondream.py:1480-1515): images to
        EncodedImages (one encode_images for the fresh ones), the batched
        cache loaded to the session's bound (`session_end(pos, length, pad)`
        is the last position the session can write), the shared prompt
        broadcast to every row, and ONE batched prefill. Returns (logits,
        hidden, kv, pos, length, bound)."""
        encs = [im if isinstance(im, EncodedImage) else None for im in images]
        to_encode = [im for im, e in zip(images, encs) if e is None]
        if to_encode:
            fresh = iter(self.encode_images(to_encode, settings))
            encs = [e if e is not None else next(fresh) for e in encs]

        pos, length = encs[0].pos, len(ids)
        pad = max(_ceil_to(length, PROMPT_PAD), PROMPT_PAD)
        bound = self._decode_bound(session_end(pos, length, pad))
        kv = self._load_snapshot(_concat_enc_kv(encs), bound)
        ids_t = torch.tensor([list(ids) + [0] * (pad - length)], device=self.device)
        emb = text_encoder(ids_t, self.text).to(self.dtype).repeat(len(encs), 1, 1)
        logits, hidden = batched_engine.prefill_batched(
            self.text, kv, emb, pos, length, self.config.text.prefix_attn,
            kv_bound=self._kv_bound(pos + pad),
        )
        return logits, hidden, kv, pos, length, bound

    def _symmetric_batch_generate(self, images, prompt_tokens, settings) -> List[str]:
        max_tokens, temperature, top_p = self._settings(settings)
        logits, _, kv, pos, length, bound = self._batched_prompt_prefill(
            images, prompt_tokens, settings,
            lambda pos, length, pad: pos + pad + max_tokens + 1,
        )
        first = batched_engine.sample_tokens_batched(
            logits, self.generator, temperature, top_p
        )
        res = batched_engine.generate_text_batched(
            self.text, kv, first, pos + length, self.generator, temperature,
            top_p, max_tokens, self.config.tokenizer.eos_id,
            (self.config.tokenizer.answer_id,), kv_bound=bound,
        )
        rows = torch.cat([res.counts[:, None], res.tokens], dim=1).tolist()  # one read
        self._recycle_kv(kv)
        return ["".join(stream_text(r[1:1 + r[0]], self._decode_tokens)) for r in rows]
