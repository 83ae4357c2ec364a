"""MoondreamModel, caption path and what the serving pool needs of the
model (the main-path subset of moondream_tpu/models/moondream.py).

encode_image: host overlap crops -> ViT over a bucketed crop batch ->
stitch + projection -> [BOS, image] prefill -> KV snapshot. caption: the
template prompt prefill over the restored snapshot, then greedy or top-p
decode, plain or streamed. `models.serve.ContinuousBatchingEngine` prefills
its requests through load_encoded_image (on recycled buffers) and
_prefill_prompt.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Literal, Optional, Tuple

import numpy as np
import torch

from ..config import MoondreamConfig
from ..engine import generate as engine
from ..engine.sampling import sample_token
from ..ops.image_crops import overlap_crop_image, reconstruct_from_crops
from ..tokenizer import TokenizerBase, load_tokenizer
from ..utils.streaming import TokenStreamer, stream_text
from ..weights import init_params
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


def _snap_enc(kv: KVCache, pos: int) -> EncodedImage:
    cut = lambda a: None if a is None else a[..., :pos].clone()
    return EncodedImage(
        pos=pos,
        k=kv.k[:, :, :, :pos].clone(),
        v=kv.v[:, :, :, :pos].clone(),
        ks=cut(kv.ks),
        vs=cut(kv.vs),
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
        device="cpu",
    ):
        """`params`: from `weights.params_from_jax`, `weights.load_params`
        or `weights.init_params` (int4 text blocks: `load_params(...,
        runtime_int4=True)`, or `models.text.quantize_text_params` on
        dense ones); None draws random weights on `device` from `seed`. An
        int8 KV cache comes from config.text.kv_int8. On a CUDA device the
        kernels take bf16 activations only."""
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if params is None:
            params = init_params(config, self.generator, self.device, dtype)
        self.params = params
        self.tokenizer = tokenizer if tokenizer is not None else load_tokenizer()
        # Recycled single-row KV buffers, by slot count (the JAX package's
        # pool, moondream_tpu/models/moondream.py:151-159): the serving pool
        # returns each prefilled request's buffer once its slot write is
        # done, so the next load_encoded_image costs only the snapshot
        # copy. Stale slots past a snapshot are overwritten before they are
        # attended. Servers recycle from other threads: hence the lock.
        self._kv_pool: Dict[int, List[KVCache]] = {}
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
    def _run_vision_encoder(self, image) -> torch.Tensor:
        """PIL image or uint8 (H, W, 3) array -> (729, text_dim) image
        embedding."""
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
        crops, tiling = out["crops"], tuple(out["tiling"])
        n = crops.shape[0]
        b = _bucket(n)
        x = torch.zeros((b, *crops.shape[1:]), dtype=torch.uint8)
        x[:n] = torch.from_numpy(crops)
        x = x.to(self.device).to(self.dtype) / 255.0
        x = (x - 0.5) / 0.5
        feats = vision_encoder(x, self.vision)

        g = cfg.grid_size
        local = feats[1:n].reshape(-1, g, g, cfg.enc_dim)
        recon = reconstruct_from_crops(
            local, tiling, overlap_margin=cfg.overlap_margin, patch_size=1
        )
        return vision_projection(feats[0], recon, self.vision)

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

    def _take_kv_buffer(self, slots: Optional[int] = None) -> KVCache:
        slots = slots or self.config.text.max_context
        with self._kv_pool_lock:
            pool = self._kv_pool.get(slots)
            if pool:
                return pool.pop()
        return KVCache.create(self.config.text, 1, self.dtype, self.device, slots)

    def _recycle_kv(self, kv: Optional[KVCache]) -> None:
        """Return a single-row buffer to the pool (at most two kept per
        size); the caller must not use it afterwards."""
        if kv is None:
            return
        with self._kv_pool_lock:
            pool = self._kv_pool.setdefault(int(kv.k.shape[3]), [])
            if len(pool) < 2:
                pool.append(kv)

    def load_encoded_image(
        self, encoded: EncodedImage, slots: Optional[int] = None
    ) -> KVCache:
        """A working cache holding the snapshot, on a recycled buffer when
        the pool has one. `slots` bounds its token capacity (default
        max_context): serving pools pass their slot_len."""
        kv = self._take_kv_buffer(slots)
        n = encoded.k.shape[3]  # the whole snapshot, as the JAX package writes it
        kv.k[:, :, :, :n] = encoded.k
        kv.v[:, :, :, :n] = encoded.v
        if kv.ks is not None:
            kv.ks[..., :n] = encoded.ks
            kv.vs[..., :n] = encoded.vs
        return kv

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
