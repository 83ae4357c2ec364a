"""Tensor- and data-parallel inference for the text decoder
(moondream_tpu/parallel/inference.py).

Each rank holds its shard of the decoder (`mesh.shard_text_model`: Megatron
splits, heads on tp), the rows of the batch that its dp group owns, and
those rows' KV cache at its heads: (L, B/dp, Hkv/tp, T, D). Every rank runs
the port's kernels on its own heads (flash attention for the prefill,
decode attention for the steps); the row-parallel proj and fc2 sum their
fp32 partials over tp, and the LM head gathers the vocabulary over tp. The
dp groups decode their rows independently (each stops when its own rows
are done); the rows are gathered over dp once, at the end of `generate`
(and of `prefill`, whose logits the caller reads). On the card the decode
steps replay CUDA graphs with their collectives inside, as the unsharded
loops do.

Where the JAX package forces its XLA attention under a mesh (GSPMD cannot
partition a Pallas call), the port keeps its kernels: attention is
independent per head, so each rank attends its own.

Usage, on every rank of a launched world (`comm.launch`):

    mesh = create_mesh({"dp": 2, "tp": 2})
    eng = ShardedTextEngine(model.text, model.config.text, mesh)
    logits, hidden, kv = eng.prefill(embeds, pos=0, length=n, prefix_len=n)
    res = eng.generate(kv, logits.argmax(-1), n, max_tokens=64)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import TextConfig
from ..engine import batched as batched_engine
from ..models.text import KVCache, TextModel
from .comm import gather_rows
from .mesh import shard_text_model


def kv_cache_sharding(mesh=None, config: Optional[TextConfig] = None) -> KVCache:
    """Where each axis of the sharded KV cache lives, in the JAX package's
    form (moondream_tpu/parallel/inference.py:36-42): values (L, B, Hkv, T,
    D) with the batch on dp and the heads on tp; with config.kv_int8 the
    scales (L, B, Hkv, T), one per head and token, split alike."""
    spec = (None, "dp", "tp", None, None)
    if config is not None and config.kv_int8:
        return KVCache(k=spec, v=spec, ks=spec[:4], vs=spec[:4])
    return KVCache(k=spec, v=spec)


def _bound(end_pos: int, max_context: int) -> Optional[int]:
    """The KV-read bound of a call ending at end_pos: rounded up to 256, or
    None (the whole cache) past 3/4 of the context, as the model's."""
    bound = -(-max(end_pos, 1) // 256) * 256
    return bound if bound <= (3 * max_context) // 4 else None


class ShardedTextEngine:
    """Sharded prefill and lockstep generation over a dp x tp mesh, with the
    JAX package's calls and results. Built on every rank from the full text
    model (cut at construction); every rank then makes the same calls with
    the same arguments (directly, or through `comm.Controller`)."""

    def __init__(self, text_model: TextModel, config: TextConfig, mesh):
        self.mesh = mesh
        self.config = config
        self.model = shard_text_model(text_model, mesh, config)
        self.shard = self.model.shard
        self.device = text_model.wte.device

    def _rows(self, batch: int) -> slice:
        """This rank's dp rows of a batch of `batch`."""
        dp = self.shard.dp
        if batch % dp:
            raise ValueError(f"batch={batch} not divisible by dp={dp}")
        per = batch // dp
        return slice(self.shard.dp_rank * per, (self.shard.dp_rank + 1) * per)

    def create_cache(self, batch: int = 1, dtype=torch.bfloat16) -> KVCache:
        """This rank's part of a batch's cache: its dp rows, its heads."""
        rows = self._rows(batch)
        return KVCache.create(self.model.config, rows.stop - rows.start, dtype, self.device)

    def prefill(
        self,
        embeds: torch.Tensor,
        kv: Optional[KVCache] = None,
        pos: int = 0,
        length: Optional[int] = None,
        prefix_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
        """Prefill the whole batch's right-padded embeds (B, T, D) at `pos`
        (this rank runs its dp rows), writing the rank's cache. Returns the
        whole batch's ((B, V) fp32 logits, (B, D) hidden) of the last real
        row, gathered over dp, and the cache."""
        bsz = embeds.shape[0]
        if kv is None:
            kv = self.create_cache(bsz, embeds.dtype)
        length = embeds.shape[1] if length is None else int(length)
        prefix_len = self.config.prefix_attn if prefix_len is None else int(prefix_len)
        local = embeds[self._rows(bsz)].to(self.device)
        bound = _bound(pos + embeds.shape[1], self.config.max_context)
        logits, hidden = batched_engine.prefill_batched(
            self.model, kv, local, int(pos), length, prefix_len, kv_bound=bound)
        return (gather_rows(logits, self.shard.dp_group),
                gather_rows(hidden, self.shard.dp_group), kv)

    def generate(
        self,
        kv: KVCache,
        first_tokens,
        pos: int,
        max_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 0.0,
        eos_id: int = 0,
        suppress_ids: Tuple[int, ...] = (),
        rng: Optional[int] = None,
        buffer: int = 1024,
    ) -> batched_engine.BatchedGenerateResult:
        """Lockstep generation of the whole batch from first_tokens (B,) at
        `pos` (this rank decodes its dp rows; `rng` seeds the draws, 0 by
        default, alike on every rank). Returns a BatchedGenerateResult
        whose tokens are (B, buffer), zero past each row's count, gathered
        over dp once at the end; its `pos` is past the last step of the
        longest-running dp group."""
        first = torch.as_tensor(first_tokens).reshape(-1).to(self.device, torch.long)
        local = first[self._rows(first.shape[0])]
        gen = torch.Generator(device=self.device).manual_seed(0 if rng is None else int(rng))
        res = batched_engine.generate_text_batched(
            self.model, kv, local, int(pos), gen, float(temperature), float(top_p),
            min(int(max_tokens), buffer), eos_id, tuple(suppress_ids),
            kv_bound=_bound(int(pos) + min(int(max_tokens), buffer), self.config.max_context))
        steps = res.tokens.shape[1]
        packed = torch.zeros((local.shape[0], buffer + 2), dtype=torch.long, device=self.device)
        packed[:, :steps] = res.tokens
        packed[:, buffer] = res.counts
        packed[:, buffer + 1] = steps
        full = gather_rows(packed, self.shard.dp_group)
        return batched_engine.BatchedGenerateResult(
            tokens=full[:, :buffer], counts=full[:, buffer],
            pos=int(pos) + int(full[:, buffer + 1].max()))
