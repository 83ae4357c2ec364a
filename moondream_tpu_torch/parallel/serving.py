"""The serving pool over a dp x tp mesh, and the crop-parallel ViT
(moondream_tpu/parallel/serving.py).

`make_sharded_serving_engine(model, mesh, **engine_kwargs)` builds, on
every rank, a `ShardedBatchingEngine`: the ContinuousBatchingEngine over a
twin of the model whose text params are the rank's shard
(`mesh.shard_text_model`). Its KV pool holds the rank's dp group's slots
(n_slots/dp) at its heads (Hkv/tp); every chunk (plain, speculative,
sampled, mixed, mixed speculative) runs the group's rows through the
port's kernels on the rank's heads and gathers every slot's tokens and
state over dp inside the chunk (inside its CUDA graph on the card), so
every rank's host scheduler holds the same state and takes the same
decisions. Admissions (encode, [BOS, image] prefill, prompt prefill) run
on every rank; a slot's KV is written only by the dp group that owns it.

Every rank must make the same engine calls in the same order: directly
(SPMD), or through `comm.Controller` on rank 0 with `comm.follow` on the
others, as `serve_http`'s `mesh=` does.

    mesh = create_mesh({"dp": 2, "tp": 2})
    eng = make_sharded_serving_engine(model, mesh, n_slots=8)
    eng.submit(image); eng.drain()          # the pool's API, mesh-wide chunks

Sampled rows of a pool with dp > 1 draw from each dp group's generator
over its own rows: the same distribution as the unsharded pool, other
draws. Greedy rows are the unsharded pool's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.moondream import MoondreamModel
from ..models.serve import ContinuousBatchingEngine
from ..models.text import KVCache
from ..models.vision import normalize_crops, vision_encoder
from ..engine import serving
from .comm import gather_rows
from .mesh import axis_size, shard_adapter, shard_text_model


def shard_model(model: MoondreamModel, mesh) -> MoondreamModel:
    """A twin of `model` on the same device whose text params are this
    rank's shard; the ViT and the region heads are the model's own,
    shared. Its caches (`cache_config`) hold the rank's heads."""
    params = nn.ModuleDict({name: mod for name, mod in model.params.items() if name != "text"})
    params["text"] = shard_text_model(model.text, mesh, model.config.text)
    return MoondreamModel(model.config, params=params, tokenizer=model.tokenizer,
                          dtype=model.dtype, device=model.device, graphed=model.graphed)


def shard_vision_encoder(model: MoondreamModel, mesh) -> None:
    """Make the model's ViT run data-parallel over every rank of the world
    (moondream_tpu/parallel/serving.py:41-80): an image's crops (already on
    each rank's card: every rank crops the whole image) are padded with
    zero crops to a multiple of the world size, each rank runs its
    contiguous share through the ViT, and the shares are gathered in rank
    order and sliced back. A crop's features do not depend on the others
    (attention and LayerNorm reduce within a crop), so the gathered stack is
    the unsharded one up to the GEMMs' choice of algorithm at another M.
    Every encode route (encode_image, encode_images, the pipelines) goes
    through `_vision_features`, which this replaces on the model."""
    import torch.distributed as dist

    world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    if axis_size(mesh, "dp") * axis_size(mesh, "tp") != world:
        raise ValueError("the crop-parallel ViT spans the whole world; the mesh must too")

    def vision_features(crops: torch.Tensor) -> torch.Tensor:
        crops = crops.to(model.device)
        n = crops.shape[0]
        per = -(-n // world)
        if per * world > n:
            crops = torch.cat([crops, crops.new_zeros((per * world - n, *crops.shape[1:]))])
        mine = crops[rank * per:(rank + 1) * per]
        feats = vision_encoder(normalize_crops(mine, model.dtype), model.vision)
        return gather_rows(feats, group)[:n]

    model._vision_features = vision_features


class ShardedBatchingEngine(ContinuousBatchingEngine):
    """A ContinuousBatchingEngine whose slots are split over the mesh's dp
    groups and whose heads over tp (the module's docstring). `model` is a
    rank's twin (`shard_model`), whose text model carries the mesh;
    `variants` are cut for the rank (`mesh.shard_adapter`) before they are
    stacked."""

    def __init__(self, model: MoondreamModel, **engine_kwargs):
        self.shard = model.text.shard
        variants = engine_kwargs.pop("variants", None)
        if variants:
            variants = {name: shard_adapter(tree, model.text) for name, tree in variants.items()}
        super().__init__(model, variants=variants, **engine_kwargs)

    def _slot_range(self, n_slots: int):
        per = n_slots // self.shard.dp
        return self.shard.dp_rank * per, (self.shard.dp_rank + 1) * per

    def _rows(self, t):
        if not isinstance(t, torch.Tensor):
            return t
        lo, hi = self._slot_range(self.n_slots)
        return t[lo:hi]

    def _gather(self, res: serving.ServeChunkResult, mixed: bool) -> serving.ServeChunkResult:
        group = self.shard.dp_group

        def every_slot(t):
            if t is None:
                return None
            if t.dtype == torch.bool:
                return gather_rows(t.to(torch.uint8), group).bool()
            return gather_rows(t, group)

        if mixed:  # the host reads the structured rows' objects
            self.nobj.copy_(every_slot(self._rows(self.nobj)))
            self.sboxes.copy_(every_slot(self._rows(self.sboxes)))
        return serving.ServeChunkResult(*(every_slot(t) for t in res))

    def _write_slot(self, snap: KVCache, slot: int) -> None:
        lo, hi = self._slot_range(self.n_slots)
        if lo <= slot < hi:
            serving.write_slot(self.kv, snap, slot - lo)


def make_sharded_serving_engine(model: MoondreamModel, mesh, shard_vision: bool = False,
                                **engine_kwargs) -> ShardedBatchingEngine:
    """This rank's engine of a pool sharded over `mesh` (slots on dp, heads
    on tp), built from the full `model` on every rank; with `shard_vision`
    the admissions' ViT runs crop-parallel over the world
    (`shard_vision_encoder`). Raises the JAX package's ValueErrors for
    n_kv_heads not divisible by tp and n_slots not divisible by dp. A
    prefix-shared pool is refused (its shared prefix store is not split).
    The engine serves a twin holding the rank's shard; drop the caller's
    `model` once it is no longer needed."""
    if engine_kwargs.get("prefix_share"):  # before the mesh is read: serve_http's check
        raise ValueError("prefix_share is single-chip for now (the sharded serving "
                         "engine does not shard the prefix pool yet)")
    cfg = model.config
    tp, dp = axis_size(mesh, "tp"), axis_size(mesh, "dp")
    if cfg.text.n_kv_heads % tp:
        raise ValueError(f"n_kv_heads={cfg.text.n_kv_heads} not divisible by tp={tp}")
    n_slots = int(engine_kwargs.get("n_slots", 8))
    if n_slots % dp:
        raise ValueError(f"n_slots={n_slots} not divisible by dp={dp}")
    smodel = shard_model(model, mesh)
    if shard_vision:
        shard_vision_encoder(smodel, mesh)
    return ShardedBatchingEngine(smodel, **engine_kwargs)
