"""Device mesh and parameter sharding rules of the port
(moondream_tpu/parallel/mesh.py).

The JAX package places its parameters with NamedShardings and lets GSPMD
partition the computation; here every rank (one process per GPU,
`parallel.comm`) holds its own shard, cut out of the full model, and the
sharded modules call their collectives themselves. The axes:

  dp: data parallel (the rows of a lockstep batch, the slots of a pool)
  tp: tensor parallel (Megatron splits: qkv and fc1 column-parallel, proj
      and fc2 row-parallel, the LM head split on the vocabulary)

`create_mesh` builds a `torch.distributed.device_mesh.DeviceMesh` over
the ranks of the process group; `shard_text_model` cuts one rank's text
model out of the full one. Training's batch placement (`batch_shardings`,
`shard_batch`) is not ported yet.

Deviation: the JAX package splits `wte` on its model axis; every rank here
keeps the whole table, since each looks up whole rows (a lookup needs no
collective then).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import TextConfig, TextShardConfig
from ..models.text import TextBlock, TextModel
from ..ops.layers import MLP, Linear, RowParallelLinear, VocabParallelLinear
from . import comm


def create_mesh(axes: Dict[str, int], device=None) -> DeviceMesh:
    """A DeviceMesh with named axes over the process group's ranks, e.g.
    {"dp": 2, "tp": 2}, rank-major in the axes' order as the JAX package
    lays devices out. The mesh must cover the world: a larger one raises
    the JAX package's ValueError("mesh needs n devices, have m"). Without a
    process group, a mesh of one starts a world of one on `device` (the
    card by default). Every group of the mesh runs one collective here, so
    that NCCL's communicators exist before any CUDA graph captures one."""
    n = 1
    for size in axes.values():
        n *= int(size)
    if not dist.is_initialized():
        if n > 1:
            raise ValueError(f"mesh needs {n} devices, have 1 (no process group: start "
                             "the ranks with parallel.comm.launch)")
        comm.init_process_group("cuda" if device is None else device, 0, 1)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh covers {n} of the world's {world} ranks; name every rank")
    dev = comm.process_device()
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"the process group's ranks run on {dev.type}, not {device}")
    mesh = init_device_mesh(dev.type, tuple(int(s) for s in axes.values()),
                            mesh_dim_names=tuple(axes))
    for name in axes:
        comm.warm_up(mesh.get_group(name), dev)
    return mesh


def default_mesh_axes(n_devices: int) -> Dict[str, int]:
    """A sensible dp x tp factorization: tp gets the largest power-of-two
    divisor up to 8, dp the rest (moondream_tpu/parallel/mesh.py:41-49)."""
    tp = 1
    for cand in (8, 4, 2):
        if n_devices % cand == 0:
            tp = cand
            break
    return {"dp": n_devices // tp, "tp": tp}


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of a mesh axis; 1 for an axis the mesh does not name."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index(name))) if name in names else 1


def axis_rank(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on a mesh axis; 0 for an axis it does not
    name."""
    return int(mesh.get_local_rank(name)) if name in (mesh.mesh_dim_names or ()) else 0


def axis_group(mesh: DeviceMesh, name: str):
    """The process group of this rank's line along a mesh axis; None for an
    axis the mesh does not name (a collective over one rank is skipped)."""
    return mesh.get_group(name) if name in (mesh.mesh_dim_names or ()) else None


# --------------------------------------------------------- placement rules


def text_param_shardings() -> Dict[str, tuple]:
    """The text model's Megatron split (moondream_tpu/parallel/mesh.py:
    78-102), per parameter of the port (its name in the text model, "*"
    for the block index): the axis of each dimension that is split, None
    whole, "tp" cut over the tp ranks; absent names are whole. qkv and fc1
    are column-parallel (qkv cut by heads: each rank's q heads and their
    K/V heads, `qkv_columns`), proj and fc2 row-parallel (their biases
    whole, added once after the sum), the LM head cut on the vocabulary,
    norms and `wte` whole. `shard_text_model` cuts by this table."""
    return {
        "wte": (None, None),
        "blocks.*.qkv.w": (None, "tp"),
        "blocks.*.qkv.b": ("tp",),
        "blocks.*.proj.w": ("tp", None),
        "blocks.*.mlp.fc1.w": (None, "tp"),
        "blocks.*.mlp.fc1.b": ("tp",),
        "blocks.*.mlp.fc2.w": ("tp", None),
        "lm_head.w": (None, "tp"),
        "lm_head.b": ("tp",),
    }


# -------------------------------------------------------------- the cut


@dataclass(frozen=True)
class Shard:
    """One rank's place in a dp x tp mesh and the groups of its lines."""

    tp: int
    tp_rank: int
    dp: int
    dp_rank: int
    tp_group: Any
    dp_group: Any
    key: str  # names the mesh and the rank in graph keys

    @classmethod
    def of(cls, mesh: DeviceMesh) -> "Shard":
        tp, dp = axis_size(mesh, "tp"), axis_size(mesh, "dp")
        tr, dr = axis_rank(mesh, "tp"), axis_rank(mesh, "dp")
        key = f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} rank {dist.get_rank()}"
        return cls(tp, tr, dp, dr, axis_group(mesh, "tp"), axis_group(mesh, "dp"), key)


def qkv_columns(config: TextConfig, tp: int, rank: int) -> torch.Tensor:
    """The fused qkv output features of tp rank `rank`: its n_heads/tp q
    heads and the n_kv_heads/tp K and V heads they read, in [q | k | v]
    order. A contiguous cut of the fused axis would mix q with k."""
    hd = config.head_dim
    hq, hkv = config.n_heads // tp, config.n_kv_heads // tp
    q0 = rank * hq * hd
    k0 = config.n_heads * hd + rank * hkv * hd
    v0 = config.n_heads * hd + config.n_kv_heads * hd + rank * hkv * hd
    return torch.cat([torch.arange(q0, q0 + hq * hd), torch.arange(k0, k0 + hkv * hd),
                      torch.arange(v0, v0 + hkv * hd)])


def local_text_config(config: TextConfig, tp: int) -> TextShardConfig:
    """A tp rank's text config (`config.TextShardConfig`)."""
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(TextConfig)}
    fields.update(dim=config.dim // tp, n_heads=config.n_heads // tp,
                  n_kv_heads=config.n_kv_heads // tp, ff_dim=config.ff_dim // tp)
    return TextShardConfig(**fields, model_dim=config.dim)


def _cut(model: TextModel, name: str, cfg: TextConfig, shard: "Shard") -> torch.Tensor:
    """Text parameter `name` of the full model, cut for the rank on each
    dimension that `text_param_shardings` puts on tp: by heads for qkv
    (`qkv_columns`), else the rank's contiguous share. A parameter left
    whole, or any under tp 1, is the full model's tensor, shared."""
    t = model.get_parameter(name)
    spec = text_param_shardings().get(re.sub(r"^blocks\.\d+\.", "blocks.*.", name))
    if spec is None or shard.tp == 1:
        return t
    r = shard.tp_rank
    for dim, axis in enumerate(spec):
        if axis != "tp":
            continue
        if ".qkv." in name:
            idx = qkv_columns(cfg, shard.tp, r)
        else:
            n = t.shape[dim] // shard.tp
            idx = torch.arange(r * n, (r + 1) * n)
        t = t.index_select(dim, idx.to(t.device))
    return t.contiguous()


def _dense_linear(w: torch.Tensor, b: torch.Tensor) -> Linear:
    lin = Linear.__new__(Linear)
    nn.Module.__init__(lin)
    lin.w = nn.Parameter(w.contiguous(), requires_grad=False)
    lin.b = nn.Parameter(b.contiguous(), requires_grad=False)
    return lin


def check_shardable(config: TextConfig, tp: int) -> None:
    """Raise ValueError unless the heads, the MLP width and the vocabulary
    split evenly over tp."""
    for name in ("n_heads", "n_kv_heads", "ff_dim", "vocab_size"):
        if getattr(config, name) % tp:
            raise ValueError(f"{name}={getattr(config, name)} not divisible by tp={tp}")


def shard_text_model(model: TextModel, mesh: DeviceMesh,
                     config: Optional[TextConfig] = None) -> TextModel:
    """This rank's shard of a full text model, on the model's device: a
    TextModel whose config is the rank's (`local_text_config`), whose qkv
    and fc1 hold its columns (`qkv_columns`; fc1's contiguous), whose proj
    and fc2 are `RowParallelLinear`s over its rows, and whose LM head is a
    `VocabParallelLinear` over its vocabulary slice; wte, the norms and the
    RoPE table are the full model's tensors, shared. Weights of a world of
    one are shared, not copied. `model.shard` (`Shard`) carries the mesh.
    `config`: the text config to cut (its kv_int8 included), by default
    the model's.

    Quantized text blocks (int4 or int8 w8a8) raise ValueError: the JAX
    package's shardings name only the dense weights, and placing quantized
    parameters on a mesh raises there too."""
    if not all(type(blk.qkv) is Linear for blk in model.blocks):
        raise ValueError(
            "sharded text params must be dense: the JAX package's mesh shardings name "
            "only the dense {w, b} leaves and refuse int4 / int8 text blocks")
    shard = Shard.of(mesh)
    cfg = config or model.config
    check_shardable(cfg, shard.tp)

    def cut(name):
        return _cut(model, name, cfg, shard)

    out = TextModel.__new__(TextModel)
    nn.Module.__init__(out)
    out.config = local_text_config(cfg, shard.tp)
    out.wte = model.wte
    blocks = []
    for i, blk in enumerate(model.blocks):
        p = f"blocks.{i}."
        nb = TextBlock.__new__(TextBlock)
        nn.Module.__init__(nb)
        nb.ln = blk.ln
        nb.qkv = (blk.qkv if shard.tp == 1 else
                  _dense_linear(cut(p + "qkv.w"), cut(p + "qkv.b")))
        nb.proj = RowParallelLinear(cut(p + "proj.w"), cut(p + "proj.b"), shard.tp_group)
        mlp = MLP.__new__(MLP)
        nn.Module.__init__(mlp)
        mlp.fc1 = (blk.mlp.fc1 if shard.tp == 1 else
                   _dense_linear(cut(p + "mlp.fc1.w"), cut(p + "mlp.fc1.b")))
        mlp.fc2 = RowParallelLinear(cut(p + "mlp.fc2.w"), cut(p + "mlp.fc2.b"), shard.tp_group)
        nb.mlp = mlp
        blocks.append(nb)
    out.blocks = nn.ModuleList(blocks)
    out.post_ln = model.post_ln
    out.lm_head = VocabParallelLinear(cut("lm_head.w"), cut("lm_head.b"), shard.tp_group)
    out.register_buffer("freqs_cis", model.freqs_cis, persistent=False)
    out.shard = shard
    return out


def shard_adapter(tree: Optional[dict], model: TextModel) -> Optional[dict]:
    """A stacked LoRA adapter (`lora.variant_state_dict`'s layout) cut for
    the rank whose shard `model` is: qkv's B to the rank's qkv columns,
    fc1's B to its MLP columns and fc2's A to the same input columns (their
    partial products are summed over tp, `ops.layers.lora_delta`); proj's
    pair reads and writes the whole width and stays whole. A tree already
    cut for this rank, or any tree under tp 1, comes back as it is. The
    rank keeps its last few cuts, by tree, so that a request under the same
    adapter gets the same tensors (graph keys name their addresses)."""
    shard = getattr(model, "shard", None)
    if tree is None or shard is None or shard.tp == 1:
        return tree
    cuts = model.__dict__.setdefault("_adapter_cuts", {})
    held = cuts.get(id(tree))
    if held is not None and held[0] is tree:
        return held[1]
    out = _cut_adapter(tree, model, shard)
    cuts[id(tree)] = (tree, out)
    while len(cuts) > 8:
        cuts.pop(next(iter(cuts)))
    return out


def _cut_adapter(tree: dict, model: TextModel, shard: Shard) -> dict:
    lcfg = model.config
    full = TextConfig(**{f.name: getattr(lcfg, f.name) for f in dataclasses.fields(TextConfig)})
    full = dataclasses.replace(full, dim=lcfg.model_dim, n_heads=lcfg.n_heads * shard.tp,
                               n_kv_heads=lcfg.n_kv_heads * shard.tp,
                               ff_dim=lcfg.ff_dim * shard.tp)
    r = shard.tp_rank
    ff = slice(r * lcfg.ff_dim, (r + 1) * lcfg.ff_dim)
    out = {grp: {name: dict(pair) for name, pair in sites.items()}
           for grp, sites in tree.items()}
    attn, mlp = out.get("attn") or {}, out.get("mlp") or {}
    if "qkv" in attn and attn["qkv"]["B"].shape[1] == full.qkv_dim:
        cols = qkv_columns(full, shard.tp, r).to(attn["qkv"]["B"].device)
        attn["qkv"]["B"] = attn["qkv"]["B"].index_select(1, cols)
    if "fc1" in mlp and mlp["fc1"]["B"].shape[1] == full.ff_dim:
        mlp["fc1"]["B"] = mlp["fc1"]["B"][:, ff].contiguous()
    if "fc2" in mlp and mlp["fc2"]["A"].shape[2] == full.ff_dim:
        mlp["fc2"]["A"] = mlp["fc2"]["A"][:, :, ff].contiguous()
    return out
