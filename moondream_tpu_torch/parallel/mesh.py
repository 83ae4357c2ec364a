"""Device mesh and parameter sharding rules of the port
(moondream_tpu/parallel/mesh.py).

The JAX package places its parameters with NamedShardings and lets GSPMD
partition the computation; here every rank (one process per GPU,
`parallel.comm`) holds its own shard, cut out of the full model, and the
sharded modules call their collectives themselves. The axes:

  dp: data parallel (the rows of a lockstep batch, the slots of a pool,
      the rows of a training batch)
  tp: tensor parallel (Megatron splits: qkv and fc1 column-parallel, proj
      and fc2 row-parallel, the LM head split on the vocabulary)
  sp: sequence parallel (a training batch's positions; any axis name
      given to `shard_batch` as seq_axis)

`create_mesh` builds a `torch.distributed.device_mesh.DeviceMesh` over
the ranks of the process group; `shard_text_model` cuts one rank's text
model out of the full one; `shard_batch` cuts one rank's block of a
training batch, which `finetune.trainer.make_train_step` trains on
(`train_plan`); `shard_params` cuts one rank's share of every tensor of
the whole model by `param_shardings` (placement only: no port forward
reads a tp-cut ViT). The pipeline axis is `parallel.pipeline`'s.

Deviations: the JAX package splits `wte` on its model axis; every rank here
keeps the whole table, since each looks up whole rows (a lookup needs no
collective then). The text qkv is cut by heads (`qkv_columns`), where the
JAX package places contiguous columns and lets GSPMD move them.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

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


def vision_param_shardings() -> Dict[str, tuple]:
    """The ViT's Megatron split (moondream_tpu/parallel/mesh.py:105-130),
    per parameter of the port's vision model, as `text_param_shardings`:
    qkv and fc1 column-parallel, proj and fc2 row-parallel, and the
    projection MLP (one MLP, not stacked) split the same way; the patch
    embedding, positions and norms whole. Placement only (`shard_params`):
    no port forward reads a tp-cut ViT (serving splits crops over the ranks,
    `parallel.serving.shard_vision_encoder`), so qkv's columns are the
    contiguous share that the JAX package places."""
    return {
        "blocks.*.qkv.w": (None, "tp"),
        "blocks.*.qkv.b": ("tp",),
        "blocks.*.proj.w": ("tp", None),
        "blocks.*.mlp.fc1.w": (None, "tp"),
        "blocks.*.mlp.fc1.b": ("tp",),
        "blocks.*.mlp.fc2.w": ("tp", None),
        "proj_mlp.fc1.w": (None, "tp"),
        "proj_mlp.fc1.b": ("tp",),
        "proj_mlp.fc2.w": ("tp", None),
    }


def region_param_shardings() -> Dict[str, tuple]:
    """The region heads: every tensor whole
    (moondream_tpu/parallel/mesh.py:133-145)."""
    return {}


def param_shardings() -> Dict[str, Dict[str, tuple]]:
    """The whole model's tables by part (moondream_tpu/parallel/mesh.py:
    148-153)."""
    return {"vision": vision_param_shardings(), "text": text_param_shardings(),
            "region": region_param_shardings()}


def _rule(table: Dict[str, tuple], name: str) -> Optional[tuple]:
    return table.get(re.sub(r"^blocks\.\d+\.", "blocks.*.", name))


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


def full_text_config(config: TextConfig, tp: int) -> TextConfig:
    """The whole model's text config from a tp rank's (`local_text_config`)."""
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(TextConfig)}
    if isinstance(config, TextShardConfig):
        fields.update(dim=config.model_dim, n_heads=config.n_heads * tp,
                      n_kv_heads=config.n_kv_heads * tp, ff_dim=config.ff_dim * tp)
    return TextConfig(**fields)


def _contiguous_cut(t: torch.Tensor, spec: Optional[tuple], n: int, r: int) -> torch.Tensor:
    """Rank r's contiguous share, of n, of each dimension `spec` puts on tp."""
    for dim, axis in enumerate(spec or ()):
        if axis == "tp" and n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, r * size, size)
    return t.contiguous()


def cut_text_tensor(t: torch.Tensor, name: str, config: TextConfig, tp: int,
                    rank: int) -> torch.Tensor:
    """Text parameter `name` (the full model's tensor `t`, `config` the full
    model's) cut for tp rank `rank` on each dimension that
    `text_param_shardings` puts on tp: by heads for qkv (`qkv_columns`),
    else the rank's contiguous share. A tensor left whole, or any under tp
    1, is `t` itself."""
    spec = _rule(text_param_shardings(), name)
    if spec is None or tp == 1:
        return t
    if ".qkv." not in name:
        return _contiguous_cut(t, spec, tp, rank)
    dim = spec.index("tp")
    return t.index_select(dim, qkv_columns(config, tp, rank).to(t.device)).contiguous()


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


def _dense_parts(params) -> None:
    """Raise ValueError for int4 / int8 blocks in the vision or text part."""
    for part in ("vision", "text"):
        if part in params and not all(type(blk.qkv) is Linear for blk in params[part].blocks):
            raise ValueError(
                f"sharded {part} params must be dense: the JAX package's mesh shardings name "
                "only the dense {w, b} leaves and refuse int4 / int8 blocks")


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
    _dense_parts({"text": model})
    shard = Shard.of(mesh)
    cfg = config or model.config
    check_shardable(cfg, shard.tp)

    def cut(name):
        return cut_text_tensor(model.get_parameter(name), name, cfg, shard.tp, shard.tp_rank)

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
    full = full_text_config(lcfg, shard.tp)
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


# ------------------------------------------------------------ the whole model


def shard_params(model, mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """This rank's share of every tensor of the whole model (a MoondreamModel
    or its parameters' ModuleDict) by `param_shardings`, name -> tensor on
    the model's device, the names "part.leaf" (`finetune.optim.named_leaves`
    of each part, the RoPE table included): the text cut as
    `shard_text_model` cuts it (`cut_text_tensor`), the vision cut into
    contiguous shares as the JAX package places them, the region heads
    whole. Placement only (moondream_tpu/parallel/mesh.py:156-159). First it
    checks that every split dimension divides its mesh axis, and that the
    text heads, MLP width and vocabulary split over tp (`check_shardable`;
    the 2B check of the JAX package's multi-chip dry run), and raises
    ValueError naming the tensor; int4 / int8 blocks raise ValueError."""
    from ..finetune.optim import named_leaves

    params = getattr(model, "params", model)
    _dense_parts(params)
    tables = param_shardings()
    tp, r = axis_size(mesh, "tp"), axis_rank(mesh, "tp")
    named = [(part, name, t) for part in ("vision", "text", "region") if part in params
             for name, t in named_leaves(params[part])]
    for part, name, t in named:
        for dim, axis in enumerate(_rule(tables[part], name) or ()):
            if axis is not None and t.shape[dim] % axis_size(mesh, axis):
                raise ValueError(
                    f"{part}.{name}: dim {dim} of {tuple(t.shape)} not divisible by "
                    f"{axis}={axis_size(mesh, axis)} under mesh "
                    f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    if "text" in params:
        check_shardable(params["text"].config, tp)
    out = {}
    for part, name, t in named:
        t = t.detach()
        out[f"{part}.{name}"] = (
            cut_text_tensor(t, name, params["text"].config, tp, r) if part == "text"
            else _contiguous_cut(t, _rule(tables[part], name), tp, r))
    return out


# ------------------------------------------------------------ training


@dataclass(frozen=True)
class BatchShard:
    """One rank's block of a training batch (`shard_batch`): the dp group
    its rows are split over, and under sequence parallelism (`seq_axis`
    set) the sequence group, the block's first position and the whole
    sequence's length."""

    dp_group: Any
    seq_axis: Optional[str]
    seq_group: Any
    seq_offset: int
    seq_len: int


class ShardedBatch(dict):
    """`shard_batch`'s result: the rank's tensors by key, and `.shard`, its
    BatchShard."""

    shard: BatchShard


def batch_shardings(mesh: Optional[DeviceMesh] = None,
                    seq_axis: Optional[str] = None) -> Dict[str, tuple]:
    """Each training batch key's split (moondream_tpu/parallel/mesh.py:
    56-69): rows on "dp" and, with `seq_axis` (say "sp"), positions on
    that axis."""
    if seq_axis is not None and mesh is not None and seq_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {seq_axis!r}")
    return {
        "inputs_embeds": ("dp", seq_axis, None),
        "labels": ("dp", seq_axis),
        "label_mask": ("dp", seq_axis),
    }


def shard_batch(batch: dict, mesh: DeviceMesh, seq_axis: Optional[str] = None) -> ShardedBatch:
    """This rank's block of a host batch {"inputs_embeds" (B, T, D),
    "labels" (B, T), "label_mask" (B, T)} (numpy or tensors) on its device
    (moondream_tpu/parallel/mesh.py:72-75): its B/dp rows and, with
    `seq_axis`, its T/sp positions, for `finetune.trainer.make_train_step`.
    Under sequence parallelism the shifted cross-entropy crosses block
    edges (position t predicts labels[t+1]), so labels and label_mask are
    shifted by one over the whole sequence before the cut, the last
    position's mask 0; the loss then reads each position's own label.
    Raises ValueError when B does not split over dp or T over the sequence
    axis."""
    shardings = batch_shardings(mesh, seq_axis)
    dp, dr = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    sp, sr = (axis_size(mesh, seq_axis), axis_rank(mesh, seq_axis)) if seq_axis else (1, 0)
    unknown = set(batch) - set(shardings)
    if unknown:
        raise KeyError(f"no split for batch keys {sorted(unknown)}")
    host = {k: torch.as_tensor(v) for k, v in batch.items()}
    b, t = host["labels"].shape
    if b % dp:
        raise ValueError(f"batch of {b} rows does not split over dp={dp}")
    if t % sp:
        raise ValueError(f"sequence of {t} positions does not split over {seq_axis}={sp}")
    if seq_axis:
        pad = lambda x: torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
        host["labels"], host["label_mask"] = pad(host["labels"]), pad(host["label_mask"])
    rows = slice(dr * (b // dp), (dr + 1) * (b // dp))
    cols = slice(sr * (t // sp), (sr + 1) * (t // sp))
    dev = comm.process_device()
    out = ShardedBatch({k: v[rows, cols].to(dev, copy=True) for k, v in host.items()})
    out.shard = BatchShard(axis_group(mesh, "dp"), seq_axis,
                           axis_group(mesh, seq_axis) if seq_axis else None,
                           sr * (t // sp), t)
    return out


@dataclass(frozen=True)
class TrainPlan:
    """How a training step on a mesh sums: `rows`, the groups over which
    the batch's rows and positions are split (dp, and the sequence axis);
    `tp_group`, the model's tp group; `seq`, the batch's BatchShard under
    sequence parallelism."""

    rows: tuple
    tp_group: Any
    seq: Optional[BatchShard]

    def groups_of(self, name: str) -> tuple:
        """The groups a leaf's gradient is summed over: every leaf over the
        rows' groups; `freqs_cis` also over tp, since each rank's heads read
        the RoPE table (the norms and the row-parallel biases need no tp sum:
        `copy_to` before the column-parallel inputs makes their gradients
        whole on every tp rank)."""
        return self.rows + ((self.tp_group,) if name == "freqs_cis" else ())

    def reduce(self, leaves, loss: torch.Tensor) -> torch.Tensor:
        """Sum the gradients (`grad.sum_gradients`) into each leaf's .grad
        and return the ranks' losses summed over the rows' groups."""
        from .grad import sum_gradients, sum_over

        grads = sum_gradients(leaves, self.groups_of)
        for name, p in leaves:
            p.grad = grads[name]
        return sum_over(loss, self.rows)


def placement(model: TextModel) -> Any:
    """Where a text model's leaves sit on a mesh: the Shard of a rank's
    `shard_text_model`, the `pipeline.Stage` of a pipeline stage
    (`pipeline.shard_params_pp`), or None for a whole model. The training
    step, its checkpoints and `train_plan` read the sharding through this
    one function."""
    shard = getattr(model, "shard", None)
    return shard if shard is not None else getattr(model, "stage", None)


def train_plan(model: TextModel, batch: dict) -> Optional[TrainPlan]:
    """The TrainPlan of a step on `model` (a rank's `shard_text_model` or a
    whole model) and `batch` (a `ShardedBatch`, or a dict of this rank's
    rows): the dp group from the batch, else from the model. None when
    neither is sharded: the step sums nothing."""
    shard = placement(model)
    if shard is not None and not isinstance(shard, Shard):
        raise ValueError("a pipeline stage trains through pipeline.make_pp_train_step")
    bs = batch.shard if isinstance(batch, ShardedBatch) else None
    if shard is None and bs is None:
        return None
    dp_group = bs.dp_group if bs is not None else shard.dp_group
    seq = bs if bs is not None and bs.seq_axis else None
    rows = tuple(g for g in (dp_group, seq and seq.seq_group) if g is not None)
    return TrainPlan(rows, shard.tp_group if shard is not None else None, seq)


# ------------------------------------------------------------ checkpoints


def _shard_and_stage(model) -> tuple:
    """(Shard, None), (None, Stage) or (None, None): `placement` split."""
    where = placement(model)
    return (where, None) if isinstance(where, Shard) else (None, where)


def _stage_layer(model, name: str):
    """(global layer, rest of the name) of a pipeline stage's block leaf."""
    _, i, rest = name.split(".", 2)
    return model.stage.first_layer + int(i), rest


def gather_leaves(model: TextModel) -> Optional[Dict[str, torch.Tensor]]:
    """The whole text model's leaves (`finetune.optim.named_leaves`' names
    and order of the unsharded model) as host tensors on global rank 0, None
    on the others, gathered from each rank's shard (`shard_text_model`:
    the tp cuts) or pipeline stage (`pipeline.shard_params_pp`: the layer
    slabs); dp replicas are equal, so dp index 0's are taken. Every rank of
    the mesh must call it."""
    from ..finetune.optim import named_leaves

    shard, stage = _shard_and_stage(model)
    blocks: Dict[int, Dict[str, torch.Tensor]] = {}
    head: List[tuple] = []
    tail: List[tuple] = []
    for name, t in named_leaves(model):
        t = t.detach()
        if stage is not None and name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            parts = comm.gather_rows(t[None].contiguous(), stage.pp_group)
            for s in range(parts.shape[0]):
                blocks.setdefault(s * len(model.blocks) + int(i), {})[rest] = parts[s]
            continue
        spec = _rule(text_param_shardings(), name) if shard is not None else None
        if spec is not None and "tp" in spec and shard.tp > 1:
            dim = spec.index("tp")
            parts = comm.gather_rows(t.movedim(dim, 0).contiguous(), shard.tp_group)
            parts = parts.chunk(shard.tp)
            if ".qkv." in name:
                full = full_text_config(model.config, shard.tp)
                whole = torch.empty((full.qkv_dim, *parts[0].shape[1:]), dtype=t.dtype,
                                    device=t.device)
                for r, piece in enumerate(parts):
                    whole[qkv_columns(full, shard.tp, r).to(t.device)] = piece
            else:
                whole = torch.cat(parts)
            t = whole.movedim(0, dim)
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            blocks.setdefault(int(i), {})[rest] = t
        else:
            (tail if blocks else head).append((name, t))
    if dist.get_rank() != 0:
        return None
    out = dict(head)
    for layer in sorted(blocks):
        out.update({f"blocks.{layer}.{rest}": t for rest, t in blocks[layer].items()})
    out.update(tail)
    return {name: t.cpu() for name, t in out.items()}


@torch.no_grad()
def load_leaves(model: TextModel, saved: Dict[str, torch.Tensor]) -> None:
    """Copy the whole model's leaves `saved` (`gather_leaves`' names) into a
    rank's shard or pipeline stage in place: each rank cuts its tp share
    (`cut_text_tensor`) or its layer slab."""
    from ..finetune.optim import named_leaves

    shard, stage = _shard_and_stage(model)
    for name, t in named_leaves(model):
        if stage is not None and name.startswith("blocks."):
            layer, rest = _stage_layer(model, name)
            src = saved[f"blocks.{layer}.{rest}"]
        elif shard is not None:
            src = cut_text_tensor(saved[name], name, full_text_config(model.config, shard.tp),
                                  shard.tp, shard.tp_rank)
        else:
            src = saved[name]
        t.copy_(src)
