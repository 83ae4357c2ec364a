"""Pipeline-parallel (pp) training of the text decoder: GPipe over a
pp x dp mesh (moondream_tpu/parallel/pipeline.py).

Stage s of S holds blocks [s L/S, (s+1) L/S) (`shard_params_pp`); wte,
post_ln, the LM head and the RoPE table are whole on every stage. Each dp
index runs its own pipeline over its rows of the global batch, cut into M
microbatches. The JAX package writes the schedule as one lax.scan over
M + S - 1 ticks with a ppermute inside a shard_map and lets value_and_grad
transpose it; here it is written out as point-to-point sends between
neighbouring stages of one dp index (`comm.send_to` / `comm.recv_from`):

  forward:  for m in 0..M-1, stage 0 takes microbatch m and stage s > 0
            receives it from s-1; the stage runs its slab, sends the result
            to s+1 and keeps both ends for the backward; the last stage
            alone computes the LM head and the microbatch's nll sum;
  backward: for m in M-1..0, the last stage backpropagates its part of
            the loss and stage s < S-1 receives the gradient of its output
            from s+1; each backpropagates through its slab and sends the
            gradient of its input to s-1.

A stage sends in the order its successor receives, and receives from s+1
only after it has sent all M forwards, so the schedule cannot deadlock.
The loss is the global masked mean: its normaliser is the mask sum of the
whole batch, which every rank holds (the JAX package psums the last
stage's over pp x dp). Gradients are summed over the microbatches in fp32,
then the block gradients over dp and the replicated leaves over pp x dp
(`grad.sum_gradients`), and rounded once to each leaf's dtype: the RoPE
table collects every stage's share, post_ln and the LM head the last
stage's, and `wte` (read by no stage) zeros. `make_pp_train_step` then
updates each rank's slab and replicated leaves in place.

tp does not compose with this module (as in the JAX package): use the
dp x tp step of `finetune.trainer.make_train_step` for tensor parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..config import TextConfig
from ..models.text import TextModel, _require_dense, lm_head_full, produce_hidden
from . import comm
from .grad import sum_gradients, sum_over
from .mesh import axis_group, axis_rank, axis_size


@dataclass(frozen=True)
class Stage:
    """One rank's place in a pp x dp mesh: its stage of `pp`, its dp index,
    the groups of its lines and the global index of its first layer."""

    pp: int
    stage: int
    dp: int
    dp_rank: int
    pp_group: Any
    dp_group: Any
    first_layer: int

    @classmethod
    def of(cls, mesh, n_layers: int) -> "Stage":
        pp, s = axis_size(mesh, "pp"), axis_rank(mesh, "pp")
        if n_layers % pp:
            raise ValueError(f"n_layers={n_layers} not divisible by pp={pp}")
        return cls(pp, s, axis_size(mesh, "dp"), axis_rank(mesh, "dp"), axis_group(mesh, "pp"),
                   axis_group(mesh, "dp"), s * (n_layers // pp))


def shard_params_pp(model: TextModel, mesh) -> TextModel:
    """This rank's pipeline stage of a full text model: a TextModel whose
    blocks are its slab of n_layers/pp consecutive blocks, and whose wte,
    norms, LM head and RoPE table are the full model's (the tensors are
    shared, not copied). `.stage` (`Stage`) carries the mesh. Raises
    ValueError when the layers do not split over pp, or for int4 / int8
    blocks."""
    _require_dense(model, "shard_params_pp")
    stage = Stage.of(mesh, len(model.blocks))
    n = len(model.blocks) // stage.pp
    out = TextModel.__new__(TextModel)
    nn.Module.__init__(out)
    out.config = model.config
    out.wte = model.wte
    out.blocks = nn.ModuleList(model.blocks[stage.first_layer:stage.first_layer + n])
    out.post_ln = model.post_ln
    out.lm_head = model.lm_head
    out.register_buffer("freqs_cis", model.freqs_cis, persistent=False)
    out.stage = stage
    return out


def _nll_sum(hidden: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
             model: TextModel) -> torch.Tensor:
    """One microbatch's shifted-CE sum, finetune.trainer.text_loss's
    numerator (moondream_tpu/parallel/pipeline.py:87-97)."""
    logits = lm_head_full(hidden, model).float()[:, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, 1:].long()[..., None])[..., 0]
    return torch.sum(nll * mask[:, 1:])


def make_pp_loss_and_grads(config: TextConfig, mesh, n_microbatches: int):
    """fn(stage_model, batch) -> (loss, grads): the forward and backward of
    the whole batch through the GPipe schedule over the mesh's "pp" axis, a
    pipeline per "dp" index. stage_model: this rank's `shard_params_pp`;
    batch: the global host batch {"inputs_embeds" (B, T, D), "labels"
    (B, T), "label_mask" (B, T)} on every rank, B divisible by
    dp * n_microbatches. loss: the whole batch's (fp32, on every rank);
    grads: name -> gradient of each of the stage model's leaves
    (`finetune.optim.named_leaves`), summed over the ranks. Raises
    ValueError when n_layers does not split over pp, or the dp-local batch
    over the microbatches."""
    from ..finetune.optim import named_leaves, trainable

    stage = Stage.of(mesh, config.n_layers)
    S, s, M = stage.pp, stage.stage, n_microbatches

    def groups_of(name: str) -> tuple:
        if name.startswith("blocks."):
            return (stage.dp_group,)
        return (stage.dp_group, stage.pp_group)

    def fn(model: TextModel, batch: dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        embeds, labels, mask = (torch.as_tensor(batch[k])
                                for k in ("inputs_embeds", "labels", "label_mask"))
        B, T, D = embeds.shape
        if B % stage.dp:
            raise ValueError(f"batch of {B} rows does not split over dp={stage.dp}")
        local = B // stage.dp
        if local % M:
            raise ValueError(f"dp-local batch {local} not divisible by M={M}")
        b = local // M
        dev = model.wte.device
        dt = torch.promote_types(embeds.dtype, model.wte.dtype)
        denom = torch.clamp_min(torch.sum(mask[:, 1:]), 1).to(dev)
        rows = slice(stage.dp_rank * local, (stage.dp_rank + 1) * local)
        micro = lambda x: x[rows].to(dev).reshape(M, b, *x.shape[1:])
        e, lab, msk = micro(embeds).to(dt), micro(labels), micro(mask)
        leaves = named_leaves(model)
        acc: Dict[str, torch.Tensor] = {}
        part = torch.zeros((), dtype=torch.float32, device=dev)

        def fold() -> None:
            """Move the leaves' gradients into the fp32 sums over microbatches."""
            for name, p in leaves:
                if p.grad is not None:
                    g = p.grad.float()
                    acc[name] = acc[name].add_(g) if name in acc else g
                    p.grad = None

        kept = []
        with trainable(leaves):
            for i in range(M):
                x = (e[i] if s == 0 else
                     comm.recv_from((b, T, D), dt, dev, stage.pp_group, s - 1).requires_grad_())
                h = produce_hidden(x, model)
                if s < S - 1:
                    comm.send_to(h.detach(), stage.pp_group, s + 1)
                    kept.append((x, h))
                else:
                    nll = _nll_sum(h, lab[i], msk[i], model) / denom
                    part += nll.detach()
                    kept.append((x, nll))
            for _ in range(M):
                x, out = kept.pop()
                if s == S - 1:
                    out.backward()
                else:
                    out.backward(comm.recv_from(out.shape, out.dtype, dev, stage.pp_group, s + 1))
                fold()
                if s > 0:
                    comm.send_to(x.grad, stage.pp_group, s - 1)
        grads = sum_gradients(leaves, groups_of, acc)
        return sum_over(part, (stage.dp_group, stage.pp_group)), grads

    return fn


def make_pp_train_step(optimizer, config: TextConfig, mesh, n_microbatches: int):
    """The pipeline-parallel training step, with the contract of
    finetune.trainer.make_train_step: train_step(state, batch) -> (state,
    loss), state.params this rank's `shard_params_pp`, batch the global
    host batch; `make_pp_loss_and_grads` computes (loss, grads), then the
    rank's optimizer updates its slab and replicated leaves in place and
    the step count advances (moondream_tpu/parallel/pipeline.py:208-229)."""
    from ..finetune.optim import named_leaves

    loss_and_grads = make_pp_loss_and_grads(config, mesh, n_microbatches)

    def train_step(state, batch: dict):
        loss, grads = loss_and_grads(state.params, batch)
        leaves = named_leaves(state.params)
        for name, p in leaves:
            p.grad = grads[name]
        optimizer.update(state.opt_state, leaves)
        return state._replace(step=state.step + 1), loss

    return train_step
