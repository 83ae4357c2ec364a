"""Finetuning: the LR schedule, the text and region losses, the training
step and checkpoints (moondream_tpu/finetune/trainer.py).

  * text: shifted cross-entropy over the answer span of a [BOS, image,
    question, answer] embedding sequence, through the cache-free
    prefix-mask forward (`models.text.produce_hidden`);
  * region: cross-entropy on the 1024-bin coordinate and size logits at
    the positions that precede each coordinate and size slot;
  * LR: 10% linear warmup to LR, then cosine to 0.1 LR, in fp32.

The training step runs the forward and backward eagerly on the card: its
attention is the plain `ops.layers.sdpa`, as the JAX package's is XLA's
(no Pallas kernel is differentiated there), and `optim.AdamW` updates the
trained tree in place, so the model's other paths (and the CUDA graphs
that baked in its weights' addresses) read the trained weights.
Checkpoints hold the trained tree and the step; resuming re-initialises
the optimizer state, as the JAX package's orbax path does.

The same step trains on a dp x tp or dp x sp mesh (`parallel.mesh`: a
rank's `shard_text_model`, `shard_batch`), and `parallel.pipeline` trains
over pp x dp; sharded states save and load the unsharded checkpoint.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from ..models.region import RegionModel, decode_coordinate
from ..models.text import TextModel, lm_head_full, produce_hidden
from ..parallel.mesh import gather_leaves, load_leaves, placement, train_plan
from .optim import AdamW, AdamWState, named_leaves, trainable


def lr_schedule(base_lr: float):
    """Warmup (10%) + cosine decay to 0.1x: schedule(step, max_steps) -> an
    fp32 scalar tensor, each operation in fp32 as the JAX package's
    jnp version computes it (step / max_steps in fp32)."""

    def schedule(step, max_steps) -> torch.Tensor:
        x = torch.tensor(step, dtype=torch.float32) / torch.tensor(max_steps, dtype=torch.float32)
        warm = 0.1 * base_lr + 0.9 * base_lr * x / 0.1
        cos = 0.1 * base_lr + 0.9 * base_lr * (1 + torch.cos(math.pi * (x - 0.1))) / 2
        return torch.where(x < 0.1, warm, cos)

    return schedule


def text_loss(
    text: TextModel, inputs_embeds: torch.Tensor, labels: torch.Tensor,
    label_mask: torch.Tensor, lora: Optional[dict] = None, seq=None,
    row_groups: Sequence = (),
) -> torch.Tensor:
    """Shifted cross-entropy over the answer span. inputs_embeds (B, T, D);
    labels (B, T) int, labels[t] the target emitted at position t;
    label_mask (B, T) fp32, 1 where labels count. The logits are the
    weights' dtype, cast to fp32 after the lm head. `lora`: a stacked
    adapter applied in the forward (finetune/lora.py).

    On a mesh (`make_train_step` passes these): `row_groups`, the groups
    over which the batch's rows and positions are split; the loss is then
    this rank's nll sum over the mask sum of the whole batch (all-reduced,
    without a gradient), and the ranks' parts add up to the global masked
    mean. `seq`: the batch is one sequence-parallel rank's block of
    positions (`parallel.mesh.shard_batch(..., seq_axis=)`), whose labels
    and mask were shifted over the whole sequence before the cut, so
    position t's own label is its target."""
    hidden = produce_hidden(inputs_embeds, text, lora=lora, seq=seq)
    logits = lm_head_full(hidden, text).float()
    if seq is None:
        logits, labels, label_mask = logits[:, :-1], labels[:, 1:], label_mask[:, 1:]
    tgt = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    denom = torch.sum(label_mask)
    if row_groups:
        from ..parallel.grad import sum_over

        denom = sum_over(denom, row_groups)
    return torch.sum(nll * label_mask) / torch.clamp_min(denom, 1)


def region_coord_loss(coord_logits: torch.Tensor, coord_labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over 1024 bins in fp32; labels round(p * 1023) for
    coordinates, size_to_bin for sizes."""
    logp = torch.log_softmax(coord_logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, -1, coord_labels.long()[..., None]))


def region_loss(
    region: RegionModel, hidden: torch.Tensor, labels: torch.Tensor,
    c_idx: torch.Tensor, s_idx: torch.Tensor,
) -> torch.Tensor:
    """The grounding heads' loss. hidden (1, T, D) from produce_hidden;
    labels (4K,) interleaved [x_bin, y_bin, w_bin, h_bin] per box;
    c_idx / s_idx the sequence positions of the coordinate and size slots,
    each predicted from the hidden state one position earlier."""
    per_box = labels.reshape(-1, 4)
    c_labels = per_box[:, :2].reshape(-1)
    s_labels = per_box[:, 2:].reshape(-1)
    c_logits = decode_coordinate(hidden[:, c_idx - 1, :], region).reshape(-1, 1024)
    s_logits = region.size_decoder(hidden[:, s_idx - 1, :]).reshape(-1, 1024)
    return region_coord_loss(c_logits, c_labels) + region_coord_loss(s_logits, s_labels)


def size_to_bin(size: torch.Tensor) -> torch.Tensor:
    """bin = (log2(size) + 10) / 10 * 1023, rounded half to even, clamped to
    [0, 1023], int32."""
    s = torch.clamp_min(size, 1.0 / 1024.0)
    b = (torch.log2(s) + 10.0) / 10.0 * 1023.0
    return torch.clamp(torch.round(b), 0, 1023).to(torch.int32)


class TrainState(NamedTuple):
    """The trained tree (a TextModel or RegionModel, or a stacked LoRA
    adapter's dict; updated in place), its optimizer state and the step
    count."""

    params: Union[nn.Module, dict]
    opt_state: AdamWState
    step: int


def make_optimizer(
    lr: float = 3e-6, betas=(0.9, 0.95), eps: float = 1e-6,
    weight_decay: float = 0.0, max_steps: Optional[int] = None,
) -> AdamW:
    """adamw at a constant LR, or on lr_schedule(lr) over max_steps."""
    if max_steps:
        sched = lr_schedule(lr)
        lr = lambda step: sched(step, max_steps)
    return AdamW(lr, b1=betas[0], b2=betas[1], eps=eps, weight_decay=weight_decay)


def cli_optimizer(lr: float, total_steps: int, grad_accum: int) -> AdamW:
    """The two finetune CLIs' optimizer: adamw on lr_schedule(lr) over
    max(total_steps, 1) updates with optax.adamw's default weight decay
    (1e-4; the CLIs do not set it), inside MultiSteps of grad_accum."""
    sched = lr_schedule(lr)
    return AdamW(
        lambda step: sched(step, max(total_steps, 1)), b1=0.9, b2=0.95, eps=1e-6,
        every_k=grad_accum,
    )


def init_train_state(params: Union[nn.Module, dict], optimizer: AdamW) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(named_leaves(params)), step=0)


def step_with(
    optimizer: AdamW, state: TrainState, loss_fn: Callable[[], torch.Tensor],
    reduce: Optional[Callable] = None,
) -> Tuple[TrainState, torch.Tensor]:
    """One training step: loss_fn() with gradients on the trained tree only
    (a module, or a stacked adapter's dict), its backward, and one
    optimizer call in place. Returns the next state and the detached
    loss. `reduce(leaves, loss)`: on a mesh, sums the gradients over the
    ranks (setting each leaf's `.grad`) and returns the whole batch's
    loss, between the backward and the update."""
    leaves = named_leaves(state.params)
    with trainable(leaves):
        loss = loss_fn()
        loss.backward()
    loss = loss.detach()
    if reduce is not None:
        loss = reduce(leaves, loss)
    optimizer.update(state.opt_state, leaves)
    return state._replace(step=state.step + 1), loss


def make_train_step(optimizer: AdamW):
    """The text training step: train_step(state, batch) -> (state, loss),
    batch {"inputs_embeds", "labels", "label_mask"} (finetune_text.
    build_example), state.params the TextModel. It runs unchanged on one
    GPU and on a dp x tp or dp x sp mesh, as the JAX package's does under
    GSPMD: state.params may be a rank's `parallel.mesh.shard_text_model`
    and the batch this rank's block from `parallel.mesh.shard_batch`
    (`parallel.mesh.train_plan` reads both); the gradients are then summed
    over the ranks (`parallel.grad.sum_gradients`) before each rank's
    optimizer updates its own shard, and the loss returned is the whole
    batch's."""

    def train_step(state: TrainState, batch: dict) -> Tuple[TrainState, torch.Tensor]:
        plan = train_plan(state.params, batch)
        seq, rows, reduce = (None, (), None) if plan is None else (plan.seq, plan.rows, plan.reduce)
        return step_with(optimizer, state, lambda: text_loss(
            state.params, batch["inputs_embeds"], batch["labels"], batch["label_mask"],
            seq=seq, row_groups=rows), reduce=reduce)

    return train_step


def save_checkpoint(path: str, state: TrainState) -> None:
    """The trained tree's leaves (named_leaves) and the step, torch.save'd
    from host copies. From a sharded state (every rank calls it), the
    stages' and tp ranks' leaves are gathered to rank 0, which writes the
    file the unsharded state would (`parallel.mesh.gather_leaves`), as the
    JAX package's orbax checkpoint holds the global arrays; the ranks leave
    when it is written."""
    if placement(state.params) is not None:
        leaves = gather_leaves(state.params)
        if leaves is not None:
            torch.save({"params": leaves, "step": state.step}, path)
        dist.barrier()
        return
    torch.save({
        "params": {name: t.detach().cpu() for name, t in named_leaves(state.params)},
        "step": state.step,
    }, path)


def load_checkpoint(path: str, template_state: TrainState, optimizer: AdamW) -> TrainState:
    """Copy a checkpoint's leaves into template_state.params in place and
    start a fresh optimizer state at the saved step. A sharded template
    (each rank's shard or stage) takes its cut of the whole model's leaves
    (`parallel.mesh.load_leaves`), so a checkpoint written on a mesh loads
    on one GPU and the other way round."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    leaves = named_leaves(template_state.params)
    if placement(template_state.params) is not None:
        load_leaves(template_state.params, saved["params"])
    else:
        with torch.no_grad():
            for name, t in leaves:
                t.copy_(saved["params"][name])
    return TrainState(
        params=template_state.params, opt_state=optimizer.init(leaves), step=saved["step"]
    )
