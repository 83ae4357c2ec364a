"""The collectives that carry a gradient, and the gradient sums of the
sharded training steps: the port's side of what the JAX package gets from
GSPMD's transposes and shard_map's psums (moondream_tpu/parallel/,
moondream_tpu/finetune/trainer.py).

Each collective is a torch.autograd.Function whose backward is the
transpose of its forward (Megatron's pair and its sequence analogue):

  copy_to(x, group)          identity          backward: all-reduce (sum)
  reduce_from(x, group)      all-reduce, fp32  backward: identity
  gather_cols(x, group)      all-gather, last dim   backward: the rank's columns
  gather_seq(x, group, dim)  all-gather along dim   backward: reduce-scatter (sum)

copy_to sits before the column-parallel linears (qkv and fc1 read one
layer-norm output; the vocabulary-parallel LM head reads post_ln's), so the
gradient of the replicated stream is whole on every tp rank; reduce_from is
the row-parallel linears' sum. `torch.distributed.nn.functional.all_reduce`
is not used: its backward all-reduces again, which would make the gradients
tp times too large. A group of None (an axis of one rank that the mesh does
not name) makes each of them the identity.

`sum_gradients` sums each leaf's gradient over its groups in fp32 and
rounds it once to the leaf's dtype, consecutive leaves packed into
buckets; every rank joins every sum in the same leaf order, a rank whose
leaf has no gradient with zeros, so that no rank skips a collective that
the others wait in.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import comm

# The most fp32 elements `sum_gradients` packs into one collective (256 MB).
BUCKET_ELEMENTS = 1 << 26


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = comm.all_reduce_fp32(grad.to(torch.float32, copy=True), ctx.group)
        return g.to(grad.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce_fp32(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return comm.gather_cols(x, group)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return comm.gather_rows(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        g = comm.reduce_scatter_fp32(grad.movedim(ctx.dim, 0).float(), ctx.group)
        return g.movedim(0, ctx.dim).to(grad.dtype), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; its gradient is summed over `group` (fp32) in the backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The fp32 sum of the fp32 partials `x` over `group` (a new tensor);
    the gradient passes through unchanged."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """The group's (..., n) shards side by side in rank order (as
    `comm.gather_cols`); the backward keeps this rank's columns of the
    gradient."""
    return x if group is None else _GatherCols.apply(x, group)


def gather_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of a sequence concatenated along `dim` in rank
    order; the backward sums the gradient over the group (fp32) and keeps
    this rank's block (a reduce-scatter)."""
    return x if group is None else _GatherSeq.apply(x, group, dim)


def sum_gradients(
    leaves: Sequence[Tuple[str, torch.Tensor]],
    groups_of: Callable[[str], Sequence],
    grads: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, Optional[torch.Tensor]]:
    """Each leaf's gradient summed over the groups `groups_of(name)` names
    (Nones skipped), in fp32, rounded once to the leaf's dtype: name ->
    gradient, in the order of `leaves`. The gradient is grads[name] where
    `grads` has it (the pipeline's fp32 sums over microbatches), else the
    leaf's `.grad`; a leaf with neither joins with zeros. A leaf without
    groups keeps its gradient as it is (None included). Consecutive leaves
    with the same groups are summed together: their gradients are packed
    into fp32 buckets of at most BUCKET_ELEMENTS, one collective per bucket
    and group (a collective's host cost, 0.08-0.15 ms per NCCL all-reduce
    on an H100 at world 1 (`profile_caption --train`), would otherwise be
    paid per leaf)."""
    grads = grads or {}
    named = [(name, p, tuple(g for g in groups_of(name) if g is not None))
             for name, p in leaves]
    out: Dict[str, Optional[torch.Tensor]] = {}
    i = 0
    while i < len(named):
        name, p, groups = named[i]
        if not groups:
            g = grads.get(name, p.grad)
            out[name] = None if g is None else g.to(p.dtype)
            i += 1
            continue
        j, size = i, 0
        while j < len(named) and named[j][2] == groups and (
                j == i or size + named[j][1].numel() <= BUCKET_ELEMENTS):
            size += named[j][1].numel()
            j += 1
        flat = torch.empty(size, dtype=torch.float32, device=p.device)
        pieces, off = [], 0
        for name_k, p_k, _ in named[i:j]:
            piece = flat[off:off + p_k.numel()].view(p_k.shape)
            g = grads.get(name_k, p_k.grad)
            if g is None:
                piece.zero_()
            else:
                piece.copy_(g)
            pieces.append((name_k, p_k, piece))
            off += p_k.numel()
        for grp in groups:
            comm.all_reduce_fp32(flat, grp)
        for name_k, p_k, piece in pieces:
            out[name_k] = piece.to(p_k.dtype)
        i = j
    return out


def sum_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """A detached fp32 copy of `x` summed over `groups` (Nones skipped)."""
    x = x.detach().to(torch.float32, copy=True)
    for grp in groups:
        comm.all_reduce_fp32(x, grp)
    return x
