"""optax.adamw inside optax.MultiSteps (optax 0.2.6), the JAX package's
finetuning optimizer, over a named list of tensors updated in place.

The arithmetic follows optax step for step, in each leaf's own dtype (bf16
weights keep bf16 moments, as optax does with mu_dtype None):

    MultiSteps:  acc <- acc + (g - acc) / (n + 1)     (Welford mean, n the mini-step)
                 at the k-th mini-step the mean goes to adamw and acc <- 0;
                 between boundaries the weights do not move
    adamw:       mu <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu
                 u  <- (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p
                 p  <- p + lr(count) u,  lr cast to p's dtype, negated

bc_i = 1 - b_i^(count + 1) in fp32, cast to the moment's dtype. The
schedule sees the update count before the increment, so the first update
uses schedule(0). Python constants take the leaf's dtype first, as JAX's
weakly typed scalars do.

Unlike torch.optim.AdamW (decay 1e-2, applied to p before the Adam step),
the decay here is optax's default 1e-4, added to the update and scaled by
the learning rate, and a leaf whose gradient is None (a tensor the loss
does not read, such as `wte`, whose embeddings the batch carries as data)
counts as a zero gradient: it still decays.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import nn

from ..models.text import TextModel

Leaves = List[Tuple[str, torch.Tensor]]


def named_leaves(module: Union[nn.Module, dict]) -> Leaves:
    """The leaves of the JAX package's tree for `module`: its parameters,
    and for the text model its RoPE table `freqs_cis` (fp32), which JAX
    keeps in the text tree (moondream_tpu/weights.py:229), so that
    value_and_grad differentiates it and adamw updates it. A nested dict of
    tensors (a stacked LoRA adapter) gives its tensors under dotted names,
    in the dict's order."""
    if isinstance(module, dict):
        leaves = []
        for k, v in module.items():
            leaves += ([(f"{k}.{n}", t) for n, t in named_leaves(v)] if isinstance(v, dict)
                       else [(k, v)])
        return leaves
    leaves = list(module.named_parameters())
    if isinstance(module, TextModel):
        leaves.append(("freqs_cis", module.freqs_cis))
    return leaves


@contextmanager
def trainable(leaves: Leaves):
    """requires_grad on `leaves` inside the block only: the port's modules
    keep requires_grad=False everywhere else (inference, CUDA graphs)."""
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for _, t in leaves:
            t.requires_grad_(False)


@dataclass
class AdamWState:
    """optax's MultiStepsState over ScaleByAdamState. `count` is adamw's
    update count, which is also its schedule's count and MultiSteps'
    gradient_step (all three advance together, at a boundary); `mini_step`
    is the position in the accumulation window. `acc` holds the Welford
    means (None for every_k 1, where the mean is the gradient itself);
    `mu`, `nu` and `acc` are in each leaf's dtype."""

    count: int
    mini_step: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    acc: Optional[List[torch.Tensor]]


def _as(value: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to `dtype`, as JAX casts a weakly typed
    scalar to the array's dtype."""
    return torch.tensor(value, dtype=torch.float64).to(dtype).item()


class AdamW:
    """`optax.MultiSteps(optax.adamw(learning_rate, b1, b2, eps,
    weight_decay=weight_decay), every_k_schedule=every_k)`; with every_k 1
    it equals optax.adamw alone. The defaults are optax.adamw's.
    `learning_rate`: a float, or a schedule count -> fp32 value."""

    def __init__(
        self, learning_rate: Union[float, Callable[[int], torch.Tensor]],
        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
        weight_decay: float = 1e-4, every_k: int = 1,
    ):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.every_k = every_k

    def init(self, leaves: Leaves) -> AdamWState:
        zeros = lambda: [torch.zeros_like(t) for _, t in leaves]
        return AdamWState(
            count=0, mini_step=0, mu=zeros(), nu=zeros(),
            acc=zeros() if self.every_k > 1 else None,
        )

    def _lr(self, count: int) -> float:
        """The learning rate of update `count`: a float as given, a
        schedule's value as the fp32 it returns."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else lr

    @torch.no_grad()
    def update(self, state: AdamWState, leaves: Leaves) -> bool:
        """One optax update call: reads each leaf's `.grad` (None counts as
        zeros), updates the leaves and `state` in place, and clears the
        gradients (each call consumes its own, as JAX's value_and_grad
        computes fresh ones). Returns whether the weights were updated
        (the last mini-step of an accumulation window)."""
        emit = state.mini_step == self.every_k - 1
        n = state.mini_step
        state.mini_step = (state.mini_step + 1) % self.every_k
        grads = []
        for i, (_, p) in enumerate(leaves):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            if state.acc is not None:
                acc = state.acc[i]
                acc.add_((g - acc) / (n + 1))
                g = acc
            grads.append(g)
        if not emit:
            return False
        lr = self._lr(state.count)
        state.count += 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = (1 - f32(self.b1) ** f32(state.count)).item()
        bc2 = (1 - f32(self.b2) ** f32(state.count)).item()
        for i, (_, p) in enumerate(leaves):
            g, mu, nu, dt = grads[i], state.mu[i], state.nu[i], p.dtype
            mu.copy_(g * _as(1 - self.b1, dt) + mu * _as(self.b1, dt))
            nu.copy_(g * g * _as(1 - self.b2, dt) + nu * _as(self.b2, dt))
            u = (mu / _as(bc1, dt)) / (torch.sqrt(nu / _as(bc2, dt)) + _as(self.eps, dt))
            u = u + p * _as(self.weight_decay, dt)
            p.add_(u * _as(-lr, dt))
            if state.acc is not None:
                state.acc[i].zero_()
        return True
