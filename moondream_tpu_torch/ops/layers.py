"""Primitive layers: linear, layer norm, tanh-GELU, MLP and the ViT
attention body (moondream_tpu/ops/layers.py:25-185).

Weights keep the JAX package's (in, out) layout, so activations multiply as
`x @ w`. Matrix products accumulate in fp32 and return the input dtype;
layer-norm statistics are fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """y = x @ w + b. `addmm` adds the bias inside the product's fp32
    epilogue, so the result is rounded to x.dtype once."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.mm(x2, w) if b is None else torch.addmm(b, x2, w)
    return y.reshape(*lead, w.shape[1])


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics."""
    out = F.layer_norm(
        x.float(), (x.shape[-1],), weight.float(), bias.float(), eps
    )
    return out.to(x.dtype)


def gelu_approx(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.w = nn.Parameter(torch.empty(n_in, n_out, **kw), requires_grad=False)
        self.b = nn.Parameter(torch.empty(n_out, **kw), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w, self.b)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class MLP(nn.Module):
    """fc1 -> tanh-GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device, dtype)
        self.fc2 = Linear(hidden, out, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_approx(self.fc1(x)))


def attn_core(
    x: torch.Tensor, qkv: Linear, n_heads: int, n_real: Optional[int] = None
) -> torch.Tensor:
    """Bidirectional fused-QKV attention up to (not including) the output
    projection. x: (B, T, D). With `n_real`, tokens >= n_real are padding:
    real rows attend only columns < n_real (pos 0, prefix n_real)."""
    from .attention import flash_attention

    bsz, seq, d_model = x.shape
    head_dim = d_model // n_heads
    # q/k/v stay strided views of the fused projection: the kernel reads
    # them in place.
    q, k, v = (
        t.view(bsz, seq, n_heads, head_dim).transpose(1, 2)
        for t in qkv(x).split(d_model, dim=-1)
    )
    prefix = seq if n_real is None else n_real
    out = flash_attention(q, k, v, pos=0, prefix=prefix)
    return out.transpose(1, 2).reshape(bsz, seq, d_model)
