"""Primitive layers: linear, layer norm, tanh-GELU, the LoRA delta, MLP
and the ViT attention body (moondream_tpu/ops/layers.py:25-185), and the
int8 w8a8 linear (`Int8Linear`, moondream_tpu/ops/layers.py:30-75).

Weights keep the JAX package's (in, out) layout, so activations multiply as
`x @ w`. Matrix products accumulate in fp32 and return the input dtype;
layer-norm statistics are fp32. The int8 codes are the one exception: they
are kept transposed, (out, in), the layout the int8 tensor-core product
reads (`pack_int8_weight`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.quant import W8A8_K_ALIGN


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


class _MmFp32(torch.autograd.Function):
    """torch.mm(x, w, out_dtype=fp32), which autograd cannot differentiate,
    with the backward of the unsharded linear: the fp32 gradient rounded to
    the operands' dtype, then the two products in that dtype (fp32
    accumulation), as addmm's backward computes them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def _mm_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated and returned in fp32, from bf16 operands on the
    card without widening them; differentiable."""
    if x.dtype == torch.float32:
        return torch.mm(x, w)
    if x.is_cuda:
        return _MmFp32.apply(x, w)
    return torch.mm(x.float(), w.float())


class RowParallelLinear(nn.Module):
    """One tensor-parallel rank's rows of a row-parallel linear (a text
    block's proj or fc2, `parallel.mesh.shard_text_model`): `w` (K/tp, N)
    reads the rank's share of the input features, `b` (N,) is the whole
    bias. The rank's partial product is fp32; the partials are summed in
    fp32 over the tp group (`parallel.comm.all_reduce_fp32`); the bias is
    added once, after the sum, and the result rounded to x's dtype once,
    as the unsharded `linear` rounds its product and bias once. Where the
    partial carries a gradient (training), the sum is `parallel.grad.
    reduce_from`, whose backward passes the gradient through; elsewhere it
    is summed in place, the call the serving paths' CUDA graphs capture."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, group):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)
        self.group = group

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """The fp32 sum of a partial product over the tp group."""
        if partial.requires_grad:
            from ..parallel.grad import reduce_from

            return reduce_from(partial, self.group)
        from ..parallel.comm import all_reduce_fp32

        return all_reduce_fp32(partial, self.group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = self.reduce(_mm_fp32(x.reshape(-1, x.shape[-1]), self.w))
        return (y + self.b.float()).to(x.dtype).reshape(*lead, self.w.shape[1])


class VocabParallelLinear(Linear):
    """One tensor-parallel rank's vocabulary slice of the LM head: `w` (D,
    V/tp) and `b` (V/tp,) its columns. `gather` concatenates the ranks'
    (..., V/tp) logits into the whole (..., V) row on every rank, in rank
    order (`engine.generate._lm_logits` calls it before the bf16 rounding
    and the argmax or draw; the training loss reaches it through
    `models.text.lm_head_full`, differentiably)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, group):
        nn.Module.__init__(self)
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)
        self.group = group

    def gather(self, logits: torch.Tensor) -> torch.Tensor:
        from ..parallel.comm import gather_cols

        return gather_cols(logits, self.group)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


def lora_delta(x: torch.Tensor, pair: dict, reduce=None) -> torch.Tensor:
    """The low-rank residual (x @ A^T) @ B^T in fp32
    (moondream_tpu/ops/layers.py:78-85): A (r, in) and B (out, r) in
    torch's (out, in) layout, or one pair per row of x (S, Tq, in): A (S,
    r, in) and B (S, out, r), as the pool gathers them
    (`models.text.layer_adapters(..., vids)`; JAX's
    engine/serving._lora_delta). Both products run in fp32 on fp32 copies
    of x and the factors (a bf16 value is exact in fp32; TF32 must stay
    off), as XLA's dots with fp32 accumulation do; the result stays
    fp32. `reduce`: where x holds a tensor-parallel rank's share of the
    input features (and A the same columns: fc2 of a rank,
    `RowParallelLinear.reduce`), the fp32 sum over the ranks of the
    partial (x @ A^T), before B."""
    a = torch.matmul(x.float(), pair["A"].float().transpose(-1, -2))
    if reduce is not None:
        a = reduce(a)
    return torch.matmul(a, pair["B"].float().transpose(-1, -2))


def lora_add(y: torch.Tensor, x: torch.Tensor, pair: Optional[dict],
             reduce=None) -> torch.Tensor:
    """y + lora_delta(x, pair, reduce) rounded to y's dtype first, as the
    JAX package adds it to a linear's rounded output; y itself without a
    pair."""
    if pair is None:
        return y
    return y + lora_delta(x, pair, reduce).to(y.dtype)


def lora_linear(x: torch.Tensor, lin: nn.Module, pair: Optional[dict]) -> torch.Tensor:
    """A linear (dense, int4 or int8: its output rounded, bias included)
    plus an optional adapter on the same input
    (moondream_tpu/ops/layers.py:88-93)."""
    return lora_add(lin(x), x, pair)


class MLP(nn.Module):
    """fc1 -> tanh-GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device, dtype)
        self.fc2 = Linear(hidden, out, device, dtype)

    def forward(self, x: torch.Tensor, lora: Optional[dict] = None) -> torch.Tensor:
        """`lora`: optional {"fc1": pair, "fc2": pair} adapters (either may be
        absent): fc1's reads x, fc2's the GELU output
        (moondream_tpu/ops/layers.py:106-117)."""
        lora = lora or {}
        h = gelu_approx(lora_linear(x, self.fc1, lora.get("fc1")))
        return lora_add(self.fc2(h), h, lora.get("fc2"), getattr(self.fc2, "reduce", None))


def sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain scaled dot-product attention over (..., heads, seq, head_dim),
    differentiable by autograd: the training path's attention, which the
    JAX package also computes outside any Pallas kernel
    (moondream_tpu/ops/layers.py:120-147). q.k^T from fp32 copies of q and
    k (a bf16 value is exact in fp32 and TF32), the -1e30 fill where the
    boolean `mask` is False, an fp32 softmax, the probabilities rounded to
    v's dtype, the PV product accumulated in fp32 and the result cast to
    q's dtype. GQA: the caller repeats the K/V heads."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


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


# ------------------------------------------------------------------ w8a8

# 1/127 rounded once to fp32: under jit, XLA turns the JAX package's
# division by 127.0 into a product with this constant.
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def q8_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization (the jitted `_q8_act`,
    moondream_tpu/ops/layers.py:30-35): a = max(row amax, 1e-6) * fp32(1/127),
    codes = round_half_even(x / a), no clip. Returns (codes int8, a fp32
    (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    a = amax.clamp_min(1e-6) * torch.full_like(amax, _INV127)
    return torch.round(xf / a).to(torch.int8), a


def q8_static(x: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    """Static int8 codes clip(round_half_even(x * inv_a), -127, 127), the
    activation scale and the SmoothQuant equaliser folded into `inv_a` (K,)
    (moondream_tpu/ops/layers.py:56-59)."""
    return torch.round(x.float() * inv_a).clamp(-127, 127).to(torch.int8)


def pack_int8_weight(wq: torch.Tensor) -> torch.Tensor:
    """JAX's int8 codes (K, N) -> the kernel's layout (N, Kp): transposed,
    K zero-padded to a multiple of W8A8_K_ALIGN (the kernel reads whole
    64-byte chunks of a code row). The codes are unchanged."""
    k, n = wq.shape
    kp = -(-k // W8A8_K_ALIGN) * W8A8_K_ALIGN
    out = torch.zeros((n, kp), dtype=torch.int8, device=wq.device)
    out[:, :k] = wq.t()
    return out


def q8_codes_plain(
    x: torch.Tensor, inv_a: Optional[torch.Tensor], kp: int
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the w8a8 quantize pass: x (M, K) -> (codes (M, Kp)
    int8, zero past K; a (M,) fp32, the dynamic row scales, or None when
    `inv_a` (>= K,) selects static codes)."""
    k = x.shape[-1]
    codes = torch.zeros((x.shape[0], kp), dtype=torch.int8, device=x.device)
    if inv_a is None:
        codes[:, :k], a = q8_act(x)
        return codes, a[:, 0]
    codes[:, :k] = q8_static(x, inv_a[:k])
    return codes, None


def int8_linear_fp64(
    x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
    b: Optional[torch.Tensor], inv_a: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int8_linear_plain's result before its last two roundings: (M, N)
    float64, x's leading axes flattened. Where it lies exactly halfway
    between two fp32 values, the plain version's emulated fma may round
    twice."""
    codes, a = q8_codes_plain(x.reshape(-1, x.shape[-1]), inv_a, wq.shape[1])
    acc = (codes.double() @ wq.double().t()).float()
    if inv_a is None:
        y = (acc * scale).double() * a.double()[:, None]
    else:
        y = acc.double() * scale.double()
    return y if b is None else y + b.double()


def int8_linear_plain(
    x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
    b: Optional[torch.Tensor], inv_a: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the w8a8 kernel: x (..., K) against the codes wq (N,
    Kp) (`pack_int8_weight`), per-channel `scale` (N,), bias `b` (N,) or
    None; `inv_a` (>= K,) selects static activation codes, else dynamic per
    row. Returns x.dtype, rounded once, as the jitted JAX `linear`
    (moondream_tpu/ops/layers.py:38-71), whose epilogue XLA contracts to
    one fused multiply-add:

        dynamic: y = fma(float(acc) * scale[n], a[m], b[n])
        static:  y = fma(float(acc), scale[n], b[n])

    acc, the int32 product, is exact in float64 (K * 127^2 < 2^53). The fma
    is emulated in float64 from fp32 operands (the product exact, the sum
    rounded to float64, then to fp32): it can differ from a true fma only
    where that sum rounds twice (`int8_linear_fp64`)."""
    y = int8_linear_fp64(x, wq, scale, b, inv_a)
    return y.float().to(x.dtype).reshape(*x.shape[:-1], wq.shape[0])


def int8_linear(
    x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
    b: Optional[torch.Tensor], inv_a: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The w8a8 linear (see int8_linear_plain): a tensor on the CPU goes to
    the plain version, a CUDA tensor to the w8a8 kernels
    (`kernels.quant.w8a8_linear`: the quantize pass where its plan asks
    for it, then one int8 tensor-core product with its epilogue), which
    raise on what they cannot take; any other device raises."""
    if x.device.type == "cpu":
        return int8_linear_plain(x, wq, scale, b, inv_a)
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear: no route for a tensor on {x.device}")
    from ..kernels.quant import w8a8_linear

    lead = x.shape[:-1]
    y = w8a8_linear(x.reshape(-1, x.shape[-1]), wq, scale, b, inv_a)
    return y.reshape(*lead, wq.shape[0])


class Int8Linear(nn.Module):
    """A linear with int8 w8a8 weights (the JAX package's {"wq", "scale",
    "b"[, "inv_a"]} leaves): buffers `wq` int8 (N, Kp) (JAX's (K, N) codes
    through `pack_int8_weight`), `scale` fp32 (N,), `inv_a` fp32 (Kp,) or
    None (dynamic activation codes), and the bias `b`, added inside the
    fp32 epilogue and rounded once with the product, as JAX's `linear`
    does. The buffers must stay as they are: do not cast the module with
    `.to(dtype)`."""

    def __init__(self, wq: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
                 inv_a: Optional[torch.Tensor] = None):
        """`wq` (K, N) int8 codes in JAX's layout, `scale` (N,) (or JAX's
        (1, N)), `inv_a` (K,) (or (1, K)) or None."""
        super().__init__()
        k, n = wq.shape
        self.in_features = k
        packed = pack_int8_weight(wq)
        self.register_buffer("wq", packed)
        self.register_buffer("scale", scale.reshape(n).float().contiguous())
        if inv_a is not None:
            pad = torch.zeros(packed.shape[1], dtype=torch.float32, device=wq.device)
            pad[:k] = inv_a.reshape(k)
            inv_a = pad
        self.register_buffer("inv_a", inv_a)
        self.b = nn.Parameter(b, requires_grad=False)

    def codes(self) -> torch.Tensor:
        """The codes in JAX's (K, N) layout."""
        return self.wq[:, :self.in_features].t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.wq, self.scale, self.b, self.inv_a)
