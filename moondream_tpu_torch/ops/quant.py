"""int4 runtime weights: packing and the W4A16 matmul, dispatched to the
CUDA kernel or to its plain PyTorch version by where the tensors lie
(moondream_tpu/ops/quant.py).

A weight (K, N) is quantized per (group of `group` input rows, column) to
the 0..15 nibble range, asymmetric: w ~ code * scale + zero, with
zero = the group's minimum. The runtime packing puts input row r in the
high nibble of byte row r and row r + K/2 in the low nibble, so a packed
weight is (K/2, N) uint8 and scale/zero are (K/group, N) fp32.

This is NOT the reference checkpoint's int4 format (256-element strips,
`weights.dequantize_int4`): a checkpoint in that format is dequantized when
it is loaded and then quantized again here.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

GROUP = 128

# Prefill-sized row counts go to a dense product (see quantized_matmul).
DENSE_M = 512


def group_size(k: int, group: Optional[int] = None) -> int:
    """The group length along K: 128, shrunk for small K to the largest
    power-of-two divisor with K % (2 * group) == 0 (K=64 -> 32, K=128 ->
    64), as moondream_tpu/ops/quant.py:53-57."""
    if group is None:
        group = min(GROUP, k // 2)
        while group > 1 and (k % (2 * group) or k % group):
            group //= 2
    if k % (2 * group):
        raise ValueError(f"K={k} not divisible by 2*group={2 * group}")
    return group


def quantize_weight(w: np.ndarray, group: Optional[int] = None) -> dict:
    """numpy: dense (..., K, N) -> {"packed": uint8 (..., K/2, N), "scale",
    "zero": fp32 (..., K/group, N)}, bit-identical to the JAX package's
    `quantize_weight`."""
    w = np.asarray(w, dtype=np.float32)
    *lead, k, n = w.shape
    group = group_size(k, group)
    g = w.reshape(*lead, k // group, group, n)
    w_min = g.min(axis=-2)
    w_max = g.max(axis=-2)
    scale = np.maximum((w_max - w_min) / 15.0, 1e-8)
    q = np.clip(np.round((g - w_min[..., None, :]) / scale[..., None, :]), 0, 15)
    q = q.reshape(*lead, k, n).astype(np.uint8)
    packed = ((q[..., : k // 2, :] << 4) | q[..., k // 2 :, :]).astype(np.uint8)
    return {"packed": packed, "scale": scale.astype(np.float32),
            "zero": w_min.astype(np.float32)}


# 1/15 rounded once to fp32, as XLA folds the constant
_INV15 = float(np.float32(1.0) / np.float32(15.0))


@torch.no_grad()
def quantize_weight_torch(w: torch.Tensor, group: Optional[int] = None) -> dict:
    """`quantize_weight` on the tensor's own device (the 2B text blocks are
    quantized on the card), bit-identical to the JAX package's jitted
    `quantize_weight_jax`, which is what its `quantize_text_params` and
    `load_params(..., runtime_int4=True)` run. Under jit, XLA turns the
    division by 15 into a product with fp32(1/15), so those scales can
    differ from numpy's `quantize_weight` in the last bit (and a code that
    sits on a rounding tie, as a dequantized int4 checkpoint's do, by one).
    The product and the tensor-by-tensor division give the same bits on
    the CPU and the card."""
    w = w.float()
    *lead, k, n = w.shape
    group = group_size(k, group)
    g = w.reshape(*lead, k // group, group, n)
    w_min = g.amin(dim=-2)
    w_max = g.amax(dim=-2)
    scale = ((w_max - w_min) * torch.full_like(w_min, _INV15)).clamp_min(1e-8)
    q = torch.round((g - w_min.unsqueeze(-2)) / scale.unsqueeze(-2)).clamp(0, 15)
    q = q.reshape(*lead, k, n).to(torch.uint8)
    packed = (q[..., : k // 2, :] << 4) | q[..., k // 2 :, :]
    return {"packed": packed.contiguous(), "scale": scale, "zero": w_min}


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) uint8 -> (..., K, N) codes 0..15 as uint8."""
    return torch.cat([packed >> 4, packed & 0x0F], dim=-2)


def dequantize_weight(qw: Mapping[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """Dense (..., K, N) reconstruction code * scale + zero in fp32, cast to
    `dtype` (moondream_tpu/ops/quant.py:101-113)."""
    q = unpack_codes(qw["packed"]).float()
    scale, zero = qw["scale"], qw["zero"]
    *lead, k, n = q.shape
    groups = scale.shape[-2]
    g = q.reshape(*lead, groups, k // groups, n)
    w = g * scale.unsqueeze(-2) + zero.unsqueeze(-2)
    return w.reshape(*lead, k, n).to(dtype)


def quantized_matmul_plain(x: torch.Tensor, qw: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Plain version of the W4A16 kernel: x (M, K) @ the packed (K/2, N)
    weight -> (M, N) in x.dtype, as the group-dot Pallas kernel
    `_q_matmul_kernel_gd` computes it, in fp32:

        out = sum_g (x_g @ code_g) * scale[g]  +  (sum_k x_g) @ zero
    """
    packed, scale, zero = qw["packed"], qw["scale"], qw["zero"]
    m, k = x.shape
    groups, n = scale.shape
    xg = x.float().reshape(m, groups, k // groups)
    codes = unpack_codes(packed).float().reshape(groups, k // groups, n)
    part = torch.einsum("mgk,gkn->mgn", xg, codes)
    out = (part * scale).sum(dim=1) + xg.sum(dim=-1) @ zero
    return out.to(x.dtype)


def quantized_matmul(x: torch.Tensor, qw: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """x (M, K) @ an int4-packed weight {"packed" (K/2, N), "scale", "zero"
    (K/group, N)} -> (M, N) in x.dtype. Counterpart of `quantized_matmul`
    of the JAX package for one layer's weight (a view into stacked (L, ...)
    tensors works too).

    A tensor on the CPU goes to the plain version. On the card, M < 512
    (prompt spans, decode) goes to the W4A16 kernel, which raises on what it
    cannot take; M >= 512 (the 730-row image prefill) dequantizes the layer
    once and runs a dense product. That is the JAX package's own route for
    prefill-sized M (moondream_tpu/ops/quant.py:263-285, plain XLA there,
    no Pallas kernel): it is neither a kernel nor a fallback from one."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, qw)
    if x.shape[0] >= DENSE_M:
        return torch.matmul(x, dequantize_weight(qw, x.dtype))
    from ..kernels.quant import w4a16_matmul

    return w4a16_matmul(x, qw["packed"], qw["scale"], qw["zero"])
