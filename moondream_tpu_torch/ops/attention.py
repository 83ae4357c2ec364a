"""Attention with the unified mask rule, dispatched to a CUDA kernel or to
its plain PyTorch version by where the tensors lie.

    attend(r, c) = c <= pos + r  OR  (pos + r < prefix AND c < prefix)

covers the ViT (pos 0, prefix = real tokens: bidirectional), the
[BOS, image] prefill (bidirectional over the first 730 positions) and causal
text after it (moondream_tpu/ops/attention.py).

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel in `moondream_tpu_torch.kernels`, which raises on what it cannot
take. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def unified_mask(tq: int, tk: int, pos: int, prefix: int, device) -> torch.Tensor:
    rows = pos + torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    return (cols <= rows) | ((rows < prefix) & (cols < prefix))


def _masked_softmax_pv(q, k, v, mask) -> torch.Tensor:
    """fp32 scores and softmax (max over masked scores), probabilities
    rounded to v.dtype, PV accumulated in fp32; returns q.dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, pos: int, prefix: int) -> torch.Tensor:
    """Plain version of kernel A. q (B, H, Tq, D), k/v (B, H, Tk, D)."""
    mask = unified_mask(q.shape[2], k.shape[2], pos, prefix, q.device)
    return _masked_softmax_pv(q, k, v, mask)


def flash_attention(q, k, v, pos: int, prefix: int) -> torch.Tensor:
    """Fused masked attention: (B, H, Tq, D) x (B, H, Tk, D) -> (B, H, Tq, D).
    Counterpart of `flash_attention` and `_flash_attention_kvtiled` of the
    JAX package; query row i sits at position pos + i."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, pos, prefix)
    from ..kernels.attention import flash_attn_fwd

    return flash_attn_fwd(q, k, v, pos, prefix)


def read_bound(t_max: int, kv_bound: Optional[int]) -> int:
    """Cache slots a decode read covers: kv_bound rounded up to 128, capped
    at the cache length (moondream_tpu/ops/attention.py:539-541)."""
    tk = t_max if kv_bound is None else min(kv_bound, t_max)
    return min(_ceil_to(tk, 128), t_max)


def decode_attention_cached_plain(
    q, k_cache, v_cache, layer: int, pos: int, prefix: int,
    kv_bound: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of kernel B: q (B, H, Tq, D) over layer `layer` of the
    stacked (L, B, H, T, D) caches. With k_scale/v_scale (L, B, H/g, T), the
    caches hold int8 codes (x ~ code * scale) and head h reads scale row
    h // g; the scales fold into the scores and the softmax weights as in
    `_decode_kernel_paired`'s int8 branch (moondream_tpu/ops/attention.py:
    677-692, 756-767)."""
    tk = read_bound(k_cache.shape[3], kv_bound)
    k = k_cache[layer, :, :, :tk]
    v = v_cache[layer, :, :, :tk]
    mask = unified_mask(q.shape[2], tk, pos, prefix, q.device)
    if k_scale is None:
        return _masked_softmax_pv(q, k, v, mask)
    g = q.shape[1] // k_scale.shape[2]
    ks = k_scale[layer, :, :, None, :tk].repeat_interleave(g, dim=1)
    vs = v_scale[layer, :, :, None, :tk].repeat_interleave(g, dim=1)
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = (s * (ks * scale)).masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pv = (p * vs).to(q.dtype).float()  # the weights meet the codes in q.dtype
    return (torch.matmul(pv, v.float()) / denom).to(q.dtype)


def decode_attention_cached(
    q, k_cache, v_cache, layer: int, pos: int, prefix: int,
    kv_bound: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention for one token or a span of <= 16 rows (row i at pos + i)
    over one layer of the whole stacked cache, bf16 or int8 codes with
    scales; the layer is addressed by index, never sliced or copied.
    Counterpart of `decode_attention_cached` of the JAX package on its plain
    (unpaired, MHA) layout."""
    if q.device.type == "cpu":
        return decode_attention_cached_plain(
            q, k_cache, v_cache, layer, pos, prefix, kv_bound, k_scale, v_scale
        )
    from ..kernels.attention import decode_attn_stacked

    tk = read_bound(k_cache.shape[3], kv_bound)
    return decode_attn_stacked(
        q, k_cache, v_cache, layer, pos, prefix, tk, k_scale, v_scale
    )
