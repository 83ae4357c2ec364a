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

from typing import Optional, Union

import torch

NEG_INF = -1e30
# Query rows of one kernel C launch (its wrapper's limit).
RAGGED_SPAN_MAX = 16


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def unified_mask(tq: int, tk: int, pos: Union[int, torch.Tensor], prefix: int,
                 device) -> torch.Tensor:
    """The (Tq, Tk) mask of a host int `pos`; for a (B,) tensor of
    positions, one mask per batch row, (B, 1, Tq, Tk), row b's queries at
    pos[b] + i."""
    rows = torch.arange(tq, device=device)[:, None]
    if isinstance(pos, torch.Tensor):
        rows = pos.long().to(device)[:, None, None, None] + rows
    else:
        rows = pos + rows
    cols = torch.arange(tk, device=device)
    return (cols <= rows) | ((rows < prefix) & (cols < prefix))


def _masked_softmax_pv(q, k, v, mask) -> torch.Tensor:
    """fp32 scores and softmax (max over masked scores), probabilities
    rounded to v.dtype, PV accumulated in fp32; returns q.dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, pos: Union[int, torch.Tensor],
                          prefix: int) -> torch.Tensor:
    """Plain version of kernel A. q (B, H, Tq, D), k/v (B, H, Tk, D); `pos`
    an int, or a (B,) tensor of positions (one mask per batch row)."""
    mask = unified_mask(q.shape[2], k.shape[2], pos, prefix, q.device)
    return _masked_softmax_pv(q, k, v, mask)


def flash_attention(q, k, v, pos: Union[int, torch.Tensor], prefix: int) -> torch.Tensor:
    """Fused masked attention: (B, H, Tq, D) x (B, H, Tk, D) -> (B, H, Tq, D).
    Counterpart of `flash_attention` and `_flash_attention_kvtiled` of the
    JAX package; query row i sits at position pos + i. `pos`: a host int,
    or a (B,) int32 tensor on q's device, row b at pos[b] (kernel A's device
    form, as the Pallas kernels take a traced position by scalar prefetch:
    nothing is read back, so a CUDA graph can capture the call)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, pos, prefix)
    from ..kernels.attention import flash_attn_fwd

    return flash_attn_fwd(q, k, v, pos, prefix)


def read_bound(t_max: int, kv_bound: Optional[int]) -> int:
    """Cache slots a decode read covers: kv_bound rounded up to 128, capped
    at the cache length (moondream_tpu/ops/attention.py:539-541)."""
    tk = t_max if kv_bound is None else min(kv_bound, t_max)
    return min(_ceil_to(tk, 128), t_max)


def _cache_softmax_pv(q, k, v, mask, ks=None, vs=None) -> torch.Tensor:
    """Masked attention of q over cache rows k/v (mask broadcasts to the
    scores). Without scales: `_masked_softmax_pv`. With ks/vs broadcasting
    to the scores, k/v hold int8 codes (x ~ code * scale): the k-scale
    folds into the scores and the v-scale into the unnormalised weights,
    which meet the codes in q.dtype, and the division comes after PV, as in
    `_decode_kernel_paired`'s int8 branches (moondream_tpu/ops/attention.py:
    677-692, 739-767)."""
    if ks is None:
        return _masked_softmax_pv(q, k, v, mask)
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = (s * (ks * scale)).masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pv = (p * vs).to(q.dtype).float()  # the weights meet the codes in q.dtype
    return (torch.matmul(pv, v.float()) / denom).to(q.dtype)


def _scale_rows(scale, layer: int, h: int, t: int, rows=slice(None)):
    """Layer `layer` of (L, B, H/g, T) scales (batch entries `rows`) as
    (B, H, 1, t): head h of the H query heads reads scale row
    h // (H / rows), its KV head's row under GQA too."""
    s = scale[layer, rows, :, None, :t]
    return s.repeat_interleave(h // scale.shape[2], dim=1)


def _repeat_kv(x: torch.Tensor, hq: int) -> torch.Tensor:
    """(..., Hkv, T, D) -> (..., Hq, T, D): query head h reads KV head
    h // (Hq / Hkv) (GQA); unchanged under MHA."""
    hkv = x.shape[-3]
    return x if hkv == hq else x.repeat_interleave(hq // hkv, dim=-3)


def decode_attention_plain(q, k, v, pos: int, prefix: int) -> torch.Tensor:
    """Plain version of kernel B's single-layer GQA entry: q (B, Hq, 1, D)
    over one (B, Hkv, T, D) layer, query head h reading KV head h // rep,
    as `decode_attention` of the JAX package computes it
    (moondream_tpu/ops/attention.py:341-489: `_decode_kernel`, rep 1, and
    `_decode_kernel_gqa`)."""
    hq = q.shape[1]
    return flash_attention_plain(q, _repeat_kv(k, hq), _repeat_kv(v, hq), pos, prefix)


def decode_attention(q, k, v, pos, prefix: int) -> torch.Tensor:
    """One query token q (B, Hq, 1, D) over a single (B, Hkv, T, D) layer,
    Hq a multiple of Hkv: the counterpart of `decode_attention` of the JAX
    package, which the int8 cache's dequantized layer takes under GQA.
    `pos`: an int, or a (B,) int32 tensor of positions (kernel B's device
    form: every row holds the decode loop's one position)."""
    if q.device.type == "cpu":
        if isinstance(pos, torch.Tensor):
            return decode_attention_ragged_plain(q, k[None], v[None], 0, pos, prefix)
        return decode_attention_plain(q, k, v, pos, prefix)
    from ..kernels.attention import decode_attn_gqa

    return decode_attn_gqa(q, k, v, pos, prefix)


def decode_attention_cached_plain(
    q, k_cache, v_cache, layer: int, pos: int, prefix: int,
    kv_bound: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of kernel B and of its stacked GQA entry: q (B, Hq,
    Tq, D) over layer `layer` of the stacked (L, B, Hkv, T, D) caches,
    every batch row at `pos`: kernel C's plain version with one position
    for all rows. With Hq = rep * Hkv, query head h reads KV head h // rep
    (`_decode_kernel_stacked_gqa`). With k_scale/v_scale (L, B, Hkv/g, T),
    the caches hold int8 codes (x ~ code * scale) and KV head h reads scale
    row h // g."""
    rows = torch.full((q.shape[0],), pos, device=q.device)
    return decode_attention_ragged_plain(
        q, k_cache, v_cache, layer, rows, prefix, kv_bound, k_scale, v_scale
    )


def decode_attention_ragged_plain(
    q, k_cache, v_cache, layer: int, pos: torch.Tensor, prefix: int,
    kv_bound: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    pref_k: Optional[torch.Tensor] = None,
    pref_v: Optional[torch.Tensor] = None,
    pref_ks: Optional[torch.Tensor] = None,
    pref_vs: Optional[torch.Tensor] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Plain version of kernel C: row b of q (S, H, Tq, D) sits at positions
    pos[b] + i over layer `layer` of the stacked (L, S, H, T, D) caches.

    Without a prefix segment, query row i of slot b attends column c iff
    c <= pos[b] + i OR (pos[b] + i < prefix AND c < prefix), as
    `_decode_kernel_stacked_ragged` computes it (moondream_tpu/ops/
    attention.py:963-1036). With `pref_k`/`pref_v` (L, P, H, Tp, D) the
    caches are SUFFIX segments whose column j sits at position
    prefix_len + j, and slot b also reads prefix entry pids[b]: prefix
    column c attends iff c <= pos[b] + i AND c < prefix_len, suffix column
    j iff prefix_len + j <= pos[b] + i, under one max and one denominator
    (`prefix` does not apply). int8 caches take scales (L, S or P, H/g, T)
    as in kernel B."""
    h, tq = q.shape[1], q.shape[2]
    tk = read_bound(k_cache.shape[3], kv_bound)
    k = _repeat_kv(k_cache[layer, :, :, :tk], h)
    v = _repeat_kv(v_cache[layer, :, :, :tk], h)
    qpos = (pos.long()[:, None] + torch.arange(tq, device=q.device))[:, None, :, None]
    cols = torch.arange(tk, device=q.device)
    int8 = k_scale is not None
    ks = _scale_rows(k_scale, layer, h, tk) if int8 else None
    vs = _scale_rows(v_scale, layer, h, tk) if int8 else None
    if pref_k is None:
        mask = (cols <= qpos) | ((qpos < prefix) & (cols < prefix))
        return _cache_softmax_pv(q, k, v, mask, ks, vs)
    tp = pref_k.shape[3]
    colsp = torch.arange(tp, device=q.device)
    pids = pids.long()
    k = torch.cat([_repeat_kv(pref_k[layer][pids], h), k], dim=2)
    v = torch.cat([_repeat_kv(pref_v[layer][pids], h), v], dim=2)
    mask = torch.cat(
        [(colsp <= qpos) & (colsp < prefix_len), prefix_len + cols <= qpos], dim=-1
    )
    if int8:
        ks = torch.cat([_scale_rows(pref_ks, layer, h, tp, pids), ks], dim=-1)
        vs = torch.cat([_scale_rows(pref_vs, layer, h, tp, pids), vs], dim=-1)
    return _cache_softmax_pv(q, k, v, mask, ks, vs)


def decode_attention_cached(
    q, k_cache, v_cache, layer: int, pos, prefix: int,
    kv_bound: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    pref_k: Optional[torch.Tensor] = None,
    pref_v: Optional[torch.Tensor] = None,
    pref_ks: Optional[torch.Tensor] = None,
    pref_vs: Optional[torch.Tensor] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
    *,
    lockstep: bool = False,
) -> torch.Tensor:
    """Attention for one token or a span over one layer of the whole stacked
    cache (<= 16 rows with one position for the batch; any span with per-row
    positions), bf16 or int8 codes with scales; the layer is
    addressed by index, never sliced or copied. Counterpart of
    `decode_attention_cached` of the JAX package on its plain (unpaired)
    layout. With fewer KV heads than query heads (GQA), one token over a
    bf16 cache, as the JAX package allows it (its kernel
    `_decode_kernel_stacked_gqa`).

    An int `pos` places row i of every batch entry at pos + i (kernel B). A
    1-D int32 `pos` tensor (S,) gives each slot its own position, as in the
    serving pool (kernel C), optionally over a shared prefix segment
    (`pref_k`, ..., `pids`, `prefix_len`; see decode_attention_ragged_plain).
    With `lockstep`, the (B,) tensor's rows hold one position (batch 1 and
    the lockstep batch, whose decode steps keep it on the device for a CUDA
    graph): kernel B's device form, MHA or GQA, and the kernel's splits
    cover the read bound. Positions and prefix ids stay on the device:
    nothing is read back."""
    ragged = isinstance(pos, torch.Tensor) and pos.dim() == 1
    if pref_k is not None and (not ragged or lockstep):
        raise ValueError("a shared prefix segment needs per-row positions")
    if q.device.type == "cpu":
        if ragged:
            return decode_attention_ragged_plain(
                q, k_cache, v_cache, layer, pos, prefix, kv_bound, k_scale,
                v_scale, pref_k, pref_v, pref_ks, pref_vs, pids, prefix_len,
            )
        return decode_attention_cached_plain(
            q, k_cache, v_cache, layer, pos, prefix, kv_bound, k_scale, v_scale
        )
    from ..kernels.attention import (
        decode_attn_gqa,
        decode_attn_ragged,
        decode_attn_stacked,
    )

    tk = read_bound(k_cache.shape[3], kv_bound)
    if q.shape[1] != k_cache.shape[2]:
        if (ragged and not lockstep) or k_scale is not None:
            raise ValueError(
                "GQA decode takes one position for the batch and a bf16 cache"
            )
        return decode_attn_gqa(q, k_cache, v_cache, pos, prefix, layer, tk)
    if ragged and not lockstep:
        # kernel C takes at most RAGGED_SPAN_MAX rows: a longer span (a
        # speculative verify of k > 16) goes in pieces, piece j's rows at
        # pos + j * RAGGED_SPAN_MAX. Exact: the whole span's K/V are in the
        # cache before any piece attends.
        pieces = [
            decode_attn_ragged(
                q[:, :, i:i + RAGGED_SPAN_MAX], k_cache, v_cache, layer,
                pos + i if i else pos, prefix, tk, k_scale, v_scale,
                pref_k, pref_v, pref_ks, pref_vs, pids, prefix_len,
            )
            for i in range(0, q.shape[2], RAGGED_SPAN_MAX)
        ]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)
    return decode_attn_stacked(
        q, k_cache, v_cache, layer, pos, prefix, tk, k_scale, v_scale
    )
