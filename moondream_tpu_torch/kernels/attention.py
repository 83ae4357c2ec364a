"""ctypes bindings of the attention kernels in `csrc/`: A (flash; its
position as a host int or as positions on the device), and B
(one position for the batch, as a host int or as positions on the device;
its GQA entries over one layer of the stacked cache or over a single
layer) and C (per-row positions, optionally over a shared prefix segment),
two families of entry points of one decode kernel.

Each wrapper checks device, dtype, shape, strides and alignment, allocates
the output, launches on `torch.cuda.current_stream()` without
synchronising, raises when the C entry point reports a CUDA error, and
adds one to its entry in `build.LAUNCHES` for each launch. They take CUDA
bf16 queries (and bf16 or int8 caches) only; the plain versions live
beside their dispatch in `moondream_tpu_torch.ops.attention`.

The decode kernel splits each (batch row, head)'s columns across blocks:
`plan_decode_splits` (pure Python, no card needed) chooses the split, and
the wrapper passes it with a per-stream workspace for the partial results
and the tickets that pick the block which merges them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import torch

from .build import LAUNCHES, load_cuda_library

FLASH = "flash_attn_fwd"
DECODE = "decode_attn_stacked"
# kernel B's int8-cache entry point, counted apart from its bf16 one
DECODE_INT8 = "decode_attn_stacked_int8"
# kernel C, the serving pool's ragged decode, bf16 and int8 entry points
RAGGED = "decode_attn_ragged"
RAGGED_INT8 = "decode_attn_ragged_int8"
# kernel B's GQA entries: one layer of the stacked cache, and a single layer
DECODE_GQA = "decode_attn_stacked_gqa"
DECODE_GQA_LAYER = "decode_attn_layer_gqa"
LAUNCHES.update({FLASH: 0, DECODE: 0, DECODE_INT8: 0, RAGGED: 0, RAGGED_INT8: 0,
                 DECODE_GQA: 0, DECODE_GQA_LAYER: 0})

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _flash_lib() -> ctypes.CDLL:
    lib = load_cuda_library(FLASH, ["flash_attn_fwd.cu"])
    fn = lib.flash_attn_fwd_bf16
    if fn.argtypes is None:
        fn.restype = _I
        # pos, pos_dev (null: the host pos), prefix, scale, stream
        fn.argtypes = [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I, _P, _I, _F, _P]
    return lib


def _decode_lib() -> ctypes.CDLL:
    lib = load_cuda_library(DECODE, ["decode_attn_stacked.cu"])
    fn = lib.decode_attn_stacked_bf16
    if fn.argtypes is None:
        fn.restype = _I
        split = [_I, _I, _P, _P, _P]  # n_split, split_cols, ws, tickets, stream
        # pos, pos_arr (null: the host pos), prefix, scale
        where = [_I, _P, _I, _F]
        fn.argtypes = [_P] * 4 + [_I] * 8 + [_L] * 6 + where + split
        fn8 = lib.decode_attn_stacked_int8
        fn8.restype = _I
        fn8.argtypes = [_P] * 6 + [_I] * 9 + [_L] * 6 + where + split
        fnr = lib.decode_attn_ragged_bf16
        fnr.restype = _I
        fnr.argtypes = [_P] * 8 + [_I] * 11 + [_L] * 6 + [_I, _I, _F] + split
        fnr8 = lib.decode_attn_ragged_int8
        fnr8.restype = _I
        fnr8.argtypes = [_P] * 12 + [_I] * 12 + [_L] * 6 + [_I, _I, _F] + split
        fng = lib.decode_attn_stacked_gqa_bf16
        fng.restype = _I
        fng.argtypes = [_P] * 4 + [_I] * 8 + [_L] * 4 + where + split
    return lib


# Compile and load the kernels now (otherwise done at first launch), e.g.
# through build.build_parallel.
LOADERS = (_flash_lib, _decode_lib)


def _check_bf16_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expected bfloat16, got {t.dtype}")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({torch.cuda.get_device_name()})"
        )


def _tma_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """t's (batch, head, token) strides for kernel A's TMA descriptors,
    which need a unit head_dim stride, a 16-byte aligned base and strides
    of whole 16 bytes (8 bf16). A dimension of size 1 is never stepped: its
    stride is passed as 0."""
    strides = tuple(0 if n == 1 else st for n, st in zip(t.shape[:3], t.stride()[:3]))
    if t.stride(3) != 1 or any(st % 8 for st in strides) or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: TMA needs a contiguous head_dim, a 16-byte aligned base and "
            f"strides in multiples of 8 elements, got strides {t.stride()} at "
            f"offset {t.data_ptr() % 16} bytes"
        )
    return strides


# The decode kernel's split plan: about three blocks per SM (two and four
# were slower on the H100), each split a multiple of 16 columns and at
# least 32, at most 128 splits.
SPLIT_BLOCKS_PER_SM = 3
SPLIT_ALIGN = 16
MIN_SPLIT_COLS = 32
MAX_SPLITS = 128
H100_SMS = 132


def plan_decode_splits(ncols: int, pairs: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(n_split, split_cols) for a decode launch over `pairs` (batch row,
    head) pairs of at most `ncols` columns each (kernel B: the exact count;
    kernel C: its host read bounds tk + min(prefix_len, tp)). Split i covers
    columns [i * split_cols, min((i + 1) * split_cols, ncols)): together
    they cover [0, ncols) once and each starts on a multiple of 16 columns.
    split_cols is the fewest columns, a multiple of 16 and at least
    MIN_SPLIT_COLS, that keep the splits per pair within the target
    ceil(SPLIT_BLOCKS_PER_SM * sms / pairs) (at most MAX_SPLITS): the splits
    come out nearly equal, with no sliver at the end whose blocks would
    only add a wave."""
    if ncols <= 0 or pairs <= 0:
        raise ValueError(f"plan_decode_splits: ncols {ncols}, pairs {pairs}")
    want = min(MAX_SPLITS, -(-SPLIT_BLOCKS_PER_SM * sms // pairs))
    per_split = -(-ncols // want)
    cols = max(MIN_SPLIT_COLS, -(-per_split // SPLIT_ALIGN) * SPLIT_ALIGN)
    return -(-ncols // cols), cols


# Per (device, stream): (fp32 workspace, int32 tickets), grown only, the
# tickets zeroed once at allocation (every launch leaves them at 0). A
# decode step then allocates nothing and the addresses stay fixed (for a
# CUDA graph). Launches on one stream run in order, so they may share one;
# launches on two streams may run at once, so each stream has its own.
# Growing replaces the pair: a CUDA graph that captured the old one keeps
# a reference to it (engine/graphs.py), so its replays never read freed
# memory.
_WORKSPACE: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_SMS: Dict[torch.device, int] = {}


def workspace(dev: torch.device, stream: int, floats: int, pairs: int):
    """The (workspace, tickets) of `stream` (a `cuda_stream` handle) on
    `dev`, grown to at least `floats` and `pairs` entries."""
    ws, tickets = _WORKSPACE.get((dev, stream), (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < pairs:
        tickets = torch.zeros(pairs, dtype=torch.int32, device=dev)
    _WORKSPACE[(dev, stream)] = ws, tickets
    return ws, tickets


def stream_workspace(dev: torch.device, stream: int) -> Tuple[torch.Tensor, ...]:
    """The (workspace, tickets) that launches on `stream` use now (empty
    before the first): what a CUDA graph captured on that stream holds."""
    return _WORKSPACE.get((dev, stream), ())


def _split_args(like: torch.Tensor, ncols: int, pairs: int, tq: int, d: int) -> tuple:
    """(n_split, split_cols, ws pointer, tickets pointer) for one launch on
    the current stream."""
    dev = like.device
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, cols = plan_decode_splits(ncols, pairs, _SMS[dev])
    ws, tickets = workspace(dev, torch.cuda.current_stream(dev).cuda_stream,
                            pairs * n_split * tq * (d + 2), pairs)
    return n_split, cols, ws.data_ptr(), tickets.data_ptr()


def _head_major_out(b: int, h: int, t: int, d: int, like: torch.Tensor):
    """A (B, H, T, D) view over (B, T, H, D) memory: the caller's
    transpose(1, 2).reshape(B, T, H*D) is then free."""
    return torch.empty(
        (b, t, h, d), dtype=like.dtype, device=like.device
    ).transpose(1, 2)


def flash_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: Union[int, torch.Tensor],
    prefix: int
) -> torch.Tensor:
    """Masked attention, q (B, H, Tq, D), k/v (B, H, Tk, D) -> (B, H, Tq, D).
    Query row i of batch row b sits at position pos + i (unified mask
    rule). `pos`: a host int, or (B,) int32 positions on q's device, row b
    at pos[b], which only the kernel reads (the form a CUDA graph's replays
    advance; Tk stays the read bound). q, k and v are read by TMA as they
    lie: a unit head_dim stride, a 16-byte aligned base and batch, head and
    token strides of whole 16 bytes (the ViT's fused-QKV head views, the
    stacked cache's layer views and contiguous tensors all are); anything
    else raises.

    The tensor maps are encoded at every launch and passed by value, so a
    CUDA graph bakes in the addresses of q, k and v as captured. That is
    sound for a captured decode loop: k and v are either the cache's layer
    views (the cache is named in the graph's key) or copies made inside the
    capture (heads repeated under GQA, an int8 layer dequantized), which
    live in the graph's private memory pool at fixed addresses for the
    graph's life."""
    _check_bf16_cuda(FLASH, q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"{FLASH}: shapes {q.shape} {k.shape} {v.shape}")
    if d % 8 or d > 80:
        raise ValueError(f"{FLASH}: head_dim {d} must be a multiple of 8 and <= 80")
    if isinstance(pos, torch.Tensor):
        _check_index(FLASH, pos, b, q)
        host_pos, pos_ptr = 0, pos.data_ptr()
    else:
        host_pos, pos_ptr = int(pos), None
    strides = [_tma_strides(FLASH, t) for t in (q, k, v)]
    out = _head_major_out(b, h, tq, d, q)
    rc = _flash_lib().flash_attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, tk, d, *strides[0], *strides[1], *strides[2], *out.stride()[:3],
        host_pos, pos_ptr, int(prefix), float(d) ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(FLASH, rc)
    LAUNCHES[FLASH] += 1
    return out


def _check_decode(name, q, k_cache, v_cache, k_scale, v_scale, batch, rep=1) -> int:
    """Check q (S, rep * H, Tq, D) against stacked (L, batch, H, T, D) caches
    (S == batch for the slot's own cache, P for a prefix segment) and their
    scales; returns the number of scale rows H/g (0 for bf16)."""
    _check_bf16_cuda(name, q)
    _, h, tq, d = q.shape
    n_layers, cb, ch, t_max, cd = k_cache.shape
    if (cb, ch * rep, cd) != (batch, h, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}"
        )
    int8 = k_scale is not None
    cache_dtype = torch.int8 if int8 else torch.bfloat16
    row = 16 if int8 else 8  # elements per 16-byte load
    if not 1 <= tq <= 16 or d % row or d > 64:
        raise ValueError(
            f"{name}: need 1 <= Tq <= 16 and head_dim <= 64, a multiple of {row}"
        )
    for c in (k_cache, v_cache):
        if c.device != q.device or c.dtype != cache_dtype:
            raise ValueError(f"{name}: caches must be {cache_dtype} on {q.device}")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError(f"{name}: caches must be contiguous and 16-byte aligned")
    if q.stride(3) != 1:
        raise ValueError(f"{name}: q head_dim must be contiguous")
    if not int8:
        return 0
    if v_scale is None or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: k_scale and v_scale must match")
    hg = k_scale.shape[2] if k_scale.dim() == 4 else 0
    if hg == 0 or h % hg or k_scale.shape != (n_layers, batch, hg, t_max):
        raise ValueError(
            f"{name}: scales {tuple(k_scale.shape)} do not fit cache "
            f"{tuple(k_cache.shape)}"
        )
    for s in (k_scale, v_scale):
        if s.device != q.device or s.dtype != torch.float32 or not s.is_contiguous():
            raise ValueError(f"{name}: scales must be contiguous fp32 on {q.device}")
    return hg


def _check_index(name: str, t: torch.Tensor, n: int, like: torch.Tensor) -> None:
    """A per-slot int32 vector on the device (positions, prefix ids), read
    by the kernel; its values are never read on the host."""
    if (t.device != like.device or t.dtype != torch.int32 or t.shape != (n,)
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: positions and prefix ids must be contiguous int32 ({n},) "
            f"on {like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _position(name: str, pos: Union[int, torch.Tensor], like: torch.Tensor, span: int,
              prefix: int, tk: int) -> Tuple[int, Optional[int], int]:
    """Kernel B's position in its host or device form: (host pos, device
    positions pointer or None, columns the splits must cover). A host int
    covers the columns its `span` rows attend, max(pos + span, prefix),
    capped at tk; a (B,) int32 tensor on the device, which only the kernel
    reads, the read bound tk."""
    if isinstance(pos, torch.Tensor):
        _check_index(name, pos, like.shape[0], like)
        return 0, pos.data_ptr(), tk
    if pos < 0:
        raise ValueError(f"{name}: pos {pos}")
    return int(pos), None, min(max(int(pos) + span, prefix), tk)


def decode_attn_stacked(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    pos: Union[int, torch.Tensor],
    prefix: int,
    tk: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of q (B, H, Tq <= 16, D) over layer `layer` of the stacked
    (L, B, H, T, D) caches, reading at most the first `tk` slots. With
    k_scale/v_scale (L, B, H/g, T) fp32, the caches hold int8 codes and
    head h reads scale row h // g. `pos`: a host int, or (B,) int32
    positions on the device (the form a CUDA graph's replays advance)."""
    int8 = k_scale is not None
    name = DECODE_INT8 if int8 else DECODE
    b, h, tq, d = q.shape
    n_layers, _, _, t_max, _ = k_cache.shape
    hg = _check_decode(name, q, k_cache, v_cache, k_scale, v_scale, b)
    if not (0 <= layer < n_layers and 0 < tk <= t_max):
        raise ValueError(f"{name}: layer {layer}, tk {tk}")
    host_pos, pos_ptr, ncols = _position(name, pos, q, tq, prefix, tk)
    out = _head_major_out(b, h, tq, d, q)
    lib = _decode_lib()
    tail = (*q.stride()[:3], *out.stride()[:3], host_pos, pos_ptr, int(prefix),
            float(d) ** -0.5, *_split_args(q, ncols, b * h, tq, d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if int8:
        rc = lib.decode_attn_stacked_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
            n_layers, b, h, t_max, d, tq, int(layer), int(tk), h // hg, *tail,
        )
    else:
        rc = lib.decode_attn_stacked_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            n_layers, b, h, t_max, d, tq, int(layer), int(tk), *tail,
        )
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return out


def decode_attn_ragged(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    pos: torch.Tensor,
    prefix: int,
    tk: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    pref_k: Optional[torch.Tensor] = None,
    pref_v: Optional[torch.Tensor] = None,
    pref_ks: Optional[torch.Tensor] = None,
    pref_vs: Optional[torch.Tensor] = None,
    pids: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Kernel C: slot b of q (S, H, Tq <= 16, D) at positions pos[b] + i over
    layer `layer` of the stacked (L, S, H, T, D) caches, reading at most the
    first `tk` slots, and with `pref_k`/`pref_v` (L, P, H, Tp, D) and `pids`
    over prefix entry pids[b] too (see ops.attention.
    decode_attention_ragged_plain). `pos` and `pids` are int32 (S,) device
    tensors that the kernel reads; nothing is synchronised. int8 caches take
    fp32 scales (L, S or P, H/g, T) as kernel B's do."""
    int8 = k_scale is not None
    name = RAGGED_INT8 if int8 else RAGGED
    s_, h, tq, d = q.shape
    n_layers, _, _, t_max, _ = k_cache.shape
    hg = _check_decode(name, q, k_cache, v_cache, k_scale, v_scale, s_)
    if not (0 <= layer < n_layers and 0 < tk <= t_max):
        raise ValueError(f"{name}: layer {layer}, tk {tk}")
    _check_index(name, pos, s_, q)
    shared = pref_k is not None
    n_pref = tp = 0
    if shared:
        if pids is None or (pref_ks is None) != (not int8) or prefix_len <= 0:
            raise ValueError(
                f"{name}: a prefix segment needs pids, prefix_len > 0 and "
                "scales exactly when the cache has them"
            )
        if pref_k.shape[0] != n_layers:
            raise ValueError(f"{name}: prefix {tuple(pref_k.shape)} has other layers")
        n_pref, tp = pref_k.shape[1], pref_k.shape[3]
        phg = _check_decode(name, q, pref_k, pref_v, pref_ks, pref_vs, n_pref)
        if phg != hg:
            raise ValueError(f"{name}: prefix scales do not match the cache's")
        _check_index(name, pids, s_, q)
    elif pids is not None or pref_v is not None:
        raise ValueError(f"{name}: pids and pref_v need pref_k")
    out = _head_major_out(s_, h, tq, d, q)
    lib = _decode_lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    # the positions live on the device: split the most columns a slot may read
    ncols = tk + (min(prefix_len, tp) if shared else 0)
    tail = (*q.stride()[:3], *out.stride()[:3], int(prefix), int(prefix_len),
            float(d) ** -0.5, *_split_args(q, ncols, s_ * h, tq, d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if int8:
        rc = lib.decode_attn_ragged_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), ptr(pref_k), ptr(pref_v),
            ptr(pref_ks), ptr(pref_vs), out.data_ptr(), pos.data_ptr(), ptr(pids),
            n_layers, s_, h, t_max, d, tq, int(layer), int(tk), h // hg,
            n_pref, tp, tp, *tail,
        )
    else:
        rc = lib.decode_attn_ragged_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(pref_k),
            ptr(pref_v), out.data_ptr(), pos.data_ptr(), ptr(pids),
            n_layers, s_, h, t_max, d, tq, int(layer), int(tk), n_pref, tp, tp,
            *tail,
        )
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return out


def decode_attn_gqa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: Union[int, torch.Tensor],
    prefix: int,
    layer: Optional[int] = None,
    tk: Optional[int] = None,
) -> torch.Tensor:
    """Kernel B's GQA entries: one token q (B, Hq, 1, D), query head h over
    KV head h // rep (rep = Hq / Hkv, at most 16; 1 is MHA). With `layer`,
    k/v are the stacked bf16 (L, B, Hkv, T, D) caches, read at that layer
    up to the first `tk` slots; without, a single (B, Hkv, T, D) layer
    (the counterpart of `decode_attention`). Only a single token: as in the
    JAX package, query spans need MHA. `pos`: a host int, or (B,) int32
    positions on the device."""
    name = DECODE_GQA if layer is not None else DECODE_GQA_LAYER
    if layer is None:  # a single layer: L = 1, layer 0, every slot
        k, v, layer = k[None], v[None], 0
    if k.dim() != 5:
        raise ValueError(f"{name}: cache shape {tuple(k.shape)}")
    b, hq, tq, d = q.shape
    n_layers, _, hkv, t_max, _ = k.shape
    rep = hq // hkv
    if tq != 1 or not 1 <= rep <= 16:
        raise ValueError(
            f"{name}: GQA decode takes one query token and Hq = rep * Hkv with "
            f"rep <= 16, got q {tuple(q.shape)} for cache {tuple(k.shape)}"
        )
    _check_decode(name, q, k, v, None, None, b, rep)
    tk = t_max if tk is None else tk
    if not (0 <= layer < n_layers and 0 < tk <= t_max):
        raise ValueError(f"{name}: layer {layer}, tk {tk}")
    host_pos, pos_ptr, ncols = _position(name, pos, q, 1, prefix, tk)
    out = _head_major_out(b, hq, 1, d, q)
    rc = _decode_lib().decode_attn_stacked_gqa_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        n_layers, b, hkv, t_max, d, rep, int(layer), int(tk),
        q.stride(0), q.stride(1), out.stride(0), out.stride(1), host_pos, pos_ptr,
        int(prefix), float(d) ** -0.5, *_split_args(q, ncols, b * hkv, rep, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return out
