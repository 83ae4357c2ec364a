"""ctypes bindings of the two attention kernels in `csrc/`.

Each wrapper checks device, dtype, shape, strides and alignment, allocates
the output, launches on `torch.cuda.current_stream()` without
synchronising, raises when the C entry point reports a CUDA error, and
adds one to its entry in `build.LAUNCHES` for each launch. They take CUDA
bf16 queries (and bf16 or int8 caches) only; the plain versions live
beside their dispatch in `moondream_tpu_torch.ops.attention`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import LAUNCHES, load_cuda_library

FLASH = "flash_attn_fwd"
DECODE = "decode_attn_stacked"
# kernel B's int8-cache entry point, counted apart from its bf16 one
DECODE_INT8 = "decode_attn_stacked_int8"
LAUNCHES.update({FLASH: 0, DECODE: 0, DECODE_INT8: 0})

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _flash_lib() -> ctypes.CDLL:
    lib = load_cuda_library(FLASH, ["flash_attn_fwd.cu"])
    fn = lib.flash_attn_fwd_bf16
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I, _I, _F, _P]
    return lib


def _decode_lib() -> ctypes.CDLL:
    lib = load_cuda_library(DECODE, ["decode_attn_stacked.cu"])
    fn = lib.decode_attn_stacked_bf16
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 4 + [_I] * 8 + [_L] * 6 + [_I, _I, _F, _P]
        fn8 = lib.decode_attn_stacked_int8
        fn8.restype = _I
        fn8.argtypes = [_P] * 6 + [_I] * 9 + [_L] * 6 + [_I, _I, _F, _P]
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


def _head_major_out(b: int, h: int, t: int, d: int, like: torch.Tensor):
    """A (B, H, T, D) view over (B, T, H, D) memory: the caller's
    transpose(1, 2).reshape(B, T, H*D) is then free."""
    return torch.empty(
        (b, t, h, d), dtype=like.dtype, device=like.device
    ).transpose(1, 2)


def flash_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, prefix: int
) -> torch.Tensor:
    """Masked attention, q (B, H, Tq, D), k/v (B, H, Tk, D) -> (B, H, Tq, D).
    Query row i sits at position pos + i (unified mask rule). Any strides
    with a unit, even-aligned head_dim axis are taken as they are."""
    _check_bf16_cuda(FLASH, q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"{FLASH}: shapes {q.shape} {k.shape} {v.shape}")
    if d % 2 or d > 80:
        raise ValueError(f"{FLASH}: head_dim {d} must be even and <= 80")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % 2 for s in t.stride()[:3]) or t.data_ptr() % 4:
            raise ValueError(
                f"{FLASH}: head_dim must be contiguous with even strides and "
                f"4-byte aligned rows, got strides {t.stride()}"
            )
    out = _head_major_out(b, h, tq, d, q)
    rc = _flash_lib().flash_attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, tk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(pos), int(prefix), float(d) ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(FLASH, rc)
    LAUNCHES[FLASH] += 1
    return out


def decode_attn_stacked(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer: int,
    pos: int,
    prefix: int,
    tk: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of q (B, H, Tq <= 16, D) over layer `layer` of the stacked
    (L, B, H, T, D) caches, reading at most the first `tk` slots. With
    k_scale/v_scale (L, B, H/g, T) fp32, the caches hold int8 codes and
    head h reads scale row h // g."""
    int8 = k_scale is not None
    name = DECODE_INT8 if int8 else DECODE
    _check_bf16_cuda(name, q)
    b, h, tq, d = q.shape
    n_layers, cb, ch, t_max, cd = k_cache.shape
    if (cb, ch, cd) != (b, h, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"{name}: q {q.shape} does not match cache {k_cache.shape}"
        )
    cache_dtype = torch.int8 if int8 else torch.bfloat16
    row = 16 if int8 else 8  # elements per 16-byte load
    if not 1 <= tq <= 16 or d % row or d > 64:
        raise ValueError(
            f"{name}: need 1 <= Tq <= 16 and head_dim <= 64, a multiple of {row}"
        )
    if not (0 <= layer < n_layers and 0 < tk <= t_max and pos >= 0):
        raise ValueError(f"{name}: layer {layer}, tk {tk}, pos {pos}")
    for c in (k_cache, v_cache):
        if c.device != q.device or c.dtype != cache_dtype:
            raise ValueError(f"{name}: caches must be {cache_dtype} on {q.device}")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError(f"{name}: caches must be contiguous and 16-byte aligned")
    if q.stride(3) != 1:
        raise ValueError(f"{name}: q head_dim must be contiguous")
    if int8:
        if v_scale is None or v_scale.shape != k_scale.shape:
            raise ValueError(f"{name}: k_scale and v_scale must match")
        hg = k_scale.shape[2] if k_scale.dim() == 4 else 0
        if hg == 0 or h % hg or k_scale.shape != (n_layers, b, hg, t_max):
            raise ValueError(
                f"{name}: scales {tuple(k_scale.shape)} do not fit cache "
                f"{tuple(k_cache.shape)}"
            )
        for s in (k_scale, v_scale):
            if (s.device != q.device or s.dtype != torch.float32
                    or not s.is_contiguous()):
                raise ValueError(f"{name}: scales must be contiguous fp32 on {q.device}")
    out = _head_major_out(b, h, tq, d, q)
    lib = _decode_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (*q.stride()[:3], *out.stride()[:3], int(pos), int(prefix),
            float(d) ** -0.5, stream)
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
