"""ctypes bindings of the two attention kernels in `csrc/`.

Each wrapper checks device, dtype, shape, strides and alignment, allocates
the output, launches on `torch.cuda.current_stream()` without
synchronising, raises when the C entry point reports a CUDA error, and
adds one to its entry in `LAUNCHES` for each launch. They take CUDA bf16
tensors only; the plain versions live beside their dispatch in
`moondream_tpu_torch.ops.attention`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .build import load_cuda_library

FLASH = "flash_attn_fwd"
DECODE = "decode_attn_stacked"

# Kernel launches since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {FLASH: 0, DECODE: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    return lib


def build_all() -> None:
    """Compile and load both kernels now (otherwise done at first launch)."""
    _flash_lib()
    _decode_lib()


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
) -> torch.Tensor:
    """Attention of q (B, H, Tq <= 16, D) over layer `layer` of the stacked
    (L, B, H, T, D) caches, reading at most the first `tk` slots."""
    _check_bf16_cuda(DECODE, q, k_cache, v_cache)
    b, h, tq, d = q.shape
    n_layers, cb, ch, t_max, cd = k_cache.shape
    if (cb, ch, cd) != (b, h, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"{DECODE}: q {q.shape} does not match cache {k_cache.shape}"
        )
    if not 1 <= tq <= 16 or d % 8 or d > 64:
        raise ValueError(
            f"{DECODE}: need 1 <= Tq <= 16 and head_dim <= 64, a multiple of 8"
        )
    if not (0 <= layer < n_layers and 0 < tk <= t_max and pos >= 0):
        raise ValueError(f"{DECODE}: layer {layer}, tk {tk}, pos {pos}")
    for c in (k_cache, v_cache):
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError(f"{DECODE}: caches must be contiguous")
    if q.stride(3) != 1:
        raise ValueError(f"{DECODE}: q head_dim must be contiguous")
    out = _head_major_out(b, h, tq, d, q)
    rc = _decode_lib().decode_attn_stacked_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        n_layers, b, h, t_max, d, tq, int(layer), int(tk),
        *q.stride()[:3], *out.stride()[:3],
        int(pos), int(prefix), float(d) ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(DECODE, rc)
    LAUNCHES[DECODE] += 1
    return out
