"""ctypes binding of the W4A16 kernel in `csrc/w4a16_matmul.cu`.

The wrapper checks device, dtype, shape, contiguity and alignment, allocates
the output, launches on `torch.cuda.current_stream()` without
synchronising, raises when the C entry point reports a CUDA error, and adds
one to `build.LAUNCHES[W4A16]` for each launch. The plain version lives
beside its dispatch in `moondream_tpu_torch.ops.quant`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LAUNCHES, load_cuda_library

W4A16 = "w4a16_matmul"
LAUNCHES[W4A16] = 0

# output columns per block in the kernel
_TN = 32


def _lib() -> ctypes.CDLL:
    lib = load_cuda_library(W4A16, ["w4a16_matmul.cu"])
    fn = lib.w4a16_matmul_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


LOADERS = (_lib,)


def w4a16_matmul(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor
) -> torch.Tensor:
    """x (M, K) bf16 @ packed int4 (K/2, N) uint8 with scale/zero (G, N)
    fp32 -> (M, N) bf16. Views into stacked (L, ...) tensors are taken as
    they are when contiguous."""
    dev = x.device
    if dev.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"{W4A16}: x must be a 2-D CUDA bf16 tensor")
    m, k = x.shape
    if packed.dim() != 2 or packed.dtype != torch.uint8 or packed.shape[0] * 2 != k:
        raise ValueError(f"{W4A16}: packed {tuple(packed.shape)} does not fit K={k}")
    n = packed.shape[1]
    groups = scale.shape[0] if scale.dim() == 2 else 0
    if groups == 0 or scale.shape != (groups, n) or zero.shape != scale.shape:
        raise ValueError(
            f"{W4A16}: scale {tuple(scale.shape)} / zero {tuple(zero.shape)} "
            f"do not fit packed {tuple(packed.shape)}"
        )
    if k % groups or k % (2 * (k // groups)) or n % _TN or m == 0:
        raise ValueError(f"{W4A16}: M={m}, K={k}, N={n}, {groups} groups")
    for t, align in ((x, 4), (packed, 4), (scale, 16), (zero, 16)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(
                f"{W4A16}: operands must be contiguous on {dev}, "
                f"{align}-byte aligned"
            )
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise ValueError(f"{W4A16}: scale and zero must be fp32")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    rc = _lib().w4a16_matmul_bf16(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), m, k, n, k // groups,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{W4A16} launch failed: CUDA error {rc} ({torch.cuda.get_device_name(dev)})"
        )
    LAUNCHES[W4A16] += 1
    return out
