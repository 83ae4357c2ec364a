"""ctypes bindings of the W4A16 kernel in `csrc/w4a16_matmul.cu` and of the
w8a8 kernel in `csrc/w8a8_matmul.cu` (the int8 weight formats' fused
activation quantization, int8 tensor-core product and epilogue).

Each wrapper checks device, dtype, shape, contiguity and alignment, allocates
the output, launches on `torch.cuda.current_stream()` without
synchronising, raises when the C entry point reports a CUDA error, and adds
one to its entry in `build.LAUNCHES` for each launch. The plain versions
live beside their dispatch: W4A16 in `moondream_tpu_torch.ops.quant`, w8a8
in `moondream_tpu_torch.ops.layers`.

The kernel splits K across the blocks of a thread-block cluster and merges
the splits inside the launch: `plan_w4a16_splits` (pure Python, no card
needed) chooses the split from (K, N, group length, SMs), never from M, and
the wrapper passes it. The merge lives in the cluster's shared memory, so
there is no workspace to share between streams.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Optional, Tuple

import torch

from .build import LAUNCHES, load_cuda_library

W4A16 = "w4a16_matmul"
W8A8 = "w8a8_matmul"
LAUNCHES.update({W4A16: 0, W8A8: 0})

# The kernel's tiles: 64 output columns per block for M tiles of up to 16
# rows (N must be a multiple of 32: the last tile may be half full), 8 warps
# along the block's split, each taking every 8th chunk of 32 byte rows (the
# group length must be a multiple of a chunk).
N_ALIGN = 32
TILE_N = 64
STAGE_ROWS = 32
WARP_ROWS = 8
# The split plan: a split is a whole number of group pairs (glen byte rows,
# which feed one group through the high nibbles and one through the low),
# of at least MIN_SPLIT_ROWS rows (two chunks for every warp) where K
# allows, and at most MAX_SPLITS: clusters of 8 blocks measured slower
# than 4 on the H100 (PERF.md). The most splits that keep one wave of
# BLOCKS_PER_SM blocks per SM.
MAX_SPLITS = 4
MIN_SPLIT_ROWS = 2 * STAGE_ROWS * WARP_ROWS
BLOCKS_PER_SM = 2
H100_SMS = 132


@lru_cache(maxsize=None)
def plan_w4a16_splits(k: int, n: int, glen: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(n_split, split_rows) for a W4A16 launch over a (K/2, N) packed
    weight with groups of `glen` rows. Split i covers byte rows [i *
    split_rows, (i + 1) * split_rows): together they cover [0, K/2) once,
    each a whole number of group pairs. n_split is the largest divisor of
    the K / (2 * glen) group pairs, at most MAX_SPLITS, whose splits keep at
    least min(MIN_SPLIT_ROWS, K/2) rows and whose ceil(N / 64) * n_split
    blocks fit in one wave of BLOCKS_PER_SM per SM; 1 when none does. M
    plays no part: every row of x is summed in the same order whatever M
    is."""
    if k <= 0 or n <= 0 or glen <= 0 or k % (2 * glen):
        raise ValueError(f"plan_w4a16_splits: K {k}, N {n}, glen {glen}")
    pairs, rows = k // (2 * glen), k // 2
    tiles = -(-n // TILE_N)
    fits = [d for d in range(1, min(MAX_SPLITS, pairs) + 1)
            if pairs % d == 0 and rows // d >= min(MIN_SPLIT_ROWS, rows)
            and tiles * d <= BLOCKS_PER_SM * sms]
    n_split = max(fits, default=1)
    return n_split, rows // n_split


_SMS: Dict[torch.device, int] = {}


def _lib() -> ctypes.CDLL:
    lib = load_cuda_library(W4A16, ["w4a16_matmul.cu"])
    fn = lib.w4a16_matmul_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _w8a8_lib() -> ctypes.CDLL:
    lib = load_cuda_library(W8A8, ["w8a8_matmul.cu"])
    fn = lib.w8a8_matmul_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


LOADERS = (_lib, _w8a8_lib)


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
    glen = k // groups if k % groups == 0 else 0
    if not glen or k % (2 * glen) or glen % STAGE_ROWS or n % N_ALIGN or m == 0:
        raise ValueError(f"{W4A16}: M={m}, K={k}, N={n}, {groups} groups")
    for t in (x, packed, scale, zero):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{W4A16}: operands must be contiguous on {dev}, 16-byte aligned"
            )
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise ValueError(f"{W4A16}: scale and zero must be fp32")
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, _ = plan_w4a16_splits(k, n, glen, _SMS[dev])
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    rc = _lib().w4a16_matmul_bf16(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), m, k, n, glen, n_split,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{W4A16} launch failed: CUDA error {rc} ({torch.cuda.get_device_name(dev)})"
        )
    LAUNCHES[W4A16] += 1
    return out


# The w8a8 kernel reads the codes' rows in 64-byte chunks: Kp, the padded
# input dim of wq (N, Kp), is a multiple of this.
W8A8_K_ALIGN = 64


def w8a8_linear(
    x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
    b: Optional[torch.Tensor] = None, inv_a: Optional[torch.Tensor] = None,
    codes_out: Optional[torch.Tensor] = None, a_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (M, K) bf16 -> (M, N) bf16 through the w8a8 kernel, one launch:
    x's int8 codes (dynamic per row, or static with `inv_a` (Kp,) fp32),
    their int32 product with the codes wq (N, Kp) int8 on the tensor cores,
    and the epilogue with `scale` (N,) fp32 and the bias `b` (N,) bf16 or
    None, as `ops.layers.int8_linear_plain` computes them. `codes_out`
    (M, Kp) int8 and `a_out` (M,) fp32 (dynamic only), when given, receive
    the activation codes and row scales, for checks."""
    dev = x.device
    if dev.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"{W8A8}: x must be a 2-D CUDA bf16 tensor")
    m, k = x.shape
    if wq.dim() != 2 or wq.dtype != torch.int8:
        raise ValueError(f"{W8A8}: wq must be int8 (N, Kp)")
    n, kp = wq.shape
    if m == 0 or k == 0 or kp % W8A8_K_ALIGN or not k <= kp < k + W8A8_K_ALIGN:
        raise ValueError(f"{W8A8}: M={m}, K={k} do not fit wq {tuple(wq.shape)}")
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"{W8A8}: scale must be fp32 ({n},)")
    if b is not None and (b.dtype != torch.bfloat16 or b.shape != (n,)):
        raise ValueError(f"{W8A8}: b must be bf16 ({n},)")
    if inv_a is not None and (inv_a.dtype != torch.float32 or inv_a.shape != (kp,)):
        raise ValueError(f"{W8A8}: inv_a must be fp32 ({kp},)")
    if codes_out is not None and (codes_out.dtype != torch.int8 or codes_out.shape != (m, kp)):
        raise ValueError(f"{W8A8}: codes_out must be int8 ({m}, {kp})")
    if a_out is not None and (inv_a is not None or a_out.dtype != torch.float32
                              or a_out.shape != (m,)):
        raise ValueError(f"{W8A8}: a_out must be fp32 ({m},), dynamic codes only")
    aligned = (wq, scale, b, inv_a, codes_out, a_out)
    for t in (x, *aligned):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{W8A8}: operands must be contiguous on {dev}")
    if any(t is not None and t.data_ptr() % 16 for t in aligned) or x.data_ptr() % 2:
        raise ValueError(f"{W8A8}: wq, scale, b, inv_a and outputs must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _w8a8_lib().w8a8_matmul_bf16(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), ptr(b), ptr(inv_a), out.data_ptr(),
        ptr(codes_out), ptr(a_out), m, k, kp, n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"{W8A8} launch failed: CUDA error {rc} ({torch.cuda.get_device_name(dev)})"
        )
    LAUNCHES[W8A8] += 1
    return out
