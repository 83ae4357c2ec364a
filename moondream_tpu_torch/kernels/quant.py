"""ctypes bindings of the W4A16 kernel in `csrc/w4a16_matmul.cu` and of the
w8a8 kernels in `csrc/w8a8_matmul.cu` (the int8 weight formats' activation
quantize pass, int8 tensor-core products and epilogue).

Each wrapper checks device, dtype, shape, contiguity and alignment, allocates
the output, launches on `torch.cuda.current_stream()` without
synchronising, raises when the C entry point reports a CUDA error, and adds
one to its entry in `build.LAUNCHES` for each launch. The plain versions
live beside their dispatch: W4A16 in `moondream_tpu_torch.ops.quant`, w8a8
in `moondream_tpu_torch.ops.layers`.

The W4A16 kernel splits K across the blocks of a thread-block cluster and
merges the splits inside the launch: `plan_w4a16_splits` (pure Python, no
card needed) chooses the split from (K, N, group length, SMs), never from
M, and the wrapper passes it. The merge lives in the cluster's shared
memory, so there is no workspace to share between streams. The w8a8
kernels take their route, tile and split from `plan_w8a8` (pure Python
too), and the SM count is read once per device.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .build import LAUNCHES, load_cuda_library

W4A16 = "w4a16_matmul"
W8A8 = "w8a8_matmul"
W8A8_QUANTIZE = "w8a8_quantize"
LAUNCHES.update({W4A16: 0, W8A8: 0, W8A8_QUANTIZE: 0})

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


def _sms(dev: torch.device) -> int:
    """The card's SM count, read once per device."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _lib() -> ctypes.CDLL:
    lib = load_cuda_library(W4A16, ["w4a16_matmul.cu"])
    fn = lib.w4a16_matmul_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _w8a8_lib() -> ctypes.CDLL:
    lib = load_cuda_library(W8A8, ["w8a8_matmul.cu"])
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("w8a8_quantize_bf16", [ptr] * 4 + [i] * 3 + [ptr]),
                       ("w8a8_small_bf16", [ptr] * 6 + [i] * 7 + [ptr]),
                       ("w8a8_large_bf16", [ptr] * 6 + [i] * 8 + [ptr])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype = i
            fn.argtypes = args
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
    n_split, _ = plan_w4a16_splits(k, n, glen, _sms(dev))
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


# The w8a8 kernels read the codes' rows in 64-byte chunks: Kp, the padded
# input dim of wq (N, Kp), is a multiple of this.
W8A8_K_ALIGN = 64
# Every call runs the quantize pass, then one product kernel: route "small"
# (kernel S, M <= SMALL_MAX_M) or "large" (kernel L's int8 wgmma tiles).
# SMALL_MAX_M is chosen by measurement (PERF.md).
SMALL_MAX_M = 32
# kernel S: 8-row fragments (fm per block), 16-column fragments (fn),
# chunks in flight per warp by fm, warps per block, clusters of <= 4 blocks
SMALL_WARPS = 8
SMALL_MAX_CLUSTER = 4
SMALL_CHUNKS_IN_FLIGHT = {1: 4, 2: 2, 4: 1}
# kernel L: 128-row tiles of BN columns, K in 128-byte stages through a
# ring of LARGE_RING bytes, two blocks per SM, K split over clusters of at
# most LARGE_MAX_SPLITS blocks, each split at least LARGE_MIN_SPLIT_STAGES
# stages
LARGE_BM = 128
LARGE_BK = 128
LARGE_BNS = (128, 64)
LARGE_BLOCKS_PER_SM = 2
LARGE_MAX_SPLITS = 8
LARGE_MIN_SPLIT_STAGES = 8
LARGE_RING = 96 * 1024


class W8A8Plan(NamedTuple):
    """The product kernel's plan of a w8a8 call (the quantize pass takes no
    plan). Kernel S ("small"): `fm` 8-row fragments (M <= 8 fm), `fn`
    16-column fragments per block, `cs` blocks per cluster along K. Kernel
    L ("large"): tiles of 128 x `bn`, K split over `splits` blocks of
    `split_stages` 128-byte stages each (the last may hold fewer)."""

    route: str
    fm: int = 0
    fn: int = 0
    cs: int = 0
    bn: int = 0
    splits: int = 0
    split_stages: int = 0


def w8a8_route(m: int) -> str:
    """The product kernel a call of M rows takes."""
    return "small" if m <= SMALL_MAX_M else "large"


def large_smem(bn: int) -> int:
    """Kernel L's shared memory at tile width `bn`: the ring of whole
    stages within LARGE_RING, 1024 bytes of alignment slack, two mbarriers
    per stage and the epilogue's scale, bias and row-scale arrays."""
    stage = (LARGE_BM + bn) * LARGE_BK
    stages = LARGE_RING // stage
    return stages * stage + 1024 + 16 * stages + (2 * bn + LARGE_BM) * 4


@lru_cache(maxsize=None)
def plan_w8a8(m: int, k: int, n: int, sms: int = H100_SMS, route: Optional[str] = None,
              bn: Optional[int] = None) -> W8A8Plan:
    """The plan of a w8a8 call: x (M, K) against wq (N, Kp), Kp = K padded
    to 64. `route` and `bn` force a route or kernel L's tile width (for
    measurements and checks); by default w8a8_route(M) and the width below.

    Kernel S: fm = ceil(M / 8) rounded up to 1, 2 or 4; two 16-column
    fragments per block where N gives a wave of such blocks (N >= 32 SMs),
    else one, and then up to 4 blocks per tile along K, enough that each
    warp takes one round of chunks, while the blocks fit one per SM.

    Kernel L: where 128-column tiles give a wave of blocks (two per SM),
    those tiles: the products bound the call. Else 64-column tiles, the
    weight's bytes bound it. Where the tiles leave SMs idle, K is split
    into as many parts as keep the blocks within one per SM and at least
    LARGE_MIN_SPLIT_STAGES 128-byte stages in each (each ceil(stages /
    splits) of Kp's ceil(Kp / 128), none empty): more blocks measured
    slower, their cluster reductions costing more than they bring."""
    if m <= 0 or k <= 0 or n <= 0:
        raise ValueError(f"plan_w8a8: M {m}, K {k}, N {n}")
    route = route or w8a8_route(m)
    kp = -(-k // W8A8_K_ALIGN) * W8A8_K_ALIGN
    if route == "small":
        if m > SMALL_MAX_M:
            raise ValueError(f"plan_w8a8: kernel S does not take M {m}")
        fm = next(f for f in (1, 2, 4) if m <= 8 * f)
        wide = n >= 32 * sms
        tiles = -(-n // (32 if wide else 16))
        chunks = kp // W8A8_K_ALIGN
        rounds = -(-chunks // (SMALL_WARPS * SMALL_CHUNKS_IN_FLIGHT[fm]))
        cs = 1
        while not wide and cs < SMALL_MAX_CLUSTER and cs < rounds and tiles * cs <= sms:
            cs *= 2
        return W8A8Plan(route, fm=fm, fn=2 if wide else 1, cs=cs)
    if route != "large":
        raise ValueError(f"plan_w8a8: no route {route!r}")
    if bn is not None and bn not in LARGE_BNS:
        raise ValueError(f"plan_w8a8: tile width {bn}")
    stages = -(-kp // LARGE_BK)
    tiles = lambda w: -(-m // LARGE_BM) * -(-n // w)
    slots = LARGE_BLOCKS_PER_SM * sms
    w = bn or (LARGE_BNS[0] if tiles(LARGE_BNS[0]) >= slots else LARGE_BNS[-1])
    want = min(LARGE_MAX_SPLITS, max(1, sms // tiles(w)), max(1, stages // LARGE_MIN_SPLIT_STAGES))
    per = -(-stages // want)
    return W8A8Plan("large", bn=w, splits=-(-stages // per), split_stages=per)


def _check_rc(name: str, rc: int, dev: torch.device) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} ({torch.cuda.get_device_name(dev)})"
        )


def w8a8_quantize(
    x: torch.Tensor, inv_a: Optional[torch.Tensor], kp: int,
    codes_out: Optional[torch.Tensor] = None, a_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The quantize pass, one launch: x (M, K) bf16 -> (codes (M, Kp) int8,
    zero past K; a (M,) fp32, the dynamic row scales, or None when `inv_a`
    (Kp,) fp32 selects static codes), as `ops.layers.q8_codes_plain`
    computes them. `codes_out` / `a_out` receive them when given; else they
    are allocated (from the graph's pool under capture)."""
    dev = x.device
    if dev.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"{W8A8_QUANTIZE}: x must be a 2-D CUDA bf16 tensor")
    m, k = x.shape
    if m == 0 or k == 0 or kp % W8A8_K_ALIGN or not k <= kp < k + W8A8_K_ALIGN:
        raise ValueError(f"{W8A8_QUANTIZE}: M={m}, K={k} do not fit Kp={kp}")
    if inv_a is not None and (inv_a.dtype != torch.float32 or inv_a.shape != (kp,)):
        raise ValueError(f"{W8A8_QUANTIZE}: inv_a must be fp32 ({kp},)")
    if codes_out is not None and (codes_out.dtype != torch.int8 or codes_out.shape != (m, kp)):
        raise ValueError(f"{W8A8_QUANTIZE}: codes_out must be int8 ({m}, {kp})")
    if a_out is not None and (inv_a is not None or a_out.dtype != torch.float32
                              or a_out.shape != (m,)):
        raise ValueError(f"{W8A8_QUANTIZE}: a_out must be fp32 ({m},), dynamic codes only")
    for t in (x, inv_a, codes_out, a_out):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{W8A8_QUANTIZE}: operands must be contiguous on {dev}")
    if any(t is not None and t.data_ptr() % 16 for t in (inv_a, codes_out, a_out)) \
            or x.data_ptr() % 2:
        raise ValueError(f"{W8A8_QUANTIZE}: inv_a and the outputs must be 16-byte aligned")
    codes = codes_out if codes_out is not None else torch.empty(
        (m, kp), dtype=torch.int8, device=dev)
    a = None if inv_a is not None else a_out if a_out is not None else torch.empty(
        m, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    _check_rc(W8A8_QUANTIZE, _w8a8_lib().w8a8_quantize_bf16(
        x.data_ptr(), ptr(inv_a), codes.data_ptr(), ptr(a), m, k, kp,
        torch.cuda.current_stream(dev).cuda_stream), dev)
    LAUNCHES[W8A8_QUANTIZE] += 1
    return codes, a


def w8a8_linear(
    x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
    b: Optional[torch.Tensor] = None, inv_a: Optional[torch.Tensor] = None,
    codes_out: Optional[torch.Tensor] = None, a_out: Optional[torch.Tensor] = None,
    plan: Optional[W8A8Plan] = None,
) -> torch.Tensor:
    """x (M, K) bf16 -> (M, N) bf16 through the w8a8 kernels: x's int8 codes
    (dynamic per row, or static with `inv_a` (Kp,) fp32), their int32
    product with the codes wq (N, Kp) int8 on the tensor cores, and the
    epilogue with `scale` (N,) fp32 and the bias `b` (N,) bf16 or None, as
    `ops.layers.int8_linear_plain` computes them, in two launches: the
    quantize pass (`w8a8_quantize`, each row's codes once) and the product
    kernel of `plan` (by default `plan_w8a8`). `codes_out` (M, Kp) int8 and
    `a_out` (M,) fp32 (dynamic only), when given, receive the pass's codes
    and row scales, for checks."""
    dev = x.device
    if dev.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"{W8A8}: x must be a 2-D CUDA bf16 tensor")
    m, k = x.shape
    if wq.dim() != 2 or wq.dtype != torch.int8:
        raise ValueError(f"{W8A8}: wq must be int8 (N, Kp)")
    n, kp = wq.shape
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"{W8A8}: scale must be fp32 ({n},)")
    if b is not None and (b.dtype != torch.bfloat16 or b.shape != (n,)):
        raise ValueError(f"{W8A8}: b must be bf16 ({n},)")
    for t in (wq, scale, b):
        if t is not None and (t.device != dev or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{W8A8}: wq, scale and b must be contiguous on {dev}, "
                             "16-byte aligned")
    if plan is None:
        plan = plan_w8a8(m, k, n, _sms(dev))
    if plan.route not in ("small", "large"):
        raise ValueError(f"{W8A8}: no route {plan.route!r}")
    codes, a = w8a8_quantize(x, inv_a, kp, codes_out, a_out)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.route == "small":
        rc = _w8a8_lib().w8a8_small_bf16(
            codes.data_ptr(), ptr(a), wq.data_ptr(), scale.data_ptr(), ptr(b), out.data_ptr(),
            m, kp, n, inv_a is not None, plan.fm, plan.fn, plan.cs, stream)
    else:
        rc = _w8a8_lib().w8a8_large_bf16(
            codes.data_ptr(), ptr(a), wq.data_ptr(), scale.data_ptr(), ptr(b), out.data_ptr(),
            m, kp, n, inv_a is not None, plan.bn, plan.splits, plan.split_stages, dev.index,
            stream)
    _check_rc(W8A8, rc, dev)
    LAUNCHES[W8A8] += 1
    return out
