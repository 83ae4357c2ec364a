"""The w8a8 kernels' plan and the quantize pass's plain version, on the CPU.

Every w8a8 call runs the quantize pass (each row of x quantized once) and
then one product kernel of `csrc/w8a8_matmul.cu`: kernel S (M <= 32,
mma.sync over column tiles of 16 or 32, K split over a cluster of up to 4
blocks) or kernel L (M > 32, int8 wgmma over 128 x 64 or 128 x 128 tiles,
K split over a cluster of up to 8 blocks). `plan_w8a8` chooses the route,
tile and split on the host from (M, K, N, SMs). Here its plans are checked
to cover every output tile once and Kp once in 64-byte chunks, to fit the
H100's shared memory, to take the tile widths and splits its rule names
(every SM busy at the 2B's text and ViT shapes from the image prefill's M
730 up), and to route each M as the source's header says.
`emulate_w8a8` sums each plan's K splits in int64 (test-only) and must give
`int8_linear_plain`'s bits, whatever the plan: the int32 sum is exact, so a
row's bits depend neither on M nor on the route. `q8_codes_plain`, the
pass's plain version, equals the JITTED JAX package's codes: `_q8_act`
(moondream_tpu/ops/layers.py:30-35) and the static branch of `linear`
(:56-59), the latter read through `linear` with an identity weight.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_w8a8_plan.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.ops import layers as jax_layers
from moondream_tpu_torch.kernels.quant import (
    H100_SMS,
    LARGE_BK,
    LARGE_BLOCKS_PER_SM,
    LARGE_BM,
    LARGE_BNS,
    LARGE_MAX_SPLITS,
    LARGE_MIN_SPLIT_STAGES,
    LARGE_RING,
    SMALL_MAX_CLUSTER,
    SMALL_MAX_M,
    SMALL_WARPS,
    W8A8_K_ALIGN,
    large_smem,
    plan_w8a8,
    w8a8_route,
)
from moondream_tpu_torch.ops.layers import (
    int8_linear_fp64,
    int8_linear_plain,
    pack_int8_weight,
    q8_codes_plain,
)

_jit_q8 = jax.jit(jax_layers._q8_act)
_jit_linear = jax.jit(jax_layers.linear)

# (K, N) of the 2B's text linears (qkv, proj, fc1, fc2, the GQA qkv) and ViT
# linears (qkv, proj, fc1, fc2), and the 0.5B ViT's MLP (K or N 2690)
TEXT = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048), (2048, 3072)]
VIT = [(1152, 3456), (1152, 1152), (1152, 4304), (4304, 1152)]
VIT_05B = [(720, 2690), (2690, 720)]
# the H100's shared memory: per SM, and what the runtime keeps per block
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
SMEM_PER_BLOCK = 227 * 1024
SOURCE = Path(__file__).resolve().parents[1] / "moondream_tpu_torch" / "csrc" / "w8a8_matmul.cu"


def _kp(k):
    return -(-k // W8A8_K_ALIGN) * W8A8_K_ALIGN


def _chunks_of_each_block(plan, kp):
    """The 64-byte K chunks each block (split or cluster member) of a plan
    reads, for one output tile."""
    chunks = kp // W8A8_K_ALIGN
    if plan.route == "small":  # warp w of block r takes chunks r*8 + w, then every cs*8th
        step = plan.cs * SMALL_WARPS
        return [[c for w in range(SMALL_WARPS) for c in range(r * SMALL_WARPS + w, chunks, step)]
                for r in range(plan.cs)]
    per = plan.split_stages * LARGE_BK // W8A8_K_ALIGN
    return [list(range(z * per, min((z + 1) * per, chunks))) for z in range(plan.splits)]


def _tiles(plan, m, n):
    """The (rows, columns) of each output tile of a plan."""
    if plan.route == "small":
        bn = 16 * plan.fn
        return [(range(m), range(x * bn, min((x + 1) * bn, n))) for x in range(-(-n // bn))]
    return [(range(y * LARGE_BM, min((y + 1) * LARGE_BM, m)),
             range(x * plan.bn, min((x + 1) * plan.bn, n)))
            for y in range(-(-m // LARGE_BM)) for x in range(-(-n // plan.bn))]


def _blocks(plan, m, n):
    if plan.route == "small":
        return -(-n // (16 * plan.fn)) * plan.cs
    return -(-m // LARGE_BM) * -(-n // plan.bn) * plan.splits


SHAPES = TEXT + VIT + VIT_05B + [(36, 24), (100, 40), (64, 64)]
MS = [1, 5, 8, 9, 15, 16, 17, 32, 33, 64, 65, 72, 200, 730, 1536]


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("k,n", SHAPES)
def test_plan_covers_every_tile_and_chunk_once(k, n):
    for m in MS:
        plan = plan_w8a8(m, k, n)
        seen = np.zeros((m, n), np.int64)
        for rows, cols in _tiles(plan, m, n):
            seen[np.ix_(list(rows), list(cols))] += 1
        assert (seen == 1).all(), (m, plan)
        blocks = _chunks_of_each_block(plan, _kp(k))
        assert sorted(c for b in blocks for c in b) == list(range(_kp(k) // W8A8_K_ALIGN)), plan
        assert all(blocks), plan  # no block of a split is empty
        if plan.route == "small":
            assert m <= 8 * plan.fm and plan.fm in (1, 2, 4) and plan.fn in (1, 2)
            assert plan.cs in (1, 2, 4) and (plan.cs == 1 or plan.fn == 1)
            assert plan.cs <= SMALL_MAX_CLUSTER
        else:
            assert plan.bn in LARGE_BNS and 1 <= plan.splits <= LARGE_MAX_SPLITS
            stages = -(-_kp(k) // LARGE_BK)
            assert (plan.splits - 1) * plan.split_stages < stages <= plan.splits * plan.split_stages


@pytest.mark.parametrize("bn", LARGE_BNS)
def test_kernel_l_fits_the_shared_memory(bn):
    """A block within 227 KB, and two blocks on one SM's 228 KB."""
    assert large_smem(bn) <= SMEM_PER_BLOCK
    assert LARGE_BLOCKS_PER_SM * (large_smem(bn) + SMEM_RESERVED_PER_BLOCK) <= SMEM_PER_SM
    # the staged bf16 output tile and the split partials reuse the ring
    ring = LARGE_RING // ((LARGE_BM + bn) * LARGE_BK) * (LARGE_BM + bn) * LARGE_BK
    assert LARGE_BM * (bn + 8) * 2 <= ring and bn // 2 * 4 * 256 <= ring


@pytest.mark.parametrize("m", [33, 65, 72, 200, 730, 5840, 9984])
def test_kernel_l_tiles_and_splits(m):
    """128-column tiles where they give a wave of two blocks per SM, else
    64-column ones. K is split only while the tiles leave SMs idle, into at
    most as many parts as keep one block per SM and LARGE_MIN_SPLIT_STAGES
    stages in each. Every SM gets a block at the 2B's text linears from the
    image prefill's M 730 up and at its ViT's from 8 crops up."""
    slots = LARGE_BLOCKS_PER_SM * H100_SMS
    for k, n in TEXT + VIT:
        plan = plan_w8a8(m, k, n)
        tiles = -(-m // LARGE_BM) * -(-n // plan.bn)
        stages = -(-_kp(k) // LARGE_BK)
        assert plan.route == "large" and plan.bn == (128 if -(-m // LARGE_BM) * -(-n // 128)
                                                     >= slots else 64), (m, k, n, plan)
        if plan.splits > 1:
            assert tiles * plan.splits <= H100_SMS, (m, k, n, plan)
            assert plan.split_stages >= LARGE_MIN_SPLIT_STAGES, (m, k, n, plan)
        else:
            assert tiles >= H100_SMS or stages < 2 * LARGE_MIN_SPLIT_STAGES \
                or 2 * tiles > H100_SMS, (m, k, n, plan)
        if m >= 730 and ((k, n) in TEXT or m >= 13 * 768 // 2):
            assert _blocks(plan, m, n) >= H100_SMS, (m, k, n, plan)


def test_plan_at_the_2b_shapes():
    """The image prefill's qkv and fc1 and the ViT take 128-column tiles;
    the prefill's proj and fc2 64-column tiles; a pool's verify rows (M 72)
    split K only where N is narrow."""
    assert plan_w8a8(730, 2048, 6144)[4:] == (128, 1, 16)
    assert plan_w8a8(730, 2048, 2048)[4:] == (64, 1, 16)
    assert plan_w8a8(9984, 1152, 3456)[4:] == (128, 1, 9)
    assert plan_w8a8(72, 2048, 6144)[4:] == (64, 1, 16)
    assert plan_w8a8(72, 2048, 2048)[4:] == (64, 2, 8)
    assert plan_w8a8(72, 8192, 2048)[4:] == (64, 4, 16)
    assert plan_w8a8(1, 2048, 6144)[:4] == ("small", 1, 2, 1)
    assert plan_w8a8(16, 8192, 2048)[:4] == ("small", 2, 1, 2)


def test_routes_by_m_as_the_source_says():
    header = SOURCE.read_text().split("#include")[0]
    assert f"(`w8a8_small`, M <= {SMALL_MAX_M})" in header
    assert f"(`w8a8_large`, M > {SMALL_MAX_M})" in header
    assert re.search(rf"constexpr int S_MAX_M = {SMALL_MAX_M};", SOURCE.read_text())
    for m in MS:
        assert w8a8_route(m) == ("small" if m <= SMALL_MAX_M else "large")
        assert plan_w8a8(m, 2048, 2048).route == w8a8_route(m)


@pytest.mark.parametrize("args", [(0, 64, 64), (4, 0, 64), (4, 64, 0)])
def test_plan_refuses_empty_shapes(args):
    with pytest.raises(ValueError):
        plan_w8a8(*args)


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        plan_w8a8(SMALL_MAX_M + 1, 64, 64, route="small")
    with pytest.raises(ValueError):
        plan_w8a8(100, 64, 64, route="large", bn=256)
    with pytest.raises(ValueError):
        plan_w8a8(8, 64, 64, route="inline")


# ------------------------------------------------------------ the sums
def emulate_w8a8(x, wq, scale, b, inv_a, plan):
    """The kernels' arithmetic in a plan's order (test-only): the pass's
    codes, then per output tile each block's int64 partial over its
    64-byte K chunks, the partials summed, and the plain version's
    epilogue. x (M, K) fp32 -> (M, N) x.dtype."""
    m, k = x.shape
    n, kp = wq.shape
    codes, a = q8_codes_plain(x, inv_a, kp)
    acc = torch.zeros(m, n, dtype=torch.int64)
    for rows, cols in _tiles(plan, m, n):
        r, c = list(rows), list(cols)
        for chunks in _chunks_of_each_block(plan, kp):
            ks = [kk for ch in chunks for kk in range(ch * 64, ch * 64 + 64)]
            acc[np.ix_(r, c)] += codes[r][:, ks].long() @ wq[c][:, ks].long().t()
    accf = acc.float()  # rounded to nearest, as the kernels' __int2float_rn
    if inv_a is None:
        y = (accf * scale).double() * a.double()[:, None]
    else:
        y = accf.double() * scale.double()
    y = y if b is None else y + b.double()
    return y.float().to(x.dtype)


def _case(seed, m, k, n, static, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, k // 3] *= 40.0
    x[0] = np.arange(k) % 254 - 127 + 0.5  # a row of rounding ties
    x[0, 0] = 127.0
    wq = pack_int8_weight(torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)))
    scale = torch.from_numpy((rng.random(n) * 1e-3 + 1e-4).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) if bias else None
    inv_a = None
    if static:
        inv_a = torch.zeros(wq.shape[1])
        inv_a[:k] = torch.from_numpy((rng.random(k) * 30 + 1).astype(np.float32))
    return torch.from_numpy(x), wq, scale, b, inv_a


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("m,k,n", [(1, 2048, 64), (9, 2048, 96), (33, 1152, 200),
                                   (72, 8192, 64), (130, 100, 40), (5, 36, 24)])
def test_every_route_equals_plain(static, m, k, n):
    x, wq, scale, b, inv_a = _case(m * k + n, m, k, n, static)
    want = int8_linear_plain(x, wq, scale, b, inv_a)
    plans = [plan_w8a8(m, k, n), plan_w8a8(m, k, n, route="large", bn=64),
             plan_w8a8(m, k, n, route="large", bn=128)]
    if m <= SMALL_MAX_M:
        plans.append(plan_w8a8(m, k, n, route="small"))
    for plan in plans:
        got = emulate_w8a8(x, wq, scale, b, inv_a, plan)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), plan


def test_rows_do_not_depend_on_m_or_the_route():
    """Rows of M 1, 8, 16, 32, 65 and 72 (kernel S and kernel L, split or
    not) equal the same rows of M 200."""
    x, wq, scale, b, inv_a = _case(3, 200, 2048, 64, False)
    full = emulate_w8a8(x, wq, scale, b, inv_a, plan_w8a8(200, 2048, 64))
    for m in (1, 8, 16, 32, 65, 72):
        for plan in {plan_w8a8(m, 2048, 64), plan_w8a8(m, 2048, 64, route="large", bn=128)}:
            got = emulate_w8a8(x[:m], wq, scale, b, inv_a, plan)
            assert torch.equal(got, full[:m]), (m, plan)


def test_fp64_value_is_the_plain_value_before_rounding():
    x, wq, scale, b, inv_a = _case(4, 8, 100, 40, True)
    assert torch.equal(int8_linear_fp64(x, wq, scale, b, inv_a).float(),
                       int8_linear_plain(x, wq, scale, b, inv_a))


# ------------------------------------------------------------ the pass
def _act(seed, m, k):
    """N(0, 1) rows with an outlier channel, a zero row (the 1e-6 floor) and
    a row of half-integers whose codes sit on or a hair past ties."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[:, k // 3] *= 40.0
    x[-1] = 0.0
    x[0] = np.arange(k) % 254 - 127 + 0.5
    x[0, 0] = 127.0
    return x


@pytest.mark.parametrize("m,k", [(5, 36), (7, 100), (3, 2690), (16, 2048), (2, 1152)])
def test_dynamic_codes_equal_jitted_jax(m, k):
    x = _act(m + k, m, k)
    codes, a = q8_codes_plain(torch.from_numpy(x), None, _kp(k))
    want_codes, want_a = _jit_q8(jnp.asarray(x))
    assert codes.shape == (m, _kp(k)) and codes.dtype == torch.int8
    np.testing.assert_array_equal(codes[:, :k].numpy(), np.asarray(want_codes))
    assert not codes[:, k:].any()
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  np.asarray(want_a)[:, 0].view(np.int32))


@pytest.mark.parametrize("m,k", [(5, 36), (7, 100), (3, 2690)])
def test_static_codes_equal_jitted_jax(m, k):
    """JAX's static codes, read through the jitted `linear` with an identity
    weight and unit scales: y = float(codes), exact."""
    rng = np.random.default_rng(k)
    x = _act(m * k, m, k)
    inv_a = (rng.random((1, k)) * 30 + 1).astype(np.float32)
    inv_a[0, :4] = 1.0  # the tie row's half-integers exactly on ties
    w = {"wq": jnp.eye(k, dtype=jnp.int8), "scale": jnp.ones((1, k), jnp.float32),
         "inv_a": jnp.asarray(inv_a)}
    want = np.asarray(_jit_linear(jnp.asarray(x), w))
    pad = torch.zeros(_kp(k))
    pad[:k] = torch.from_numpy(inv_a[0])
    codes, a = q8_codes_plain(torch.from_numpy(x), pad, _kp(k))
    assert a is None and codes.shape == (m, _kp(k))
    np.testing.assert_array_equal(codes[:, :k].numpy().astype(np.float32), want)
    assert not codes[:, k:].any()
    assert np.abs(want).max() == 127.0  # the clip is reached
