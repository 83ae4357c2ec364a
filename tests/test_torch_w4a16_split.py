"""The W4A16 kernel's split-K plan and merge, on the CPU.

The CUDA W4A16 kernel (`csrc/w4a16_matmul.cu`) splits the packed weight's
byte rows across the blocks of a thread-block cluster, each split a whole
number of group pairs (byte row r feeds group r / glen through its high
nibble and group r / glen + G/2 through its low one), and merges the
splits' fp32 partials in split order inside the launch. `plan_w4a16_splits`
chooses the split on the host from (K, N, glen, SMs); here its splits are
checked to cover the rows once, in whole group pairs, within the cluster
size, at the 2B text linears, the tiny config's K 64 / 128 and a stacked
layer view. `emulate_w4a16` below repeats the kernel's arithmetic in fp32
(test-only), in its order: per 32-row chunk (8 warps take every 8th),
16-row tensor-core steps into a fresh accumulator per nibble for the
product and for the chunk's sum of x, each scaled into the warp's sum with
a fused multiply-add (scale, then zero point); the warps summed in order,
then the splits. It must equal the plain version
`quantized_matmul_plain` (the same math summed in another order) and the
JAX package's `quantized_matmul(..., interpret=True)` at the tolerance of
tests/test_torch_quant.py, and a row's bits must not depend on M.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_w4a16_split.py -q
"""

import numpy as np
import pytest
import torch

from moondream_tpu_torch.kernels.quant import (
    BLOCKS_PER_SM,
    MAX_SPLITS,
    MIN_SPLIT_ROWS,
    STAGE_ROWS,
    TILE_N,
    WARP_ROWS,
    plan_w4a16_splits,
)
from moondream_tpu_torch.ops.quant import group_size, quantize_weight, quantized_matmul_plain

# the same math as the plain version in another order, fp32
ATOL = 2e-5
# against the Pallas kernel in interpret mode: tests/test_torch_quant.py:29
JAX_ATOL, JAX_RTOL = 2e-4, 1e-3

# (K, N) of the 2B text linears: qkv, proj, fc1, fc2
TWO_B = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)]
# the tiny config's widths (K 64 -> glen 32, K 128 -> glen 64)
TINY = [(64, 64), (64, 128), (64, 192), (128, 64), (128, 128)]


def split_rows(k, n_split, rows):
    """The [start, end) byte rows of each split of a plan."""
    return [(i * rows, (i + 1) * rows) for i in range(n_split)]


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("k,n", TWO_B + TINY + [(512, 256), (8192, 64), (16384, 64)])
@pytest.mark.parametrize("sms", [132, 16])
def test_plan_covers_the_rows_once_in_group_pairs(k, n, sms):
    glen = group_size(k)
    n_split, rows = plan_w4a16_splits(k, n, glen, sms)
    ranges = split_rows(k, n_split, rows)
    assert [r for a, b in ranges for r in range(a, b)] == list(range(k // 2))
    assert 1 <= n_split <= MAX_SPLITS and rows % glen == 0
    pairs = k // (2 * glen)
    assert pairs % n_split == 0
    # the most splits (divisors of the group pairs) that keep a chunk for
    # every warp and one wave of blocks; 1 when none does
    tiles = -(-n // TILE_N)
    ok = lambda d: (pairs % d == 0 and k // 2 // d >= min(MIN_SPLIT_ROWS, k // 2)
                    and tiles * d <= BLOCKS_PER_SM * sms)
    if n_split > 1:
        assert ok(n_split)
    assert not any(ok(d) for d in range(n_split + 1, MAX_SPLITS + 1))


def test_plan_at_the_2b_linears():
    """One wave of two blocks per SM on the H100's 132 SMs, a chunk for
    every warp."""
    plans = {(k, n): plan_w4a16_splits(k, n, 128) for k, n in TWO_B}
    assert plans == {(2048, 6144): (2, 512), (2048, 2048): (2, 512),
                     (2048, 8192): (2, 512), (8192, 2048): (4, 1024)}
    for (k, n), (n_split, rows) in plans.items():
        assert n // TILE_N * n_split <= BLOCKS_PER_SM * 132 and rows >= MIN_SPLIT_ROWS


def test_plan_of_a_stacked_layer_view_is_the_layer_plan():
    """A (L, K/2, N) stacked weight is read one layer at a time: the plan
    of layer l's view is that of its (K/2, N) shape."""
    qw = quantize_weight(np.zeros((3, 2048, 6144), np.float32))
    layer = {name: t[1] for name, t in qw.items()}
    k, n = 2 * layer["packed"].shape[0], layer["packed"].shape[1]
    assert plan_w4a16_splits(k, n, k // layer["scale"].shape[0]) == (2, 512)


@pytest.mark.parametrize("k,n,glen", [(0, 64, 32), (96, 64, 32), (64, 64, 0)])
def test_plan_refuses_what_does_not_split(k, n, glen):
    with pytest.raises(ValueError):
        plan_w4a16_splits(k, n, glen)


# ------------------------------------------------------------ the merge
def _fma(a, b, c):
    """fp32 fused multiply-add: the product is exact in fp64."""
    return (a.double() * b.double() + c.double()).float()


def emulate_w4a16(x, qw, sms=132):
    """The kernel's split-and-merge in fp32: x (M, K) fp32 values, qw the
    packed (K/2, N) weight with (G, N) scale and zero -> (M, N) fp32 before
    the bf16 rounding. Elementwise only, so a row never meets another.

    In each split, warp w takes the 32-row chunks w, w + 8, ...; per chunk
    and nibble, two 16-row tensor-core steps from zero give the product and
    (with A all ones) the chunk's sum of x, then the warp's sum takes one
    fma with the group's scale and one with its zero point. The warps' sums
    are added in order, then the splits'."""
    packed, scale, zero = qw["packed"], qw["scale"], qw["zero"]
    m, k = x.shape
    half, n = packed.shape
    groups = scale.shape[0]
    glen = k // groups
    n_split, rows = plan_w4a16_splits(k, n, glen, sms)
    codes = {"hi": (packed >> 4).float(), "lo": (packed & 0x0F).float()}
    xs = {"hi": x[:, :half], "lo": x[:, half:]}
    goff = {"hi": 0, "lo": groups // 2}

    def two_steps(c0, term):
        total = torch.zeros(m, n)
        for s0 in (c0, c0 + 16):  # one tensor-core step each
            step = torch.zeros(m, n)
            for r in range(s0, s0 + 16):
                step = step + term(r)
            total = total + step
        return total

    partials = []
    for r0, r1 in split_rows(k, n_split, rows):
        acc = None
        for w in range(WARP_ROWS):
            wacc = torch.zeros(m, n)
            for c0 in range(r0 + w * STAGE_ROWS, r1, WARP_ROWS * STAGE_ROWS):
                for nib in ("hi", "lo"):
                    part = two_steps(c0, lambda r: xs[nib][:, r, None] * codes[nib][r])
                    xsum = two_steps(c0, lambda r: xs[nib][:, r, None].expand(m, n))
                    g = c0 // glen + goff[nib]
                    wacc = _fma(part, scale[g], wacc)
                    wacc = _fma(xsum, zero[g].expand(m, n), wacc)
            acc = wacc if acc is None else acc + wacc
        partials.append(acc)
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    return out


def _case(seed, m, k, n, layers=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.2).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float()  # the kernel's bf16 x
    shape = (k, n) if layers is None else (layers, k, n)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return x, {name: torch.from_numpy(v) for name, v in quantize_weight(w).items()}


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (8, 64, 192), (13, 128, 128),
                                   (1, 2048, 64), (8, 2048, 64), (16, 8192, 64)])
def test_split_merge_equals_plain(m, k, n):
    x, qw = _case(m + k + n, m, k, n)
    torch.testing.assert_close(emulate_w4a16(x, qw), quantized_matmul_plain(x, qw),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("layer", [0, 2])
def test_split_merge_equals_plain_on_a_stacked_layer_view(layer):
    x, qw = _case(5, 8, 1024, 64, layers=3)
    view = {name: t[layer] for name, t in qw.items()}
    torch.testing.assert_close(emulate_w4a16(x, view), quantized_matmul_plain(x, view),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (8, 512, 256), (4, 2048, 128)])
def test_split_merge_equals_jax(m, k, n):
    import jax.numpy as jnp

    from moondream_tpu.ops.quant import quantized_matmul as jax_qmm

    x, qw = _case(30 + m, m, k, n)
    want = np.asarray(jax_qmm(jnp.asarray(x.numpy()),
                              {name: jnp.asarray(t.numpy()) for name, t in qw.items()},
                              interpret=True))
    np.testing.assert_allclose(emulate_w4a16(x, qw).numpy(), want,
                               atol=JAX_ATOL, rtol=JAX_RTOL)


@pytest.mark.parametrize("k", [128, 2048])
def test_row_bits_do_not_depend_on_m(k):
    """Row 0 of M 8 / 16 / 64 equals M 1 bit for bit, as does every row of
    M 64 against its own M 1 product."""
    x, qw = _case(k, 64, k, 64)
    alone = emulate_w4a16(x[:1], qw)
    for m in (8, 16, 64):
        assert torch.equal(emulate_w4a16(x[:m], qw)[:1], alone)
    full = emulate_w4a16(x, qw)
    for row in (7, 31, 63):
        assert torch.equal(full[row:row + 1], emulate_w4a16(x[row:row + 1], qw))
