"""int4 runtime weights of the port against the JAX package's.

On the CPU: the port's `quantize_weight` (numpy) equals the JAX package's
`quantize_weight` and (eager) `quantize_weight_jax` bit for bit, its torch
twin `quantize_weight_torch` the jitted `quantize_weight_jax` that JAX's
`quantize_text_params` runs, and the plain W4A16 product `quantized_matmul_plain` matches
`quantized_matmul(..., interpret=True)` (the group-dot Pallas kernel, and
the legacy full-dequant kernel under MOONDREAM_INT4_LEGACY=1) at
atol 2e-4, rtol 1e-3, the tolerance of tests/test_quant.py:64 (fp32 sums
in another order).

Tests marked `cuda` hold the W4A16 kernel against the plain version on the
card, and the w8a8 kernels (the quantize pass and the product kernels)
against their plain version (`ops.layers.int8_linear_plain`) bit for bit,
with the pass's activation codes and row scales;
on a machine without jax they run with
`python -m pytest --noconftest -m cuda tests/test_torch_quant.py`.
"""

import numpy as np
import pytest
import torch

from moondream_tpu_torch.ops.quant import (
    dequantize_weight,
    quantize_weight,
    quantize_weight_torch,
    quantized_matmul,
    quantized_matmul_plain,
)

ATOL, RTOL = 2e-4, 1e-3

# K in {64, 128} shrink the group to 32 and 64; a stacked (3, 256, 128)
SHAPES = [(64, 96), (128, 64), (512, 256), (2048, 64), (3, 256, 128)]


def _weight(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_weight_bit_identical_to_jax(shape):
    """numpy `quantize_weight` against JAX's and its eager
    `quantize_weight_jax`; the torch twin against the jitted
    `quantize_weight_jax` that JAX's `quantize_text_params` runs."""
    import jax
    import jax.numpy as jnp

    from moondream_tpu.ops import quant as jq

    w = _weight(sum(shape), shape)
    # a dequantized int4 checkpoint puts weights on the grid: ties
    w_grid = np.array(jq.dequantize_weight(jq.quantize_weight(w), jnp.float32))
    for x in (w, w_grid):
        ours = quantize_weight(x)
        ours_t = quantize_weight_torch(torch.from_numpy(x))
        refs = {
            "numpy": (ours, jq.quantize_weight(x)),
            "eager": (ours, jq.quantize_weight_jax(jnp.asarray(x))),
            "jit": ({k: v.numpy() for k, v in ours_t.items()},
                    jax.jit(jq.quantize_weight_jax)(jnp.asarray(x))),
        }
        for label, (got, ref) in refs.items():
            for name in ("packed", "scale", "zero"):
                want = np.asarray(ref[name])
                assert got[name].dtype == want.dtype, (label, name)
                np.testing.assert_array_equal(got[name], want, err_msg=f"{label} {name}")


def test_packing_puts_row_r_high_and_r_plus_half_low():
    w = np.zeros((256, 128), np.float32)
    w[3, 0], w[131, 0], w[200, 0] = 15.0, 7.0, 15.0
    b = int(quantize_weight_torch(torch.from_numpy(w))["packed"][3, 0])
    assert (b >> 4, b & 0x0F) == (15, 7)


def test_dequantize_matches_jax():
    import jax.numpy as jnp

    from moondream_tpu.ops import quant as jq

    qw = quantize_weight(_weight(1, (2, 512, 64)))
    want = np.asarray(jq.dequantize_weight(qw, jnp.float32))
    got = dequantize_weight({k: torch.from_numpy(v) for k, v in qw.items()}, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def _case(seed, m, k, n, layers=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.2).astype(np.float32)
    shape = (k, n) if layers is None else (layers, k, n)
    return x, quantize_weight(_weight(seed + 1, shape))


def _jax_matmul(x, qw, layer=None):
    import jax.numpy as jnp

    from moondream_tpu.ops.quant import quantized_matmul as jax_qmm

    jqw = {k: jnp.asarray(v) for k, v in qw.items()}
    lay = None if layer is None else jnp.int32(layer)
    return np.asarray(jax_qmm(jnp.asarray(x), jqw, layer=lay, interpret=True))


def _ours(x, qw, layer=None):
    t = {k: torch.from_numpy(v if layer is None else v[layer]) for k, v in qw.items()}
    return quantized_matmul(torch.from_numpy(x), t).numpy()


@pytest.mark.parametrize("m", [1, 8, 300])
def test_plain_matches_pallas(m):
    x, qw = _case(m, m, 512, 256)
    np.testing.assert_allclose(_ours(x, qw), _jax_matmul(x, qw), atol=ATOL, rtol=RTOL)


def test_plain_matches_pallas_stacked_layers():
    x, qw = _case(7, 4, 256, 128, layers=3)
    for layer in range(3):
        np.testing.assert_allclose(
            _ours(x, qw, layer), _jax_matmul(x, qw, layer), atol=ATOL, rtol=RTOL
        )


@pytest.mark.parametrize("m", [1, 8])
def test_w4a16_matches_legacy_kernel(m, monkeypatch):
    """`_q_matmul_kernel` (MOONDREAM_INT4_LEGACY, full dequant of the tile)
    computes the same product as the group-dot kernel: the port's W4A16
    function covers both."""
    monkeypatch.setenv("MOONDREAM_INT4_LEGACY", "1")
    x, qw = _case(20 + m, m, 512, 256)
    np.testing.assert_allclose(_ours(x, qw), _jax_matmul(x, qw), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ on the card
# bf16 x; the plain version runs in fp32 on the same values. Errors count
# relative to max|plain|: rounding the output to bf16 alone costs up to
# 2^-8 (3.9e-3) of it, so 1e-2, as for the attention kernels.
CUDA_REL_TOL = 1e-2
# (M, K, N): decode and the prompt span at the 2B and tiny widths, a
# 300-row span and an M that is not a multiple of the kernel's 8-row tile;
# the query span (16) and lockstep spans (64, 128) at 2B widths
CUDA_CASES = [(1, 2048, 6144), (8, 8192, 2048), (300, 512, 256), (13, 64, 192), (1, 128, 64),
              (16, 2048, 6144), (64, 2048, 8192), (128, 8192, 2048), (16, 2048, 2048)]
# (K, N) of the 2B text linears: qkv, proj, fc1, fc2
TWO_B = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", CUDA_CASES)
def test_w4a16_kernel_matches_plain(cuda, m, k, n):
    x, qw = _case(m + k, m, k, n)
    tq = {name: torch.from_numpy(v).to(cuda) for name, v in qw.items()}
    xb = torch.from_numpy(x).to(cuda, torch.bfloat16)
    got = quantized_matmul(xb, tq).float()
    want = quantized_matmul_plain(xb.float(), tq)
    assert ((got - want).abs().max() / want.abs().max()).item() < CUDA_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", TWO_B)
def test_w4a16_kernel_rows_do_not_depend_on_m(cuda, k, n):
    """A row's output bits depend only on that row of x and the weight: M 1
    and the rows of M 8 / 16 equal the first rows of M 64, bit for bit."""
    x, qw = _case(k + n, 64, k, n)
    tq = {name: torch.from_numpy(v).to(cuda) for name, v in qw.items()}
    xb = torch.from_numpy(x).to(cuda, torch.bfloat16)
    full = quantized_matmul(xb, tq)
    for m in (1, 8, 16):
        assert torch.equal(quantized_matmul(xb[:m].clone(), tq), full[:m]), m


@pytest.mark.cuda
def test_w4a16_kernel_reads_a_stacked_layer_view(cuda):
    x, qw = _case(5, 8, 256, 128, layers=3)
    tq = {name: torch.from_numpy(v).to(cuda) for name, v in qw.items()}
    xb = torch.from_numpy(x).to(cuda, torch.bfloat16)
    for layer in range(3):
        view = {name: t[layer] for name, t in tq.items()}
        got = quantized_matmul(xb, view).float()
        want = quantized_matmul_plain(xb.float(), view)
        assert ((got - want).abs().max() / want.abs().max()).item() < CUDA_REL_TOL


@pytest.mark.cuda
def test_quantize_weight_torch_same_bits_on_the_card(cuda):
    w = torch.from_numpy(_weight(3, (2048, 256)))
    cpu, card = quantize_weight_torch(w), quantize_weight_torch(w.to(cuda))
    for name in cpu:
        assert torch.equal(cpu[name], card[name].cpu()), name


@pytest.mark.cuda
def test_w4a16_kernel_refuses_fp32(cuda):
    x, qw = _case(0, 1, 128, 64)
    tq = {name: torch.from_numpy(v).to(cuda) for name, v in qw.items()}
    with pytest.raises(ValueError):
        quantized_matmul(torch.from_numpy(x).to(cuda), tq)


# (M, K, N, static): decode, lockstep and span rows over the 2B text linears,
# a 730-row prefill, K and N tails (the 0.5B ViT's 2690), the M 32 / 33 / 64
# / 65 edges between the two product kernels, a pool's verify rows (M 72)
# and M 200 (kernel L splitting K), and the ViT qkv's 13 crops (M 9984)
W8A8_CASES = [(1, 2048, 6144, False), (8, 8192, 2048, False), (16, 2048, 8192, False),
              (64, 2048, 2048, False), (65, 720, 2690, True), (730, 2048, 6144, False),
              (5, 2690, 720, True), (300, 1152, 3456, True), (3, 36, 24, False),
              (32, 2048, 2048, True), (33, 2048, 6144, False), (72, 2048, 6144, False),
              (200, 8192, 2048, True), (9984, 1152, 3456, True), (9984, 1152, 3456, False)]


def _w8a8_case(seed, m, k, n, static, device):
    from moondream_tpu_torch.ops.layers import pack_int8_weight

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, k // 3] *= 40.0  # an outlier channel
    wq = pack_int8_weight(torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)))
    scale = torch.from_numpy((rng.random(n) * 1e-3 + 1e-4).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    inv_a = None
    if static:
        inv_a = torch.zeros(wq.shape[1])
        inv_a[:k] = torch.from_numpy((rng.random(k) * 40 + 5).astype(np.float32))
    to = lambda t: None if t is None else t.to(device)
    return (torch.from_numpy(x).to(device, torch.bfloat16), to(wq), to(scale), to(b), to(inv_a))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,static", W8A8_CASES)
def test_w8a8_kernel_equals_plain_bit_for_bit(cuda, m, k, n, static):
    from moondream_tpu_torch.kernels.quant import w8a8_linear
    from moondream_tpu_torch.ops.layers import int8_linear_plain, q8_act, q8_static

    x, wq, scale, b, inv_a = _w8a8_case(m * k + n, m, k, n, static, cuda)
    codes = torch.empty(m, wq.shape[1], dtype=torch.int8, device=cuda)
    a = None if static else torch.empty(m, device=cuda)
    got = w8a8_linear(x, wq, scale, b, inv_a, codes, a)
    assert torch.equal(got.view(torch.int16),
                       int8_linear_plain(x, wq, scale, b, inv_a).view(torch.int16))
    if static:
        assert torch.equal(codes[:, :k], q8_static(x, inv_a[:k]))
    else:
        want_codes, want_a = q8_act(x)
        assert torch.equal(codes[:, :k], want_codes) and torch.equal(a, want_a[:, 0])
    assert not codes[:, k:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_w8a8_kernel_rows_do_not_depend_on_m(cuda, static):
    """A row's bits depend only on that row and the weight: rows of M 1, 8,
    16, 32, 64, 65, 72 and 200, through every route that takes them
    (kernel S up to M 32; kernel L at tile width 64 and 128, K split or
    not), equal the first rows of M 300."""
    from moondream_tpu_torch.kernels.quant import SMALL_MAX_M, plan_w8a8, w8a8_linear
    from moondream_tpu_torch.ops.layers import int8_linear

    x, wq, scale, b, inv_a = _w8a8_case(7, 300, 2048, 256, static, cuda)
    full = int8_linear(x, wq, scale, b, inv_a)
    for m in (1, 8, 16, 32, 64, 65, 72, 200):
        plans = {plan_w8a8(m, 2048, 256, route="large", bn=bn) for bn in (64, 128)}
        if m <= SMALL_MAX_M:
            plans.add(plan_w8a8(m, 2048, 256, route="small"))
        for plan in plans:
            got = w8a8_linear(x[:m].clone(), wq, scale, b, inv_a, plan=plan)
            assert torch.equal(got, full[:m]), (m, plan)


@pytest.mark.cuda
def test_int8_quantizers_same_bits_on_the_card(cuda):
    from moondream_tpu_torch.models.text import quantize_weight_int8
    from moondream_tpu_torch.models.vision import _quantize_vision_linear
    from moondream_tpu_torch.ops.layers import Linear

    w = torch.from_numpy(_weight(4, (1152, 256)))
    for cpu, card in zip(quantize_weight_int8(w), quantize_weight_int8(w.to(cuda))):
        assert torch.equal(cpu, card.cpu())
    amax = torch.from_numpy(np.random.default_rng(5).random(1152).astype(np.float32) * 9)
    lins = []
    for dev in ("cpu", cuda):
        lin = Linear(1152, 256, dev, torch.float32)
        with torch.no_grad():
            lin.w.copy_(w)
            lin.b.zero_()
        lins.append(_quantize_vision_linear(lin, amax.to(dev), 0.5))
    for name in ("wq", "scale", "inv_a"):
        assert torch.equal(getattr(lins[0], name), getattr(lins[1], name).cpu()), name


@pytest.mark.cuda
def test_w8a8_kernel_refuses_fp32(cuda):
    from moondream_tpu_torch.ops.layers import int8_linear

    x, wq, scale, b, _ = _w8a8_case(0, 4, 64, 32, False, cuda)
    with pytest.raises(ValueError):
        int8_linear(x.float(), wq, scale, b)
