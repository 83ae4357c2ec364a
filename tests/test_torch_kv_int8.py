"""int8 KV cache of the port against the JAX package's.

The JAX package stores codes in its head-paired layout, one fp32 scale per
token and cache row, where a row holds `kv_pair_factor` (2 for every
published config) adjacent heads. The port keeps the plain (L, B, H, T, D)
codes with scales (L, B, H/g, T) of the same granularity. Here, on the CPU:

  * `quantize_kv` gives JAX's codes and scales bit for bit on `pair_kv`
    rows, and `dequantize_kv` its values;
  * the plain int8 decode (`decode_attention_cached_plain` with scales)
    matches JAX `decode_attention_cached(..., interpret=True, k_scale=,
    v_scale=)` (the int8 branch of `_decode_kernel_paired`) for Tq 1 and
    Tq 8 over a garbage tail, fp32 inputs, atol 2e-5 (the same fp32 math
    summed in another order).

Tests marked `cuda` hold kernel B's int8 branch against the plain version
on the card (`python -m pytest --noconftest -m cuda tests/test_torch_kv_int8.py`
on a machine without jax).
"""

import numpy as np
import pytest
import torch

from moondream_tpu_torch.models.text import dequantize_kv, quantize_kv
from moondream_tpu_torch.ops.attention import (
    decode_attention_cached,
    decode_attention_cached_plain,
)

ATOL = 2e-5


def _x(seed, *shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("g", [1, 2])
def test_quantize_kv_bit_identical_to_jax(g):
    import jax.numpy as jnp

    from moondream_tpu.models import text as jt

    x = _x(g, 2, 4, 16, 32)
    jc, js = jt.quantize_kv(jt.pair_kv(jnp.asarray(x), g))
    codes, scale = quantize_kv(torch.from_numpy(x), g)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jt.unpair_kv(jc, g)))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js)[..., 0])
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jt.unpair_kv(jt.dequantize_kv(jc, js, jdt), g)
        got = dequantize_kv(codes, scale, dt)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32))
        )


def _int8_cache(seed, L, b, h, t, d, garbage_from, g=2):
    """Codes and scales (L, B, H, T, D) / (L, B, H/g, T) from seeded normals;
    past `garbage_from`, random codes with scales x1000."""
    out = []
    for i in range(2):
        x = torch.from_numpy(_x(seed + i, L * b, h, t, d))
        codes, scale = quantize_kv(x, g)
        codes = codes.reshape(L, b, h, t, d)
        scale = scale.reshape(L, b, h // g, t)
        tail = codes[..., garbage_from:, :].shape
        codes[..., garbage_from:, :] = torch.from_numpy(
            np.random.default_rng(seed - i).integers(-127, 128, tail, dtype=np.int8)
        )
        scale[..., garbage_from:] *= 1000
        out += [codes, scale]
    return out  # k codes, k scale, v codes, v scale


def _paired(codes, scale, g):
    """The JAX package's layout of the same cache: (L, B, H/g, T, g*D)
    codes and (L, B, H/g, 1, T) scales."""
    import jax.numpy as jnp

    from moondream_tpu.models.text import pair_kv

    L, b, h, t, d = codes.shape
    c = pair_kv(jnp.asarray(codes.numpy()).reshape(L * b, h, t, d), g)
    return c.reshape(L, b, h // g, t, g * d), jnp.asarray(scale.numpy())[:, :, :, None, :]


# (tq, layer, pos, prefix, kv_bound)
DECODE_CASES = [
    (1, 1, 200, 0, None),
    (1, 0, 735, 730, 1024),
    (8, 1, 730, 730, 768),
    (8, 1, 180, 0, 256),
]


@pytest.mark.parametrize("tq,layer,pos,prefix,kv_bound", DECODE_CASES)
def test_int8_decode_plain_matches_pallas(tq, layer, pos, prefix, kv_bound):
    import jax.numpy as jnp

    from moondream_tpu.ops.attention import decode_attention_cached as jax_dec

    L, b, h, t, d, g = 2, 1, 4, 1024, 32, 2
    kc, ks, vc, vs = _int8_cache(31, L, b, h, t, d, max(pos + tq, prefix), g)
    q = _x(32, b, h, tq, d)
    jkc, jks = _paired(kc, ks, g)
    jvc, jvs = _paired(vc, vs, g)
    want = np.asarray(jax_dec(
        jnp.asarray(q), jkc, jvc, layer, pos, prefix, kv_bound=kv_bound,
        interpret=True, k_scale=jks, v_scale=jvs,
    ))
    got = decode_attention_cached(
        torch.from_numpy(q), kc, vc, layer, pos, prefix, kv_bound, ks, vs
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_int8_decode_plain_ignores_garbage_tail():
    L, b, h, t, d, pos, tq = 2, 1, 4, 512, 32, 200, 8
    dirty = _int8_cache(33, L, b, h, t, d, pos + tq)
    clean = _int8_cache(33, L, b, h, t, d, t)
    q = torch.from_numpy(_x(34, b, h, tq, d))
    got = decode_attention_cached(q, dirty[0], dirty[2], 1, pos, 0, None, dirty[1], dirty[3])
    want = decode_attention_cached(q, clean[0], clean[2], 1, pos, 0, None, clean[1], clean[3])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ------------------------------------------------------------ on the card
CUDA_REL_TOL = 1e-2  # of max|plain|, as for the bf16 decode kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("diagonal", [False, True])
@pytest.mark.parametrize("tq,layer,pos,prefix,kv_bound", DECODE_CASES)
def test_int8_decode_kernel_matches_plain(cuda, tq, layer, pos, prefix, kv_bound, diagonal):
    """With `diagonal`, row i's query is the dequantized key at pos + i
    scaled up, so that column carries most of the row's weight: dropping it
    or letting in the garbage after it moves the output by ~max|plain|."""
    L, b, h, t, d = 2, 1, 4, 1024, 64
    cache = [c.to(cuda) for c in _int8_cache(35, L, b, h, t, d, max(pos + tq, prefix))]
    kc, ks, vc, vs = cache
    if diagonal:
        q = dequantize_kv(kc[layer, :, :, pos:pos + tq], ks[layer, :, :, pos:pos + tq],
                          torch.bfloat16) * 10
    else:
        q = torch.from_numpy(_x(36, b, h, tq, d, scale=0.5)).to(cuda, torch.bfloat16)
    got = decode_attention_cached(q, kc, vc, layer, pos, prefix, kv_bound, ks, vs)
    want = decode_attention_cached_plain(q.float(), kc, vc, layer, pos, prefix, kv_bound, ks, vs)
    assert ((got.float() - want).abs().max() / want.abs().max()).item() < CUDA_REL_TOL


@pytest.mark.cuda
def test_int8_decode_kernel_refuses_a_bf16_cache_with_scales(cuda):
    q = torch.zeros(1, 4, 1, 64, device=cuda, dtype=torch.bfloat16)
    cache = torch.zeros(1, 1, 4, 128, 64, device=cuda, dtype=torch.bfloat16)
    scale = torch.ones(1, 1, 2, 128, device=cuda)
    with pytest.raises(ValueError):
        decode_attention_cached(q, cache, cache, 0, 0, 0, None, scale, scale)
