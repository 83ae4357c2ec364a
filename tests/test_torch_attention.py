"""Attention of the port against the JAX package's Pallas kernels.

On the CPU: the plain versions of kernel A (`flash_attention_plain`) and
kernel B (`decode_attention_cached_plain`) against `flash_attention` and
`decode_attention_cached` run with interpret=True, on the cases of
tests/test_attention_kernel.py, fp32 inputs, atol 2e-5 (the same fp32 math
summed in another order). The GQA plain versions are held to the JAX
package in tests/test_torch_gqa.py.

Kernel A's device form (a (B,) position tensor) is held on the CPU to
JAX's `flash_attention` under jax.jit at a traced position (Tq 8 and 24,
MHA and repeated GQA heads, atol 2e-5) and to its own int form.

Tests marked `cuda` hold the CUDA kernels (kernel B's GQA entries too)
against the plain versions on the card and skip without one; kernel A's
device form also bit for bit against its host form, and after a CUDA
graph's replay at a changed position. jax is imported inside the CPU tests only, so on
a machine without jax the card tests run with
`python -m pytest --noconftest -m cuda tests/test_torch_attention.py`.
"""

import numpy as np
import pytest
import torch

from moondream_tpu_torch.ops.attention import (
    decode_attention,
    decode_attention_cached,
    decode_attention_cached_plain,
    decode_attention_plain,
    flash_attention,
    flash_attention_plain,
)

ATOL = 2e-5


def _qkv(seed, b, h, tq, tk, d, scale=0.3):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return f(b, h, tq, d), f(b, h, tk, d), f(b, h, tk, d)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (seed, b, h, tq, tk, d, pos, prefix): tests/test_attention_kernel.py:30-126
FLASH_CASES = {
    "vit": (0, 2, 4, 729, 729, 72, 0, 729),
    "image_prefill": (1, 1, 2, 730, 768, 64, 0, 730),
    "prompt_after_image": (2, 1, 2, 16, 1024, 64, 730, 730),
    "prefix_inside_span": (3, 1, 3, 128, 128, 32, 5, 12),
    "pure_causal": (4, 1, 2, 256, 256, 64, 0, 0),
    "kvtiled_2048": (5, 1, 2, 2048, 2048, 64, 0, 730),
    "tiny_vit": (6, 3, 2, 768, 768, 16, 0, 729),  # tiny_test_config ViT
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(case):
    import jax.numpy as jnp

    from moondream_tpu.ops.attention import flash_attention as jax_flash

    seed, b, h, tq, tk, d, pos, prefix = FLASH_CASES[case]
    q, k, v = _qkv(seed, b, h, tq, tk, d)
    want = np.asarray(
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, prefix,
                  interpret=True)
    )
    got = flash_attention(*_t(q, k, v), pos, prefix).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# Kernel A's device form: a (B,) int32 position tensor, as the JAX package
# calls `flash_attention` at a traced position inside its decode loops
# (scalar prefetch). (tq, rep): a speculative verify span of 8 or 24 rows
# over Tk 256, MHA (rep 1) or KV heads repeated for GQA (rep 2), as
# attn_with_cache repeats them; prefix 100, so that the rows at position 0
# cross the prefix edge and those at Tk - Tq end on the diagonal.
DEVICE_POS_CASES = [(8, 1), (8, 2), (24, 1), (24, 2)]
DEVICE_POS_PREFIX = 100


def _span_qkv(seed, b, hkv, rep, tq, tk, d, scale=0.3):
    """q (b, hkv * rep, tq, d) and k/v (b, hkv, tk, d) with their heads
    repeated rep times (query head h reads KV head h // rep)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    q, k, v = f(b, hkv * rep, tq, d), f(b, hkv, tk, d), f(b, hkv, tk, d)
    return q, np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)


@pytest.fixture(scope="module")
def jax_flash_traced():
    """JAX's flash_attention in interpret mode under jax.jit with the
    position traced, compiled once per shape."""
    import jax

    from moondream_tpu.ops.attention import flash_attention as jax_flash

    return jax.jit(lambda q, k, v, pos: jax_flash(q, k, v, pos, DEVICE_POS_PREFIX,
                                                  interpret=True))


@pytest.mark.parametrize("tq,rep", DEVICE_POS_CASES,
                         ids=[f"tq{t}-{'mha' if r == 1 else 'gqa'}" for t, r in DEVICE_POS_CASES])
def test_flash_plain_device_position_matches_pallas(jax_flash_traced, tq, rep):
    """Kernel A's plain version at (B,) tensor positions 0 and Tk - Tq
    against JAX's flash_attention at a traced jnp.int32 position (atol
    ATOL), and equal to its int form bit for bit."""
    import jax.numpy as jnp

    b, tk = 2, 256
    q, k, v = _span_qkv(90 + tq + rep, b, 2, rep, tq, tk, 32)
    for pos in (0, tk - tq):
        want = np.asarray(jax_flash_traced(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.int32(pos)))
        got = flash_attention(*_t(q, k, v), torch.full((b,), pos, dtype=torch.int32),
                              DEVICE_POS_PREFIX)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        assert torch.equal(got, flash_attention(*_t(q, k, v), pos, DEVICE_POS_PREFIX))


def test_flash_plain_device_position_is_per_row():
    """Row b of a (B,) position tensor places batch row b's queries at
    pos[b] + i: each row equals the int form at its own position."""
    q, k, v = _t(*_span_qkv(97, 3, 2, 2, 8, 256, 32))
    pos = [0, 95, 248]
    got = flash_attention(q, k, v, torch.tensor(pos, dtype=torch.int32), DEVICE_POS_PREFIX)
    for r, p in enumerate(pos):
        want = flash_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1], p, DEVICE_POS_PREFIX)
        torch.testing.assert_close(got[r:r + 1], want, rtol=0, atol=1e-7)


def _cache(seed, L, b, h, t, d, pos, garbage_from):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((L, b, h, t, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((L, b, h, t, d)) * 0.3).astype(np.float32)
    k[:, :, :, garbage_from:] = 1e4
    v[:, :, :, garbage_from:] = -1e4
    return k, v


# (tq, layer, pos, prefix, kv_bound)
DECODE_CASES = [
    (1, 1, 97, 0, None),
    (1, 2, 735, 730, 1024),
    (8, 1, 730, 730, 768),
    (8, 2, 40, 100, 256),
]


@pytest.mark.parametrize("tq,layer,pos,prefix,kv_bound", DECODE_CASES)
def test_decode_plain_matches_pallas(tq, layer, pos, prefix, kv_bound):
    """Plain-layout (L, B, H, T, D) cache, layer > 0, a garbage tail past
    the span (+-1e4), optionally bounded reads."""
    import jax.numpy as jnp

    from moondream_tpu.ops.attention import decode_attention_cached as jax_dec

    L, b, h, t, d = 3, 1, 4, 1024, 64
    k, v = _cache(11, L, b, h, t, d, pos, max(pos + tq, prefix))
    q = (np.random.default_rng(12).standard_normal((b, h, tq, d)) * 0.3).astype(
        np.float32
    )
    want = np.asarray(
        jax_dec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer, pos,
                prefix, kv_bound=kv_bound, interpret=True)
    )
    got = decode_attention_cached(*_t(q, k, v), layer, pos, prefix, kv_bound)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_decode_plain_ignores_garbage_tail():
    L, b, h, t, d, pos, tq = 2, 1, 4, 512, 64, 200, 8
    dirty = _cache(13, L, b, h, t, d, pos, pos + tq)
    clean = _cache(13, L, b, h, t, d, pos, t)
    q = torch.from_numpy(
        (np.random.default_rng(14).standard_normal((b, h, tq, d)) * 0.3).astype(np.float32)
    )
    got = decode_attention_cached(q, *_t(*dirty), 1, pos, 0)
    want = decode_attention_cached(q, *_t(*clean), 1, pos, 0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ------------------------------------------------------------ on the card
# bf16 inputs; the plain version runs in fp32 on the same values. Errors
# count relative to the largest |plain| value: rounding the output to bf16
# alone costs up to 2^-8 (3.9e-3) of it, so 1e-2. chip_smoke.py prints the
# plain version's own error in bf16 beside each kernel's at the main path's
# shapes.
CUDA_REL_TOL = 1e-2


def _rel_err(got, want):
    return ((got.float() - want).abs().max() / want.abs().max()).item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(cuda, *arrays):
    return [torch.from_numpy(a).to(cuda, torch.bfloat16) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda, case):
    seed, b, h, tq, tk, d, pos, prefix = FLASH_CASES[case]
    q, k, v = _bf16(cuda, *_qkv(seed, b, h, tq, tk, d, scale=0.5))
    got = flash_attention(q, k, v, pos, prefix)
    want = flash_attention_plain(q.float(), k.float(), v.float(), pos, prefix)
    assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as head views of one fused (B, T, 3*H*D) projection."""
    b, t, h, d = 2, 200, 3, 72
    qkv = torch.randn(b, t, 3 * h * d, device=cuda, dtype=torch.bfloat16)
    q, k, v = (x.view(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, -1))
    got = flash_attention(q, k, v, 0, 190)
    want = flash_attention_plain(q.float(), k.float(), v.float(), 0, 190)
    assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("tq,layer,pos,prefix,kv_bound", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, tq, layer, pos, prefix, kv_bound, d):
    L, b, h, t = 3, 1, 4, 1024
    k, v = _bf16(cuda, *_cache(11, L, b, h, t, d, pos, max(pos + tq, prefix)))
    (q,) = _bf16(cuda, (np.random.default_rng(12).standard_normal((b, h, tq, d)) * 0.5).astype(np.float32))
    got = decode_attention_cached(q, k, v, layer, pos, prefix, kv_bound)
    want = decode_attention_cached_plain(
        q.float(), k.float(), v.float(), layer, pos, prefix, kv_bound
    )
    assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("tq,layer,pos,prefix,kv_bound", DECODE_CASES)
def test_decode_kernel_keeps_the_diagonal(cuda, tq, layer, pos, prefix, kv_bound):
    """Row i's query is the key at pos + i, scaled so that column carries
    most of the row's weight: dropping it, or letting in the garbage column
    after it, moves the output by about max|plain|."""
    L, b, h, t, d = 3, 1, 4, 1024, 64
    k, v = _bf16(cuda, *_cache(11, L, b, h, t, d, pos, max(pos + tq, prefix)))
    q = (k[layer, :, :, pos:pos + tq] * 10).contiguous()
    got = decode_attention_cached(q, k, v, layer, pos, prefix, kv_bound)
    want = decode_attention_cached_plain(
        q.float(), k.float(), v.float(), layer, pos, prefix, kv_bound
    )
    assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
def test_kernels_refuse_fp32(cuda):
    x = torch.zeros(1, 1, 4, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(x, x, x, 0, 0)
    cache = torch.zeros(1, 1, 1, 128, 64, device=cuda)
    with pytest.raises(ValueError):
        decode_attention_cached(x[:, :, :1], cache, cache, 0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,rep", [(1, 4), (8, 4), (3, 2), (2, 1)])
def test_gqa_kernels_match_plain(cuda, b, rep):
    """Kernel B's GQA entries (stacked, and over a single layer) against
    their fp32 plain versions on bf16 inputs, with x1000 garbage past pos,
    on random queries and on "diagonal" ones (each head's KV key at pos,
    scaled to carry most of the row's weight)."""
    pos, prefix, hkv, layer = 300, 200, 8 // rep if rep > 1 else 4, 2
    rng = np.random.default_rng(20 + b * rep)
    k, v = _bf16(cuda, *((rng.standard_normal((4, b, hkv, 512, 64)) * 0.5).astype(np.float32)
                          for _ in range(2)))
    k[..., pos + 1:, :] *= 1000
    v[..., pos + 1:, :] *= 1000
    (q,) = _bf16(cuda, (rng.standard_normal((b, hkv * rep, 1, 64)) * 0.5).astype(np.float32))
    diag = (k[layer, :, :, pos:pos + 1] * 10).repeat_interleave(rep, dim=1)
    for q in (q, diag):
        got = decode_attention_cached(q, k, v, layer, pos, prefix, 384)
        want = decode_attention_cached_plain(q.float(), k.float(), v.float(), layer, pos,
                                             prefix, 384)
        assert _rel_err(got, want) < CUDA_REL_TOL
        got = decode_attention(q, k[layer], v[layer], pos, prefix)
        want = decode_attention_plain(q.float(), k[layer].float(), v[layer].float(), pos,
                                      prefix)
        assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
def test_gqa_kernel_refuses_spans_and_int8(cuda):
    """JAX allows query spans only under MHA, and the int8 cache reaches
    GQA decode dequantized: both raise on the card."""
    q = torch.zeros(1, 4, 2, 64, device=cuda, dtype=torch.bfloat16)
    cache = torch.zeros(1, 1, 2, 128, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one query token"):
        decode_attention_cached(q, cache, cache, 0, 5, 0)
    codes = torch.zeros(1, 1, 2, 128, 64, device=cuda, dtype=torch.int8)
    scales = torch.ones(1, 1, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="bf16 cache"):
        decode_attention_cached(q[:, :, :1], codes, codes, 0, 5, 0, None, scales, scales)


# Kernel A's tile edges (64-column wgmma steps, 128-column tiles and 128-row
# blocks): `prefix` one column either side of a tile edge, spans of 8 and 16
# rows after the image (the GQA prompt prefill, heads repeated), 729 real
# rows in a 768-row plane.
FLASH_EDGE_CASES = {
    f"prefix{p}": (30 + p, 1, 3, 300, 300, 64, 0, p) for p in (63, 64, 65, 127, 128, 129)
}
FLASH_EDGE_CASES.update({
    "span8_pos730": (40, 2, 4, 8, 1024, 64, 730, 730),
    "span16_pos700": (41, 1, 4, 16, 1024, 64, 700, 730),
    "span16_pos1008": (42, 1, 2, 16, 1024, 64, 1008, 730),
    "vit_plane_729_real": (43, 1, 2, 768, 768, 72, 0, 729),
})


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_EDGE_CASES))
def test_flash_kernel_tile_edges(cuda, case):
    """Random queries, then "diagonal" ones (row i's query is its own key,
    scaled to carry most of the row's weight: a mask off by one at a tile
    edge moves the output by about max|plain|)."""
    seed, b, h, tq, tk, d, pos, prefix = FLASH_EDGE_CASES[case]
    q, k, v = _bf16(cuda, *_qkv(seed, b, h, tq, tk, d, scale=0.5))
    diag = (k[:, :, pos:pos + tq] * 10).contiguous()
    for q in (q, diag):
        got = flash_attention(q, k, v, pos, prefix)
        want = flash_attention_plain(q.float(), k.float(), v.float(), pos, prefix)
        assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
def test_flash_kernel_zero_pads_head_dim_72(cuda):
    """d72 head views of the fused QKV: the columns past a head's 72 are the
    next head's (large) values, which the kernel's padding to 80 must not
    read."""
    b, t, h, d = 2, 300, 3, 72
    qkv = torch.randn(b, t, 3 * h * d, device=cuda, dtype=torch.bfloat16)
    qkv.view(b, t, 3 * h, d)[..., :8] *= 100  # each head's first 8: the last head's neighbours
    q, k, v = (x.view(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, -1))
    got = flash_attention(q, k, v, 0, 290)
    want = flash_attention_plain(q.float(), k.float(), v.float(), 0, 290)
    assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
def test_flash_kernel_refuses_unaligned_views(cuda):
    """TMA needs 16-byte aligned bases and strides: a view 2 elements in, or
    a token stride of 36 elements, raises instead of reading wrongly."""
    x = torch.zeros(1, 2, 64, 72 + 8, device=cuda, dtype=torch.bfloat16)
    ok = x[..., :72]
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(x[..., 2:74], ok, ok, 0, 0)
    y = torch.zeros(1, 2, 64, 36, device=cuda, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(y, y, y, 0, 0)


# The decode kernel's column splits: positions at the ends of the cache and
# at a 64-column tile edge, over 2048 slots (many splits at a few pairs).
@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tq", [1, 8, 16])
@pytest.mark.parametrize("pos", [0, 63, 64, 2047])
def test_decode_kernel_split_edges(cuda, pos, tq, int8):
    from moondream_tpu_torch.models.text import dequantize_kv, quantize_kv

    L, b, h, t, d, layer, prefix = 2, 1, 4, 2048, 64, 1, 0
    pos = min(pos, t - tq)
    rng = np.random.default_rng(pos + tq)
    k, v = _bf16(cuda, *_cache(60 + tq, L, b, h, t, d, pos, pos + tq))
    q = (k[layer, :, :, pos:pos + tq] * 10).contiguous()
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = (quantize_kv(x.float().view(L * b, h, t, d), 2) for x in (k, v))
        k, v = k.view(L, b, h, t, d), v.view(L, b, h, t, d)
        ks, vs = ks.view(L, b, h // 2, t), vs.view(L, b, h // 2, t)
        q = (dequantize_kv(k[layer, :, :, pos:pos + tq], ks[layer, :, :, pos:pos + tq],
                           torch.bfloat16) * 10).contiguous()
    for q in (q, _bf16(cuda, (rng.standard_normal((b, h, tq, d)) * 0.5).astype(np.float32))[0]):
        got = decode_attention_cached(q, k, v, layer, pos, prefix, None, ks, vs)
        want = decode_attention_cached_plain(q.float(), k if int8 else k.float(),
                                             v if int8 else v.float(), layer, pos, prefix,
                                             None, ks, vs)
        assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2, 4, 16])
@pytest.mark.parametrize("pos", [0, 63, 64, 800, 2047])
def test_gqa_kernels_split_edges(cuda, rep, pos):
    """Kernel B's GQA entries at rep 1/2/4/16 over 2048 slots, diagonal
    queries (each head's KV key at pos), x1000 garbage past pos."""
    b, hkv, t, layer, prefix = 1, 2, 2048, 1, 730
    rng = np.random.default_rng(rep * 100 + pos)
    k, v = _bf16(cuda, *((rng.standard_normal((2, b, hkv, t, 64)) * 0.5).astype(np.float32)
                          for _ in range(2)))
    k[..., pos + 1:, :] *= 1000
    v[..., pos + 1:, :] *= 1000
    q = (k[layer, :, :, pos:pos + 1] * 10).repeat_interleave(rep, dim=1)
    got = decode_attention_cached(q, k, v, layer, pos, prefix)
    want = decode_attention_cached_plain(q.float(), k.float(), v.float(), layer, pos, prefix)
    assert _rel_err(got, want) < CUDA_REL_TOL
    got = decode_attention(q, k[layer], v[layer], pos, prefix)
    want = decode_attention_plain(q.float(), k[layer].float(), v[layer].float(), pos, prefix)
    assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
def test_decode_kernel_leaves_tickets_at_zero(cuda):
    """The merge's tickets return to 0 after every launch: a second call on
    the same workspace gives the same output."""
    from moondream_tpu_torch.kernels import attention as K

    k, v = _bf16(cuda, *_cache(70, 2, 2, 4, 1024, 64, 900, 901))
    q = k[1, :, :, 900:901].contiguous()
    first = decode_attention_cached(q, k, v, 1, 900, 0)
    again = decode_attention_cached(q, k, v, 1, 900, 0)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    ws = K._WORKSPACE[(q.device, torch.cuda.current_stream(q.device).cuda_stream)]
    assert int(ws[1].abs().sum()) == 0


@pytest.mark.cuda
def test_decode_workspace_is_per_stream(cuda):
    """Launches on two streams, which may run at once, get two workspaces
    (partials and tickets); each gives the output of the default stream."""
    from moondream_tpu_torch.kernels import attention as K

    k, v = _bf16(cuda, *_cache(71, 2, 2, 4, 1024, 64, 900, 901))
    q = k[1, :, :, 900:901].contiguous()
    want = decode_attention_cached(q, k, v, 1, 900, 0)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            outs.append(decode_attention_cached(q, k, v, 1, 900, 0))
    torch.cuda.synchronize()
    spaces = [K._WORKSPACE[(q.device, s.cuda_stream)] for s in streams]
    assert spaces[0][0].data_ptr() != spaces[1][0].data_ptr()
    assert spaces[0][1].data_ptr() != spaces[1][1].data_ptr()
    for out in outs:
        assert torch.equal(out, want)


# Kernel A's device form on the card, at the speculative verify spans'
# shapes: the GQA 2B's (32 query heads over 8 KV heads repeated, Tq 8) and
# the MHA 2B's at k 24 (32 heads), over the layer view of a stacked cache
# read to kv_bound 1024, diagonal queries (row i's query is its own key
# x 10) and x1000 garbage past the span.
DEVICE_FORM_CASES = {"gqa_k8": (8, 4), "mha_k24": (24, 1)}


def _device_form_inputs(cuda, tq, rep, pos, seed=120):
    L, t, tk, hkv, d, layer = 2, 2048, 1024, 32 // rep, 64, 1
    rng = np.random.default_rng(seed + tq + pos)
    kc, vc = _bf16(cuda, *((rng.standard_normal((L, 1, hkv, t, d)) * 0.5).astype(np.float32)
                           for _ in range(2)))
    kc[..., pos + tq:, :] *= 1000
    vc[..., pos + tq:, :] *= 1000
    k = kc[layer, :, :, :tk].repeat_interleave(rep, dim=1)
    v = vc[layer, :, :, :tk].repeat_interleave(rep, dim=1)
    q = (k[:, :, pos:pos + tq] * 10).contiguous()
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DEVICE_FORM_CASES))
def test_flash_kernel_device_position_equals_host_form(cuda, case):
    """At positions 0 and Tk - Tq (prefix 730): the device form bit for bit
    the host form, and within CUDA_REL_TOL of the plain version."""
    tq, rep = DEVICE_FORM_CASES[case]
    for pos in (0, 1024 - tq):
        q, k, v = _device_form_inputs(cuda, tq, rep, pos)
        got = flash_attention(q, k, v, torch.full((1,), pos, dtype=torch.int32, device=cuda),
                              730)
        assert torch.equal(got, flash_attention(q, k, v, pos, 730))
        want = flash_attention_plain(q.float(), k.float(), v.float(), pos, 730)
        assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DEVICE_FORM_CASES))
def test_flash_kernel_device_position_replays_at_a_new_position(cuda, case):
    """A CUDA graph captured at one device position, replayed after the
    position tensor changed, gives the host form at the new position."""
    tq, rep = DEVICE_FORM_CASES[case]
    q, k, v = _device_form_inputs(cuda, tq, rep, 500)
    pos = torch.full((1,), 0, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention(q, k, v, pos, 730)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention(q, k, v, pos, 730)
    for p in (500, 1024 - tq, 3):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, flash_attention(q, k, v, p, 730))
