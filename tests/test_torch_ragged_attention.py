"""Kernel C's plain version (`decode_attention_ragged_plain`, reached through
`decode_attention_cached` with a 1-D `pos`) against the JAX package's Pallas
kernels run with interpret=True, fp32 inputs, atol 2e-5 / rtol 1e-4 (the
JAX suite's own; the same fp32 math summed in another order):

  * bf16-layout caches: `_decode_kernel_stacked_ragged`, per-row positions
    with and without a shared prefix segment;
  * int8 caches: the ragged and prefix-shared int8 branches of
    `_decode_kernel_paired`, on the JAX package's head-paired layout of the
    same codes and scales (built as tests/test_torch_kv_int8.py builds them).

Every cache holds garbage (x1000) past what each row may attend, and the
prefix segment past `prefix_len`.

Tests marked `cuda` hold kernel C against the plain version on the card
(`python -m pytest --noconftest -m cuda tests/test_torch_ragged_attention.py`
on a machine without jax).
"""

import numpy as np
import pytest
import torch

from moondream_tpu_torch.models.text import dequantize_kv, quantize_kv
from moondream_tpu_torch.ops.attention import (
    decode_attention_cached,
    decode_attention_ragged_plain,
)

ATOL, RTOL = 2e-5, 1e-4
L, H, D = 3, 4, 32
LAYER = 1


def _normal(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cache(seed, s, t, ends):
    """k, v (L, S, H, T, D): unit-scale normals, x1000 past column ends[b]
    of slot b."""
    rng = np.random.default_rng(seed)
    k, v = _normal(rng, L, s, H, t, D), _normal(rng, L, s, H, t, D)
    for b, e in enumerate(ends):
        k[:, b, :, e:] *= 1000
        v[:, b, :, e:] *= 1000
    return k, v


# (tq, prefix, kv_bound, pos): ragged positions over a 512-slot cache,
# including 0 and the last slot a span can take
RAGGED_CASES = [
    (1, 0, None, [0, 37, 300, 511]),
    (1, 100, None, [0, 99, 100, 401]),
    (4, 0, None, [0, 5, 250, 508]),
    (4, 100, 256, [0, 98, 130, 252]),
    (1, 0, 384, [383, 0, 12, 200]),
]


def _ends(pos, tq, prefix):
    return [max(p + tq, prefix) for p in pos]


@pytest.mark.parametrize("tq,prefix,kv_bound,pos", RAGGED_CASES)
def test_ragged_plain_matches_pallas(tq, prefix, kv_bound, pos):
    import jax.numpy as jnp

    from moondream_tpu.ops.attention import decode_attention_cached as jax_dec

    s, t = len(pos), 512
    k, v = _cache(40, s, t, _ends(pos, tq, prefix))
    q = _normal(np.random.default_rng(41), s, H, tq, D)
    pos_np = np.asarray(pos, np.int32)
    want = np.asarray(jax_dec(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), LAYER, jnp.asarray(pos_np),
        prefix, kv_bound=kv_bound, interpret=True,
    ))
    got = decode_attention_cached(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), LAYER,
        torch.from_numpy(pos_np), prefix, kv_bound,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# Prefix-shared: suffix segments of 256 slots, a prefix pool of 3 entries
# padded to 128 slots of which 100 are the prefix; slots 0 and 2 share
# entry 1, slot 3 is idle at position 0.
PREFIX_LEN, TP, TS = 100, 128, 256
PIDS = [1, 0, 1, 2]


def _prefix_inputs(seed, pos, tq):
    rng = np.random.default_rng(seed)
    pk = _normal(rng, L, 3, H, TP, D)
    pv = _normal(rng, L, 3, H, TP, D)
    pk[..., PREFIX_LEN:, :] *= 1000  # the padding past prefix_len
    pv[..., PREFIX_LEN:, :] *= 1000
    k, v = _cache(seed + 1, len(pos), TS, [max(p + tq - PREFIX_LEN, 0) for p in pos])
    q = _normal(rng, len(pos), H, tq, D)
    return q, k, v, pk, pv


@pytest.mark.parametrize("tq,pos", [(1, [100, 140, 355, 0]), (4, [101, 100, 352, 0])])
def test_prefix_shared_plain_matches_pallas(tq, pos):
    import jax.numpy as jnp

    from moondream_tpu.ops.attention import decode_attention_cached as jax_dec

    q, k, v, pk, pv = _prefix_inputs(42, pos, tq)
    pos_np, pids_np = np.asarray(pos, np.int32), np.asarray(PIDS, np.int32)
    want = np.asarray(jax_dec(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), LAYER, jnp.asarray(pos_np),
        0, interpret=True, pref_k=jnp.asarray(pk), pref_v=jnp.asarray(pv),
        pids=jnp.asarray(pids_np), prefix_len=PREFIX_LEN,
    ))
    t = torch.from_numpy
    got = decode_attention_cached(
        t(q), t(k), t(v), LAYER, t(pos_np), 0, pref_k=t(pk), pref_v=t(pv),
        pids=t(pids_np), prefix_len=PREFIX_LEN,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_prefix_shared_reads_each_rows_own_entry():
    """Slot 0 and slot 2 hold the same queries and suffix at one position:
    equal outputs on one entry, different ones when slot 2 moves to
    another."""
    pos = [200, 140, 200, 0]
    q, k, v, pk, pv = _prefix_inputs(43, pos, 1)
    q[2], k[:, 2], v[:, 2] = q[0], k[:, 0], v[:, 0]
    t = torch.from_numpy
    run = lambda pids: decode_attention_cached(
        t(q), t(k), t(v), LAYER, torch.tensor(pos, dtype=torch.int32), 0,
        pref_k=t(pk), pref_v=t(pv), pids=torch.tensor(pids, dtype=torch.int32),
        prefix_len=PREFIX_LEN,
    )
    same, moved = run(PIDS), run([1, 0, 2, 2])
    assert torch.equal(same[0], same[2])
    assert not torch.allclose(moved[0], moved[2])


# ---------------------------------------------------------------- int8
G = 2


def _int8(x, garbage_ends, seed):
    """Codes and scales of x (L, S, H, T, D); past garbage_ends[b], random
    codes with scales x1000."""
    l, s, h, t, d = x.shape
    codes, scale = quantize_kv(torch.from_numpy(x).reshape(l * s, h, t, d), G)
    codes, scale = codes.reshape(l, s, h, t, d), scale.reshape(l, s, h // G, t)
    rng = np.random.default_rng(seed)
    for b, e in enumerate(garbage_ends):
        tail = codes[:, b, :, e:].shape
        codes[:, b, :, e:] = torch.from_numpy(rng.integers(-127, 128, tail, dtype=np.int8))
        scale[:, b, :, e:] *= 1000
    return codes, scale


def _paired(codes, scale):
    """The JAX package's layout of the same cache: (L, S, H/g, T, g*D)
    codes and (L, S, H/g, 1, T) scales."""
    import jax.numpy as jnp

    from moondream_tpu.models.text import pair_kv

    l, s, h, t, d = codes.shape
    c = pair_kv(jnp.asarray(codes.numpy()).reshape(l * s, h, t, d), G)
    return c.reshape(l, s, h // G, t, G * d), jnp.asarray(scale.numpy())[:, :, :, None, :]


@pytest.mark.parametrize("tq,pos", [(1, [0, 37, 300, 511]), (4, [0, 5, 250, 508])])
def test_int8_ragged_plain_matches_pallas(tq, pos):
    import jax.numpy as jnp

    from moondream_tpu.ops.attention import decode_attention_cached as jax_dec

    rng = np.random.default_rng(44)
    ends = _ends(pos, tq, 0)
    kc, ks = _int8(_normal(rng, L, len(pos), H, 512, D), ends, 45)
    vc, vs = _int8(_normal(rng, L, len(pos), H, 512, D), ends, 46)
    q = _normal(rng, len(pos), H, tq, D)
    pos_np = np.asarray(pos, np.int32)
    (jkc, jks), (jvc, jvs) = _paired(kc, ks), _paired(vc, vs)
    want = np.asarray(jax_dec(
        jnp.asarray(q), jkc, jvc, LAYER, jnp.asarray(pos_np), 0, interpret=True,
        k_scale=jks, v_scale=jvs,
    ))
    got = decode_attention_cached(
        torch.from_numpy(q), kc, vc, LAYER, torch.from_numpy(pos_np), 0, None, ks, vs
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("tq,pos", [(1, [100, 140, 355, 0]), (4, [101, 100, 352, 0])])
def test_int8_prefix_shared_plain_matches_pallas(tq, pos):
    import jax.numpy as jnp

    from moondream_tpu.ops.attention import decode_attention_cached as jax_dec

    rng = np.random.default_rng(47)
    ends = [max(p + tq - PREFIX_LEN, 0) for p in pos]
    kc, ks = _int8(_normal(rng, L, len(pos), H, TS, D), ends, 48)
    vc, vs = _int8(_normal(rng, L, len(pos), H, TS, D), ends, 49)
    pkc, pks = _int8(_normal(rng, L, 3, H, TP, D), [PREFIX_LEN] * 3, 50)
    pvc, pvs = _int8(_normal(rng, L, 3, H, TP, D), [PREFIX_LEN] * 3, 51)
    q = _normal(rng, len(pos), H, tq, D)
    pos_np, pids_np = np.asarray(pos, np.int32), np.asarray(PIDS, np.int32)
    (jkc, jks), (jvc, jvs) = _paired(kc, ks), _paired(vc, vs)
    (jpkc, jpks), (jpvc, jpvs) = _paired(pkc, pks), _paired(pvc, pvs)
    want = np.asarray(jax_dec(
        jnp.asarray(q), jkc, jvc, LAYER, jnp.asarray(pos_np), 0, interpret=True,
        k_scale=jks, v_scale=jvs, pref_k=jpkc, pref_v=jpvc, pref_ks=jpks,
        pref_vs=jpvs, pids=jnp.asarray(pids_np), prefix_len=PREFIX_LEN,
    ))
    got = decode_attention_cached(
        torch.from_numpy(q), kc, vc, LAYER, torch.from_numpy(pos_np), 0, None,
        ks, vs, pkc, pvc, pks, pvs, torch.from_numpy(pids_np), PREFIX_LEN,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_shared_prefix_needs_ragged_positions():
    x = torch.zeros(1, H, 1, D)
    cache = torch.zeros(L, 1, H, 128, D)
    with pytest.raises(ValueError):
        decode_attention_cached(x, cache, cache, 0, 5, 0, pref_k=cache, pref_v=cache,
                                pids=torch.zeros(1, dtype=torch.int32), prefix_len=4)


# ------------------------------------------------------------ on the card
CUDA_REL_TOL = 1e-2  # of max|plain|, as for kernel B


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.float() - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("diagonal", [False, True])
@pytest.mark.parametrize("tq,prefix,kv_bound,pos", RAGGED_CASES)
def test_ragged_kernel_matches_plain(cuda, tq, prefix, kv_bound, pos, diagonal):
    """With `diagonal`, row i's query is its own key at pos[b] + i, scaled,
    so that column carries most of the row's weight."""
    k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in _cache(40, len(pos), 512, _ends(pos, tq, prefix)))
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    if diagonal:
        q = torch.stack([k[LAYER, b, :, p:p + tq] for b, p in enumerate(pos)]) * 10
    else:
        q = torch.from_numpy(_normal(np.random.default_rng(41), len(pos), H, tq, D, scale=0.5))
        q = q.to(cuda, torch.bfloat16)
    got = decode_attention_cached(q, k, v, LAYER, pos_t, prefix, kv_bound)
    want = decode_attention_ragged_plain(q.float(), k.float(), v.float(), LAYER, pos_t,
                                         prefix, kv_bound)
    assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tq,pos", [(1, [100, 140, 355, 0]), (4, [101, 100, 352, 0])])
def test_prefix_shared_kernel_matches_plain(cuda, tq, pos, int8):
    """Slot b's query at its first row is prefix entry pids[b]'s key at
    column 50, scaled: a wrong entry moves the output by ~max|plain|."""
    q, k, v, pk, pv = (torch.from_numpy(a).to(cuda) for a in _prefix_inputs(42, pos, tq))
    pids = torch.tensor(PIDS, dtype=torch.int32, device=cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    q[:, :, 0] = pk[LAYER, pids.long(), :, 50] * 10
    q = q.to(torch.bfloat16)
    if int8:
        ends = [max(p + tq - PREFIX_LEN, 0) for p in pos]
        kc, ks = (x.to(cuda) for x in _int8(k.cpu().numpy(), ends, 52))
        vc, vs = (x.to(cuda) for x in _int8(v.cpu().numpy(), ends, 53))
        pkc, pks = (x.to(cuda) for x in _int8(pk.cpu().numpy(), [PREFIX_LEN] * 3, 54))
        pvc, pvs = (x.to(cuda) for x in _int8(pv.cpu().numpy(), [PREFIX_LEN] * 3, 55))
        args = (kc, vc, LAYER, pos_t, 0, None, ks, vs, pkc, pvc, pks, pvs, pids, PREFIX_LEN)
        got = decode_attention_cached(q, *args)
        want = decode_attention_ragged_plain(q.float(), *args)
    else:
        k, v, pk, pv = (x.to(torch.bfloat16) for x in (k, v, pk, pv))
        got = decode_attention_cached(q, k, v, LAYER, pos_t, 0, None,
                                      pref_k=pk, pref_v=pv, pids=pids, prefix_len=PREFIX_LEN)
        want = decode_attention_ragged_plain(
            q.float(), k.float(), v.float(), LAYER, pos_t, 0, None,
            pref_k=pk.float(), pref_v=pv.float(), pids=pids, prefix_len=PREFIX_LEN,
        )
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < CUDA_REL_TOL


@pytest.mark.cuda
def test_ragged_kernel_reads_nothing_back(cuda):
    k = torch.randn(L, 4, H, 256, D, device=cuda, dtype=torch.bfloat16)
    q = torch.randn(4, H, 1, D, device=cuda, dtype=torch.bfloat16)
    pos = torch.tensor([0, 5, 100, 255], dtype=torch.int32, device=cuda)
    decode_attention_cached(q, k, k, LAYER, pos, 0)  # built and loaded
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_attention_cached(q, k, k, LAYER, pos, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_ragged_kernel_refuses_host_positions(cuda):
    k = torch.zeros(L, 2, H, 128, D, device=cuda, dtype=torch.bfloat16)
    q = torch.zeros(2, H, 1, D, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        decode_attention_cached(q, k, k, 0, torch.zeros(2, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        decode_attention_cached(q, k, k, 0, torch.zeros(2, dtype=torch.int64, device=cuda), 0)


# The decode kernel splits each (slot, head)'s columns across blocks from the
# host's read bounds; slots whose positions end early leave the later splits
# empty. A pool at 0, 1, 730 and the last slot at once, an idle slot (0),
# and prefix segments whose 730-column edge falls inside a split.
@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tq", [1, 4])
def test_ragged_kernel_split_edges(cuda, tq, int8):
    s_, h, t, d = 4, 8, 1024, 64
    pos = [0, 1, 730, t - tq]
    rng = np.random.default_rng(60 + tq)
    k, v = (torch.from_numpy(_normal(rng, L, s_, h, t, d)) for _ in range(2))
    for b, p in enumerate(pos):
        k[:, b, :, p + tq:] *= 1000
        v[:, b, :, p + tq:] *= 1000
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    diag = torch.stack([k[LAYER, b, :, p:p + tq] for b, p in enumerate(pos)]) * 10
    rand = torch.from_numpy(_normal(rng, s_, h, tq, d, scale=0.5))
    if int8:
        (kc, ks), (vc, vs) = (quantize_kv(x.reshape(L * s_, h, t, d), G) for x in (k, v))
        kc, vc = kc.reshape(L, s_, h, t, d).to(cuda), vc.reshape(L, s_, h, t, d).to(cuda)
        ks, vs = (x.reshape(L, s_, h // G, t).to(cuda) for x in (ks, vs))
        args = (kc, vc, LAYER, pos_t, 0, None, ks, vs)
        plain = lambda q: decode_attention_ragged_plain(q.float(), *args)
    else:
        kc, vc = k.to(cuda, torch.bfloat16), v.to(cuda, torch.bfloat16)
        args = (kc, vc, LAYER, pos_t, 0)
        plain = lambda q: decode_attention_ragged_plain(q.float(), kc.float(), vc.float(),
                                                        LAYER, pos_t, 0)
    for q in (diag, rand):
        q = q.to(cuda, torch.bfloat16)
        got = decode_attention_cached(q, *args)
        assert torch.isfinite(got).all()
        assert _rel_err(got, plain(q)) < CUDA_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tq", [1, 4])
def test_prefix_shared_kernel_split_straddles_prefix(cuda, tq, int8):
    """A 730-column prefix (768 with padding x1000) and 384-column suffixes:
    the split holding columns 704-735 (or wider) reads both segments; slot
    3 is idle at 0. Each slot's first query row is its prefix entry's key at
    column 729, the last prefix column."""
    s_, h, d, tp, ts, plen = 4, 8, 64, 768, 384, 730
    pos, pids_l = [730, 731, 0, 1110 - tq + 1], [0, 1, 1, 0]
    rng = np.random.default_rng(70 + tq)
    k, v = (torch.from_numpy(_normal(rng, L, s_, h, ts, d)) for _ in range(2))
    for b, p in enumerate(pos):
        k[:, b, :, max(p + tq - plen, 0):] *= 1000
        v[:, b, :, max(p + tq - plen, 0):] *= 1000
    pk, pv = (torch.from_numpy(_normal(rng, L, 2, h, tp, d)) for _ in range(2))
    pk[..., plen:, :] *= 1000
    pv[..., plen:, :] *= 1000
    q = torch.from_numpy(_normal(rng, s_, h, tq, d, scale=0.5))
    q[:, :, 0] = pk[LAYER, torch.tensor(pids_l), :, plen - 1] * 10
    q = q.to(cuda, torch.bfloat16)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    pids = torch.tensor(pids_l, dtype=torch.int32, device=cuda)
    if int8:
        q8 = lambda x, n: (y.to(cuda) for y in quantize_kv(x.reshape(L * n, h, x.shape[3], d), G))
        (kc, ks), (vc, vs) = q8(k, s_), q8(v, s_)
        (pkc, pks), (pvc, pvs) = q8(pk, 2), q8(pv, 2)
        kc, vc = kc.reshape(k.shape), vc.reshape(v.shape)
        pkc, pvc = pkc.reshape(pk.shape), pvc.reshape(pv.shape)
        ks, vs = ks.reshape(L, s_, h // G, ts), vs.reshape(L, s_, h // G, ts)
        pks, pvs = pks.reshape(L, 2, h // G, tp), pvs.reshape(L, 2, h // G, tp)
        args = (kc, vc, LAYER, pos_t, 0, None, ks, vs, pkc, pvc, pks, pvs, pids, plen)
        want = decode_attention_ragged_plain(q.float(), *args)
    else:
        kc, vc, pkc, pvc = (x.to(cuda, torch.bfloat16) for x in (k, v, pk, pv))
        args = (kc, vc, LAYER, pos_t, 0, None, None, None, pkc, pvc, None, None, pids, plen)
        want = decode_attention_ragged_plain(q.float(), kc.float(), vc.float(), LAYER, pos_t,
                                             0, None, pref_k=pkc.float(), pref_v=pvc.float(),
                                             pids=pids, prefix_len=plen)
    got = decode_attention_cached(q, *args)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) < CUDA_REL_TOL
