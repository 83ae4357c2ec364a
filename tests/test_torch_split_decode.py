"""The decode kernel's column split, on the CPU.

The CUDA decode kernel (kernels B, B-int8, B-GQA and C) splits each (batch
row, head)'s columns across blocks and merges the blocks' partial results
in the last block to finish. `plan_decode_splits` chooses the split on the
host; here its splits are checked to cover the columns exactly once, on
16-column boundaries, and to come as close to the block target as whole
16-column splits allow without exceeding it. `emulate_split_decode`
below repeats the kernel's algorithm in plain fp32 PyTorch (test-only):
the pair's columns in the kernel's order (a prefix segment first), one
online-softmax partial (max, denominator, unnormalised PV sum) per split,
empty splits at (-inf, 0), and the merge. It must equal the plain versions
in fp32 (atol 1e-5: the same math summed in another order), including
empty trailing splits, a split straddling the prefix boundary, spans of
1/8/16 rows, GQA rep 1/2/4/16 and int8 codes with per-token scales, and
the JAX package's `decode_attention_cached` in interpret mode.
"""

import numpy as np
import pytest
import torch

from moondream_tpu_torch.kernels.attention import (
    MAX_SPLITS,
    MIN_SPLIT_COLS,
    SPLIT_ALIGN,
    SPLIT_BLOCKS_PER_SM,
    plan_decode_splits,
)
from moondream_tpu_torch.models.text import quantize_kv
from moondream_tpu_torch.ops.attention import (
    decode_attention_cached_plain,
    decode_attention_ragged_plain,
    read_bound,
)

ATOL = 1e-5


def split_ranges(ncols, n_split, split_cols):
    """The [start, end) columns of each split of a plan, as the kernel reads
    them (empty past ncols)."""
    return [(min(i * split_cols, ncols), min((i + 1) * split_cols, ncols))
            for i in range(n_split)]


def emulate_split_decode(q, k_cache, v_cache, layer, pos, prefix, tk, plan_ncols, sms=132,
                         k_scale=None, v_scale=None, pref_k=None, pref_v=None, pref_ks=None,
                         pref_vs=None, pids=None, prefix_len=0):
    """The decode kernel's split-and-merge in fp32: q (S, Hq, Tq, D) over
    layer `layer` of (L, S, Hkv, T, D) caches, slot b at positions pos[b]
    + i (GQA, Hq = rep * Hkv: one token, the rep heads as rows at pos[b]),
    splits planned from `plan_ncols` as the wrapper plans them."""
    s_, hq, tq, d = q.shape
    hkv = k_cache.shape[2]
    rep = hq // hkv
    pairs = s_ * hkv
    n_split, cols = plan_decode_splits(plan_ncols, pairs, sms)
    row_step = 0 if rep > 1 else 1
    int8 = k_scale is not None
    g = hkv // k_scale.shape[2] if int8 else 1
    out = torch.empty(s_, hq, tq, d)
    for b in range(s_):
        p = int(pos[b])
        rows = q[b].reshape(hkv, rep * tq, d)
        qpos = p + torch.arange(rep * tq) * row_step
        span = (tq - 1) * row_step + 1
        scales = lambda t, e, a, n: t[layer, e, :, a:a + n].repeat_interleave(g, dim=0)
        if pref_k is None:
            n = min(max(p + span, prefix), tk)
            k, v = k_cache[layer, b, :, :n], v_cache[layer, b, :, :n]
            gpos, pfx = torch.arange(n), prefix
            if int8:
                ks, vs = scales(k_scale, b, 0, n), scales(v_scale, b, 0, n)
        else:
            pid, tp = int(pids[b]), pref_k.shape[3]
            npre = min(prefix_len, p + span, tp)
            nsuf = max(0, min(tk, p + span - prefix_len))
            n = npre + nsuf
            k = torch.cat([pref_k[layer, pid, :, :npre], k_cache[layer, b, :, :nsuf]], dim=1)
            v = torch.cat([pref_v[layer, pid, :, :npre], v_cache[layer, b, :, :nsuf]], dim=1)
            gpos = torch.cat([torch.arange(npre), prefix_len + torch.arange(nsuf)])
            pfx = 0
            if int8:
                ks = torch.cat([scales(pref_ks, pid, 0, npre), scales(k_scale, b, 0, nsuf)], 1)
                vs = torch.cat([scales(pref_vs, pid, 0, npre), scales(v_scale, b, 0, nsuf)], 1)
        assert n_split * cols >= plan_ncols >= n
        k, v = k.float(), v.float()  # int8 codes as values
        s = torch.matmul(rows, k.transpose(-1, -2)) * d ** -0.5  # (Hkv, R, n)
        if int8:
            s = s * ks[:, None, :]
        mask = (gpos[None] <= qpos[:, None]) | ((qpos[:, None] < pfx) & (gpos[None] < pfx))
        parts = []
        for c0, c1 in split_ranges(n, n_split, cols):
            if c0 >= c1:  # past the pair's last attendable column
                parts.append((torch.full((hkv, rep * tq, 1), -torch.inf), None, None))
                continue
            sc = s[..., c0:c1].masked_fill(~mask[:, c0:c1], -torch.inf)
            m = sc.amax(-1, keepdim=True)
            e = torch.exp(sc - torch.where(m == -torch.inf, 0.0, m))
            w = e * vs[:, None, c0:c1] if int8 else e
            parts.append((m, e.sum(-1, keepdim=True), torch.matmul(w, v[:, c0:c1])))
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = torch.zeros(hkv, rep * tq, d), torch.zeros(hkv, rep * tq, 1)
        for m, l, o in parts:
            if l is None:
                continue
            w = torch.where(m == -torch.inf, 0.0, torch.exp(m - big))
            num, den = num + w * o, den + w * l
        out[b] = torch.where(den > 0, num / den, 0.0).reshape(hq, tq, d)
    return out


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("ncols,pairs", [
    (801, 8), (736, 32), (1024, 256), (896, 256), (1114, 256), (2048, 32), (1, 1),
    (2817, 8), (31, 4), (2047 + 768, 1), (16384, 1), (64, 264), (730, 512),
])
def test_plan_covers_the_columns_once(ncols, pairs):
    n_split, cols = plan_decode_splits(ncols, pairs)
    ranges = split_ranges(ncols, n_split, cols)
    covered = [c for a, b in ranges for c in range(a, b)]
    assert covered == list(range(ncols))  # every column once, in order
    assert 1 <= n_split <= MAX_SPLITS and cols % SPLIT_ALIGN == 0
    # every split but possibly the last is full; none is empty
    assert all(b - a == cols for a, b in ranges[:-1]) and ranges[-1][1] > ranges[-1][0]
    # each split starts on 16-byte boundaries of bf16 and int8 rows (D 64)
    # and of the fp32 scale rows
    for a, _ in ranges:
        assert a % SPLIT_ALIGN == 0
        assert all(a * 64 * e % 16 == 0 for e in (1, 2)) and a * 4 % 16 == 0
    # the block target: at most `want` splits per pair, and the fewest
    # columns that keep within it (16 fewer would exceed it) unless the
    # smallest split holds them back
    want = min(MAX_SPLITS, -(-SPLIT_BLOCKS_PER_SM * 132 // pairs))
    assert n_split <= want
    if cols > MIN_SPLIT_COLS:
        assert -(-ncols // (cols - SPLIT_ALIGN)) > want
    else:
        assert n_split == -(-ncols // MIN_SPLIT_COLS)


def test_plan_refuses_nothing_to_split():
    with pytest.raises(ValueError):
        plan_decode_splits(0, 8)


# ------------------------------------------------------------ the merge
def _rand(rng, *shape, scale=0.3):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _garbage_past(t, ends):
    """x1000 (K) past each slot's span: a column read by mistake moves the
    output."""
    for b, e in enumerate(ends):
        t[:, b, :, e:] *= 1000
    return t


@pytest.mark.parametrize("tq", [1, 8, 16])
@pytest.mark.parametrize("pos,prefix,kv_bound", [
    (0, 0, None), (63, 0, 256), (64, 0, 256), (735, 730, 1024), (730, 730, 768),
    (1000, 730, None), (40, 100, 256),
])
@pytest.mark.parametrize("sms", [132, 4])
def test_split_merge_equals_kernel_b_plain(tq, pos, prefix, kv_bound, sms):
    rng = np.random.default_rng(pos + tq)
    L, b, h, t, d = 2, 2, 4, 1024, 64
    k = _garbage_past(_rand(rng, L, b, h, t, d), [max(pos + tq, prefix)] * b)
    v = _garbage_past(_rand(rng, L, b, h, t, d), [max(pos + tq, prefix)] * b)
    q = _rand(rng, b, h, tq, d)
    tk = read_bound(t, kv_bound)
    ncols = min(max(pos + tq, prefix), tk)
    got = emulate_split_decode(q, k, v, 1, [pos] * b, prefix, tk, ncols, sms)
    want = decode_attention_cached_plain(q, k, v, 1, pos, prefix, kv_bound)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rep", [1, 2, 4, 16])
@pytest.mark.parametrize("pos", [0, 63, 64, 800, 2047])
def test_split_merge_equals_gqa_plain(rep, pos):
    """GQA: a block holds the rep query heads of one KV head as rows, all
    at pos; rep 1 is MHA's single token."""
    rng = np.random.default_rng(rep * 7 + pos)
    L, b, hkv, t, d, prefix = 2, 2, 2, 2048, 64, 730
    k = _garbage_past(_rand(rng, L, b, hkv, t, d), [max(pos + 1, prefix)] * b)
    v = _garbage_past(_rand(rng, L, b, hkv, t, d), [max(pos + 1, prefix)] * b)
    q = _rand(rng, b, hkv * rep, 1, d)
    tk = read_bound(t, pos + 64)
    got = emulate_split_decode(q, k, v, 1, [pos] * b, prefix, tk, min(max(pos + 1, prefix), tk))
    want = decode_attention_cached_plain(q, k, v, 1, pos, prefix, pos + 64)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("tq", [1, 4, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_split_merge_equals_ragged_plain(tq, int8):
    """Kernel C's pool: slots at 0 (idle), 1, 730 and 1023 - tq + 1 at
    once; the splits are planned from the read bound, so the low slots'
    trailing splits are empty."""
    rng = np.random.default_rng(tq + 10 * int8)
    L, s_, h, t, d = 2, 4, 4, 1024, 64
    pos = [0, 1, 730, t - tq]
    ends = [p + tq for p in pos]
    k = _garbage_past(_rand(rng, L, s_, h, t, d), ends)
    v = _garbage_past(_rand(rng, L, s_, h, t, d), ends)
    ks = vs = None
    if int8:
        (k, ks), (v, vs) = (_int8(x, 2) for x in (k, v))
    q = _rand(rng, s_, h, tq, d)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    got = emulate_split_decode(q, k, v, 1, pos_t, 0, t, t, k_scale=ks, v_scale=vs)
    want = decode_attention_ragged_plain(q, k, v, 1, pos_t, 0, None, ks, vs)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # the idle slot's 1 column lies in split 0: every other split is empty
    n_split, cols = plan_decode_splits(t, s_ * h)
    assert n_split > 1 and split_ranges(1, n_split, cols)[1] == (1, 1)


def _int8(x, g):
    """(L, S, H, T, D) fp32 -> int8 codes and (L, S, H/g, T) scales."""
    L, s_, h, t, d = x.shape
    codes, scales = quantize_kv(x.reshape(L * s_, h, t, d), g)
    return codes.reshape(x.shape), scales.reshape(L, s_, h // g, t)


@pytest.mark.parametrize("tq", [1, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_split_merge_equals_prefix_shared_plain(tq, int8):
    """Prefix-shared pool: prefix entries of 730 real columns (padding to
    768 x1000), suffix caches of 384; a split straddles column 730, where
    the prefix segment ends and the slot's own cache begins."""
    rng = np.random.default_rng(3 + tq + int8)
    L, s_, h, d, tp, ts, plen = 2, 4, 4, 64, 768, 384, 730
    pos = [730, 731, 900, 1113 - tq + 1]
    pids = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    k = _garbage_past(_rand(rng, L, s_, h, ts, d), [p + tq - plen for p in pos])
    v = _garbage_past(_rand(rng, L, s_, h, ts, d), [p + tq - plen for p in pos])
    pk = _garbage_past(_rand(rng, L, 2, h, tp, d), [plen] * 2)
    pv = _garbage_past(_rand(rng, L, 2, h, tp, d), [plen] * 2)
    ks = vs = pks = pvs = None
    if int8:
        (k, ks), (v, vs), (pk, pks), (pv, pvs) = (_int8(x, 2) for x in (k, v, pk, pv))
    q = _rand(rng, s_, h, tq, d)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    ncols = ts + min(plen, tp)
    got = emulate_split_decode(q, k, v, 1, pos_t, 0, ts, ncols, k_scale=ks, v_scale=vs,
                               pref_k=pk, pref_v=pv, pref_ks=pks, pref_vs=pvs, pids=pids,
                               prefix_len=plen)
    want = decode_attention_ragged_plain(q, k, v, 1, pos_t, 0, None, ks, vs, pk, pv, pks,
                                         pvs, pids, plen)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    n_split, cols = plan_decode_splits(ncols, s_ * h)
    assert any(a < plen < b for a, b in split_ranges(ncols, n_split, cols))


@pytest.mark.parametrize("tq", [1, 8])
def test_split_merge_equals_int8_stacked_plain(tq):
    """Kernel B's int8 entry: the k-scale folds into the scores, p times
    the v-scale meets the codes, the division follows the merge."""
    rng = np.random.default_rng(40 + tq)
    L, b, h, t, d, pos, prefix = 2, 2, 4, 1024, 64, 733, 730
    (k, ks), (v, vs) = (_int8(_rand(rng, L, b, h, t, d), 2) for _ in range(2))
    q = _rand(rng, b, h, tq, d)
    tk = read_bound(t, 896)
    got = emulate_split_decode(q, k, v, 0, [pos] * b, prefix, tk, pos + tq, k_scale=ks,
                               v_scale=vs)
    want = decode_attention_cached_plain(q, k, v, 0, pos, prefix, 896, ks, vs)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_split_merge_equals_jax_decode():
    """Against the JAX package's decode_attention_cached in interpret mode,
    on the cases' layout of tests/test_torch_attention.py."""
    import jax.numpy as jnp

    from moondream_tpu.ops.attention import decode_attention_cached as jax_dec

    rng = np.random.default_rng(12)
    L, b, h, t, d, tq, layer, pos, prefix, kv_bound = 3, 1, 4, 1024, 64, 8, 2, 730, 730, 768
    k = _garbage_past(_rand(rng, L, b, h, t, d), [pos + tq])
    v = _garbage_past(_rand(rng, L, b, h, t, d), [pos + tq])
    q = _rand(rng, b, h, tq, d)
    want = np.asarray(jax_dec(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), layer, pos, prefix,
                              kv_bound=kv_bound, interpret=True))
    tk = read_bound(t, kv_bound)
    got = emulate_split_decode(q, k, v, layer, [pos] * b, prefix, tk, pos + tq)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_workspace_is_keyed_by_device_and_stream():
    """The decode workspace (partials, tickets) belongs to one (device,
    stream): two streams never share one, one stream reuses its own and
    grows it only when a launch needs more."""
    from moondream_tpu_torch.kernels import attention as K

    cpu = torch.device("cpu")
    try:
        a_ws, a_t = K.workspace(cpu, 101, 64, 4)
        b_ws, b_t = K.workspace(cpu, 102, 64, 4)
        assert a_ws.data_ptr() != b_ws.data_ptr() and a_t.data_ptr() != b_t.data_ptr()
        assert int(a_t.abs().sum()) == 0
        again_ws, again_t = K.workspace(cpu, 101, 32, 2)
        assert again_ws is a_ws and again_t is a_t
        grown_ws, grown_t = K.workspace(cpu, 101, 128, 8)
        assert grown_ws.numel() == 128 and grown_t.numel() == 8
        assert K.workspace(cpu, 102, 64, 4)[0] is b_ws
    finally:
        for stream in (101, 102):
            K._WORKSPACE.pop((cpu, stream), None)
