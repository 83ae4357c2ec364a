"""The loops that replay CUDA graphs on the card besides the answer loop,
checked on the CPU against the JAX package's fused loops at the tiny config
in fp32 (exact ids), in a plain and an int8 KV cache:

  * `attn_with_cache` with a (B,) position tensor over a span of 1, 4, 8
    and 16 rows (kernel B's device form; its plain version here) equals the
    host-int form exactly, and JAX's `text_decoder` (hidden states atol
    2e-5 / rtol 1e-4, the same fp32 math summed in another order; int8
    codes and scales to one code step, 1e-5), also where the span's write
    start is clamped to T - Tq as `dynamic_update_slice` clamps it.
  * The speculative loop's device state (`spec_step`) gives JAX's
    `generate_text_spec` ids, count and position: EOS as the first token,
    inside a span and none (the limit), at k 4 and 16; its reads are at
    most ceil(spans / 8) + 1. The sampled loop gives the same ids twice
    from one seed. A GQA model (k 4) and k 24 run on the device state too
    (kernel A's device form), greedy and sampled, graphed and eager: their
    ids equal JAX's `generate_text_spec` and, at top_p 0,
    `generate_text_spec_sampled`, with ceil(spans / 8) + 1 reads.
  * A GQA span of 4 rows and an MHA span of 24 at a device position equal
    the host-int form and JAX's `text_decoder`.
  * The plain token stream replays a graph of one step per token and gives
    the fused loop's ids, one host read per token.
  * The reasoning loop (`reasoning_step`) gives JAX's `generate_reasoning`
    tokens, coordinate flags and values (exact), with and without the
    answer token ending it.
  * The structured loop (`points_step`) gives JAX's `generate_points` (B 1)
    and `generate_points_batched` (B 3, one row EOS at once) boxes and
    counts, with and without sizes, under the peaked oracle (region
    decoders' fc2 bias + N(0, 1) x 50; boxes atol 1e-6: sizes pass through
    exp2, which the libraries round apart by an ulp).
  * A run of each loop, the gaze step and each pool chunk kind reads
    nothing on the host.
  * Under a stand-in capture (graphs replay by rerunning what was
    captured), every loop and every pool chunk kind gives the eager
    results, and the loops replay their graphs.
"""

import dataclasses
import math
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import batched as jax_batched
from moondream_tpu.engine import generate as jax_generate
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import batched as port_batched
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.engine import serving as port_serving
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

ATOL, RTOL = 2e-5, 1e-4
BOX_ATOL = 1e-6
FIRST = 5
EVERY = port_generate.DONE_CHECK_EVERY
# cache formats: (int8 KV cache, KV heads)
FORMATS = {"mha": (False, 2), "kv_int8": (True, 2), "gqa": (False, 1)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _cfgs(fmt):
    kv_int8, n_kv = FORMATS[fmt]
    set_text = lambda c: dataclasses.replace(
        c, text=dataclasses.replace(c.text, kv_int8=kv_int8, n_kv_heads=n_kv))
    return set_text(tiny_test_config()), set_text(port_tiny_config())


@pytest.fixture(scope="module")
def pairs():
    """pairs(fmt) -> (JAX text config, JAX tree, port text, port region,
    port config) on one set of seeded fp32 weights, the region decoders
    peaked (fc2 bias + N(0, 1) x 50)."""
    built = {}

    def build_pair(fmt):
        if fmt not in built:
            jcfg, pcfg = _cfgs(fmt)
            kv_, kt, kr = jax.random.split(jax.random.PRNGKey(3), 3)
            tree = {"vision": jax_vision.init_vision_params(jcfg.vision, kv_, jnp.float32),
                    "text": jax_text.init_text_params(jcfg.text, kt, jnp.float32),
                    "region": jax_region.init_region_params(jcfg.region, kr, jnp.float32)}
            rng = np.random.default_rng(3)
            for site in ("coord_decoder", "size_decoder"):
                b = np.asarray(tree["region"][site]["fc2"]["b"])
                tree["region"][site]["fc2"]["b"] = jnp.asarray(
                    b + rng.standard_normal(b.shape).astype(np.float32) * 50)
            port = params_from_jax(tree, pcfg)
            built[fmt] = jcfg.text, tree, port["text"], port["region"], pcfg
        return built[fmt]

    return build_pair


def _embeds(dim, batch, seed=35):
    return np.random.default_rng(seed).standard_normal((batch, 12, dim)).astype(np.float32)


def _prefill(cfg, tree, model, x, pkv=None):
    """The same 12 embeddings (bidirectional over 8) prefilled into a fresh
    fp32 cache of each package (the port's into `pkv` when given): (JAX
    cache, JAX last hidden (B, D), port cache, port last hidden (B, D))."""
    batch = x.shape[0]
    jkv = jax_text.KVCache.create(cfg, batch=batch, dtype=jnp.float32)
    jh, jkv = jax_text.text_decoder(jnp.asarray(x), tree["text"], jkv, jnp.int32(0),
                                    jnp.int32(8), cfg)
    if pkv is None:
        pkv = port_text.KVCache.create(model.config, batch, torch.float32, "cpu")
    ph = port_text.text_decoder(torch.from_numpy(x), model, pkv, 0, 8)
    return jkv, jh[:, -1], pkv, ph[:, -1]


# ------------------------------------------- attn_with_cache, device spans


def _jax_cache_values(jkv, layer, b, cols, head_dim):
    """(K, V) of JAX's cache at `cols` of batch row b, unpaired and, for an
    int8 cache, dequantized, as (H, n, D) fp32."""
    out = []
    for x, s in ((jkv.k, jkv.ks), (jkv.v, jkv.vs)):
        x = np.asarray(x[layer, b:b + 1]).astype(np.float32)  # (1, H/pf, T, pf * D)
        if s is not None:  # (1, H/pf, 1, T) scales, one per token and cache row
            x = x * np.asarray(s[layer, b:b + 1])[:, :, 0, :, None]
        heads = np.asarray(jax_text.unpair_kv(jnp.asarray(x), x.shape[-1] // head_dim))
        out.append(heads[0][:, cols])
    return out


def _port_cache_values(pkv, layer, b, cols):
    k, v = pkv.k[layer, b][:, cols].float(), pkv.v[layer, b][:, cols].float()
    if pkv.ks is not None:
        k = port_text.dequantize_kv(pkv.k[layer, b][:, cols], pkv.ks[layer, b][:, cols],
                                    torch.float32)
        v = port_text.dequantize_kv(pkv.v[layer, b][:, cols], pkv.vs[layer, b][:, cols],
                                    torch.float32)
    return k.numpy(), v.numpy()


@pytest.mark.parametrize("tq", [1, 4, 8, 16])
@pytest.mark.parametrize("fmt", ["mha", "kv_int8"])
def test_device_position_span_equals_int_form_and_jax(pairs, fmt, tq):
    """A span of tq rows at position 12 after the 12-row prefill, over two
    batch rows: the (B,) position tensor's hidden states and cache writes
    equal the int form's exactly and JAX's within ATOL / RTOL."""
    cfg, tree, model, _, _ = pairs(fmt)
    x = _embeds(cfg.dim, 2)
    span = np.random.default_rng(60 + tq).standard_normal((2, tq, cfg.dim)).astype(np.float32)
    jkv, _, pkv, _ = _prefill(cfg, tree, model, x)
    _, _, pkv2, _ = _prefill(cfg, tree, model, x)
    want, jkv = jax_text.text_decoder(jnp.asarray(span), tree["text"], jkv, jnp.int32(12),
                                      jnp.int32(0), cfg)
    host = port_text.text_decoder(torch.from_numpy(span), model, pkv, 12, 0)
    got = port_text.text_decoder(torch.from_numpy(span), model, pkv2,
                                 torch.full((2,), 12, dtype=torch.int32), 0)
    torch.testing.assert_close(got, host, rtol=0, atol=0)
    for a, b in zip((pkv.k, pkv.v, pkv.ks, pkv.vs), (pkv2.k, pkv2.v, pkv2.ks, pkv2.vs)):
        assert a is None or torch.equal(a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    cols = np.arange(12, 12 + tq)
    atol = 1e-5 if fmt == "kv_int8" else ATOL
    for layer in range(cfg.n_layers):
        for b in range(2):
            for p, j in zip(_port_cache_values(pkv2, layer, b, cols),
                            _jax_cache_values(jkv, layer, b, cols, cfg.head_dim)):
                np.testing.assert_allclose(p, j, atol=atol, rtol=RTOL)


@pytest.mark.parametrize("fmt", ["mha", "kv_int8"])
def test_device_span_write_clamps_at_the_cache_end(pairs, fmt):
    """A span of 8 rows whose device position is 4 slots from the end of a
    cache of T slots writes at T - 8 .. T - 1 (RoPE rows past the table
    clamped to its last), as JAX's dynamic_update_slice and gather clamp
    them: the cache and the hidden states equal JAX's."""
    cfg, tree, model, _, _ = pairs(fmt)
    t, tq = cfg.max_context, 8
    pos = t - 4
    span = np.random.default_rng(9).standard_normal((1, tq, cfg.dim)).astype(np.float32)
    jkv, _, pkv, _ = _prefill(cfg, tree, model, _embeds(cfg.dim, 1))
    want, jkv = jax_text.text_decoder(jnp.asarray(span), tree["text"], jkv, jnp.int32(pos),
                                      jnp.int32(0), cfg)
    got = port_text.text_decoder(torch.from_numpy(span), model, pkv,
                                 torch.full((1,), pos, dtype=torch.int32), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    cols = np.arange(t - 16, t)
    atol = 1e-5 if fmt == "kv_int8" else ATOL
    for layer in range(cfg.n_layers):
        for p, j in zip(_port_cache_values(pkv, layer, 0, cols),
                        _jax_cache_values(jkv, layer, 0, cols, cfg.head_dim)):
            np.testing.assert_allclose(p, j, atol=atol, rtol=RTOL)
    assert pkv.k[:, :, :, t - tq:].abs().sum() > 0


def test_device_span_refuses_gqa_and_long_spans(pairs):
    """A device position no longer refuses a GQA span (4 rows) or one of
    more than 16 rows (24, MHA): both take kernel A's device form (its
    plain version here), as JAX routes them at a traced position. Hidden
    states and cache writes equal the host-int form's exactly and JAX's
    within ATOL / RTOL. (The name predates the device route; it is kept.)"""
    for fmt, tq in (("gqa", 4), ("mha", 24)):
        cfg, tree, model, _, _ = pairs(fmt)
        x = _embeds(cfg.dim, 1)
        span = np.random.default_rng(70 + tq).standard_normal((1, tq, cfg.dim)).astype(
            np.float32)
        jkv, _, pkv, _ = _prefill(cfg, tree, model, x)
        _, _, pkv2, _ = _prefill(cfg, tree, model, x)
        want, _ = jax_text.text_decoder(jnp.asarray(span), tree["text"], jkv, jnp.int32(12),
                                        jnp.int32(0), cfg)
        host = port_text.text_decoder(torch.from_numpy(span), model, pkv, 12, 0)
        got = port_text.text_decoder(torch.from_numpy(span), model, pkv2,
                                     torch.full((1,), 12, dtype=torch.int32), 0)
        torch.testing.assert_close(got, host, rtol=0, atol=0)
        assert torch.equal(pkv.k, pkv2.k) and torch.equal(pkv.v, pkv2.v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------ speculative loop


def _jax_spec(cfg, tree, k, max_tokens, eos):
    fn = jax.jit(partial(jax_generate.generate_text_spec, config=cfg, eos_id=eos,
                         suppress_ids=(), buffer=cfg.max_context, spec_k=k))
    kv = jax_text.KVCache.create(cfg, batch=1, dtype=jnp.float32)
    r = fn(tree["text"], kv, jnp.int32(FIRST), jnp.int32(0), jnp.int32(max_tokens))
    n = int(r.count)
    return [int(t) for t in np.asarray(r.tokens[:n])], n, int(r.pos)


def _port_spec(model, k, max_tokens, eos, **kw):
    kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")
    r = port_generate.generate_text_spec(model, kv, torch.tensor(FIRST), 0, max_tokens, eos,
                                         (), k, **kw)
    return r.tokens, r.count, r.pos


@pytest.fixture(scope="module")
def free_spec(pairs):
    """The port's plain greedy run of 24 tokens from FIRST, per format."""
    runs = {}

    def run(fmt):
        if fmt not in runs:
            _, _, model, _, _ = pairs(fmt)
            kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")
            runs[fmt] = port_generate.generate_text(model, kv, torch.tensor(FIRST), 0, None,
                                                    0.0, 0.0, 24, -1, ()).tokens
        return runs[fmt]

    return run


@pytest.mark.parametrize("case", ["first", "inside", "limit"])
@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("fmt", ["mha", "kv_int8"])
def test_spec_loop_matches_jax(pairs, free_spec, fmt, k, case):
    """EOS as the first token (nothing emitted), at the first occurrence of
    the plain run's token 13 (inside a span), or none: 24 tokens, the
    limit. Ids, count and position equal JAX's; reads <= ceil(spans / 8) + 1."""
    cfg, tree, model, _, _ = pairs(fmt)
    free = free_spec(fmt)
    eos = {"first": FIRST, "inside": free[13], "limit": -1}[case]
    want = _jax_spec(cfg, tree, k, 24, eos)
    port_generate.reset_loop_counts()
    got = _port_spec(model, k, 24, eos)
    assert got == want
    n = free.index(eos) if case != "limit" else 24
    assert got[0] == free[:n]
    c = port_generate.LOOP_COUNTS["generate_text_spec"]
    assert c["calls"] == 1 and c["reads"] <= math.ceil(c["steps"] / EVERY) + 1
    if case == "first":
        assert c == {"calls": 1, "steps": 0, "reads": 1}


def test_sampled_spec_loop_repeats_from_one_seed(pairs):
    _, _, model, _, _ = pairs("mha")
    outs = []
    for _ in range(2):
        kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")
        r = port_generate.generate_text_spec_sampled(
            model, kv, torch.tensor(FIRST), 0, torch.Generator().manual_seed(4), 0.8, 0.9, 30,
            -1, (), 4)
        outs.append(r)
    assert outs[0] == outs[1] and outs[0].count == 30


@pytest.fixture(scope="module")
def jax_spec_ids(pairs):
    """JAX's speculative ids from FIRST at position 0 (eos -1), one jit per
    (format, k, kind), kept: greedy `generate_text_spec`, or
    `generate_text_spec_sampled` at top_p 0, where the target is one-hot at
    the argmax and the ids are the greedy ones whatever the key."""
    done = {}

    def get(fmt, k, max_tokens, sampled=False):
        if (fmt, k, max_tokens, sampled) not in done:
            cfg, tree, _, _, _ = pairs(fmt)
            kw = dict(config=cfg, eos_id=-1, suppress_ids=(), buffer=cfg.max_context, spec_k=k)
            kv = jax_text.KVCache.create(cfg, batch=1, dtype=jnp.float32)
            if sampled:
                fn = jax.jit(partial(jax_generate.generate_text_spec_sampled, **kw))
                r = fn(tree["text"], kv, jnp.int32(FIRST), jnp.int32(0), jax.random.PRNGKey(1),
                       jnp.float32(0.7), jnp.float32(0.0), jnp.int32(max_tokens))
            else:
                fn = jax.jit(partial(jax_generate.generate_text_spec, **kw))
                r = fn(tree["text"], kv, jnp.int32(FIRST), jnp.int32(0), jnp.int32(max_tokens))
            done[fmt, k, max_tokens, sampled] = np.asarray(r.tokens[:int(r.count)]).tolist()
        return done[fmt, k, max_tokens, sampled]

    return get


# GQA spans, and spans of more than 16 rows: kernel A's device form
LONG_OR_GQA = [("gqa", 4), ("mha", 24)]


@pytest.mark.parametrize("fmt,k", LONG_OR_GQA)
def test_spec_on_gqa_or_long_spans_takes_the_eager_route(pairs, free_spec, jax_spec_ids, fmt,
                                                         k):
    """GQA spans, and spans of more than 16 rows, no longer take an eager
    route: the loop runs on its device state (`spec_step`) as every other,
    under "generate_text_spec", reading the host ceil(spans / 8) + 1 times;
    its ids equal JAX's generate_text_spec and the plain greedy ones. (The
    name predates the device route; it is kept.)"""
    _, _, model, _, _ = pairs(fmt)
    free, want = free_spec(fmt), jax_spec_ids(fmt, k, 24)
    port_generate.reset_loop_counts()
    got = _port_spec(model, k, 24, -1)
    assert got[0] == want == free
    assert list(port_generate.LOOP_COUNTS) == ["generate_text_spec"]
    c = port_generate.LOOP_COUNTS["generate_text_spec"]
    assert c["calls"] == 1 and c["reads"] == math.ceil(c["steps"] / EVERY) + 1


# ---------------------------------------------------------- reasoning loop


@pytest.fixture(scope="module")
def reasoning_case(pairs):
    """Per format: the prefill's last hidden state and cache, and a
    coordinate id the free reasoning run meets early (its token 2)."""
    built = {}

    def get(fmt):
        if fmt not in built:
            cfg, tree, model, region, _ = pairs(fmt)
            _, _, pkv, ph = _prefill(cfg, tree, model, _embeds(cfg.dim, 1, seed=36))
            free = port_generate.generate_reasoning(
                model, region, pkv, torch.tensor(FIRST), ph[0], 12, None, 0.0, 0.0, 8, -1, -1,
                ())
            built[fmt] = free.tokens[2]
        return built[fmt]

    return get


@pytest.mark.parametrize("case", ["limit", "answer"])
@pytest.mark.parametrize("fmt", ["mha", "kv_int8"])
def test_reasoning_loop_matches_jax(pairs, reasoning_case, fmt, case):
    """20 steps (8 + 8 + 4) with the coordinate branch taken, or ended by
    the answer token at the first occurrence of the run's token 10."""
    cfg, tree, model, region, _ = pairs(fmt)
    coord_id = reasoning_case(fmt)
    x = _embeds(cfg.dim, 1, seed=36)

    def run(answer_id):
        jkv, jh, pkv, ph = _prefill(cfg, tree, model, x)
        want = jax_generate.generate_reasoning(
            tree["text"], tree["region"], jkv, jnp.int32(FIRST), jh[0], jnp.int32(12),
            jax.random.PRNGKey(0), jnp.float32(0.0), jnp.float32(0.0), jnp.int32(20), cfg,
            answer_id, coord_id, (), 64)
        port_generate.reset_loop_counts()
        got = port_generate.generate_reasoning(model, region, pkv, torch.tensor(FIRST), ph[0],
                                               12, None, 0.0, 0.0, 20, answer_id, coord_id, ())
        n = int(want.count)
        assert got.count == n and got.pos == int(want.pos)
        assert got.tokens == np.asarray(want.tokens[:n]).tolist()
        assert got.is_coord == np.asarray(want.is_coord[:n]).tolist()
        np.testing.assert_array_equal(np.float32(got.coord_vals),
                                      np.asarray(want.coord_vals[:n]))
        c = port_generate.LOOP_COUNTS["generate_reasoning"]
        assert c["reads"] <= math.ceil(c["steps"] / EVERY) + 1
        return got

    free = run(-1)
    assert free.count == 20 and any(free.is_coord)
    if case == "answer":
        answer = free.tokens[10]
        got = run(answer)
        assert got.count == free.tokens.index(answer) < 20


# --------------------------------------------------------- structured loop


@pytest.mark.parametrize("include_size", [True, False], ids=["boxes", "points"])
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("fmt", ["mha", "kv_int8"])
def test_points_loop_matches_jax(pairs, fmt, bsz, include_size):
    """Up to 5 objects from position 12 (15 or 10 steps: a full run of 8,
    then one of 7 or 2 starting at phase 8 % steps_per_object), eos -1; at
    B 3 row 1's first token is EOS. Boxes and counts equal JAX's
    generate_points / generate_points_batched."""
    cfg, tree, model, region, _ = pairs(fmt)
    jkv, jh, pkv, ph = _prefill(cfg, tree, model, _embeds(cfg.dim, bsz, seed=40))
    first = np.array([3, -1, 5][:bsz], np.int32)
    kw = dict(config=cfg, eos_id=-1, include_size=include_size, max_objects=5)
    if bsz == 1:
        r = jax_generate.generate_points(tree["text"], tree["region"], jkv, jh[0],
                                         jnp.int32(first[0]), jnp.int32(12), **kw)
        want_boxes, want_counts = np.asarray(r.boxes)[None], [int(r.count)]
    else:
        r = jax_batched.generate_points_batched(tree["text"], tree["region"], jkv, jh,
                                                jnp.asarray(first), jnp.int32(12), **kw)
        want_boxes, want_counts = np.asarray(r.boxes), np.asarray(r.counts).tolist()
    port_generate.reset_loop_counts()
    got = port_generate.points_loop(model, region, pkv, ph, torch.from_numpy(first), 12, -1,
                                    include_size, 5, None, "test")
    assert got.counts == want_counts == [5, 0, 5][:bsz]
    for b, n in enumerate(want_counts):
        np.testing.assert_allclose(got.boxes[b, :n], want_boxes[b, :n], atol=BOX_ATOL, rtol=0)
    c = port_generate.LOOP_COUNTS["test"]
    assert c["reads"] <= math.ceil(c["steps"] / EVERY) + 1


# --------------------------------------------------- no host read in a run

HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.fixture
def no_host_reads(monkeypatch):
    """patch(): from then on, a tensor method that reads a value to the
    host raises (until monkeypatch.undo())."""
    def patch():
        for name in HOST_READS:
            def raiser(self, *a, _name=name, **k):
                raise AssertionError(f"host read Tensor.{_name} inside a run")
            monkeypatch.setattr(torch.Tensor, name, raiser)
    return patch


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_a_spec_run_reads_nothing_on_the_host(pairs, no_host_reads, monkeypatch, sampled):
    _, _, model, _, _ = pairs("kv_int8")
    kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")
    st, run = port_generate.spec_loop(
        model, kv, torch.tensor(FIRST), 0, 100, -1, (3,), 4, 256, torch.tensor([-1, 5, 6]),
        torch.Generator().manual_seed(0), 0.7 if sampled else 0.0, 0.9, True, "test")
    no_host_reads()
    run(EVERY)
    monkeypatch.undo()
    assert 8 <= st.count.item() <= 32 and st.pos.item() == st.count.item()
    assert st.run_m.sum().item() == st.count.item()


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("fmt,k", LONG_OR_GQA)
def test_gqa_and_long_span_spec_runs_read_nothing_on_the_host(pairs, no_host_reads,
                                                              monkeypatch, fmt, k, sampled):
    _, _, model, _, _ = pairs(fmt)
    kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")
    st, run = port_generate.spec_loop(
        model, kv, torch.tensor(FIRST), 0, 100, -1, (3,), k, 256, None,
        torch.Generator().manual_seed(0), 0.7 if sampled else 0.0, 0.9, True, "test")
    no_host_reads()
    run(EVERY)
    monkeypatch.undo()
    assert 8 <= st.count.item() <= 8 * k and st.pos.item() == st.count.item()


def test_reasoning_and_structured_runs_read_nothing_on_the_host(pairs, no_host_reads,
                                                                monkeypatch):
    cfg, tree, model, region, _ = pairs("mha")
    _, _, pkv, ph = _prefill(cfg, tree, model, _embeds(cfg.dim, 3))
    _, _, pkv1, ph1 = _prefill(cfg, tree, model, _embeds(cfg.dim, 1))
    st, run = port_generate.graphs.loop(
        model, None, lambda: port_generate.ReasoningState.create(ph1, (3,), False),
        lambda st, j: port_generate.reasoning_step(model, region, pkv1, st, j, -1, 9, 256,
                                                   None),
        EVERY, False, "test")
    st.reset(torch.tensor(9), ph1[0], 12, -1, 0.0, 0.0)
    pts, prun = port_generate.graphs.loop(
        model, None, lambda: port_generate.PointsState.create(ph, 8),
        lambda s, t: port_generate.points_step(model, region, pkv, s, t % 3, -1, True, 8, 256),
        EVERY, False, "test")
    pts.reset(ph, torch.tensor([3, 4, 5]), 12, -1)
    gaze = port_generate.GazeState(ph.clone(), torch.zeros(3), torch.zeros(3),
                                   torch.full((3,), 12, dtype=torch.int32))
    no_host_reads()
    run(EVERY)
    for phase in (0, 2, 1):
        prun(EVERY, phase)
    port_generate.gaze_step(model, region, pkv, gaze, 256)
    monkeypatch.undo()
    assert st.count.item() == 8 and bool(st.run_coord[0, 0])
    assert pts.n.tolist() == [8, 8, 8] and pts.pos.tolist() == [36] * 3


@pytest.mark.parametrize("kind", ["serve_chunk_spec", "serve_chunk_spec_sampled",
                                  "serve_chunk_mixed", "serve_chunk_mixed_spec"])
def test_spec_and_mixed_chunks_read_nothing_on_the_host(pairs, no_host_reads, monkeypatch,
                                                        kind):
    _, _, model, region, pcfg = pairs("mha")
    S = 4
    kv = port_text.KVCache.create(model.config, S, torch.float32, "cpu", 256)
    state = (kv, torch.tensor([5, 300, 17, 400], dtype=torch.int32),
             torch.tensor([0, 12, 40, 100], dtype=torch.int32),
             torch.tensor([True, True, False, True]),
             torch.tensor([20, 3, 0, 20], dtype=torch.int32))
    hist = torch.zeros((S, 257), dtype=torch.int32)
    hist_cnt = torch.tensor([1, 5, 0, 9], dtype=torch.int32)
    struct = (torch.tensor([0, 1, 0, 1], dtype=torch.int32), torch.randn(S, pcfg.text.dim),
              torch.tensor([3, 4, 0, 5], dtype=torch.int32), torch.zeros(S), torch.zeros(S),
              torch.zeros(S, 5, 4), torch.zeros(S, dtype=torch.int32),
              torch.tensor([False, True, False, False]))
    kw = dict(eos_id=-1, suppress_ids=(3,), kv_bound=256)
    gen = torch.Generator().manual_seed(0)
    no_host_reads()
    if kind == "serve_chunk_spec":
        res = port_serving.serve_chunk_spec(model, *state, hist, hist_cnt, n_iter=8, spec_k=4,
                                            **kw)
    elif kind == "serve_chunk_spec_sampled":
        res = port_serving.serve_chunk_spec_sampled(model, *state, hist, hist_cnt, gen, 0.7,
                                                    0.9, n_iter=8, spec_k=4, **kw)
    elif kind == "serve_chunk_mixed":
        res = port_serving.serve_chunk_mixed(model, region, *state, gen, 0.0, 0.0, *struct,
                                             chunk=8, max_objects=5, **kw)
    else:
        res = port_serving.serve_chunk_mixed_spec(model, region, *state, hist, hist_cnt,
                                                  *struct, n_iter=8, spec_k=4, max_objects=5,
                                                  **kw)
    monkeypatch.undo()
    assert res.emitted.sum().item() > 0


# ------------------------------------------------- graphed equals eager


class _RerunGraph:
    """A stand-in CUDA graph: a replay reruns what was captured and writes
    its tensors into the captured outputs, as a replay rewrites them."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        res = self.fn()
        if self.out is not None:
            for o, r in zip(self.out, res):
                if isinstance(o, torch.Tensor):
                    o.copy_(r)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Graphs on the CPU: graphs.enabled() is true and capture() runs the
    warm-up, then 'captures' by recording fn."""
    captured = []

    def capture(cache, fn, label, generator=None):
        first = fn()
        out = None if first is None else type(first)(
            *(t.clone() if isinstance(t, torch.Tensor) else t for t in first))
        captured.append(label)
        return graphs.StepGraph(_RerunGraph(fn, out), {}, label, ()), first, out

    monkeypatch.setattr(graphs, "enabled", lambda dev: True)
    monkeypatch.setattr(graphs, "capture", capture)
    graphs.reset_graph_counts()
    return captured


def test_graphed_loops_equal_eager(pairs, stand_in_graphs):
    """Each loop through the graph path, twice on the same caches (the
    second call finds the first one's graphs and only replays), against
    its eager run: the spec loop greedy (40 tokens) and sampled from one
    seed, the reasoning loop (20 steps), the structured loop at B 1 and B 3
    with and without sizes (5 objects: a full run and a shorter one) and
    the gaze step."""
    captured = stand_in_graphs
    cfg, tree, model, region, _ = pairs("mha")
    x1, x3 = _embeds(cfg.dim, 1, seed=36), _embeds(cfg.dim, 3, seed=40)
    caches = {}
    gen = torch.Generator()  # one generator, as a model's: one sampled key

    def loops(graphed):
        _, _, kv1, h1 = _prefill(cfg, tree, model, x1, caches.get(1))
        _, _, kv3, h3 = _prefill(cfg, tree, model, x3, caches.get(3))
        spec_kv = caches.get("spec") or port_text.KVCache.create(model.config, 1,
                                                                  torch.float32, "cpu")
        if graphed:
            caches.update({1: kv1, 3: kv3, "spec": spec_kv})
        out = []
        for sampled in (False, True):
            gen.manual_seed(5)
            out.append(port_generate._fused_spec(
                model, spec_kv, torch.tensor(FIRST), 0, 40, -1, (), 4, None, None, gen,
                0.7 if sampled else 0.0, 0.9, graphed))
        out.append(port_generate.generate_reasoning(
            model, region, kv1, torch.tensor(FIRST), h1[0], 12, None, 0.0, 0.0, 20, -1, 9, (),
            graphed=graphed))
        for kv, h, first in ((kv1, h1, [3]), (kv3, h3, [3, -1, 5])):
            for size in (True, False):
                r = port_generate.points_loop(model, region, kv, h, torch.tensor(first), 12, -1,
                                              size, 5, None, "points", graphed)
                out.append((r.boxes.tolist(), r.counts))
        out.append(port_generate.gaze_points_batched(model, region, kv3, h3,
                                                     torch.tensor([3, 7, 5]), 12, 256, graphed))
        return out

    eager = loops(False)
    assert captured == []
    first = loops(True)
    n_captured = len(captured)
    replays = dict(graphs.REPLAYS)
    second = loops(True)
    assert first == second == eager
    assert len(captured) == n_captured  # the second call found every graph
    # points, per batch: boxes run 8 steps from phase 0 and a 7-step tail
    # from phase 2, points 8 from phase 0 and a 2-step tail: four graphs,
    # each captured in the first call and replayed in the second
    assert captured.count("points") == 2 * 4
    assert graphs.REPLAYS["points"] - replays.get("points", 0) == 2 * 4
    assert graphs.REPLAYS["gaze_points_batched"] == 1 and captured.count(
        "gaze_points_batched") == 1
    for label in ("generate_text_spec", "generate_text_spec_sampled", "generate_reasoning"):
        assert graphs.REPLAYS[label] > replays.get(label, 0) > 0 or (
            graphs.REPLAYS[label] >= 1 and label in captured)


@pytest.mark.parametrize("fmt,k", LONG_OR_GQA)
def test_gqa_and_long_span_spec_graphed_equals_eager(pairs, stand_in_graphs, jax_spec_ids,
                                                     fmt, k):
    """The GQA k 4 and MHA k 24 speculative loops through the graph path,
    twice (the second call only replays), against their eager runs: greedy
    (40 tokens: five runs of 8 spans would pass the limit, so a shorter
    last run is eager), sampled at top_p 0.9 from one seed, and sampled at
    top_p 0, whose ids are JAX's generate_text_spec_sampled's. The fused
    loops read ceil(spans / 8) + 1 times, and graphs replay."""
    captured = stand_in_graphs
    _, _, model, _, _ = pairs(fmt)
    kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")
    gen = torch.Generator()

    def loops(graphed):
        out = []
        for temperature, top_p in ((0.0, 0.0), (0.7, 0.9), (0.7, 0.0)):
            gen.manual_seed(5)
            port_generate.reset_loop_counts()
            out.append(port_generate._fused_spec(
                model, kv, torch.tensor(FIRST), 0, 40, -1, (), k, None, None, gen,
                temperature, top_p, graphed).tokens)
            (c,) = port_generate.LOOP_COUNTS.values()
            assert c["reads"] == math.ceil(c["steps"] / EVERY) + 1
        return out

    eager = loops(False)
    assert captured == []
    replays = dict(graphs.REPLAYS)
    assert loops(True) == loops(True) == eager
    assert eager[0] == jax_spec_ids(fmt, k, 40) == eager[2] == jax_spec_ids(fmt, k, 40, True)
    for label in ("generate_text_spec", "generate_text_spec_sampled"):
        assert label in captured and graphs.REPLAYS[label] > replays.get(label, 0)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_stream_replays_one_step_and_equals_the_fused_loop(pairs, free_spec, stand_in_graphs,
                                                            sampled):
    """stream_tokens through the graph path (a graph of one answer_step,
    label "stream", captured once and replayed per token) and eagerly, both
    equal to the fused generate_text from one seed, with the plain greedy
    run's token 13 as EOS: one host read per token, plus the read that
    finds EOS if one does (the greedy stream stops at its first
    occurrence)."""
    captured = stand_in_graphs
    _, _, model, _, _ = pairs("mha")
    free = free_spec("mha")
    eos = free[13]
    gen = torch.Generator()
    temperature = 0.7 if sampled else 0.0
    kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")

    def run(kind):
        gen.manual_seed(6)
        port_generate.reset_loop_counts()
        args = (model, kv, torch.tensor(FIRST), 0, gen, temperature, 0.9, 40, eos, (), 256)
        if kind == "fused":
            return port_generate.generate_text(*args, graphed=False).tokens
        return list(port_generate.stream_tokens(*args, graphed=kind == "graphed"))

    fused = run("fused")
    eager = run("eager")
    n = len(eager)
    assert port_generate.LOOP_COUNTS["stream"] == {"calls": 1, "steps": n,
                                                   "reads": n + (n < 40)}
    assert captured == []
    assert run("graphed") == run("graphed") == eager == fused
    assert captured == ["stream"] and graphs.REPLAYS["stream"] == 2 * n - 1
    if not sampled:
        assert fused == free[:free.index(eos)]


@pytest.fixture(scope="module")
def moondream(pairs):
    _, tree, _, _, pcfg = pairs("mha")
    return MoondreamModel(pcfg, params_from_jax(tree, pcfg), IdTokenizer(), torch.float32,
                          device="cpu")


@pytest.mark.parametrize("kind", ["spec", "spec_sampled", "mixed", "mixed_spec"])
def test_graphed_pool_chunks_equal_eager(moondream, stand_in_graphs, kind):
    """A pool of 8 slots (8-step chunks) serving four text requests (and,
    for the mixed kinds, a detect, a point and a gaze request) through the
    graph path gives the eager pool's results; one capture per chunk key,
    later chunks replays."""
    captured = stand_in_graphs
    model = moondream
    image = np.random.default_rng(5).integers(0, 255, (378, 378, 3), dtype=np.uint8)
    enc = model.encode_image(image)
    spec = 4 if "spec" in kind else 0
    sampled = kind == "spec_sampled"
    results = []
    for graphed in (False, True):
        model.generator.manual_seed(0)
        eng = ContinuousBatchingEngine(model, n_slots=8, slot_len=800, chunk=8,
                                       speculative=spec, max_objects=4, graphed=graphed,
                                       temperature=0.7 if sampled else 0.0, top_p=0.9,
                                       eos_id=None if "mixed" in kind else -1)
        rids = [eng.submit(enc, question=q, max_tokens=n) for q, n in
                ((None, 10), ("Why?", 20), (None, 3), ("What?", 17))]
        if "mixed" in kind:
            rids += [eng.submit_detect(enc, "x"), eng.submit_point(enc, "x"),
                     eng.submit_gaze(enc, (0.4, 0.3))]
        out = eng.drain()
        results.append([out[r] for r in rids])
    assert results[0] == results[1]
    label = {"spec": "serve_chunk_spec", "spec_sampled": "serve_chunk_spec_sampled",
             "mixed": "serve_chunk_mixed", "mixed_spec": "serve_chunk_mixed_spec"}[kind]
    assert captured[0] == label and graphs.REPLAYS.get(label, 0) >= 1
