"""The port's graphed decode paths, checked on the CPU: the capturable step
functions that CUDA graphs replay on the card (engine/graphs.py), run
eagerly here, against the JAX package's fused loops, at the tiny config in
fp32 (exact ids).

  * `generate_text` (its `answer_step` runs) gives JAX's `generate_text`
    ids, count and position for a plain fp32 cache, int4 text blocks with
    an int8 KV cache, GQA (one KV head) and GQA with an int8 cache, with
    EOS at emitted token 0, 1, 7, 8 and 9, at the limit (8: one whole run)
    and with a partial last run (limit 10: 8 + 2 steps); it reads the
    device once per run plus once. `generate_text_batched` (the same step
    at 3 rows) gives JAX's lockstep loop's tokens and counts, MHA and GQA.
  * `decode_attention_cached` with a (B,) position tensor (kernel B's
    device form; its plain version on the CPU) equals its int form and
    JAX's `decode_attention_cached` (interpret mode) at random and diagonal
    queries, for a plain, an int8 and a GQA cache: atol 2e-5 / rtol 1e-4
    (the JAX suite's own: the same fp32 math summed in another order; int8
    atol 1e-5, as tests/test_torch_kv_int8.py).
  * One run of the answer step (batch 1 and lockstep) and one pool chunk
    complete with the tensor methods that read the host patched to raise.
  * Replay accounting: a graph's captured launches are added once per
    replay (a stub graph). With a stand-in capture (its graph replays by
    running the captured function), the graphed loop and pool paths give
    the eager ids, reuse their static state across calls, and count
    replays.
  * `compile()` returns the model, and what follows equals the output of a
    model that never compiled.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import batched as jax_batched
from moondream_tpu.engine import generate as jax_generate
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.text import pair_kv
from moondream_tpu.ops.attention import decode_attention_cached as jax_decode_cached
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import batched as port_batched
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.engine import serving as port_serving
from moondream_tpu_torch.kernels import build
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.ops.attention import decode_attention_cached
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import init_params, params_from_jax

ATOL, RTOL = 2e-5, 1e-4
SUPPRESS = (3,)
FIRST = 300
# cache formats: (int4 text blocks, int8 KV cache, KV heads)
FORMATS = {
    "mha": (False, False, 2),
    "int4+kv_int8": (True, True, 2),
    "gqa": (False, False, 1),
    "gqa+kv_int8": (False, True, 1),
}
# EOS at emitted token k of a free greedy run whose 12 ids are distinct,
# or no EOS and the limit (max_tokens): one whole run, or 8 + 2 steps
EOS_AT = [0, 1, 7, 8, 9, "limit8", "limit10"]
# per format, a seed of the prefilled embeddings whose free run has 12
# distinct ids (so that EOS at token k stops the loop there)
EMBED_SEED = {"mha": 35, "int4+kv_int8": 36, "gqa": 47, "gqa+kv_int8": 47}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(fmt):
    _, kv_int8, n_kv = FORMATS[fmt]
    set_text = lambda c: dataclasses.replace(
        c, text=dataclasses.replace(c.text, kv_int8=kv_int8, n_kv_heads=n_kv))
    return set_text(tiny_test_config()), set_text(port_tiny_config())


@pytest.fixture(scope="module")
def pairs():
    """pairs(fmt) -> (JAX config, JAX text tree, port TextModel) on one set
    of seeded fp32 weights (int4 blocks quantized by the JAX package and
    carried over with the same codes)."""
    built = {}

    def build_pair(fmt):
        if fmt not in built:
            int4 = FORMATS[fmt][0]
            jcfg, pcfg = _cfgs(fmt)
            text = jax_text.init_text_params(jcfg.text, jax.random.PRNGKey(3), jnp.float32)
            if int4:
                text = jax_text.quantize_text_params(text)
            vision = jax_vision.init_vision_params(jcfg.vision, jax.random.PRNGKey(4),
                                                   jnp.float32)
            tree = {"vision": vision, "text": text}
            built[fmt] = jcfg.text, text, params_from_jax(tree, pcfg)["text"]
        return built[fmt]

    return build_pair


def _prefill(cfg, tree, model, x, batch, pkv=None):
    """The same 12 random embeddings (bidirectional over 8) prefilled into
    a fresh fp32 cache of each package (the port's into `pkv` when given)."""
    jkv = jax_text.KVCache.create(cfg, batch=batch, dtype=jnp.float32)
    _, jkv = jax_text.text_decoder(jnp.asarray(x), tree, jkv, jnp.int32(0), jnp.int32(8), cfg)
    if pkv is None:
        pkv = port_text.KVCache.create(model.config, batch, torch.float32, "cpu")
    port_text.text_decoder(torch.from_numpy(x), model, pkv, 0, 8)
    return jkv, pkv


def _embeds(cfg, batch, seed=35):
    return np.random.default_rng(seed).standard_normal((batch, 12, cfg.dim)).astype(np.float32)


@pytest.fixture(scope="module")
def free_runs(pairs):
    """JAX's free greedy run (no EOS) of 12 tokens per format: EOS at token
    k then ends JAX's loop after k tokens, at position 12 + k."""
    runs = {}

    def run(fmt):
        if fmt not in runs:
            cfg, tree, _ = pairs(fmt)
            jkv, _ = _prefill(cfg, tree, pairs(fmt)[2], _embeds(cfg, 1, EMBED_SEED[fmt]), 1)
            res = jax_generate.generate_text(
                tree, jkv, jnp.int32(FIRST), jnp.int32(12), jax.random.PRNGKey(0),
                jnp.float32(0.0), jnp.float32(0.0), jnp.int32(12), cfg, -1, SUPPRESS, 64)
            runs[fmt] = np.asarray(res.tokens)[:int(res.count)].tolist()
        return runs[fmt]

    return run


@pytest.mark.parametrize("at", EOS_AT, ids=[str(a) for a in EOS_AT])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_answer_steps_match_jax_generate_text(pairs, free_runs, fmt, at):
    cfg, tree, model = pairs(fmt)
    free = free_runs(fmt)
    assert len(set(free)) == len(free) == 12
    max_tokens = int(at[5:]) if isinstance(at, str) else 12
    eos = free[at] if isinstance(at, int) else -1
    n = at if isinstance(at, int) else max_tokens
    want = (free[:n], n, 12 + n)
    if at in (8, "limit10"):  # JAX's own loop with this EOS and limit
        jkv, _ = _prefill(cfg, tree, model, _embeds(cfg, 1, EMBED_SEED[fmt]), 1)
        res = jax_generate.generate_text(
            tree, jkv, jnp.int32(FIRST), jnp.int32(12), jax.random.PRNGKey(0),
            jnp.float32(0.0), jnp.float32(0.0), jnp.int32(max_tokens), cfg, eos, SUPPRESS, 64)
        assert (np.asarray(res.tokens)[:int(res.count)].tolist(), int(res.count),
                int(res.pos)) == want

    _, pkv = _prefill(cfg, tree, model, _embeds(cfg, 1, EMBED_SEED[fmt]), 1)
    port_generate.reset_loop_counts()
    res = port_generate.generate_text(model, pkv, torch.tensor(FIRST), 12, None, 0.0, 0.0,
                                      max_tokens, eos, SUPPRESS)
    assert (res.tokens, res.count, res.pos) == want
    c = port_generate.LOOP_COUNTS["generate_text"]
    assert c["steps"] == port_batched.batched_steps(n, max_tokens)
    assert c["reads"] == math.ceil(c["steps"] / port_generate.DONE_CHECK_EVERY) + 1


@pytest.mark.parametrize("case", ["mid", "none"])
@pytest.mark.parametrize("fmt", ["mha", "gqa"])
def test_lockstep_steps_match_jax(pairs, fmt, case):
    """Three rows from first tokens (5, 300, 17), up to 10 tokens: EOS at
    a token one row emits mid-way, or none (8 + 2 steps)."""
    cfg, tree, model = pairs(fmt)
    x = _embeds(cfg, 3, seed=11)
    first = np.asarray([5, 300, 17], np.int32)

    def run_jax(eos):
        jkv, _ = _prefill(cfg, tree, model, x, 3)
        res = jax_batched.generate_text_batched(
            tree, jkv, jnp.asarray(first), jnp.int32(12), jax.random.PRNGKey(0),
            jnp.float32(0.0), jnp.float32(0.0), jnp.int32(10), cfg, eos, SUPPRESS, 64)
        steps = int(res.pos) - 12
        return np.asarray(res.tokens)[:, :steps], np.asarray(res.counts)

    free, _ = run_jax(-1)
    eos = int(free[1, 4]) if case == "mid" else -1
    want_tokens, want_counts = run_jax(eos) if case == "mid" else (free, _)
    _, pkv = _prefill(cfg, tree, model, x, 3)
    port_generate.reset_loop_counts()
    res = port_batched.generate_text_batched(model, pkv, torch.from_numpy(first), 12, None,
                                             0.0, 0.0, 10, eos, SUPPRESS)
    width = want_tokens.shape[1]
    np.testing.assert_array_equal(res.tokens.numpy()[:, :width], want_tokens)
    assert not res.tokens[:, width:].any()
    np.testing.assert_array_equal(res.counts.numpy(), want_counts)
    steps = port_batched.batched_steps(int(want_counts.max()), 10)
    assert res.pos == 12 + steps
    c = port_generate.LOOP_COUNTS["generate_text_batched"]
    assert c["steps"] == steps and c["reads"] <= math.ceil(steps / 8) + 1


# ------------------------------------------------ kernel B's device form


def _normal(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _garbage_after(x, end):
    x[..., end:, :] *= 1000
    return x


@pytest.mark.parametrize("query", ["random", "diagonal"])
@pytest.mark.parametrize("kind,b,hkv,rep,pos,prefix,kv_bound", [
    ("plain", 1, 4, 1, 200, 0, 256),
    ("plain", 3, 4, 1, 735, 730, 1024),
    ("gqa", 2, 2, 4, 300, 0, None),
    ("gqa", 1, 2, 2, 20, 64, 128),
    ("int8", 1, 4, 1, 735, 730, 1024),
    ("int8", 2, 4, 1, 180, 0, 256),
])
def test_device_position_equals_int_form_and_jax(kind, b, hkv, rep, pos, prefix, kv_bound,
                                                 query):
    """One decode token at `pos` for every row: a (B,) int32 position tensor
    against the int form and JAX's kernel in interpret mode. Caches hold
    garbage (x1000) past every column a row may attend; a diagonal query
    is each row's own key at pos (scaled x4), so that column carries most
    of the weight and a position off by one moves the output."""
    rng = np.random.default_rng(50 + b + rep)
    L, t, d, layer, g = 2, 1024, 32, 1, 2
    end = max(pos + 1, prefix)
    k = _garbage_after(_normal(rng, L, b, hkv, t, d), end)
    v = _garbage_after(_normal(rng, L, b, hkv, t, d), end)
    if query == "diagonal":
        q = np.repeat(k[layer, :, :, pos:pos + 1], rep, axis=1) * 4
    else:
        q = _normal(rng, b, hkv * rep, 1, d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scales, jscales = (), {}
    if kind == "int8":
        codes = []
        for x in (tk, tv):
            c, s = port_text.quantize_kv(x.reshape(L * b, hkv, t, d), g)
            codes.append((c.reshape(L, b, hkv, t, d), s.reshape(L, b, hkv // g, t)))
        (tk, ks), (tv, vs) = codes
        scales = (ks, vs)
        paired = lambda c, s: (
            pair_kv(jnp.asarray(c.numpy()).reshape(L * b, hkv, t, d), g).reshape(
                L, b, hkv // g, t, g * d), jnp.asarray(s.numpy())[:, :, :, None, :])
        (jk, jks), (jv, jvs) = paired(tk, ks), paired(tv, vs)
        jscales = {"k_scale": jks, "v_scale": jvs}
        atol, rtol = 1e-5, 0
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        atol, rtol = ATOL, RTOL
    want = np.asarray(jax_decode_cached(jnp.asarray(q), jk, jv, layer, pos, prefix,
                                        kv_bound=kv_bound, interpret=True, **jscales))
    host = decode_attention_cached(tq, tk, tv, layer, pos, prefix, kv_bound, *scales)
    dev_pos = torch.full((b,), pos, dtype=torch.int32)
    got = decode_attention_cached(tq, tk, tv, layer, dev_pos, prefix, kv_bound, *scales,
                                  lockstep=True)
    torch.testing.assert_close(got, host, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


# --------------------------------------------------- no host read in a run

HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.fixture
def no_host_reads(monkeypatch):
    """Within the fixture's `with`-less scope, calling any tensor method
    that reads a value to the host raises."""
    def patch():
        for name in HOST_READS:
            def raiser(self, *a, _name=name, **k):
                raise AssertionError(f"host read Tensor.{_name} inside a run")
            monkeypatch.setattr(torch.Tensor, name, raiser)
    return patch


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("bsz,temperature", [(1, 0.0), (1, 0.7), (3, 0.0)],
                         ids=["batch1-greedy", "batch1-sampled", "lockstep"])
def test_a_run_reads_nothing_on_the_host(pairs, no_host_reads, monkeypatch, fmt, bsz,
                                         temperature):
    cfg, tree, model = pairs(fmt)
    _, pkv = _prefill(cfg, tree, model, _embeds(cfg, bsz), bsz)
    st, run = port_generate.answer_loop(
        model, pkv, torch.tensor([FIRST, 5, 17][:bsz]), 12, torch.Generator().manual_seed(0),
        temperature, 0.9, -1, SUPPRESS, 256, True, "test")
    no_host_reads()
    run(port_generate.DONE_CHECK_EVERY)
    monkeypatch.undo()
    assert st.count.tolist() == [8] * bsz and st.pos.tolist() == [20] * bsz
    assert (st.run[:, 0] == torch.tensor([FIRST, 5, 17][:bsz])).all()


def test_a_pool_chunk_reads_nothing_on_the_host(pairs, no_host_reads, monkeypatch):
    _, _, model = pairs("mha")
    cfg = model.config
    kv = port_text.KVCache.create(cfg, 4, torch.float32, "cpu", 256)
    cur = torch.tensor([5, 300, 17, 400], dtype=torch.int32)
    pos = torch.tensor([0, 12, 40, 100], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    budget = torch.tensor([20, 3, 0, 20], dtype=torch.int32)
    no_host_reads()
    res = port_serving.serve_chunk(model, kv, cur, pos, active, budget, None, 0.0, 0.0,
                                   eos_id=-1, suppress_ids=SUPPRESS, chunk=8, kv_bound=256)
    monkeypatch.undo()
    assert res.emitted.sum(dim=1).tolist() == [8, 3, 0, 8]


# ------------------------------------------------------- replay accounting


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_captured_launches_once_per_replay():
    name = next(iter(build.LAUNCHES))
    before = dict(build.LAUNCHES)
    graphs.reset_graph_counts()
    stub = _StubGraph()
    g = graphs.StepGraph(stub, {name: 24}, "stub", ())
    for _ in range(3):
        g.replay()
    assert stub.replays == 3
    assert build.launches_since(before) == {name: 72}
    assert graphs.REPLAYS == {"stub": 3}
    build.LAUNCHES.update(before)
    assert build.launches_since(before) == {}


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
    warm-up, then 'captures' by recording fn (counting 5 launches of a
    kernel per replay)."""
    name = next(iter(build.LAUNCHES))
    captured = []

    def capture(cache, fn, label, generator=None):
        first = fn()
        out = None if first is None else type(first)(
            *(t.clone() if isinstance(t, torch.Tensor) else t for t in first))
        captured.append(label)
        return graphs.StepGraph(_RerunGraph(fn, out), {name: 5}, label, ()), first, out

    monkeypatch.setattr(graphs, "enabled", lambda dev: True)
    monkeypatch.setattr(graphs, "capture", capture)
    graphs.reset_graph_counts()
    return captured, name


@pytest.mark.parametrize("fmt", ["mha", "int4+kv_int8"])
def test_graphed_loops_equal_eager(pairs, free_runs, stand_in_graphs, fmt):
    """generate_text through the graph path (20 tokens: two replayed runs
    after the capturing one, then an eager partial run of 4) and again on
    the same cache (the cached entry: replays only), against the eager
    loop; and the lockstep loop likewise."""
    captured, name = stand_in_graphs
    cfg, tree, model = pairs(fmt)
    outs, pkv = [], None
    for graphed in (False, True, True):
        # the graphed calls prefill the same cache tensors: the second finds
        # the first one's graph under its key
        x = _embeds(cfg, 1, EMBED_SEED[fmt])
        _, pkv = _prefill(cfg, tree, model, x, 1, pkv if graphed else None)
        before = dict(build.LAUNCHES)
        res = port_generate.generate_text(model, pkv, torch.tensor(FIRST), 12, None, 0.0, 0.0,
                                          20, -1, SUPPRESS, graphed=graphed)
        outs.append(((res.tokens, res.count, res.pos), build.launches_since(before)))
    assert outs[0][0] == outs[1][0] == outs[2][0]
    assert outs[0][0][0][:12] == free_runs(fmt)
    assert captured == ["generate_text"]  # one capture, found again by the third call
    assert graphs.REPLAYS["generate_text"] == 1 + 2
    assert outs[1][1] == {name: 5} and outs[2][1] == {name: 10}

    x = _embeds(cfg, 3, seed=11)
    first = torch.tensor([5, 300, 17])
    got = []
    for graphed in (False, True):
        _, pkv = _prefill(cfg, tree, model, x, 3)
        res = port_batched.generate_text_batched(model, pkv, first, 12, None, 0.0, 0.0, 10,
                                                 -1, SUPPRESS, graphed=graphed)
        got.append((res.tokens.tolist(), res.counts.tolist(), res.pos))
    assert got[0] == got[1] and captured[-1] == "generate_text_batched"


def test_graphed_pool_equals_eager(stand_in_graphs):
    """A pool of 4 slots (8-token chunks) draining 6 requests through the
    graph path gives the eager pool's results; one capture per (chunk,
    sampling), every later chunk a replay."""
    captured, _ = stand_in_graphs
    cfg = port_tiny_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    model = MoondreamModel(cfg, params, _IdTokenizer(), torch.float32, device="cpu")
    image = np.random.default_rng(5).integers(0, 255, (378, 378, 3), dtype=np.uint8)
    enc = model.encode_image(image)
    results = []
    for graphed in (False, True):
        eng = ContinuousBatchingEngine(model, n_slots=4, slot_len=800, chunk=8, eos_id=-1,
                                       graphed=graphed)
        rids = [eng.submit(enc, question=q, max_tokens=n) for q, n in
                ((None, 10), ("Why?", 20), (None, 3), ("What?", 17))]
        eng.step()  # the 3-token request ends in the first chunk
        rids.append(eng.submit(enc, max_tokens=12))
        eng.step()  # the 10-token request in the second
        rids.append(eng.submit(enc, question="?", max_tokens=5))
        out = eng.drain()
        results.append([out[r] for r in rids])
    assert results[0] == results[1]
    assert [r.count("<") for r in results[0]] == [10, 20, 3, 17, 12, 5]
    assert captured == ["serve_chunk"] and graphs.REPLAYS["serve_chunk"] >= 2


# ------------------------------------------------------------- compile()


class _IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def test_compile_returns_the_model_and_changes_no_output():
    cfg = port_tiny_config()
    image = np.random.default_rng(7).integers(0, 255, (378, 504, 3), dtype=np.uint8)

    def model():
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
        return MoondreamModel(cfg, params, _IdTokenizer(), torch.float32, seed=1, device="cpu")

    def outputs(m):
        greedy = {"temperature": 0.0, "max_tokens": 12}
        enc = m.encode_image(image)
        return (m.caption(enc, settings=greedy), m.query(enc, "Why?", settings=greedy),
                m.detect(enc, "x", settings={"max_objects": 3}),
                m.caption(enc, settings={"max_tokens": 12, "temperature": 0.7}))

    fresh = outputs(model())
    warmed = model()
    assert warmed.compile({"max_tokens": 12, "max_objects": 3}) is warmed
    assert outputs(warmed) == fresh
