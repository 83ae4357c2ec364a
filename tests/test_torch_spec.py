"""The port's speculative decode against moondream_tpu's on the CPU, at
tiny_test_config in fp32 with the same parameters (`params_from_jax`).

Drafting (`ngram_draft_rows`, over rows and over one row as JAX's
single-stream `ngram_draft`) must equal JAX's on seeded
histories; the greedy speculative loop `generate_text_spec` must give JAX's
`generate_text_spec` ids, count and position and the port's own plain
`generate_text` ids (k 2, 3, 4 and 8, max_tokens hit exactly, EOS as the
first token, inside a span and at a span's last row, the early stop at the
context end and at kv_bound; int4 text blocks, an int8 KV cache and GQA).
The entry points route settings["speculative"] to the loop (LOOP_COUNTS
shows it ran) with plain-call ids, streamed and not. Speculative sampling
keeps the first stochastic token's distribution (total variation < 0.2
over 500 draws, as tests/test_speculative.py:188 holds JAX's) and respects
max_tokens. Random tiny models repeat heavily, so drafts are accepted often
and whole spans as well as misses are exercised."""

import dataclasses
from collections import Counter
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import drafting as jax_drafting
from moondream_tpu.engine import generate as jax_generate
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import drafting
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.text import KVCache
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

FIRST = 5  # the first token of every engine-level run, at position 0
MAX_TOKENS = 40


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's ops are too small to gain from intra-op threads, and
    under parallel test workers those threads contend for the cores: run
    this module on one, and give the worker its setting back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _cfgs(kv_int8=False, n_kv_heads=2):
    """(JAX config, port config) of the tiny model with these text options."""
    out = []
    for cfg in (tiny_test_config(), port_tiny_config()):
        out.append(dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, kv_int8=kv_int8, n_kv_heads=n_kv_heads)))
    return out


def _text_pair(variant: str, seed: int = 7):
    """(JAX config, JAX text params, port config, port TextModel) on one
    seeded tree: "dense", "int4" (JAX's quantize_text_params, carried over
    with the same codes), "kv_int8" or "gqa" (one KV head)."""
    jcfg, pcfg = _cfgs(kv_int8=variant == "kv_int8", n_kv_heads=1 if variant == "gqa" else 2)
    kv, kt = jax.random.split(jax.random.PRNGKey(seed))
    text = jax_text.init_text_params(jcfg.text, kt, jnp.float32)
    if variant == "int4":
        text = jax_text.quantize_text_params(text)
    tree = {"vision": jax_vision.init_vision_params(jcfg.vision, kv, jnp.float32), "text": text}
    return jcfg, text, pcfg, params_from_jax(tree, pcfg)["text"]


@pytest.fixture(scope="module")
def pairs():
    built = {}

    def get(variant="dense", seed=7):
        if (variant, seed) not in built:
            built[variant, seed] = _text_pair(variant, seed)
        return built[variant, seed]

    return get


def _jax_spec(jcfg, params, k, max_tokens=MAX_TOKENS, eos=-1, pos=0, kv_bound=None):
    fn = jax.jit(partial(jax_generate.generate_text_spec, config=jcfg.text, eos_id=eos,
                         suppress_ids=(), buffer=jcfg.text.max_context, spec_k=k,
                         kv_bound=kv_bound))
    kv = jax_text.KVCache.create(jcfg.text, batch=1, dtype=jnp.float32)
    r = fn(params, kv, jnp.int32(FIRST), jnp.int32(pos), jnp.int32(max_tokens))
    n = int(r.count)
    return [int(t) for t in np.asarray(r.tokens[:n])], n, int(r.pos)


def _port(model, pcfg, k=None, max_tokens=MAX_TOKENS, eos=-1, pos=0, kv_bound=None):
    """The port's speculative loop (k) or plain greedy loop (k None) from
    FIRST at `pos` on an empty cache: (ids, count, pos)."""
    kv = KVCache.create(pcfg.text, 1, torch.float32, "cpu")
    first = torch.tensor(FIRST)
    if k is None:
        r = port_generate.generate_text(model, kv, first, pos, None, 0.0, 0.0, max_tokens, eos,
                                        (), kv_bound)
    else:
        r = port_generate.generate_text_spec(model, kv, first, pos, max_tokens, eos, (), k,
                                             kv_bound)
    return r.tokens, r.count, r.pos


# ------------------------------------------------------------------ drafting
def _histories(case):
    rng = np.random.default_rng(11)
    if case == "repeats":  # a cycle: long suffix matches everywhere
        h = np.tile(np.arange(3, 8), (4, 8))
        cnt1 = np.array([40, 23, 17, 6])
    elif case == "seed pads":  # -1 pads ahead of a short history
        h = np.full((4, 24), -1)
        h[:, 12:] = rng.integers(0, 4, (4, 12))
        cnt1 = np.array([24, 20, 14, 13])
    elif case == "bigram miss":  # cur occurs, never after the same token
        # cur 1 at 8 after a 4; the only earlier 1 follows a 9
        h = np.array([[9, 1, 8, 2, 7, 3, 6, 4, 1, 0, 0, 0]] * 4)
        cnt1 = np.array([9, 9, 9, 9])
    elif case == "full miss":  # cur never occurred before
        h = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 0, 0]] * 4)
        cnt1 = np.array([8, 8, 5, 1])
    else:  # random small alphabets
        h = rng.integers(-1, 5, (4, 30))
        cnt1 = rng.integers(0, 31, 4)
    h = h.astype(np.int32)
    cnt1 = cnt1.astype(np.int32)
    cur = h[np.arange(4), np.clip(cnt1 - 1, 0, h.shape[1] - 1)].clip(min=0).astype(np.int32)
    return h, cnt1, cur


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("case", ["repeats", "seed pads", "bigram miss", "full miss", "random"])
def test_ngram_draft_rows_matches_jax(case, k):
    h, cnt1, cur = _histories(case)
    want_d, want_m = jax_drafting.ngram_draft_rows(jnp.asarray(h), jnp.asarray(cnt1),
                                                   jnp.asarray(cur), k)
    got_d, got_m = drafting.ngram_draft_rows(torch.tensor(h), torch.tensor(cnt1),
                                             torch.tensor(cur), k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_d.dtype == torch.int32 and (got_d >= 0).all()
    if case == "full miss":  # no anchor: the current token repeated
        assert not got_m[:3].any() and (got_d == torch.tensor(cur)[:, None]).all()
    if case == "bigram miss":  # the unigram fallback: what followed cur's last occurrence
        assert got_m.all() and got_d[0, 0] == 8


def test_ngram_draft_single_stream_matches_jax():
    """JAX's single-stream ngram_draft against the rows form over one row,
    as the batch-1 loop (spec_step) drafts."""
    rng = np.random.default_rng(2)
    for _ in range(20):
        hist = rng.integers(-1, 4, 40).astype(np.int32)
        n = int(rng.integers(1, 41))
        tok = int(max(hist[n - 1], 0))
        want = jax_drafting.ngram_draft(jnp.asarray(hist), n, jnp.int32(tok), 5)
        got = drafting.ngram_draft_rows(torch.tensor(hist)[None], torch.tensor([n]),
                                        torch.tensor([tok]), 5)
        assert got[0][0].tolist() == np.asarray(want[0]).tolist()
        assert bool(got[1][0]) == bool(want[1])


# ------------------------------------------------------------ greedy loop
@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_generate_text_spec_matches_jax_and_plain(pairs, k):
    jcfg, params, pcfg, model = pairs()
    want = _jax_spec(jcfg, params, k)
    port_generate.reset_loop_counts()
    got = _port(model, pcfg, k)
    c = port_generate.LOOP_COUNTS["generate_text_spec"]
    assert got == want and got[1] == MAX_TOKENS  # max_tokens hit exactly
    assert got[0] == _port(model, pcfg)[0]
    # one read per run of DONE_CHECK_EVERY verify spans and one before them
    assert c["calls"] == 1
    assert c["reads"] <= -(-c["steps"] // port_generate.DONE_CHECK_EVERY) + 1
    if k > 2:
        assert c["steps"] < MAX_TOKENS  # drafts were accepted


def test_generate_text_spec_eos_positions(pairs, monkeypatch):
    """EOS at every first occurrence of a token in the plain greedy run, at
    k 2, 3, 4 and 8: the spec ids equal the plain ids cut there. The
    verify rows are recorded to show that EOS came as the first token,
    inside a span and at a span's last row."""
    _, _, pcfg, model = pairs()
    plain = _port(model, pcfg, max_tokens=MAX_TOKENS)[0]  # FIRST emitted first
    firsts = {}
    for j, t in enumerate(plain):
        firsts.setdefault(t, j)
    rows_of_eos = Counter()
    accept = port_generate.greedy_accept

    def spy(draft, g, eos_id):
        hit = (g == eos_id).nonzero()
        if len(hit):
            rows_of_eos["last" if int(hit[0]) == g.shape[0] - 1 else "inside"] += 1
        return accept(draft, g, eos_id)

    monkeypatch.setattr(port_generate, "greedy_accept", spy)
    for k in (2, 3, 4, 8):
        for eos, j in firsts.items():
            got = _port(model, pcfg, k, eos=eos)
            want = _port(model, pcfg, None, eos=eos)
            assert got == want, (k, eos)
            assert got[1] == j and got[0] == plain[:j]
    assert firsts[FIRST] == 0  # EOS as the first token: nothing emitted
    assert rows_of_eos["inside"] and rows_of_eos["last"], rows_of_eos


def test_generate_text_spec_eos_matches_jax(pairs):
    jcfg, params, pcfg, model = pairs()
    plain = _port(model, pcfg)[0]
    eos = plain[len(plain) // 2]  # a token that first occurs somewhere inside
    assert _port(model, pcfg, 4, eos=eos) == _jax_spec(jcfg, params, 4, eos=eos)


@pytest.mark.parametrize("where", ["context end", "kv_bound"])
def test_generate_text_spec_stops_k_minus_1_early(pairs, where):
    """The verify span must fit: the loop stops spec_k - 1 tokens before the
    context end (or kv_bound) that the plain loop reaches, as JAX's does."""
    jcfg, params, pcfg, model = pairs()
    k = 4
    if where == "context end":
        pos, bound = jcfg.text.max_context - 20, None
    else:
        pos, bound = 0, 32
    room = (jcfg.text.max_context if bound is None else bound) - pos
    got = _port(model, pcfg, k, pos=pos, kv_bound=bound)
    assert got == _jax_spec(jcfg, params, k, pos=pos, kv_bound=bound)
    assert got[1] == room - k + 1 and got[2] == pos + got[1]
    plain = _port(model, pcfg, None, pos=pos, kv_bound=bound)
    assert plain[1] == room and got[0] == plain[0][:got[1]]


@pytest.mark.parametrize("variant", ["int4", "kv_int8", "gqa"])
def test_generate_text_spec_quantized_and_gqa(pairs, variant):
    jcfg, params, pcfg, model = pairs(variant)
    got = _port(model, pcfg, 4, max_tokens=24)
    assert got == _jax_spec(jcfg, params, 4, max_tokens=24)
    assert got[0] == _port(model, pcfg, None, max_tokens=24)[0]


# ------------------------------------------------------------ entry points
@pytest.fixture(scope="module")
def model():
    return MoondreamModel(port_tiny_config(), tokenizer=IdTokenizer(), dtype=torch.float32,
                          seed=3, device="cpu")


@pytest.fixture(scope="module")
def enc(model):
    img = np.random.default_rng(3).integers(0, 255, (64, 96, 3), dtype=np.uint8)
    return model.encode_image(img)


@pytest.mark.parametrize("spec", [True, 2, 4], ids=["True", "k2", "k4"])
def test_caption_and_query_route_speculative(model, enc, spec):
    for mt in (1, 7, 40):
        plain = {"temperature": 0.0, "max_tokens": mt}
        port_generate.reset_loop_counts()
        a = model.caption(enc, settings={**plain, "speculative": spec})["caption"]
        assert port_generate.LOOP_COUNTS["generate_text_spec"]["calls"] == 1
        assert "generate_text" not in port_generate.LOOP_COUNTS
        assert a == model.caption(enc, settings=plain)["caption"]
        assert a.count("<") <= mt
        q = model.query(enc, "what?", settings={**plain, "speculative": spec})["answer"]
        assert q == model.query(enc, "what?", settings=plain)["answer"]


def test_speculative_query_matches_jax(pairs):
    """The entry point end to end against JAX's `query` with
    settings["speculative"] (its draft seed included)."""
    from PIL import Image

    from moondream_tpu.models.moondream import MoondreamModel as JaxModel

    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    tree = {"vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
            "text": jax_text.init_text_params(cfg.text, kt, jnp.float32)}
    ref = JaxModel(cfg, params=dict(tree, region=None), tokenizer=IdTokenizer(),
                   dtype=jnp.float32)
    ours = MoondreamModel(port_tiny_config(), params=params_from_jax(tree, port_tiny_config()),
                          tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
    img = np.random.default_rng(4).integers(0, 255, (80, 100, 3), dtype=np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
        s = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 24, "speculative": True}
        want = ref.query(Image.fromarray(img), "what is it?", settings=s)["answer"]
    assert ours.query(img, "what is it?", settings=s)["answer"] == want


@pytest.mark.parametrize("k", [2, 4, 8])
def test_speculative_stream_equals_plain_stream(model, enc, k):
    plain = {"temperature": 0.0, "max_tokens": 40}
    base = "".join(model.query(enc, "?", stream=True, settings=plain)["answer"])
    port_generate.reset_loop_counts()
    spec = "".join(model.query(enc, "?", stream=True,
                               settings={**plain, "speculative": k})["answer"])
    c = port_generate.LOOP_COUNTS["generate_text_spec"]
    assert c["calls"] == 1 and c["reads"] == c["steps"] + 1  # the spec loop streamed
    assert spec == base == model.query(enc, "?", settings=plain)["answer"]
    cap = "".join(model.caption(enc, stream=True, settings={**plain, "speculative": k})["caption"])
    assert cap == model.caption(enc, settings=plain)["caption"]


# ------------------------------------------------------------ sampled loop
def test_top_p_0_ties_keep_the_lower_id_as_jax():
    """At top_p 0 the nucleus is the single most likely token; at an exact
    tie (bf16-rounded logits tie often) the sorts are stable, as JAX's
    argsort, so the lower id is kept: the plain sampler, the pool's batched
    sampler and the speculative target all agree with argmax and JAX."""
    from moondream_tpu.engine.sampling import sample_token as jax_sample_token
    from moondream_tpu_torch.engine.batched import sample_tokens_batched
    from moondream_tpu_torch.engine.sampling import sample_token, target_probs

    logits = torch.full((512,), -3.0)
    logits[[40, 7, 300]] = 2.5  # a three-way tie at the top
    gen = torch.Generator().manual_seed(0)
    want = int(jax_sample_token(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                                jnp.float32(0.5), jnp.float32(0.0)))
    assert want == 7 == int(torch.argmax(logits))
    assert all(int(sample_token(logits, gen, 0.5, 0.0)) == 7 for _ in range(20))
    rows = logits.repeat(3, 1)
    assert sample_tokens_batched(rows, gen, torch.full((3,), 0.5), torch.zeros(3)).tolist() == [7] * 3
    assert torch.equal(target_probs(logits, 0.5, 0.0), torch.nn.functional.one_hot(
        torch.tensor(7), 512).float())


N_DRAWS = 500
TEMP, TOP_P = 0.3, 0.9


@pytest.fixture(scope="module")
def sampling_pair():
    return _text_pair("dense", seed=11)


def _first_stochastic(sample, n=N_DRAWS, base=0) -> Counter:
    return Counter(sample(base + s) for s in range(n))


def _tv(a: Counter, b: Counter) -> float:
    return 0.5 * sum(abs(a.get(t, 0) - b.get(t, 0)) for t in set(a) | set(b)) / N_DRAWS


def _port_draw(model, pcfg, spec: bool, s: int) -> int:
    kv = KVCache.create(pcfg.text, 1, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(s)
    first = torch.tensor(7)
    if spec:
        r = port_generate.generate_text_spec_sampled(model, kv, first, 0, gen, TEMP, TOP_P, 2,
                                                     -1, (), 4)
    else:
        r = port_generate.generate_text(model, kv, first, 0, gen, TEMP, TOP_P, 2, -1, ())
    return r.tokens[1]


def test_sampled_spec_keeps_the_distribution(sampling_pair):
    """The first stochastic token of the sampled speculative loop against the
    port's plain sampled loop and JAX's plain sampled loop (different
    generators, so per-draw equality is impossible): total variation < 0.2
    over 500 draws each; a broken residual rule lands far above."""
    jcfg, params, pcfg, model = sampling_pair
    spec = _first_stochastic(lambda s: _port_draw(model, pcfg, True, s), base=5000)
    plain = _first_stochastic(lambda s: _port_draw(model, pcfg, False, s), base=1000)
    jplain = jax.jit(lambda kv, r: jax_generate.generate_text(
        params, kv, jnp.int32(7), jnp.int32(0), r, jnp.float32(TEMP), jnp.float32(TOP_P),
        jnp.int32(2), config=jcfg.text, eos_id=-1, suppress_ids=(),
        buffer=jcfg.text.max_context).tokens[1])
    kv0 = jax_text.KVCache.create(jcfg.text, batch=1, dtype=jnp.float32)
    ref = _first_stochastic(lambda s: int(jplain(kv0, jax.random.PRNGKey(s))), base=9000)
    assert len(spec) > 1  # a real distribution, not a point mass
    assert _tv(spec, plain) < 0.2, (spec.most_common(5), plain.most_common(5))
    assert _tv(spec, ref) < 0.2, (spec.most_common(5), ref.most_common(5))


def test_sampled_spec_at_top_p_0_is_greedy_spec(pairs):
    """At top_p 0 the target is one-hot at the argmax: every draft that
    equals the greedy continuation is accepted and every other rejected, so
    the sampled loop gives the greedy loop's ids in as many verify spans."""
    _, _, pcfg, model = pairs()
    port_generate.reset_loop_counts()
    greedy = _port(model, pcfg, 4)
    kv = KVCache.create(pcfg.text, 1, torch.float32, "cpu")
    r = port_generate.generate_text_spec_sampled(
        model, kv, torch.tensor(FIRST), 0, torch.Generator().manual_seed(0), 0.5, 0.0,
        MAX_TOKENS, -1, (), 4)
    c = port_generate.LOOP_COUNTS
    assert (r.tokens, r.count, r.pos) == greedy
    assert c["generate_text_spec_sampled"]["steps"] == c["generate_text_spec"]["steps"]
    assert c["generate_text_spec"]["steps"] < MAX_TOKENS


@pytest.mark.parametrize("stream", [False, True], ids=["fused", "stream"])
def test_sampled_spec_respects_max_tokens(model, enc, stream):
    for mt in (1, 5, 12):
        s = {"temperature": 0.5, "top_p": 0.9, "max_tokens": mt, "speculative": 4}
        port_generate.reset_loop_counts()
        out = model.query(enc, "?", stream=stream, settings=s)["answer"]
        text = "".join(out) if stream else out
        assert text.count("<") <= mt
        c = port_generate.LOOP_COUNTS["generate_text_spec_sampled"]
        # the stream reads once per span, the fused loop once per run of
        # DONE_CHECK_EVERY spans; both once before the first
        runs = c["steps"] if stream else -(-c["steps"] // port_generate.DONE_CHECK_EVERY)
        assert c["calls"] == 1 and c["reads"] == runs + 1
