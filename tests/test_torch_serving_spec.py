"""The port's speculative serving pool against moondream_tpu's on the CPU, at
tiny_test_config in fp32 with the same parameters (`params_from_jax`), as
tests/test_serving_spec.py holds JAX's spec pool to its plain pool.

Each scenario runs call for call on a pool of each package, and the result
strings must be equal (IdTokenizer renders every id as `<id>`), and equal
the port's plain pool: k 2, 4, 8 and 24 (more rows than one kernel C launch
takes on the card, which splits the span; here the plain version takes it
whole), staggered admission, slot reuse, the accept rate and the adaptive
switch, a sampled pool, int4 blocks with an int8 KV cache, a prefix-shared
pool, and a request admitted with the largest budget the speculative margin
allows, which runs to its slot's last column."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.models.serve import ContinuousBatchingEngine as JaxEngine
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax


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


def _pair(quantized: bool):
    """(JAX side, port side) on one tree: {"model", "encs", "engine"}, the
    three images encoded once. `quantized`: int4 text blocks (JAX's
    quantize_text_params, the same codes on both) and an int8 KV cache."""
    cfg, port_cfg = tiny_test_config(), port_tiny_config()
    if quantized:
        kv8 = lambda c: dataclasses.replace(c, text=dataclasses.replace(c.text, kv_int8=True))
        cfg, port_cfg = kv8(cfg), kv8(port_cfg)
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    text = jax_text.init_text_params(cfg.text, kt, jnp.float32)
    if quantized:
        text = jax_text.quantize_text_params(text)
    tree = {"vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32), "text": text}
    ref = JaxModel(cfg, params=dict(tree, region=None), tokenizer=IdTokenizer(),
                   dtype=jnp.float32)
    ours = MoondreamModel(port_cfg, params=params_from_jax(tree, port_cfg),
                          tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (80 + 16 * i, 100, 3), np.uint8) for i in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")  # JAX's host crop path
        ref_encs = [ref.encode_image(Image.fromarray(im)) for im in images]
    return (
        {"model": ref, "encs": ref_encs, "engine": JaxEngine, "jits": {}},
        {"model": ours, "encs": [ours.encode_image(im) for im in images],
         "engine": ContinuousBatchingEngine},
    )


@pytest.fixture(scope="module")
def sides():
    return _pair(quantized=False)


@pytest.fixture(scope="module")
def sides_q():
    return _pair(quantized=True)


def _engine(side, slot_len=1024, **kw):
    eng = side["engine"](side["model"], slot_len=slot_len, **kw)
    if "jits" in side:
        # JAX pools that compile the same chunk share it: the chunk keys
        # carry chunk, spec_k and sampling; slot length, EOS and prefix
        # sharing are bound into them, so they key the shared dict
        key = (slot_len, kw.get("eos_id"), kw.get("prefix_share", False))
        eng._jits = side["jits"].setdefault(key, {})
    return eng


def _both(sides, scenario, **kw):
    ref, ours = sides
    return scenario(ref, **kw), scenario(ours, **kw)


def _pool(side, encs=None, max_tokens=14, n_slots=4, chunk=3, **kw):
    eng = _engine(side, n_slots=n_slots, chunk=chunk, **kw)
    rids = [eng.submit(e, max_tokens=max_tokens) for e in (encs or side["encs"])]
    out = eng.drain()
    return [out[r] for r in rids], eng


def _spec_vs_plain(side, k, **kw):
    plain, _ = _pool(side, **kw)
    spec, eng = _pool(side, speculative=k, **kw)
    return plain, spec, eng.spec_accept_rate


@pytest.mark.parametrize("k", [2, 4, 8, 24])
def test_spec_pool_matches_plain_and_jax(sides, k):
    (_, want, want_rate), (plain, got, rate) = _both(sides, _spec_vs_plain, k=k)
    assert got == want == plain
    assert all(r.count("<") == 14 or "<0>" not in r for r in got)
    assert rate == pytest.approx(want_rate) and 1.0 < rate <= k


def _staggered(side, k):
    out = []
    for spec in (0, k):
        eng = _engine(side, n_slots=3, chunk=3, speculative=spec)
        encs = side["encs"]
        r0 = eng.submit(encs[0], max_tokens=12)
        eng.step()
        r1 = eng.submit(encs[1], question="what?", max_tokens=12)
        eng.step()
        r2 = eng.submit(encs[2], max_tokens=12)
        res = eng.drain()
        out.append([res[r0], res[r1], res[r2]])
    return out


def test_spec_pool_staggered_admission(sides):
    (_, want), (plain, got) = _both(sides, _staggered, k=4)
    assert got == want == plain


def _slot_reuse(side):
    """One slot, two requests in turn: the history of the first must not
    leak into the second's output (it may only change drafts)."""
    eng = _engine(side, n_slots=1, chunk=4, speculative=4)
    r0 = eng.submit(side["encs"][0], max_tokens=6)
    eng.drain()
    r1 = eng.submit(side["encs"][1], max_tokens=6)
    eng.drain()
    return [eng.results[r0], eng.results[r1]]


def test_spec_pool_slot_reuse(sides):
    want, got = _both(sides, _slot_reuse)
    plain, _ = _pool(sides[1], encs=sides[1]["encs"][:2], max_tokens=6, chunk=4)
    assert got == want == plain


def _adaptive(side):
    out, eng = _pool(side, encs=side["encs"][:2], max_tokens=40, n_slots=2, chunk=2,
                     speculative=4, spec_adaptive=100.0)  # a rate it cannot reach
    return out, eng.spec_k, eng.spec_accept_rate, eng._spec_chunks


def test_spec_accept_rate_and_adaptive_off(sides):
    (want, want_k, want_rate, want_n), (got, k, rate, n) = _both(sides, _adaptive)
    plain, _ = _pool(sides[1], encs=sides[1]["encs"][:2], max_tokens=40, n_slots=2, chunk=2)
    assert got == want == plain
    assert k == want_k == 0  # the adaptive switch fired
    assert n == want_n == 8  # after the warm-up of 8 spec chunks
    assert rate == pytest.approx(want_rate) and 0.0 < rate <= 4.0


def test_spec_pool_sampled(sides):
    """A sampled pool speculates by the rejection test: every request ends
    within its budget, and a greedy request beside sampled ones stays
    exact (its temperature 0 is a point mass)."""
    _, ours = sides
    eng = _engine(ours, n_slots=3, chunk=3, speculative=4, temperature=0.6, top_p=0.9)
    rids = [eng.submit(e, max_tokens=9) for e in ours["encs"]]
    out = eng.drain()
    assert all(isinstance(out[r], str) and out[r].count("<") <= 9 for r in rids)
    assert eng.spec_accept_rate is not None and eng._sampling_used

    mixed = _engine(ours, n_slots=2, chunk=3, speculative=4)
    rg = mixed.submit(ours["encs"][0], max_tokens=12)
    rs = mixed.submit(ours["encs"][1], max_tokens=12, temperature=0.8, top_p=0.9)
    res = mixed.drain()
    assert res[rg] == _pool(ours, encs=ours["encs"][:1], max_tokens=12)[0][0]
    assert res[rs].count("<") <= 12


def test_spec_pool_int4_kv_int8(sides_q):
    (_, want, _), (plain, got, _) = _both(sides_q, _spec_vs_plain, k=4)
    assert got == want == plain


def _prefix(side, k):
    encs = side["encs"]
    out = []
    for spec in (0, k):
        eng = _engine(side, n_slots=4, chunk=3, prefix_share=True, speculative=spec)
        rids = [eng.submit(encs[0], max_tokens=10), eng.submit(encs[1], max_tokens=10),
                eng.submit(encs[0], question="what?", max_tokens=10)]
        res = eng.drain()
        assert eng._pref_refs.count(0) == len(eng._pref_refs)
        out.append([res[r] for r in rids])
    return out


@pytest.mark.parametrize("k", [4, 24])
def test_spec_pool_prefix_shared(sides, k):
    (_, want), (plain, got) = _both(sides, _prefix, k=k)
    assert got == want == plain


def _at_the_margin(side, k):
    """The largest budget the margin admits: pos + budget + k == slot_len,
    with EOS off so the request runs to the end of its budget (its last
    verify span ends at the slot's last column)."""
    enc = side["encs"][0]
    pos = enc.pos + len(side["model"].config.tokenizer.templates["caption"]["normal"])
    slot_len = pos + 11 + k
    eng = _engine(side, slot_len=slot_len, n_slots=2, chunk=3, speculative=k, eos_id=-1)
    rid = eng.submit(enc, max_tokens=1000)
    out = eng.drain()
    with pytest.raises(ValueError, match="speculative margin"):
        eng.submit(enc, question="what is the thing on the left of it?", max_tokens=4)
    return out[rid], eng.token_counts[rid]


@pytest.mark.parametrize("k", [4, 8])
def test_spec_pool_largest_budget_the_margin_admits(sides, k):
    (want, n_want), (got, n) = _both(sides, _at_the_margin, k=k)
    assert got == want and n == n_want == 11
