"""The port's lockstep speculative loop (`engine/batched.
generate_text_spec_batched`) against the JAX package's on the CPU, at
tiny_test_config in fp32 on the same weights:

  * tokens, counts, positions and iterations equal JAX's at k 3 and 8,
    with and without prompt-seeded draft histories, for four rows that
    start from given tokens at one position: one whose first token is EOS,
    rows that reach EOS at different lengths and rows cut by their budget
    (max_tokens, or kv_bound - pos - k);
  * its reads: one before the first run and one per run of
    DONE_CHECK_EVERY spans;
  * the graph path (a stand-in capture on the CPU) equals the eager one
    and replays its graph, and a run of spans reads nothing on the host;
  * a GQA model raises a ValueError.
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
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import batched as port_batched
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.weights import params_from_jax
from test_torch_graphs_loops import no_host_reads, stand_in_graphs  # noqa: F401

EVERY = port_generate.DONE_CHECK_EVERY
POS = 12
MAX_TOKENS = 24
FIRST = [5, 300, 17, 41]
# a prompt tail for the seeded histories (prompt lookup)
SEED = [17, 44, 5, 9, 300, 17, 41, 5]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(JAX text config, JAX text tree, port text model, the prefilled
    embeddings) on one set of seeded fp32 weights."""
    jcfg = tiny_test_config()
    cfg = jcfg.text
    kv_, kt = jax.random.split(jax.random.PRNGKey(5))
    tree = jax_text.init_text_params(cfg, kt, jnp.float32)
    vision = jax_vision.init_vision_params(jcfg.vision, kv_, jnp.float32)
    model = params_from_jax({"vision": vision, "text": tree}, port_tiny_config())["text"]
    x = np.random.default_rng(21).standard_normal((4, POS, cfg.dim)).astype(np.float32)
    return cfg, tree, model, x


# JAX's loop per (k, eos, kv_bound, seeded): the cases share them
_JITS = {}


def _jax_spec(cfg, tree, x, first, k, eos, kv_bound, seeded):
    key = (k, eos, kv_bound, seeded)
    if key not in _JITS:
        _JITS[key] = jax.jit(partial(
            jax_batched.generate_text_spec_batched, config=cfg, eos_id=eos,
            suppress_ids=(3,), buffer=cfg.max_context, spec_k=k, kv_bound=kv_bound))
    kv = jax_text.KVCache.create(cfg, batch=4, dtype=jnp.float32)
    _, kv = jax_text.text_decoder(jnp.asarray(x), tree, kv, jnp.int32(0), jnp.int32(8), cfg)
    hist = {}
    if seeded:
        hist = dict(hist_init=jnp.broadcast_to(jnp.asarray(SEED, jnp.int32), (4, len(SEED))),
                    hist_cnt_init=jnp.full((4,), len(SEED), jnp.int32))
    r = _JITS[key](tree, kv, jnp.asarray(first, jnp.int32), jnp.int32(POS),
                   jnp.int32(MAX_TOKENS), **hist)
    counts = np.asarray(r.counts)
    tokens = [np.asarray(r.tokens[b, :counts[b]]).tolist() for b in range(4)]
    return tokens, counts.tolist(), np.asarray(r.pos).tolist(), int(r.iters)


def _port_spec(model, x, first, k, eos, kv_bound, seeded, graphed=True, kv=None):
    if kv is None:
        kv = port_text.KVCache.create(model.config, 4, torch.float32, "cpu")
    port_text.text_decoder(torch.from_numpy(x), model, kv, 0, 8)
    hist = {}
    if seeded:
        hist = dict(hist_init=torch.tensor(SEED).expand(4, -1), hist_cnt_init=len(SEED))
    r = port_batched.generate_text_spec_batched(
        model, kv, torch.tensor(first), POS, MAX_TOKENS, eos, (3,), k, kv_bound,
        graphed=graphed, **hist)
    counts = r.counts.tolist()
    tokens = [r.tokens[b, :counts[b]].tolist() for b in range(4)]
    assert not any(r.tokens[b, counts[b]:].any() for b in range(4))
    return tokens, counts, r.pos.tolist(), r.iters


@pytest.fixture(scope="module")
def free(pair):
    """The plain lockstep greedy run of MAX_TOKENS from FIRST, per row."""
    _, _, model, x = pair
    kv = port_text.KVCache.create(model.config, 4, torch.float32, "cpu")
    port_text.text_decoder(torch.from_numpy(x), model, kv, 0, 8)
    r = port_batched.generate_text_batched(model, kv, torch.tensor(FIRST), POS, None, 0.0,
                                           0.0, MAX_TOKENS, -1, (3,))
    return r.tokens.tolist()


def _eos_cases(free):
    """(eos, first tokens): "desync" picks an EOS that some rows emit at
    different lengths while another runs to its budget, and makes row 3's
    first token EOS; "budget": no EOS, kv_bound cuts the budget."""
    best = None
    for tok in sorted({t for row in free[:3] for t in row}):
        firsts = [row.index(tok) for row in free[:3] if tok in row]
        score = (len(set(firsts)) >= 2, len(firsts) < 3, -min(firsts))
        if best is None or score > best[0]:
            best = (score, tok)
    eos = best[1]
    return {"desync": (eos, FIRST[:3] + [eos]), "budget": (-1, FIRST)}


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "seeded"])
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("case", ["desync", "budget"])
def test_spec_batched_matches_jax(pair, free, case, k, seeded):
    cfg, tree, model, x = pair
    eos, first = _eos_cases(free)[case]
    kv_bound = 40 if case == "budget" else None
    want = _jax_spec(cfg, tree, x, first, k, eos, kv_bound, seeded)
    port_generate.reset_loop_counts()
    got = _port_spec(model, x, first, k, eos, kv_bound, seeded)
    assert got == want
    tokens, counts, pos, iters = got
    # the greedy ids are the plain lockstep loop's
    limit = MAX_TOKENS if kv_bound is None else min(MAX_TOKENS, kv_bound - POS - k)
    for b in range(4):
        row = free[b] if b < 3 or case == "budget" else []
        n = row.index(eos) if eos in row else limit
        assert tokens[b] == row[:n] and pos[b] == POS + counts[b]
    if case == "desync":
        assert counts[3] == 0 and len(set(counts[:3])) >= 2
    else:
        assert counts == [limit] * 4
    assert 0 < iters <= max(counts) and sum(counts) >= iters
    c = port_generate.LOOP_COUNTS["generate_text_spec_batched"]
    assert c["calls"] == 1 and c["reads"] == math.ceil(c["steps"] / EVERY) + 1
    assert c["steps"] >= iters


def test_spec_batched_graphed_equals_eager(pair, free, stand_in_graphs):
    """Through the graph path twice on one cache (the second call only
    replays) against the eager loop."""
    captured = stand_in_graphs
    _, _, model, x = pair
    eos, first = _eos_cases(free)["desync"]
    eager = _port_spec(model, x, first, 4, eos, None, True, graphed=False)
    assert captured == []
    kv = port_text.KVCache.create(model.config, 4, torch.float32, "cpu")
    once = _port_spec(model, x, first, 4, eos, None, True, kv=kv)
    assert captured == ["generate_text_spec_batched"]
    twice = _port_spec(model, x, first, 4, eos, None, True, kv=kv)
    assert eager == once == twice
    assert captured == ["generate_text_spec_batched"]
    assert graphs.REPLAYS["generate_text_spec_batched"] >= 1


def test_a_spec_batched_run_reads_nothing_on_the_host(pair, no_host_reads, monkeypatch):
    _, _, model, x = pair
    kv = port_text.KVCache.create(model.config, 4, torch.float32, "cpu")
    port_text.text_decoder(torch.from_numpy(x), model, kv, 0, 8)
    st = port_batched.BatchedSpecState.create(4, model.config.max_context, "cpu", (3,))
    st.reset(torch.tensor(FIRST), POS, 200, -1, torch.tensor(SEED).expand(4, -1), len(SEED))
    no_host_reads()
    for _ in range(EVERY):
        port_batched.spec_batched_step(model, kv, st, 4, -1, 256, 256)
    monkeypatch.undo()
    assert st.iters.item() == EVERY
    assert (st.counts >= EVERY).all() and (st.pos == POS + st.counts).all()


def test_spec_batched_refuses_gqa():
    cfg = port_tiny_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, n_kv_heads=1))
    from moondream_tpu_torch.weights import init_params

    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)["text"]
    kv = port_text.KVCache.create(model.config, 2, torch.float32, "cpu")
    with pytest.raises(ValueError, match="MHA"):
        port_batched.generate_text_spec_batched(model, kv, torch.tensor([5, 6]), POS, 8, -1,
                                                (), 4)
