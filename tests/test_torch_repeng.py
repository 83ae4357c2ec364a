"""Steering and representation engineering in the port
(`moondream_tpu_torch/repeng.py`, `steer=` through the text forwards and the
answer loops, settings["steer"] / ["steer_scale"] in caption and query)
against the JAX package on the CPU, at tiny_test_config in fp32 under the
peaked oracle (lm_head bias + N(0, 1), region decoders' fc2 bias +
N(0, 1) x 50: greedy ids without ties, generations that are not empty):

  * `text_decoder(..., steer=)` equals JAX's jitted one over a prefill, a
    decode token and a 5-row span, on the dense, int4 + kv_int8 and GQA
    routes (within 1e-5 of max|ref|); `produce_hidden_layers` equals JAX's
    and its last layer equals `produce_hidden`;
  * steered greedy ids equal JAX's through caption and query: plain,
    reasoning, spatial refs, text-only, speculative k 8 (the device span
    loop) and k 24 (the eager span loop), streamed (plain and
    speculative), on the int4 + kv_int8 and GQA routes and under a LoRA
    variant, for a ControlVector and a raw array, with and without
    steer_scale; a zero scale is the unsteered output bit for bit and
    steer_scale alone steers nothing; a wrong shape raises ValueError;
  * CUDA graphs on the CPU (a stand-in capture replays by rerunning what it
    captured): graphed equals eager; two vectors and scales replay one
    graph (no new capture); interleaved steered streams keep their own
    vectors; a steered run reads nothing on the host;
  * ControlVector .npz files load in both packages; train_control_vectors
    equals JAX's bit for bit, recovers a planted direction and raises on
    empty input; HiddenStateCollector.collect at temperature 0 gives JAX's
    states (within 1e-5 of max|ref|), and collect, train and steer run end
    to end.
"""

import copy
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

import moondream_tpu.repeng as jax_repeng
from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch import repeng
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

GREEDY = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 8}
SPATIAL_REFS = [(0.3, 0.4), (0.2, 0.3, 0.6, 0.7)]
IMAGES = [np.random.default_rng(5 + i).integers(0, 255, shape, dtype=np.uint8)
          for i, shape in enumerate([(300, 420, 3), (120, 160, 3)])]
SCALE = 4.2
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _host_crops(monkeypatch):
    # the JAX model's host crop path (its device path is bit-identical)
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _cfg(base, kv_int8=False, n_kv_heads=2):
    return dataclasses.replace(base, text=dataclasses.replace(
        base.text, kv_int8=kv_int8, n_kv_heads=n_kv_heads))


# route -> (kv_int8, KV heads, int4 text blocks)
ROUTES = {"dense": (False, 2, False), "int4+kv_int8": (True, 2, True), "gqa": (False, 1, False)}


def _tree(cfg) -> dict:
    """Seeded fp32 weights with the peaked oracle's biases."""
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = copy.deepcopy({
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
        "region": jax_region.init_region_params(cfg.region, kr, jnp.float32),
    })
    rng = np.random.default_rng(3)
    lb = np.asarray(tree["text"]["lm_head"]["b"])
    tree["text"]["lm_head"]["b"] = jnp.asarray(
        lb + rng.standard_normal(lb.shape).astype(np.float32))
    for site in ("coord_decoder", "size_decoder"):
        b = np.asarray(tree["region"][site]["fc2"]["b"])
        tree["region"][site]["fc2"]["b"] = jnp.asarray(
            b + rng.standard_normal(b.shape).astype(np.float32) * 50)
    return tree


@pytest.fixture(scope="module")
def sides():
    """sides(route) -> (JAX model, port model, JAX config), built once."""
    built = {}

    def get(route):
        if route not in built:
            kv_int8, n_kv, int4 = ROUTES[route]
            jcfg = _cfg(tiny_test_config(), kv_int8, n_kv)
            pcfg = _cfg(port_tiny_config(), kv_int8, n_kv)
            tree = _tree(jcfg)
            if int4:
                tree["text"] = jax_text.quantize_text_params(tree["text"])
            ref = JaxModel(jcfg, params=tree, tokenizer=IdTokenizer(), dtype=jnp.float32)
            ours = MoondreamModel(pcfg, params=params_from_jax(tree, pcfg),
                                  tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
            built[route] = ref, ours, jcfg
        return built[route]

    return get


def _directions(cfg, seed: int = 1) -> np.ndarray:
    """Seeded unit rows (n_layers, dim)."""
    vec = np.random.default_rng(seed).standard_normal(
        (cfg.text.n_layers, cfg.text.dim)).astype(np.float32)
    return vec / np.linalg.norm(vec, axis=-1, keepdims=True)


def _steer(cfg, form: str, seed: int = 1) -> dict:
    """Steering settings of one form, for either package (`ControlVector`
    resolved per package by `_for`)."""
    d = _directions(cfg, seed)
    return {"cv": {"steer": ("cv", d), "steer_scale": SCALE},
            "cv-default": {"steer": ("cv", d)},
            "array": {"steer": d, "steer_scale": SCALE},
            "array-unscaled": {"steer": d * SCALE}}[form]


def _for(settings: dict, jax_side: bool) -> dict:
    s = dict(settings)
    if isinstance(s.get("steer"), tuple):
        cls = jax_repeng.ControlVector if jax_side else repeng.ControlVector
        s["steer"] = cls(s["steer"][1])
    return s


def _close(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-6
    return a == b


def _entry(model, task, settings, jax_side: bool):
    """One public-API call of `task` on either package's model."""
    image = Image.fromarray(IMAGES[0]) if jax_side else IMAGES[0]
    s = _for(settings, jax_side)
    enc = lambda: model.encode_image(image, settings={k: v for k, v in s.items()
                                                       if k.startswith("variant")})
    joined = lambda out: out if isinstance(out, str) else "".join(out)
    if task == "caption":
        return model.caption(enc(), "normal", settings=s)["caption"]
    if task == "stream":
        return joined(model.caption(enc(), "normal", stream=True, settings=s)["caption"])
    if task.startswith("spec"):
        k = int(task.split("-")[1])
        spec = {**s, "speculative": k}
        if task.endswith("stream"):
            return joined(model.caption(enc(), "normal", stream=True, settings=spec)["caption"])
        return model.caption(enc(), "normal", settings=spec)["caption"]
    if task == "query":
        return model.query(enc(), "What is it?", settings=s)["answer"]
    if task == "reasoning":
        out = model.query(enc(), "Where?", reasoning=True, settings=s)
        return out["reasoning"], out["answer"]
    if task == "spatial":
        return model.query(enc(), "What?", spatial_refs=SPATIAL_REFS, settings=s)["answer"]
    assert task == "text-only"
    return model.query(None, "What is it?", settings=s)["answer"]


# ------------------------------------------------------------ text forwards


def _decoder_runs(cfg, jtext, ours, steer):
    """(JAX hidden, port hidden) of a 12-row prefill (prefix 8), one decode
    token and a 5-row span, both caches advancing."""
    rng = np.random.default_rng(41)
    jkv = jax_text.KVCache.create(cfg, batch=1, dtype=jnp.float32)
    pkv = port_text.KVCache.create(ours.config, 1, torch.float32, "cpu")
    jsteer = None if steer is None else jnp.asarray(steer)
    psteer = None if steer is None else torch.from_numpy(steer)
    pos, out = 0, []
    for rows, prefix, bound in ((12, 8, None), (1, 0, 256), (5, 0, 256)):
        x = rng.standard_normal((1, rows, cfg.dim)).astype(np.float32)
        fn = jax.jit(partial(jax_text.text_decoder, config=cfg, kv_bound=bound))
        want, jkv = fn(jnp.asarray(x), jtext, jkv, jnp.int32(pos), jnp.int32(prefix),
                       steer=jsteer)
        got = port_text.text_decoder(torch.from_numpy(x), ours, pkv, pos, prefix, bound,
                                     steer=psteer)
        out.append((np.asarray(want), got.numpy()))
        pos += rows
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_text_decoder_with_steer_matches_jitted_jax(sides, route):
    ref, ours, cfg = sides(route)
    steer = _directions(cfg) * SCALE
    runs = _decoder_runs(cfg.text, ref.params["text"], ours.text, steer)
    base = _decoder_runs(cfg.text, ref.params["text"], ours.text, None)
    for (want, got), (_, plain) in zip(runs, base):
        assert np.abs(got - want).max() <= REL * np.abs(want).max()
        assert np.abs(got - plain).max() > 1.0  # the vector matters


def test_produce_hidden_layers_matches_jax(sides):
    ref, ours, cfg = sides("dense")
    x = np.random.default_rng(0).standard_normal((1, 16, cfg.text.dim)).astype(np.float32)
    want = np.asarray(jax_text.produce_hidden_layers(jnp.asarray(x), ref.params["text"],
                                                     cfg.text))
    got = port_text.produce_hidden_layers(torch.from_numpy(x), ours.text)
    assert got.shape == (cfg.text.n_layers, 1, 16, cfg.text.dim)
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()
    assert torch.equal(got[-1], port_text.produce_hidden(torch.from_numpy(x), ours.text))


# ------------------------------------------------------------ public API


@pytest.fixture(scope="module")
def jax_results(sides):
    """JAX's result of (route, task, form, variant), computed once."""
    done = {}

    def get(route, task, form, variant=None):
        key = (route, task, form, variant)
        if key not in done:
            ref, _, cfg = sides(route)
            s = {**GREEDY, **_steer(cfg, form)}
            if variant:
                s["variant"] = variant
            done[key] = _entry(ref, task, s, True)
        return done[key]

    return get


TASKS = ["caption", "stream", "query", "reasoning", "spatial", "text-only", "spec-8",
         "spec-24", "spec-8-stream", "spec-24-stream"]


@pytest.mark.parametrize("task", TASKS)
def test_steered_ids_equal_jax(sides, jax_results, task):
    ref, ours, cfg = sides("dense")
    want = jax_results("dense", task, "cv")
    assert _close(_entry(ours, task, {**GREEDY, **_steer(cfg, "cv")}, False), want)
    if task in ("caption", "query", "text-only", "spec-24"):
        assert not _close(_entry(ref, task, GREEDY, True), want)  # the vector matters


@pytest.mark.parametrize("form", ["cv-default", "array", "array-unscaled"])
def test_each_form_of_vector_equals_jax(sides, jax_results, form):
    _, ours, cfg = sides("dense")
    got = _entry(ours, "caption", {**GREEDY, **_steer(cfg, form)}, False)
    assert got == jax_results("dense", "caption", form)
    if form == "array-unscaled":  # the same product as "array"
        assert got == jax_results("dense", "caption", "array")


@pytest.mark.parametrize("route,task", [("int4+kv_int8", "caption"), ("int4+kv_int8", "spec-8"),
                                        ("gqa", "caption"), ("gqa", "spec-8")])
def test_steered_ids_equal_jax_on_each_route(sides, jax_results, route, task):
    _, ours, cfg = sides(route)
    assert _entry(ours, task, {**GREEDY, **_steer(cfg, "cv")}, False) == jax_results(
        route, task, "cv")


def _variant_file(path, cfg, b_scale: float = 0.5, rank: int = 4) -> str:
    """A seeded adapter at the tiny widths in the training checkpoint's
    names."""
    rng = np.random.default_rng(0)
    d, ff = cfg.text.dim, cfg.text.ff_dim
    shapes = {"mixer.Wqkv": (d, cfg.text.qkv_dim), "mixer.out_proj": (d, d),
              "mlp.fc1": (d, ff), "mlp.fc2": (ff, d)}
    state = {}
    for i in range(cfg.text.n_layers):
        for site, (fin, fout) in shapes.items():
            a = rng.standard_normal((rank, fin)).astype(np.float32) * 0.1
            b = rng.standard_normal((fout, rank)).astype(np.float32) * b_scale
            state[f"text_model.transformer.h.{i}.{site}.A"] = torch.from_numpy(a)
            state[f"text_model.transformer.h.{i}.{site}.B"] = torch.from_numpy(b)
    torch.save(state, str(path))
    return str(path)


@pytest.mark.parametrize("task", ["caption", "query"])
def test_steered_ids_equal_jax_under_a_variant(sides, jax_results, tmp_path_factory, task):
    _, ours, cfg = sides("dense")
    path = _variant_file(tmp_path_factory.getbasetemp() / "steer-variant.pt", cfg)
    want = jax_results("dense", task, "cv", path)
    assert _entry(ours, task, {**GREEDY, **_steer(cfg, "cv"), "variant": path}, False) == want
    assert want != jax_results("dense", task, "cv")


def test_zero_scale_is_the_base_bit_for_bit(sides):
    """The prompt's logits and the caption: steer_scale 0 gives the
    unsteered bits; steer_scale alone (no vector) steers nothing."""
    _, ours, cfg = sides("dense")
    enc = ours.encode_image(IMAGES[0])
    prompt = list(ours.config.tokenizer.templates["caption"]["normal"])

    def first_logits(s):
        kv = ours.load_encoded_image(enc)
        out = ours._prefill_prompt(kv, prompt, enc.pos, 0.0, 0.0,
                                   steer=ours._steer_vectors(s))[0]
        ours._recycle_kv(kv)
        return out

    zero = {**_steer(cfg, "array"), "steer_scale": 0.0}
    base = first_logits(None)
    assert torch.equal(first_logits(zero), base)
    assert torch.equal(first_logits({"steer_scale": 3.0}), base)
    assert not torch.equal(first_logits(_steer(cfg, "array")), base)
    caption = ours.caption(enc, settings=GREEDY)["caption"]
    for s in (zero, {"steer_scale": 3.0}):
        assert ours.caption(enc, settings={**GREEDY, **s})["caption"] == caption
    cv = repeng.ControlVector(_directions(cfg))
    assert ours.caption(enc, settings={**GREEDY, "steer": cv, "steer_scale": 0.0}) == {
        "caption": caption}


@pytest.mark.parametrize("shape", [(2, 63), (3, 64), (64,)])
def test_a_wrong_shaped_vector_raises(sides, shape):
    _, ours, _ = sides("dense")
    with pytest.raises(ValueError, match="n_layers, dim"):
        ours.caption(IMAGES[0], settings={**GREEDY, "steer": np.ones(shape, np.float32)})


# ------------------------------------------------------------ CUDA graphs


class _RerunGraph:
    """A stand-in CUDA graph: a replay reruns what was captured."""

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
    """Graphs on the CPU: graphs.enabled() is true, and a capture runs the
    warm-up, then records the function, which each replay reruns over the
    state it captured (so a vector outside the state would be stale)."""
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


LOOPS = {"caption": "generate_text", "spec-8": "generate_text_spec",
         "spec-8-stream": "generate_text_spec"}


@pytest.mark.parametrize("task", list(LOOPS))
def test_graphed_equals_eager_when_steered(sides, stand_in_graphs, task):
    _, ours, cfg = sides("dense")
    s = {**GREEDY, "max_tokens": 20, **_steer(cfg, "cv")}
    ours.graphed = False
    try:
        eager = _entry(ours, task, s, False)
    finally:
        ours.graphed = True
    assert stand_in_graphs == []
    for _ in range(2):  # the first run captures, the second replays
        assert _entry(ours, task, s, False) == eager
    assert LOOPS[task] in stand_in_graphs
    assert graphs.REPLAYS.get(LOOPS[task], 0) >= 1


def test_one_graph_serves_every_vector_and_scale(sides, stand_in_graphs):
    """Captions (24 tokens) under two vectors and three scales, graphed, on
    the model's recycled cache: each equals its eager run, and only the
    first steered call captures (the unsteered call keeps its own graph)."""
    _, ours, cfg = sides("dense")
    runs = [None, _steer(cfg, "cv"), {"steer": _directions(cfg, 2), "steer_scale": 2.0},
            {"steer": ("cv", _directions(cfg)), "steer_scale": 1.0}, _steer(cfg, "cv"), None]
    settings = [{**GREEDY, "max_tokens": 24, **(r or {})} for r in runs]
    ours.graphed = False
    try:
        eager = [_entry(ours, "caption", s, False) for s in settings]
    finally:
        ours.graphed = True
    assert len(set(eager[:4])) == 4
    captures = []
    for s, want in zip(settings, eager):
        assert _entry(ours, "caption", s, False) == want
        captures.append(stand_in_graphs.count("generate_text"))
    assert captures == [1, 2, 2, 2, 2, 2]


def test_interleaved_steered_streams_keep_their_vectors(sides, stand_in_graphs):
    """Two steered streams (plain and speculative) advanced in turns, each
    equal to its own fused caption."""
    _, ours, cfg = sides("dense")
    for k in (None, 8):
        spec = {} if k is None else {"speculative": k}
        s = [{**GREEDY, "max_tokens": 16, **spec, **_steer(cfg, "cv", seed)} for seed in (1, 2)]
        fused = [ours.caption(IMAGES[0], settings=_for(x, False))["caption"] for x in s]
        assert fused[0] != fused[1]
        streams = [iter(ours.caption(IMAGES[0], stream=True, settings=_for(x, False))["caption"])
                   for x in s]
        out, live = ["", ""], [True, True]
        while any(live):
            for i, it in enumerate(streams):
                if live[i]:
                    chunk = next(it, None)
                    live[i] = chunk is not None
                    out[i] += chunk or ""
        assert out == fused


HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.mark.parametrize("loop", ["answer", "spec"])
def test_a_steered_run_reads_nothing_on_the_host(sides, monkeypatch, loop):
    _, ours, cfg = sides("dense")
    model = ours.text
    steer = torch.from_numpy(_directions(cfg) * SCALE)
    kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(35).standard_normal(
        (1, 12, cfg.text.dim)).astype(np.float32))
    port_text.text_decoder(x, model, kv, 0, 8, steer=steer)
    first = torch.tensor([300])
    if loop == "answer":
        st, run = port_generate.answer_loop(model, kv, first, 12, None, 0.0, 0.0, -1, (3,),
                                            256, True, "test", steer=steer)
    else:
        st, run = port_generate.spec_loop(model, kv, first, 12, 64, -1, (3,), 4, 256, None,
                                          None, 0.0, 0.0, True, "test", steer=steer)
    assert torch.equal(st.steer, steer)
    for name in HOST_READS:
        def raiser(self, *a, _name=name, **k):
            raise AssertionError(f"host read Tensor.{_name} inside a run")
        monkeypatch.setattr(torch.Tensor, name, raiser)
    run(port_generate.DONE_CHECK_EVERY)
    monkeypatch.undo()
    assert st.count.tolist()[0] >= 8


# ------------------------------------------------------------ repeng.py


def test_control_vector_files_cross_between_packages(tmp_path):
    d = np.random.default_rng(4).standard_normal((3, 8)).astype(np.float32)
    ours = repeng.ControlVector(d, default_scale=2.5)
    theirs = jax_repeng.ControlVector(d, default_scale=2.5)
    ours.save(str(tmp_path / "ours.npz"))
    theirs.save(str(tmp_path / "theirs.npz"))
    for loaded in (jax_repeng.ControlVector.load(str(tmp_path / "ours.npz")),
                   repeng.ControlVector.load(str(tmp_path / "theirs.npz"))):
        np.testing.assert_array_equal(loaded.directions, d)
        assert loaded.default_scale == 2.5
    for scale in (None, 0.7):
        np.testing.assert_array_equal(ours.scaled(scale).numpy(),
                                      np.asarray(theirs.scaled(scale)))
    np.testing.assert_array_equal((-ours).directions, -d)
    assert (-ours).default_scale == 2.5


def test_train_control_vectors_equals_jax():
    rng = np.random.default_rng(7)
    pos = [rng.standard_normal((3, 32)).astype(np.float32) for _ in range(9)]
    neg = [rng.standard_normal((3, 32)).astype(np.float32) for _ in range(7)]
    got, want = repeng.train_control_vectors(pos, neg), jax_repeng.train_control_vectors(pos, neg)
    np.testing.assert_array_equal(got.directions, want.directions)
    assert got.default_scale == want.default_scale == repeng.DEFAULT_SCALE


def test_train_control_vectors_recovers_a_planted_direction():
    rng = np.random.default_rng(0)
    n_layers, dim = 3, 32
    planted = rng.standard_normal((n_layers, dim)).astype(np.float32)
    planted /= np.linalg.norm(planted, axis=-1, keepdims=True)
    pos, neg = [], []
    for _ in range(64):
        base = rng.standard_normal((n_layers, dim)).astype(np.float32) * 0.3
        shift = rng.uniform(0.5, 1.5)
        pos.append(base + shift * planted)
        neg.append(base - shift * planted)
    cv = repeng.train_control_vectors(pos, neg)
    assert (np.sum(cv.directions * planted, axis=-1) > 0.95).all()
    with pytest.raises(ValueError):
        repeng.train_control_vectors([], [])
    with pytest.raises(ValueError):
        repeng.train_control_vectors(pos, [])


def test_collect_equals_jax_and_steers_end_to_end(sides):
    ref, ours, cfg = sides("dense")
    kw = dict(samples_per_image=1, max_tokens=6, temperature=0.0)
    images = IMAGES[:2]
    want = jax_repeng.HiddenStateCollector(ref).collect([Image.fromarray(i) for i in images],
                                                        "describe", **kw)
    reps = repeng.HiddenStateCollector(ours)
    got = reps.collect(images, "describe", **kw)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.shape == (cfg.text.n_layers, cfg.text.dim) and g.dtype == np.float32
        assert np.abs(g - w).max() <= REL * np.abs(w).max()

    neg = reps.collect(images, "ignore", **kw)
    cv = repeng.train_control_vectors(got, neg)
    np.testing.assert_allclose(np.linalg.norm(cv.directions, axis=-1), 1.0, rtol=1e-5)
    steered = ours.query(IMAGES[0], "What?", settings={**GREEDY, "steer": cv,
                                                        "steer_scale": 20.0})["answer"]
    assert steered and steered != ours.query(IMAGES[0], "What?", settings=GREEDY)["answer"]
    for key, value in (("steer", cv), ("variant", "x"), ("variant_tree", {})):
        with pytest.raises(NotImplementedError, match=key):
            reps.collect(images, "x", settings={key: value}, **kw)
