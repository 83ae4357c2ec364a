"""The port's handling of the JAX package's LoRA-variant and steering
settings in every entry point that takes settings.

`variant`, `variant_tree` and `variant_label` apply in every entry point but
`detect_gaze` (the JAX package's runs no adapter) and `PooledPipeline` (the
JAX package's builds its pool without variants and drops the setting):
with a nonzero adapter the delta reaches every site of every layer of the
text forwards the entry runs, a zero-B adapter gives the base output bit
for bit, and an EncodedImage of another variant label is refused. `steer`
and `steer_scale` apply in caption and query (and compile, which warms
them), as the JAX package's do: the vector reaches the answer's prompt
prefill and every decode step (each adding its every row), not the image
prefill, a zero scale gives the base output bit for bit, and a scale
alone steers nothing (tests/test_torch_repeng.py holds the ids to JAX's).
Every other entry point, which the JAX package lets drop them without a
word, raises NotImplementedError naming the entry point, as do the
variant settings in `detect_gaze` and `PooledPipeline`. The pool's
`variant=` names one of its own variants (tests/test_torch_multi_lora.py):
an unknown name raises KeyError in every submission."""

import inspect

import numpy as np
import pytest
import torch

from moondream_tpu_torch import lora as port_lora
from moondream_tpu_torch.config import tiny_test_config
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.engine.pipeline import BatchPipeline, PooledPipeline
from moondream_tpu_torch.models.moondream import (
    STEER_SETTINGS,
    VARIANT_SETTINGS,
    EncodedImage,
    MoondreamModel,
)
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.models.text import LORA_SITES
from moondream_tpu_torch.ops import layers

IMG = np.zeros((40, 60, 3), dtype=np.uint8)
FACE = {"x_min": 0.3, "x_max": 0.6, "y_min": 0.2, "y_max": 0.5}
RANK = 4

# entry(model, settings, image): `image` is IMG, or an EncodedImage where the
# entry takes one
ENTRY_POINTS = {
    "encode_image": lambda m, s, im: m.encode_image(im, settings=s),
    "encode_images": lambda m, s, im: m.encode_images([IMG], settings=s),
    "caption": lambda m, s, im: m.caption(im, settings=s),
    "query": lambda m, s, im: m.query(im, "why?", settings=s),
    "detect": lambda m, s, im: m.detect(im, "cat", settings=s),
    "point": lambda m, s, im: m.point(im, "cat", settings=s),
    "detect_gaze": lambda m, s, im: m.detect_gaze(im, face=FACE, unstable_settings={
        "prioritize_accuracy": True, **s}),
    "caption_batch": lambda m, s, im: m.caption_batch([im], settings=s),
    "query_batch": lambda m, s, im: m.query_batch([im], "why?", settings=s),
    "detect_batch": lambda m, s, im: m.detect_batch([im], "cat", settings=s),
    "point_batch": lambda m, s, im: m.point_batch([im], "cat", settings=s),
    "compile": lambda m, s, im: m.compile(settings=s),
    "BatchPipeline": lambda m, s, im: BatchPipeline(m, batch_size=1).caption([IMG], settings=s),
    "PooledPipeline": lambda m, s, im: PooledPipeline(m, n_slots=2).caption([IMG], settings=s),
}
# the entry points that refuse the variant settings
NO_VARIANTS = ("PooledPipeline", "detect_gaze")
# the entry points that apply the steering settings
STEERED = ("caption", "compile", "query")
APPLYING = sorted(set(ENTRY_POINTS) - set(NO_VARIANTS))
# the entry points whose image may be an EncodedImage
TAKE_ENCODED = ("encode_image", "caption", "query", "detect", "point", "caption_batch",
                "query_batch", "detect_batch", "point_batch")
VALUES = {"variant": "some/adapter", "variant_tree": {"blocks": {}},
          "variant_label": "some/adapter", "steer": np.ones((2, 64), np.float32),
          "steer_scale": 5.0}
SMALL = {"max_tokens": 2, "max_objects": 2, "temperature": 0.0, "top_p": 0.0}


@pytest.fixture(scope="module")
def model():
    return MoondreamModel(tiny_test_config(), dtype=torch.float32, seed=1, device="cpu")


def _variant_file(path, cfg, b_scale: float) -> str:
    """A seeded adapter in the training checkpoint's legacy names (as
    tests/test_lora.py writes one)."""
    rng = np.random.default_rng(0)
    d, ff = cfg.text.dim, cfg.text.ff_dim
    sites = {"mixer.Wqkv": (d, cfg.text.qkv_dim), "mixer.out_proj": (d, d),
             "mlp.fc1": (d, ff), "mlp.fc2": (ff, d)}
    state = {}
    for i in range(cfg.text.n_layers):
        for site, (fin, fout) in sites.items():
            a = rng.standard_normal((RANK, fin)).astype(np.float32) * 0.1
            b = rng.standard_normal((fout, RANK)).astype(np.float32) * b_scale
            state[f"text_model.transformer.h.{i}.{site}.A"] = torch.from_numpy(a)
            state[f"text_model.transformer.h.{i}.{site}.B"] = torch.from_numpy(b)
    torch.save(state, str(path))
    return str(path)


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    cfg = tiny_test_config()
    tmp = tmp_path_factory.mktemp("variants")
    return {"zero": _variant_file(tmp / "zero.pt", cfg, 0.0),
            "real": _variant_file(tmp / "real.pt", cfg, 0.5)}


def _tree(model, path):
    """A loaded copy of the adapter at `path`, as a caller's variant_tree."""
    loaded = port_lora.variant_state_dict(path, model.config.text.n_layers, torch.float32,
                                          model.device)
    return {g: {n: {f: t.clone() for f, t in p.items()} for n, p in sites.items()}
            for g, sites in loaded.items()}


def _settings(model, key, variants, which):
    if key == "variant":
        return {**SMALL, "variant": variants[which]}
    return {**SMALL, "variant_tree": _tree(model, variants[which])}


def _same(a, b) -> bool:
    """Equal outputs; an EncodedImage by its snapshot (its label names the
    variant, which the zero-B case changes)."""
    if isinstance(a, EncodedImage):
        return torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, MoondreamModel):
        return a is b
    return a == b


def test_every_unported_key_has_a_case():
    assert set(VALUES) == set(STEER_SETTINGS) | set(VARIANT_SETTINGS)
    assert len(APPLYING) == 12


REFUSALS = ([(e, k) for e in sorted(set(ENTRY_POINTS) - set(STEERED))
             for k in sorted(STEER_SETTINGS)]
            + [(e, k) for e in NO_VARIANTS for k in sorted(VARIANT_SETTINGS)])


@pytest.mark.parametrize("entry,key", REFUSALS, ids=[f"{e}-{k}" for e, k in REFUSALS])
def test_entry_points_refuse_variants_and_steering(model, entry, key):
    """Where the JAX package drops the setting without a word."""
    with pytest.raises(NotImplementedError, match=rf"\['{key}'\]: {entry} does not apply"):
        ENTRY_POINTS[entry](model, {"max_tokens": 2, key: VALUES[key]}, IMG)


STEERING = [(e, k) for e in STEERED for k in sorted(STEER_SETTINGS)]


@pytest.mark.parametrize("entry,key", STEERING, ids=[f"{e}-{k}" for e, k in STEERING])
def test_entry_points_apply_steering(model, monkeypatch, entry, key):
    """`steer`: every text forward of the answer (its prompt prefill and
    each decode step) gets the whole (n_layers, dim) vector times the
    scale, the image prefill none, and the answer's hidden states move;
    compile warms a steered answer loop (its graph state, under graphs
    enabled on the CPU) and runs its detect and point warm-ups unsteered.
    `steer_scale`: alone it steers nothing, and a zero scale gives the base
    output and every hidden state bit for bit."""
    run = ENTRY_POINTS[entry]
    cfg = model.config.text
    vec = np.random.default_rng(2).standard_normal((cfg.n_layers, cfg.dim)).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
    calls = []
    decoder = port_generate.text_decoder

    def recorded(*args, **kw):
        arg = inspect.signature(decoder).bind(*args, **kw).arguments
        steer = arg.get("steer")
        out = decoder(*args, **kw)
        calls.append((arg["x"].shape[1], None if steer is None else steer.clone(), out.clone()))
        return out

    def traced(s):
        calls.clear()
        return run(model, {**SMALL, **s}, IMG), list(calls)

    monkeypatch.setattr(port_generate, "text_decoder", recorded)
    if entry == "compile":  # graphs on the CPU: a capture runs its steps, a replay reruns them
        monkeypatch.setattr(graphs, "enabled", lambda dev: True)
        monkeypatch.setattr(graphs, "capture", lambda cache, fn, label, generator=None: (
            graphs.StepGraph(type("Rerun", (), {"replay": lambda self: fn()})(), {}, label, ()),
            fn(), None))
    base, base_calls = traced({})
    assert all(s is None for _, s, _ in base_calls)
    hidden = lambda cs: [o for _, _, o in cs]
    if key == "steer_scale":
        for s in ({"steer_scale": 3.0}, {"steer": vec, "steer_scale": 0.0}):
            out, cs = traced(s)
            assert _same(out, base)
            assert all(torch.equal(a, b) for a, b in zip(hidden(cs), hidden(base_calls)))
            assert all(st is None or not st.any() for _, st, _ in cs)
        return
    out, cs = traced({"steer": vec, "steer_scale": 100.0})
    steered = [(n, st, o) for n, st, o in cs if st is not None]
    assert steered and all(torch.equal(st, torch.from_numpy(vec) * 100.0) for _, st, _ in steered)
    assert all(st is None for n, st, _ in cs if n > 700)  # the image prefills
    assert any(n <= 700 and st is None for n, st, _ in base_calls)
    first = next(i for i, (n, st, _) in enumerate(cs) if st is not None)
    assert not torch.equal(cs[first][2], base_calls[first][2])  # the answer's prefill moved
    if entry == "compile":
        keys = list(graphs.cache_of(model.text).entries)
        assert any(k[0] == "generate_text" and k[6] is True for k in keys)
        assert any(k[0] == "generate_points" for k in keys)
        last = max(i for i, (_, st, _) in enumerate(cs) if st is not None)
        assert all(st is None for _, st, _ in cs[last + 1:])  # detect, point and gaze
        graphs.cache_of(model.text).entries.clear()


APPLIED = [(e, k) for e in APPLYING for k in sorted(VARIANT_SETTINGS)]


@pytest.mark.parametrize("entry,key", APPLIED, ids=[f"{e}-{k}" for e, k in APPLIED])
def test_entry_points_apply_variants(model, variants, monkeypatch, entry, key):
    """`variant` / `variant_tree`: a nonzero adapter reaches qkv, proj, fc1
    and fc2 of every layer; a zero-B one gives the base output bit for
    bit. `variant_label`: an EncodedImage of another label is refused where
    the entry takes one; encode_images labels its snapshots; elsewhere a
    label alone runs the base weights."""
    run = ENTRY_POINTS[entry]
    n_layers = model.config.text.n_layers
    base = run(model, SMALL, IMG)
    if key == "variant_label":
        mine = {**SMALL, "variant_label": "mine"}
        if entry in TAKE_ENCODED:
            other = model.encode_image(IMG, settings={"variant_label": "other"})
            with pytest.raises(ValueError, match="variant"):
                run(model, mine, other)
            assert other.variant == "other"
            run(model, mine, model.encode_image(IMG, settings=mine))
        elif entry == "encode_images":
            out = run(model, mine, IMG)
            assert [e.variant for e in out] == ["mine"] and _same(out, base)
        else:
            assert _same(run(model, mine, IMG), base)
        return

    real = _settings(model, key, variants, "real")
    tree = model._variant(real)
    where = {tree[g][n]["A"][layer].data_ptr(): (n, layer)
             for g, n in LORA_SITES for layer in range(n_layers)}
    seen = set()
    delta = layers.lora_delta

    def counted(x, pair, *rest):
        seen.add(where[pair["A"].data_ptr()])
        return delta(x, pair, *rest)

    monkeypatch.setattr(layers, "lora_delta", counted)
    run(model, real, IMG)
    monkeypatch.undo()
    assert seen == {(n, layer) for _, n in LORA_SITES for layer in range(n_layers)}
    assert _same(run(model, _settings(model, key, variants, "zero"), IMG), base)


def test_unset_keys_are_accepted(model):
    s = {"max_tokens": 2, "temperature": 0.0, "variant": None, "steer": None}
    assert isinstance(model.caption(IMG, settings=s)["caption"], str)


SUBMISSIONS = {
    "submit": lambda e, v: e.submit(IMG, variant=v),
    "submit_many": lambda e, v: e.submit_many([IMG], variant=v),
    "prepare": lambda e, v: e.prepare(IMG, variant=v),
    "submit_detect": lambda e, v: e.submit_detect(IMG, "cat", variant=v),
    "submit_point": lambda e, v: e.submit_point(IMG, "cat", variant=v),
    "submit_gaze": lambda e, v: e.submit_gaze(IMG, (0.5, 0.5), variant=v),
    "prepare_gaze": lambda e, v: e.prepare_gaze(IMG, (0.5, 0.5), variant=v),
    "prepare_structured": lambda e, v: e.prepare_structured(IMG, "cat", "detect", True,
                                                            variant=v),
}


@pytest.mark.parametrize("submission", sorted(SUBMISSIONS))
def test_pool_submissions_refuse_variants(model, submission):
    """A variant the pool was not built with raises KeyError('unknown
    variant ...') before anything is encoded, and leaves every slot free."""
    eng = ContinuousBatchingEngine(model, n_slots=2)
    with pytest.raises(KeyError, match="unknown variant 'a'; registered: \\[\\]"):
        SUBMISSIONS[submission](eng, "a")
    assert len(eng.free_slots()) == 2


@pytest.mark.parametrize("submission", ["prepare_gaze", "prepare_structured"])
def test_pool_prepares_take_variant_none(model, submission):
    """The JAX engine's signatures: variant=None runs."""
    eng = ContinuousBatchingEngine(model, n_slots=2)
    prep = SUBMISSIONS[submission](eng, None)
    assert prep.structured in ("gaze", "detect")
    eng.release_prepared(prep)
