"""LoRA variants in the port (`moondream_tpu_torch/lora.py`, the adapter in
every text forward) against the JAX package on the CPU, at
tiny_test_config in fp32, with adapters written from seeds in the training
checkpoint's legacy names (as tests/test_lora.py writes them; nothing is
downloaded):

  * `variant_state_dict` gives JAX's factors bit for bit (both read one
    file), in fp32 and bf16; the rename rules and the cache directory are
    JAX's, and a missing adapter raises FileNotFoundError;
  * `lora_delta` / `lora_linear` equal JAX's in fp32 (rtol 1e-5) and stay
    within 2x JAX's own error in bf16 (against float64);
  * `text_decoder` with an adapter (a 12-row prefill bidirectional over 8,
    one decode token, a 5-row span) equals JAX's jitted one on the dense,
    int4, int8 w8a8, GQA and int8-KV routes (hidden states atol / rtol
    1e-4: the same fp32 math summed in another order);
  * a zero-B adapter is a bit-for-bit no-op and a nonzero one changes the
    logits (tests/test_lora.py:72-98);
  * greedy ids and boxes equal JAX's through the public API under the
    peaked oracle (lm_head bias + N(0, 1), region decoders' fc2 bias +
    N(0, 1) x 50), for `variant` and for `variant_tree`
    (`weights.lora_from_jax`): caption, query (plain, reasoning, spatial
    refs), detect, point, the four lockstep batches, greedy speculative,
    streamed and BatchPipeline; and a caption on the int4, int8 w8a8, GQA
    and int8-KV routes;
  * an EncodedImage of another variant raises ValueError in both packages;
  * `merge_variant` folds JAX's weights (rtol 1e-6), returns no residual
    for a zero proj adapter, equals the adapter forward once the residual
    is passed (rtol 1e-5 on the prefill logits and on `produce_hidden`),
    and refuses int4 and int8 blocks; `stack_variant_pytrees` equals JAX's;
  * CUDA graphs on the CPU (a stand-in capture replays by rerunning what
    it captured): graphed equals eager under an adapter; switching
    adapters gives each its own ids and going back reuses the first
    graph; a run under an adapter reads nothing on the host.
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

import moondream_tpu.lora as jax_lora
from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import pipeline as jax_pipeline
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.ops import layers as jax_layers
from moondream_tpu_torch import lora as port_lora
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.engine.pipeline import BatchPipeline
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.ops import layers as port_layers
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import lora_from_jax, lora_to_jax, params_from_jax

RANK = 4
ATOL = RTOL = 1e-4
BOX_ATOL = 1e-6
GREEDY = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 8, "max_objects": 4}
SPATIAL_REFS = [(0.3, 0.4), (0.2, 0.3, 0.6, 0.7)]
IMAGES = [np.random.default_rng(5 + i).integers(0, 255, shape, dtype=np.uint8)
          for i, shape in enumerate([(300, 420, 3), (120, 160, 3)])]
SITES = {"mixer.Wqkv": "qkv", "mixer.out_proj": "proj", "mlp.fc1": "fc1", "mlp.fc2": "fc2"}


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


def _variant_file(path, b_scale: float, rank: int = RANK, seed: int = 0,
                  zero=(), n_kv_heads: int = 2) -> str:
    """A seeded adapter at the tiny widths (with `n_kv_heads` KV heads) in
    the legacy names; the sites in `zero` get B = 0."""
    cfg = _cfg(tiny_test_config(), n_kv_heads=n_kv_heads).text
    rng = np.random.default_rng(seed)
    d, ff = cfg.dim, cfg.ff_dim
    shapes = {"mixer.Wqkv": (d, cfg.qkv_dim), "mixer.out_proj": (d, d),
              "mlp.fc1": (d, ff), "mlp.fc2": (ff, d)}
    state = {}
    for i in range(cfg.n_layers):
        for site, (fin, fout) in shapes.items():
            a = rng.standard_normal((rank, fin)).astype(np.float32) * 0.1
            b = rng.standard_normal((fout, rank)).astype(np.float32) * b_scale
            if SITES[site] in zero:
                b[:] = 0.0
            state[f"text_model.transformer.h.{i}.{site}.A"] = torch.from_numpy(a)
            state[f"text_model.transformer.h.{i}.{site}.B"] = torch.from_numpy(b)
    torch.save(state, str(path))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lora")
    return {"zero": _variant_file(tmp / "zero.pt", 0.0),
            "real": _variant_file(tmp / "real.pt", 0.5),
            "real2": _variant_file(tmp / "real2.pt", 0.5, rank=2, seed=1),
            "noproj": _variant_file(tmp / "noproj.pt", 0.5, seed=2, zero=("proj",)),
            "real-gqa": _variant_file(tmp / "real-gqa.pt", 0.5, n_kv_heads=1)}


def _real(files, route: str) -> str:
    """The nonzero adapter at the route's widths."""
    return files["real-gqa" if route == "gqa" else "real"]


def _jax_tree(name: str, n_layers: int = 2) -> dict:
    return jax_lora.variant_state_dict(name, n_layers=n_layers, dtype_str="float32")


def _cfg(base, kv_int8=False, n_kv_heads=2):
    return dataclasses.replace(base, text=dataclasses.replace(
        base.text, kv_int8=kv_int8, n_kv_heads=n_kv_heads))


# route -> (kv_int8, KV heads, text weights)
ROUTES = {"dense": (False, 2, None), "int4": (False, 2, "int4"), "int8": (False, 2, "int8"),
          "gqa": (False, 1, None), "kv_int8": (True, 2, None)}


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
    """sides(route) -> (JAX model, port model, JAX config) on one peaked
    tree, built once per route."""
    built = {}

    def get(route):
        if route not in built:
            kv_int8, n_kv, fmt = ROUTES[route]
            jcfg = _cfg(tiny_test_config(), kv_int8, n_kv)
            pcfg = _cfg(port_tiny_config(), kv_int8, n_kv)
            tree = _tree(jcfg)
            if fmt == "int4":
                tree["text"] = jax_text.quantize_text_params(tree["text"])
            elif fmt == "int8":
                tree["text"] = jax_text.quantize_text_params_int8(tree["text"])
            ref = JaxModel(jcfg, params=tree, tokenizer=IdTokenizer(), dtype=jnp.float32)
            ours = MoondreamModel(pcfg, params=params_from_jax(tree, pcfg),
                                  tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
            built[route] = ref, ours, jcfg
        return built[route]

    return get


def _pil(images):
    return [Image.fromarray(im) for im in images]


# ------------------------------------------------------------ lora.py


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_variant_state_dict_equals_jax(files, dtype):
    want = jax_lora.variant_state_dict(files["real2"], n_layers=2, dtype_str=dtype)
    got = port_lora.variant_state_dict(files["real2"], 2, getattr(torch, dtype), "cpu")
    assert got is port_lora.variant_state_dict(files["real2"], 2, getattr(torch, dtype), "cpu")
    for grp, name in port_text.LORA_SITES:
        for f in ("A", "B"):
            t = got[grp][name][f]
            assert t.dtype == getattr(torch, dtype) and t.shape[0] == 2
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(want[grp][name][f], np.float32))
    cfg = tiny_test_config().text
    assert got["attn"]["qkv"]["A"].shape == (2, 2, cfg.dim)
    assert got["mlp"]["fc2"]["B"].shape == (2, cfg.dim, 2)


def test_rename_rules_and_local_files(files, tmp_path, monkeypatch):
    assert port_lora._RENAME_RULES == jax_lora._RENAME_RULES
    assert (port_lora._renamed("text_model.transformer.h.3.mixer.Wqkv.parametrizations."
                               "weight.0.A") == "text.blocks.3.attn.qkv.A")
    assert port_lora.cached_variant_path(files["real"]) == jax_lora.cached_variant_path(
        files["real"])
    for env in ({"HF_HUB_CACHE": str(tmp_path / "hub")}, {"HF_HOME": str(tmp_path / "home")}):
        monkeypatch.delenv("HF_HUB_CACHE", raising=False)
        monkeypatch.delenv("HF_HOME", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert port_lora.variant_cache_dir() == jax_lora.variant_cache_dir()
    cached = port_lora.variant_cache_dir() / "my-variant" / "final.pt"
    cached.parent.mkdir(parents=True)
    cached.write_bytes(open(files["real"], "rb").read())
    assert port_lora.cached_variant_path("my-variant") == cached
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        port_lora.cached_variant_path("no-such-variant")
    assert not (port_lora.variant_cache_dir() / "no-such-variant").exists()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["lora_delta", "lora_linear"])
def test_lora_ops_match_jax(op, dtype):
    """fp32: rtol 1e-5; bf16 inputs: the port's error against float64 at
    most 2x JAX's own (floored at 2^-20 of the result's scale)."""
    rng = np.random.default_rng(7)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rnd = lambda *shape, s=1.0: np.array(
        jnp.asarray(rng.standard_normal(shape).astype(np.float32) * s, jdt), np.float32)
    x, a, b = rnd(3, 5, 64), rnd(4, 64, s=0.1), rnd(96, 4, s=0.5)
    w, bias = rnd(64, 96, s=0.125), rnd(96, s=0.1)
    jpair = {"A": jnp.asarray(a, jdt), "B": jnp.asarray(b, jdt)}
    tpair = {"A": torch.from_numpy(a).to(tdt), "B": torch.from_numpy(b).to(tdt)}
    tx = torch.from_numpy(x).to(tdt)
    ref = (x.astype(np.float64) @ a.T.astype(np.float64)) @ b.T.astype(np.float64)
    if op == "lora_delta":
        want = jax.jit(jax_layers.lora_delta)(jnp.asarray(x, jdt), jpair)
        got = port_layers.lora_delta(tx, tpair)
    else:
        ref = ref + x.astype(np.float64) @ w.astype(np.float64) + bias
        want = jax.jit(jax_layers.lora_linear)(
            jnp.asarray(x, jdt), {"w": jnp.asarray(w, jdt), "b": jnp.asarray(bias, jdt)}, jpair)
        lin = port_layers.Linear(64, 96, dtype=tdt)
        lin.w.copy_(torch.from_numpy(w))
        lin.b.copy_(torch.from_numpy(bias))
        got = port_layers.lora_linear(tx, lin, tpair)
        assert got.dtype == tdt
    want, got = np.asarray(want, np.float64), got.double().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        floor = 2.0 ** -20 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= 2 * max(np.abs(want - ref).max(), floor)


# ------------------------------------------------------------ text decoder


def _decoder_runs(cfg, jtext, ours, jlora, plora):
    """(JAX hidden, port hidden) of a 12-row prefill (prefix 8), one decode
    token and a 5-row span, both caches advancing."""
    rng = np.random.default_rng(41)
    jkv = jax_text.KVCache.create(cfg, batch=1, dtype=jnp.float32)
    pkv = port_text.KVCache.create(ours.config, 1, torch.float32, "cpu")
    pos, out = 0, []
    for rows, prefix, bound in ((12, 8, None), (1, 0, 256), (5, 0, 256)):
        x = rng.standard_normal((1, rows, cfg.dim)).astype(np.float32)
        fn = jax.jit(partial(jax_text.text_decoder, config=cfg, kv_bound=bound))
        want, jkv = fn(jnp.asarray(x), jtext, jkv, jnp.int32(pos), jnp.int32(prefix),
                       lora=jlora)
        got = port_text.text_decoder(torch.from_numpy(x), ours, pkv, pos, prefix, bound,
                                     lora=plora)
        out.append((np.asarray(want), got.numpy()))
        pos += rows
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_text_decoder_with_adapter_matches_jitted_jax(sides, files, route):
    ref, ours, cfg = sides(route)
    jlora = _jax_tree(_real(files, route))
    runs = _decoder_runs(cfg.text, ref.params["text"], ours.text, jlora, lora_from_jax(jlora))
    base = _decoder_runs(cfg.text, ref.params["text"], ours.text, None, None)
    for (want, got), (_, plain) in zip(runs, base):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        assert np.abs(got - plain).max() > 1e-2  # the adapter matters


@pytest.mark.parametrize("form", ["variant", "variant_tree"])
def test_zero_b_is_a_noop_and_nonzero_changes_logits(sides, files, form):
    _, ours, _ = sides("dense")
    enc = ours.encode_image(IMAGES[0])
    prompt = list(ours.config.tokenizer.templates["caption"]["normal"])

    def first_logits(name):
        s = None if name is None else (
            {"variant": files[name]} if form == "variant"
            else {"variant_tree": lora_from_jax(_jax_tree(files[name]))})
        kv = ours.load_encoded_image(enc)
        logits = ours._prefill_prompt(kv, prompt, enc.pos, 0.0, 0.0,
                                      lora=ours._variant(s))[0]
        ours._recycle_kv(kv)
        return logits

    base = first_logits(None)
    assert torch.equal(first_logits("zero"), base)
    assert not torch.equal(first_logits("real"), base)


# ------------------------------------------------------------ public API


def _close(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= BOX_ATOL
    return a == b


def _entry(model, task, images, settings, jax_side: bool):
    """One public-API call of `task` on either package's model."""
    ims = _pil(images) if jax_side else images
    enc = lambda: model.encode_image(ims[0], settings=settings)
    s = settings
    if task == "caption":
        return model.caption(enc(), "normal", settings=s)["caption"]
    if task == "stream":
        return "".join(model.caption(enc(), "normal", stream=True, settings=s)["caption"])
    if task == "spec":
        return model.caption(enc(), "normal", settings={**s, "speculative": 4})["caption"]
    if task == "query":
        return model.query(enc(), "What is it?", settings=s)["answer"]
    if task == "reasoning":
        return model.query(enc(), "Where?", reasoning=True, settings=s)
    if task == "spatial":
        return model.query(enc(), "What?", spatial_refs=SPATIAL_REFS, settings=s)["answer"]
    if task == "detect":
        return model.detect(enc(), "thing", settings=s)
    if task == "point":
        return model.point(enc(), "thing", settings=s)
    if task == "caption_batch":
        return model.caption_batch(ims, "normal", settings=s)
    if task == "query_batch":
        return model.query_batch(ims, "What is it?", settings=s)
    if task == "detect_batch":
        return model.detect_batch(ims, "thing", settings=s)
    if task == "point_batch":
        return model.point_batch(ims, "thing", settings=s)
    assert task == "batch_pipeline"
    pipe = (jax_pipeline.BatchPipeline if jax_side else BatchPipeline)(model, batch_size=2)
    return pipe.caption(ims, "normal", settings=s)


TASKS = ["caption", "query", "reasoning", "spatial", "detect", "point", "caption_batch",
         "query_batch", "detect_batch", "point_batch", "spec", "stream", "batch_pipeline"]


@pytest.fixture(scope="module")
def jax_results(sides, files):
    """JAX's result of each task under the real adapter, computed once."""
    ref, _, _ = sides("dense")
    done = {}

    def get(task):
        if task not in done:
            done[task] = _entry(ref, task, IMAGES, {**GREEDY, "variant": files["real"]}, True)
        return done[task]

    return get


@pytest.mark.parametrize("form", ["variant", "variant_tree"])
@pytest.mark.parametrize("task", TASKS)
def test_greedy_results_equal_jax(sides, files, jax_results, task, form):
    _, ours, _ = sides("dense")
    s = dict(GREEDY)
    if form == "variant":
        s["variant"] = files["real"]
    else:
        s.update(variant_tree=lora_from_jax(_jax_tree(files["real"])), variant_label="real")
    want, got = jax_results(task), _entry(ours, task, IMAGES, s, False)
    assert _close(got, want), (got, want)


def test_the_variant_changes_greedy_ids(sides, files, jax_results):
    ref, ours, _ = sides("dense")
    base = _entry(ours, "caption", IMAGES, GREEDY, False)
    assert base == _entry(ref, "caption", IMAGES, GREEDY, True)
    assert base != jax_results("caption") and base.count("<") == GREEDY["max_tokens"]


@pytest.mark.parametrize("route", ["int4", "int8", "gqa", "kv_int8"])
def test_caption_ids_equal_jax_on_each_route(sides, files, route):
    ref, ours, _ = sides(route)
    s = {**GREEDY, "variant": _real(files, route)}
    want = _entry(ref, "caption", IMAGES, s, True)
    assert _entry(ours, "caption", IMAGES, s, False) == want
    assert want != _entry(ref, "caption", IMAGES, GREEDY, True)


def test_an_encoded_image_of_another_variant_raises(sides, files):
    ref, ours, _ = sides("dense")
    s = {**GREEDY, "variant": files["real"]}
    for model, image in ((ref, Image.fromarray(IMAGES[1])), (ours, IMAGES[1])):
        enc = model.encode_image(image, settings=s)
        assert enc.variant == files["real"]
        with pytest.raises(ValueError, match="variant"):
            model.caption(enc, "normal", settings=GREEDY)
        with pytest.raises(ValueError, match="variant"):
            model.encode_image(enc, settings={"variant_label": "other"})


# ------------------------------------------------------------ merge, stack


def _dense_text(sides):
    ref, ours, cfg = sides("dense")
    return ref.params["text"], ours.text, cfg.text


@pytest.mark.parametrize("name", ["noproj", "real"])
def test_merge_variant_matches_jax_and_the_adapter_forward(sides, files, name):
    jtext, text, cfg = _dense_text(sides)
    jlora = _jax_tree(files[name])
    lora = lora_from_jax(jlora)
    before = [t.clone() for t in text.parameters()]
    want, want_res = jax_lora.merge_variant(jtext, jlora)
    merged, residual = port_lora.merge_variant(text, lora)
    assert all(torch.equal(a, b) for a, b in zip(before, text.parameters()))
    assert (residual is None) == (want_res is None) == (name == "noproj")
    for grp, site in port_text.LORA_SITES:
        w = np.asarray(want["blocks"][grp][site]["w"])
        for layer, blk in enumerate(merged.blocks):
            lin = {"qkv": blk.qkv, "proj": blk.proj, "fc1": blk.mlp.fc1,
                   "fc2": blk.mlp.fc2}[site]
            np.testing.assert_allclose(lin.w.numpy(), w[layer], rtol=1e-6, atol=1e-7)
    if residual is not None:
        for f in ("A", "B"):
            np.testing.assert_array_equal(lora_to_jax(residual)["attn"]["proj"][f],
                                          np.asarray(want_res["attn"]["proj"][f]))

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 12, cfg.dim)).astype(np.float32))
    logits = []
    for model, ad in ((text, lora), (merged, residual)):
        kv = port_text.KVCache.create(cfg, 1, torch.float32, "cpu")
        h = port_text.text_decoder(x, model, kv, 0, 8, lora=ad)
        logits.append(port_generate._lm_logits(h[0, -1], model))
        logits.append(port_text.produce_hidden(x, model, lora=ad))
    for got, want_t in zip(logits[2:], logits[:2]):
        np.testing.assert_allclose(got.numpy(), want_t.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["int4", "int8"])
def test_merge_variant_refuses_quantized_blocks(sides, files, route):
    ref, ours, _ = sides(route)
    jlora = _jax_tree(files["real"])
    with pytest.raises(ValueError):
        jax_lora.merge_variant(ref.params["text"], jlora)
    with pytest.raises(ValueError, match="dense"):
        port_lora.merge_variant(ours.text, lora_from_jax(jlora))


def test_stack_variant_pytrees_equals_jax(files):
    jtrees = [_jax_tree(files["real"]), _jax_tree(files["real2"])]
    want = jax_lora.stack_variant_pytrees(jtrees)
    got = lora_to_jax(port_lora.stack_variant_pytrees([lora_from_jax(t) for t in jtrees]))
    for grp, site in port_text.LORA_SITES:
        for f in ("A", "B"):
            np.testing.assert_array_equal(got[grp][site][f], np.asarray(want[grp][site][f]))
    assert got["attn"]["qkv"]["A"].shape[1:3] == (3, RANK)
    with pytest.raises(ValueError):
        port_lora.stack_variant_pytrees([])


# ------------------------------------------------------------ CUDA graphs


class _RerunGraph:
    """A stand-in CUDA graph: a replay reruns what was captured and writes
    its tensors into the captured outputs."""

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
    warm-up, then records the function, which each replay reruns (with
    whatever adapter the capture saw: a key without the adapter replays the
    wrong one)."""
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


LOOP_TASKS = {"caption": "generate_text", "spec": "generate_text_spec",
              "reasoning": "generate_reasoning", "detect": "generate_points",
              "caption_batch": "generate_text_batched"}


@pytest.mark.parametrize("task", list(LOOP_TASKS))
def test_graphed_equals_eager_under_an_adapter(sides, files, stand_in_graphs, task):
    _, ours, _ = sides("dense")
    s = {**GREEDY, "max_tokens": 20, "variant": files["real"]}
    ours.graphed = False
    try:
        eager = _entry(ours, task, IMAGES, s, False)
    finally:
        ours.graphed = True
    assert stand_in_graphs == []
    for _ in range(2):  # the first run captures, the second replays
        assert _close(_entry(ours, task, IMAGES, s, False), eager)
    assert LOOP_TASKS[task] in stand_in_graphs
    assert graphs.REPLAYS.get(LOOP_TASKS[task], 0) >= 1


def test_switching_adapters_keeps_a_graph_each(sides, files, stand_in_graphs):
    """The answer loop (16 steps, EOS off) on the model's recycled cache
    under no adapter, real, real2, then none and real again in one
    process: each gives its own eager ids, each adapter captures its own
    graph, and going back captures nothing new."""
    _, ours, _ = sides("dense")
    tok = ours.config.tokenizer
    prompt = list(tok.templates["caption"]["normal"])

    def run(name, graphed):
        s = None if name is None else {"variant": files[name]}
        lora = ours._variant(s)
        enc = ours.encode_image(IMAGES[0], settings=s)
        kv = ours.load_encoded_image(enc)
        _, _, first, pos, _ = ours._prefill_prompt(kv, prompt, enc.pos, 0.0, 0.0, lora=lora)
        ids = port_generate.generate_text(
            ours.text, kv, first, pos, None, 0.0, 0.0, 16, -1, (tok.answer_id,),
            ours._decode_bound(pos + 17), graphed=graphed, lora=lora).tokens
        ours._recycle_kv(kv)
        return ids

    names = [None, "real", "real2", None, "real"]
    eager = {n: run(n, False) for n in names[:3]}
    assert len({tuple(v) for v in eager.values()}) == 3
    assert stand_in_graphs == []
    captures, replays = [], []
    for n in names:
        assert run(n, True) == eager[n]
        captures.append(stand_in_graphs.count("generate_text"))
        replays.append(graphs.REPLAYS["generate_text"])
    assert captures == [1, 2, 3, 3, 3]
    assert replays == [1, 2, 3, 5, 7]


HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.mark.parametrize("loop", ["answer", "spec", "points"])
def test_a_run_under_an_adapter_reads_nothing_on_the_host(sides, files, monkeypatch, loop):
    """One run of DONE_CHECK_EVERY steps (the answer loop, the speculative
    loop's verify spans, the structured loop's steps) under an adapter,
    every tensor read to the host an error."""
    _, ours, cfg = sides("dense")
    model, lora = ours.text, ours._variant({"variant": files["real"]})
    kv = port_text.KVCache.create(model.config, 1, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(35).standard_normal(
        (1, 12, cfg.text.dim)).astype(np.float32))
    hidden = port_text.text_decoder(x, model, kv, 0, 8, lora=lora)[:, -1]
    first = torch.tensor([300])
    if loop == "answer":
        st, run = port_generate.answer_loop(model, kv, first, 12, None, 0.0, 0.0, -1, (3,),
                                            256, True, "test", lora)
    elif loop == "spec":
        st, run = port_generate.spec_loop(model, kv, first, 12, 64, -1, (3,), 4, 256, None,
                                          None, 0.0, 0.0, True, "test", lora=lora)
    else:
        st = port_generate.PointsState.create(hidden, 4)
        st.reset(hidden, first, 12, -1)
        run = lambda n: [port_generate.points_step(model, ours.region, kv, st, j % 3, -1, True,
                                                   4, 256, lora) for j in range(n)]
    for name in HOST_READS:
        def raiser(self, *a, _name=name, **k):
            raise AssertionError(f"host read Tensor.{_name} inside a run")
        monkeypatch.setattr(torch.Tensor, name, raiser)
    run(port_generate.DONE_CHECK_EVERY)
    monkeypatch.undo()
    if loop == "answer":
        assert st.count.tolist() == [8] and st.pos.tolist() == [20]
    elif loop == "spec":
        assert st.count.tolist()[0] >= 8
    else:
        assert st.n.tolist() == [2] and st.pos.tolist() == [20]
