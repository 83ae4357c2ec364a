"""Multi-variant (per-slot LoRA) serving in the port's pool against the JAX
package's pool and the port's single-stream variant calls, on the CPU at
tiny_test_config in fp32, with adapters written from seeds in the training
checkpoint's legacy names (nothing is downloaded). One counterpart for each
test of tests/test_multi_lora.py, and:

  * the per-row delta the pool runs (`models.text.layer_adapters(loras, L,
    vids)` gathers each row's factors, `ops.layers.lora_delta` applies
    them) against JAX's `engine.serving._lora_delta` (within 1e-5 of
    max|ref|);
  * the entries `prepare` + `admit_prepared`, `submit_many` and
    `submit_gaze` under a variant, against JAX's pool and the port's
    single-stream calls;
  * every pooled row's ids and boxes equal to the port's single-stream
    caption / query / detect under settings={"variant": ...};
  * the int4, int8 w8a8 and int8-KV bases;
  * CUDA graphs on the CPU (a stand-in capture replays by rerunning what it
    captured): every chunk kind of a variant pool gives its eager results
    with one capture per key, and no chunk kind reads the host.

Exactness needs decisive argmaxes: the peaked oracle of the port's other
parity tests (lm_head bias + N(0, 1), the region decoders' fc2 biases +
N(0, 1) x 50). Ids must be identical; boxes within BOX_ATOL (sizes pass
through exp2, which the two libraries may round an ulp apart). A zero-B
adapter is held bit for bit against a pool without variants.

JAX's pools are built once per scenario (module-scoped `jax_runs`) and
share their compiled chunks per config (`_JITS`)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import moondream_tpu.lora as jax_lora
from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import serving as jax_serving
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.models.serve import ContinuousBatchingEngine as JaxEngine
from moondream_tpu_torch import lora as port_lora
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.engine import serving as port_serving
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.models.text import LORA_SITES, KVCache, layer_adapters
from moondream_tpu_torch.ops import layers as port_layers
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

BOX_ATOL = 1e-6
DELTA_RTOL = 1e-5  # of max|ref|
GREEDY = {"temperature": 0.0, "top_p": 0.0}
MAX_OBJECTS = 3
EYE = (0.4, 0.3)
IMAGES = [np.random.default_rng(i).integers(0, 255, (80 + 16 * i, 100, 3), dtype=np.uint8)
          for i in range(3)]
# the adapters: name -> (rank, seed, B scale)
ADAPTERS = {"v1": (4, 1, 0.5), "v2": (2, 2, 0.5), "z": (4, 3, 0.0)}
# route -> (kv_int8, text weights, the region decoders' bias scale): "mild"
# keeps x1 biases, so that boxes follow each row's hidden state
ROUTES = {"dense": (False, None, 50.0), "int4": (False, "int4", 50.0),
          "int8": (False, "int8", 50.0), "kv_int8": (True, None, 50.0),
          "mild": (False, None, 1.0)}
_JITS = {}


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


def _variant_file(path, rank: int, seed: int, b_scale: float) -> str:
    """A seeded adapter at the tiny widths in the legacy names."""
    cfg = tiny_test_config().text
    rng = np.random.default_rng(seed)
    d, ff = cfg.dim, cfg.ff_dim
    shapes = {"mixer.Wqkv": (d, cfg.qkv_dim), "mixer.out_proj": (d, d),
              "mlp.fc1": (d, ff), "mlp.fc2": (ff, d)}
    state = {}
    for i in range(cfg.n_layers):
        for site, (fin, fout) in shapes.items():
            a = rng.standard_normal((rank, fin)).astype(np.float32) * 0.1
            b = rng.standard_normal((fout, rank)).astype(np.float32) * b_scale
            state[f"text_model.transformer.h.{i}.{site}.A"] = torch.from_numpy(a)
            state[f"text_model.transformer.h.{i}.{site}.B"] = torch.from_numpy(b)
    torch.save(state, str(path))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi_lora")
    return {name: _variant_file(tmp / f"{name}.pt", *spec) for name, spec in ADAPTERS.items()}


def _cfg(base, kv_int8: bool):
    return dataclasses.replace(base, text=dataclasses.replace(base.text, kv_int8=kv_int8))


def _tree(cfg, scale: float) -> dict:
    """Seeded fp32 weights with the peaked oracle's biases (the region
    decoders' x `scale`)."""
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
            b + rng.standard_normal(b.shape).astype(np.float32) * scale)
    return tree


@pytest.fixture(scope="module")
def sides(files):
    """sides(route) -> {"jax": side, "port": side} on one peaked tree, built
    once per route. A side: its model, engine class, images and adapter
    trees by name (JAX's in fp32; the port's from `variant_state_dict`, on
    the model's device in its dtype)."""
    built = {}

    def get(route):
        if route not in built:
            kv_int8, fmt, scale = ROUTES[route]
            jcfg, pcfg = _cfg(tiny_test_config(), kv_int8), _cfg(port_tiny_config(), kv_int8)
            tree = _tree(jcfg, scale)
            if fmt == "int4":
                tree["text"] = jax_text.quantize_text_params(tree["text"])
            elif fmt == "int8":
                tree["text"] = jax_text.quantize_text_params_int8(tree["text"])
            ref = JaxModel(jcfg, params=tree, tokenizer=IdTokenizer(), dtype=jnp.float32)
            ours = MoondreamModel(pcfg, params=params_from_jax(tree, pcfg),
                                  tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
            n = jcfg.text.n_layers
            built[route] = {
                "jax": {"model": ref, "engine": JaxEngine, "images": [Image.fromarray(im)
                                                                       for im in IMAGES],
                        "trees": {k: jax_lora.variant_state_dict(p, n_layers=n,
                                                                 dtype_str="float32")
                                  for k, p in files.items()},
                        "jits": _JITS.setdefault(route, {})},
                "port": {"model": ours, "engine": ContinuousBatchingEngine, "images": IMAGES,
                         "trees": {k: port_lora.variant_state_dict(p, n, torch.float32,
                                                                   ours.device)
                                   for k, p in files.items()}},
            }
        return built[route]

    return get


def _engine(side, names=("v1", "v2"), **kw):
    """A pool of `side` serving the adapters `names` (none: no variants)."""
    variants = {k: side["trees"][k] for k in names} or None
    eng = side["engine"](side["model"], slot_len=1024, max_objects=MAX_OBJECTS,
                         variants=variants, **kw)
    if "jits" in side:  # JAX pools of one prefix mode share their compiled chunks
        eng._jits = side["jits"].setdefault(kw.get("prefix_share", False), {})
    return eng


# scenario(side) -> the pooled results, in submission order


def _mix(side, **kw):
    """Base and two variants of ranks 4 and 2, one admitted a chunk late."""
    ims = side["images"]
    eng = _engine(side, n_slots=3, chunk=3, **kw)
    r0 = eng.submit(ims[0], max_tokens=10)
    r1 = eng.submit(ims[1], max_tokens=10, variant="v1")
    eng.step()
    r2 = eng.submit(ims[2], question="what?", max_tokens=10, variant="v2")
    out = eng.drain()
    return [out[r0], out[r1], out[r2]]


def _reuse(side):
    """One slot: a v1 request, then a base request on the same slot."""
    eng = _engine(side, n_slots=1, chunk=4)
    r0 = eng.submit(side["images"][0], max_tokens=8, variant="v1")
    first = eng.drain()[r0]
    r1 = eng.submit(side["images"][0], max_tokens=8)
    return [first, eng.drain()[r1]]


def _structured(side):
    """A base text row beside detects through the zero-B and v1 adapters
    and a point through v2."""
    ims = side["images"]
    eng = _engine(side, names=("v1", "v2", "z"), n_slots=4, chunk=3)
    rt = eng.submit(ims[1], max_tokens=8)
    rz = eng.submit_detect(ims[0], "cat", max_objects=MAX_OBJECTS, variant="z")
    rv = eng.submit_detect(ims[0], "cat", max_objects=MAX_OBJECTS, variant="v1")
    rp = eng.submit_point(ims[2], "cat", max_objects=MAX_OBJECTS, variant="v2")
    out = eng.drain()
    return [out[rt], out[rz], out[rv], out[rp]]


def _two_rows(side):
    """A v1 caption and a base query."""
    ims = side["images"]
    eng = _engine(side, n_slots=2, chunk=4)
    r0 = eng.submit(ims[0], max_tokens=8, variant="v1")
    r1 = eng.submit(ims[1], question="what?", max_tokens=8)
    out = eng.drain()
    return [out[r0], out[r1]]


def _prefix(side, prefix_share: bool):
    """Base and v1 requests on one image's two encodes."""
    model, im = side["model"], side["images"][0]
    enc_base = model.encode_image(im)
    enc_v1 = model.encode_image(im, settings={"variant_tree": side["trees"]["v1"],
                                              "variant_label": "v1"})
    eng = _engine(side, n_slots=3, chunk=3, prefix_share=prefix_share)
    rids = [eng.submit(enc_base, max_tokens=10), eng.submit(enc_v1, max_tokens=10, variant="v1"),
            eng.submit(enc_base, question="what?", max_tokens=10)]
    out = eng.drain()
    return [out[r] for r in rids], eng


def _entries(side):
    """A v1 caption through prepare + admit_prepared, a v2 gaze row in the
    mixed chunks, and a burst of two v2 queries through submit_many (one
    batched encode under the adapter)."""
    ims = side["images"]
    eng = _engine(side, n_slots=4, chunk=3)
    prep = eng.prepare(ims[0], variant="v1")
    rids = [eng.admit_prepared(prep, max_tokens=8), eng.submit_gaze(ims[1], EYE, variant="v2")]
    rids += eng.submit_many([ims[1], ims[2]], question="what?", max_tokens=8, variant="v2")
    assert sorted(eng.vid.tolist()) == [1, 2, 2, 2]
    out = eng.drain()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def jax_runs(sides):
    """JAX's result of each (route, scenario), computed once."""
    done = {}

    def get(route, scenario):
        if (route, scenario) not in done:
            done[route, scenario] = SCENARIOS[scenario](sides(route)["jax"])
        return done[route, scenario]

    return get


@pytest.fixture(scope="module")
def port_runs(sides):
    """The port's result of each (route, scenario), computed once."""
    done = {}

    def get(route, scenario):
        if (route, scenario) not in done:
            done[route, scenario] = SCENARIOS[scenario](sides(route)["port"])
        return done[route, scenario]

    return get


SCENARIOS = {"mix": _mix, "reuse": _reuse, "structured": _structured, "two_rows": _two_rows,
             "prefix": lambda side: _prefix(side, True)[0], "entries": _entries}


def _close(a, b) -> bool:
    """Equal nested results, floats within BOX_ATOL."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= BOX_ATOL
    return a == b


def _single(side, files, task, image, variant, max_tokens=8):
    """The port's single-stream call under settings={"variant": file}."""
    s = {**GREEDY, "max_tokens": max_tokens, "max_objects": MAX_OBJECTS}
    if variant is not None:
        s["variant"] = files[variant]
    model = side["model"]
    if task == "caption":
        return model.caption(image, settings=s)["caption"]
    if task == "query":
        return model.query(image, "what?", settings=s)["answer"]
    if task == "detect":
        return model.detect(image, "cat", settings=s)
    return model.point(image, "cat", settings=s)


# ---------------------------------------------------------------- the ops


def test_gathered_lora_delta_matches_jax():
    """The pool's per-row delta: `layer_adapters` gathers row s's factors of
    variant vids[s] from a (L, V + 1)-stacked tree (variant 0 zero, a
    rank-2 variant zero-padded to 4), `lora_delta` applies them; every
    layer and site within 1e-5 of max|ref| of JAX's `_lora_delta`."""
    rng = np.random.default_rng(9)
    S, tq, n_layers, r = 5, 3, 2, 4
    widths = {("attn", "qkv"): (64, 96), ("mlp", "fc2"): (80, 64)}
    tree = {}
    for (grp, name), (d_in, d_out) in widths.items():
        a = rng.standard_normal((n_layers, 3, r, d_in)).astype(np.float32) * 0.1
        b = rng.standard_normal((n_layers, 3, d_out, r)).astype(np.float32) * 0.5
        a[:, 0], b[:, 0], a[:, 2, 2:], b[:, 2, :, 2:] = 0.0, 0.0, 0.0, 0.0
        tree.setdefault(grp, {})[name] = {"A": a, "B": b}
    vids = np.array([0, 1, 2, 1, 0], dtype=np.int32)
    adapters = layer_adapters(
        {g: {n: {f: torch.from_numpy(t) for f, t in p.items()} for n, p in sites.items()}
         for g, sites in tree.items()}, n_layers, torch.from_numpy(vids))
    delta = jax.jit(jax_serving._lora_delta)
    for layer in range(n_layers):
        for (grp, name), (d_in, d_out) in widths.items():
            pair = tree[grp][name]
            x = rng.standard_normal((S, tq, d_in)).astype(np.float32)
            want = np.asarray(delta(jnp.asarray(x), {f: jnp.asarray(t[layer])
                                                     for f, t in pair.items()},
                                    jnp.asarray(vids)))
            got = port_layers.lora_delta(torch.from_numpy(x), adapters[layer][name])
            assert got.dtype == torch.float32 and got.shape == (S, tq, d_out)
            assert np.abs(got.numpy() - want).max() <= DELTA_RTOL * np.abs(want).max()
            assert not got[0].any() and not got[4].any()


def test_stacked_shapes_and_zero_base(sides):
    """The pool stacks its adapters once, on the model's device in its
    dtype: (L, V + 1, r_max, in) and (L, V + 1, out, r_max), variant 0
    zeros, v2's rank 2 zero-padded to 4, equal to JAX's pool's stack."""
    ours, ref = _engine(sides("dense")["port"]), _engine(sides("dense")["jax"])
    cfg = port_tiny_config().text
    qkv = ours._loras["attn"]["qkv"]
    assert qkv["A"].shape == (cfg.n_layers, 3, 4, cfg.dim)
    assert qkv["B"].shape == (cfg.n_layers, 3, cfg.qkv_dim, 4)
    assert not qkv["A"][:, 0].any() and not ours._loras["mlp"]["fc2"]["B"][:, 0].any()
    assert not ours._loras["mlp"]["fc1"]["A"][:, 2, 2:].any()
    assert ours._vid_of == {"v1": 1, "v2": 2} and ours.vid.dtype == torch.int32
    for grp, name in LORA_SITES:
        for f in ("A", "B"):
            t = ours._loras[grp][name][f]
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(ref._loras[grp][name][f]))


# ---------------------------------------------------- pools against JAX's


def test_pool_mixes_base_and_two_variants(sides, files, jax_runs, port_runs):
    got = port_runs("dense", "mix")
    assert got == jax_runs("dense", "mix")
    base = _single(sides("dense")["port"], files, "caption", IMAGES[0], None, 10)
    assert got[0] == base and got[1] != got[0] and all(r.count("<") == 10 for r in got)


def test_slot_reuse_switches_adapter(sides, files, jax_runs, port_runs):
    """A slot freed by a v1 request must not leak its adapter into the
    next (base) request on the same slot."""
    got = port_runs("dense", "reuse")
    assert got == jax_runs("dense", "reuse")
    port = sides("dense")["port"]
    assert got == [_single(port, files, "caption", IMAGES[0], "v1"),
                   _single(port, files, "caption", IMAGES[0], None)]
    assert got[0] != got[1]


def test_structured_rows_with_variant(sides, files, jax_runs, port_runs):
    """Detect rows through a zero-B and a nonzero adapter, and a point row
    through another, beside a base text row in the mixed chunks, under x1
    region biases (boxes follow the hidden state): equal to JAX's pool; the
    zero-B detect equals the plain pool's bit for bit and the nonzero one
    differs."""
    got = port_runs("mild", "structured")
    assert _close(got, jax_runs("mild", "structured"))
    port = sides("mild")["port"]
    plain = _engine(port, names=(), n_slots=2, chunk=3)
    pd = plain.submit_detect(IMAGES[0], "cat", max_objects=MAX_OBJECTS)
    ref_detect = plain.drain()[pd]
    assert got[1] == ref_detect and got[2] != ref_detect and got[1]["objects"]


@pytest.mark.parametrize("route", ["int4", "int8", "kv_int8"])
def test_quantized_bases_compose_with_variants(sides, files, jax_runs, port_runs, route):
    """A v1 caption and a base query over an int4, int8 w8a8 or int8-KV
    base: the delta adds after the quantized linear's bias or epilogue;
    equal to JAX's pool and to the port's single-stream calls."""
    got = port_runs(route, "two_rows")
    assert got == jax_runs(route, "two_rows")
    port = sides(route)["port"]
    assert got == [_single(port, files, "caption", IMAGES[0], "v1"),
                   _single(port, files, "query", IMAGES[1], None)]


def test_zero_b_adapter_is_bitwise_noop(sides):
    """A zero-B adapter's rows equal a pool without variants bit for bit,
    its KV cache included: the plumbing (gather, padding, threading) adds
    an exact zero."""
    port = sides("dense")["port"]
    outs = []
    for names, variant in (((), None), (("z",), "z")):
        eng = _engine(port, names=names, n_slots=2, chunk=4)
        r0 = eng.submit(IMAGES[0], max_tokens=10, variant=variant)
        r1 = eng.submit(IMAGES[1], question="what?", max_tokens=10)
        out = eng.drain()
        outs.append(([out[r0], out[r1]], eng.kv.k.clone(), eng.kv.v.clone()))
    assert outs[0][0] == outs[1][0]
    assert torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2])


@pytest.mark.parametrize("variants", [("v1", "v2"), ()], ids=["registered", "none"])
def test_unknown_variant_rejected(sides, variants):
    """KeyError naming the registered variants, as JAX's pool raises, also
    from a pool built without variants; no slot is taken."""
    pair = sides("dense")
    msgs = []
    for side in (pair["jax"], pair["port"]):
        eng = _engine(side, names=variants, n_slots=1, chunk=4)
        with pytest.raises(KeyError, match="unknown variant") as err:
            eng.submit(side["images"][0], variant="nope")
        assert len(eng.free_slots()) == 1
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_speculative_composes_with_variants(sides, port_runs):
    """Greedy speculative chunks (k 4) over the mixed-tenant pool: the span
    verify applies each row's adapter over its whole span, so the ids equal
    the plain variant pool's (held to JAX's above)."""
    assert _mix(sides("dense")["port"], speculative=4) == port_runs("dense", "mix")


def test_variants_compose_with_prefix_share(sides, jax_runs, port_runs):
    """A variant's image prefix is encoded under its adapter, so base and v1
    requests on one image hold two prefix entries (the registry is keyed by
    EncodedImage identity); the results equal the pool without sharing and
    JAX's prefix-shared pool."""
    port = sides("dense")["port"]
    shared, eng = _prefix(port, True)
    assert len(eng._pref_pid_of) == 2
    assert shared == _prefix(port, False)[0] == jax_runs("dense", "prefix")


def test_pool_entries_take_variants(sides, files, jax_runs, port_runs):
    """prepare(variant=) + admit_prepared, submit_gaze(variant=) and
    submit_many(variant=) in one pool (x1 region biases): equal to JAX's
    pool; the text rows equal the port's single-stream calls under their
    variants, and the v2 gaze row differs from the base model's gaze
    (single-stream `detect_gaze` takes no variant)."""
    got = port_runs("mild", "entries")
    assert _close(got, jax_runs("mild", "entries"))
    port = sides("mild")["port"]
    assert got[0] == _single(port, files, "caption", IMAGES[0], "v1")
    assert got[2:] == [_single(port, files, "query", IMAGES[i], "v2") for i in (1, 2)]
    base_gaze = port["model"].detect_gaze(IMAGES[1], eye=EYE)
    assert got[1]["gaze"] is not None and got[1] != base_gaze


@pytest.mark.parametrize("task", ["caption", "query", "detect", "point"])
def test_rows_equal_single_stream(sides, files, port_runs, task):
    """Every pooled row equals the port's single-stream call under
    settings={"variant": ...}: the mix's v1 caption and v2 query, the
    structured pool's v1 detect and v2 point (x1 region biases)."""
    if task in ("caption", "query"):
        row, image, variant = (1, 1, "v1") if task == "caption" else (2, 2, "v2")
        want = _single(sides("dense")["port"], files, task, IMAGES[image], variant, 10)
        assert port_runs("dense", "mix")[row] == want
    else:
        row, image, variant = (2, 0, "v1") if task == "detect" else (3, 2, "v2")
        want = _single(sides("mild")["port"], files, task, IMAGES[image], variant)
        assert port_runs("mild", "structured")[row] == want


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
    warm-up, then records the function, which each replay reruns (reading
    the pool's vid buffer where it is, as a CUDA graph does)."""
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


HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.fixture
def no_host_reads(monkeypatch):
    """Calling it makes every tensor method that reads a value to the host
    raise, until monkeypatch.undo()."""
    def patch():
        for name in HOST_READS:
            def raiser(self, *a, _name=name, **k):
                raise AssertionError(f"host read Tensor.{_name} inside a chunk")
            monkeypatch.setattr(torch.Tensor, name, raiser)
    return patch


KINDS = {"plain": "serve_chunk", "spec": "serve_chunk_spec",
         "spec_sampled": "serve_chunk_spec_sampled", "mixed": "serve_chunk_mixed",
         "mixed_spec": "serve_chunk_mixed_spec"}


@pytest.mark.parametrize("kind", list(KINDS))
def test_graphed_variant_pool_equals_eager(sides, stand_in_graphs, kind):
    """A variant pool (3 slots, 4-step chunks) serving base, v1 and v2 rows,
    a slot reused by another variant, and for the mixed kinds a v1 detect:
    graphed equals eager, one capture per chunk key, later chunks
    replays."""
    captured = stand_in_graphs
    port = sides("dense")["port"]
    model = port["model"]
    spec = 4 if "spec" in kind else 0
    results = []
    for graphed in (False, True):
        model.generator.manual_seed(0)
        eng = _engine(port, n_slots=3, chunk=4, speculative=spec, graphed=graphed,
                      temperature=0.7 if kind == "spec_sampled" else 0.0, top_p=0.9)
        rids = [eng.submit(IMAGES[0], max_tokens=10, variant="v1"),
                eng.submit(IMAGES[1], question="why?", max_tokens=3)]
        if "mixed" in kind:
            rids.append(eng.submit_detect(IMAGES[2], "cat", variant="v1"))
        eng.step()
        eng.step()  # the 3-token request is done: its slot goes to v2
        rids.append(eng.submit(IMAGES[2], max_tokens=6, variant="v2"))
        out = eng.drain()
        results.append([out[r] for r in rids])
    assert _close(results[1], results[0])
    # the pool turns to plain or spec chunks once the detect is done
    assert captured[0] == KINDS[kind] and len(set(captured)) == len(captured)
    assert graphs.REPLAYS.get(KINDS[kind], 0) >= 1


@pytest.mark.parametrize("kind", list(KINDS))
def test_variant_chunks_read_nothing_on_the_host(sides, no_host_reads, monkeypatch, kind):
    """Each chunk kind with per-row adapters (base, v1, v2 and a zero row)
    reads nothing back to the host, and the adapters change the ids."""
    port = sides("dense")["port"]
    model, region = port["model"].text, port["model"].region
    loras = port_lora.stack_variant_pytrees([port["trees"]["v1"], port["trees"]["v2"]])
    dim = model.config.dim
    S = 4

    def run(vids):
        kv = KVCache.create(model.config, S, torch.float32, "cpu", 256)
        state = (kv, torch.tensor([5, 300, 17, 400], dtype=torch.int32),
                 torch.tensor([0, 12, 40, 100], dtype=torch.int32),
                 torch.tensor([True, True, True, True]),
                 torch.tensor([20, 20, 20, 20], dtype=torch.int32))
        hist = torch.zeros((S, 257), dtype=torch.int32)
        hist_cnt = torch.tensor([1, 5, 0, 9], dtype=torch.int32)
        struct = (torch.tensor([0, 1, 0, 1], dtype=torch.int32),
                  torch.from_numpy(np.random.default_rng(4).standard_normal(
                      (S, dim)).astype(np.float32)),
                  torch.tensor([3, 4, 0, 5], dtype=torch.int32), torch.zeros(S), torch.zeros(S),
                  torch.zeros(S, 5, 4), torch.zeros(S, dtype=torch.int32),
                  torch.tensor([False, True, False, False]))
        kw = dict(eos_id=-1, suppress_ids=(3,), kv_bound=256, loras=loras,
                  vids=torch.tensor(vids, dtype=torch.int32))
        gen = torch.Generator().manual_seed(0)
        if kind == "plain":
            return port_serving.serve_chunk(model, *state, gen, 0.0, 0.0, chunk=8, **kw)
        if kind == "spec":
            return port_serving.serve_chunk_spec(model, *state, hist, hist_cnt, n_iter=4,
                                                 spec_k=4, **kw)
        if kind == "spec_sampled":
            return port_serving.serve_chunk_spec_sampled(model, *state, hist, hist_cnt, gen,
                                                         0.7, 0.9, n_iter=4, spec_k=4, **kw)
        if kind == "mixed":
            return port_serving.serve_chunk_mixed(model, region, *state, gen, 0.0, 0.0,
                                                  *struct, chunk=8, max_objects=5, **kw)
        return port_serving.serve_chunk_mixed_spec(model, region, *state, hist, hist_cnt,
                                                   *struct, n_iter=4, spec_k=4,
                                                   max_objects=5, **kw)

    base = run([0, 0, 0, 0])
    no_host_reads()
    res = run([1, 2, 0, 1])
    monkeypatch.undo()
    assert res.emitted.sum().item() > 0
    assert not torch.equal(res.tokens, base.tokens)
    # row 2 is a base row in both runs; its ids stay where no other row's
    # adapter can reach them (text rows of the plain and spec kinds)
    if kind in ("plain", "spec"):
        assert torch.equal(res.tokens[2], base.tokens[2])
