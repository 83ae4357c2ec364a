"""The int8 w8a8 formats end to end: the port's entry points against
moondream_tpu's on the CPU at tiny_test_config in fp32, with the same
parameters (the JAX package quantizes them; `params_from_jax` carries the
codes over) and IdTokenizer, so equal strings mean equal token ids.

Dynamic activation codes are discontinuous: an fp32 ulp between the two
libraries can flip a code and move a logit. The peaked oracle makes the
greedy argmax decisive: lm_head's bias gets seeded N(0, 8^2) noise, the
region decoders' fc2 biases N(0, 1) x 50, in the tree both sides load.

* greedy ids equal JAX's: int8 text blocks (caption, query), int8 text
  with an int8 KV cache, int8 text on a GQA config (one KV head), int8 text
  with a dynamic and a statically calibrated int8 ViT (calibrated on
  normalized crops); detect's boxes within 1e-6 (sizes pass through exp2,
  which the libraries round an ulp apart);
* serving: a plain pool of three requests, and a greedy speculative
  caption (k 4), equal to JAX's;
* port only: under stand-in CUDA graphs an int8 caption and an int8 pool
  give the eager results, and a decode run and a pool chunk read nothing
  on the host; `load_params(runtime_int8=True)` equals quantizing after
  the load, and runtime_int4 with runtime_int8 raises.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.models.serve import ContinuousBatchingEngine as JaxEngine
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.engine import serving as port_serving
from moondream_tpu_torch.kernels import build
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.ops.layers import Int8Linear
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import load_params, params_from_jax

GREEDY = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 12}
ATOL = 1e-6
HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _cfg(base, kv_int8=False, n_kv_heads=2):
    return dataclasses.replace(base, text=dataclasses.replace(
        base.text, kv_int8=kv_int8, n_kv_heads=n_kv_heads))


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
        lb + rng.standard_normal(lb.shape).astype(np.float32) * 8)
    for site in ("coord_decoder", "size_decoder"):
        b = np.asarray(tree["region"][site]["fc2"]["b"])
        tree["region"][site]["fc2"]["b"] = jnp.asarray(
            b + rng.standard_normal(b.shape).astype(np.float32) * 50)
    return tree


IMAGES = [np.random.default_rng(5 + i).integers(0, 255, shape, dtype=np.uint8)
          for i, shape in enumerate([(300, 420, 3), (120, 160, 3), (200, 150, 3)])]
# normalized calibration crops in [-1, 1], as the runtime feeds the ViT
CALIB = np.random.default_rng(11).uniform(-1, 1, (4, 378, 378, 3)).astype(np.float32)

# variant -> (kv_int8, KV heads, ViT format)
VARIANTS = {
    "int8": (False, 2, None),
    "int8+kv_int8": (True, 2, None),
    "int8-gqa": (False, 1, None),
    "int8+vit-dynamic": (False, 2, "dynamic"),
    "int8+vit-static": (False, 2, "static"),
}


@pytest.fixture(scope="module")
def sides():
    """sides(variant) -> (JAX model, port model) on one peaked tree, the
    text blocks int8 (quantize_text_params_int8), the ViT as `variant`
    says, carried over by params_from_jax."""
    built = {}

    def get(variant):
        if variant not in built:
            kv_int8, n_kv, vit = VARIANTS[variant]
            jcfg = _cfg(tiny_test_config(), kv_int8, n_kv)
            pcfg = _cfg(port_tiny_config(), kv_int8, n_kv)
            tree = _tree(jcfg)
            tree["text"] = jax_text.quantize_text_params_int8(tree["text"])
            if vit is not None:
                stats = None if vit == "dynamic" else jax_vision.collect_vision_act_stats(
                    jnp.asarray(CALIB), tree["vision"], jcfg.vision, chunk=2)
                tree["vision"] = jax_vision.quantize_vision_params(tree["vision"], stats)
            ref = JaxModel(jcfg, params=tree, tokenizer=IdTokenizer(), dtype=jnp.float32)
            ours = MoondreamModel(pcfg, params=params_from_jax(tree, pcfg),
                                  tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
            assert isinstance(ours.text.blocks[0].mlp.fc2, Int8Linear)
            assert isinstance(ours.vision.blocks[0].qkv, Int8Linear) == (vit is not None)
            built[variant] = ref, ours
        return built[variant]

    return get


def _jax_enc(ref, image):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")  # JAX's host crop path
        return ref.encode_image(Image.fromarray(image))


@pytest.mark.parametrize("variant,task", [
    ("int8", "caption"), ("int8", "query"), ("int8+kv_int8", "caption"),
    ("int8-gqa", "caption"), ("int8+vit-dynamic", "caption"), ("int8+vit-static", "caption"),
])
def test_greedy_ids_equal_jax(sides, variant, task):
    ref, ours = sides(variant)
    image = IMAGES[0]
    if task == "caption":
        want = ref.caption(_jax_enc(ref, image), "normal", settings=GREEDY)["caption"]
        got = ours.caption(image, "normal", settings=GREEDY)["caption"]
    else:
        want = ref.query(_jax_enc(ref, image), "What is it?", settings=GREEDY)["answer"]
        got = ours.query(image, "What is it?", settings=GREEDY)["answer"]
    assert got == want and got.count("<") == GREEDY["max_tokens"]


def _close(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= ATOL
    return a == b


def test_detect_equals_jax(sides):
    ref, ours = sides("int8")
    s = {"max_objects": 4}
    want = ref.detect(_jax_enc(ref, IMAGES[1]), "thing", settings=s)
    got = ours.detect(IMAGES[1], "thing", settings=s)
    assert got["objects"] and _close(got, want), (got, want)


def _pool(side_model, encs, engine_cls, jits=None, **kw):
    eng = engine_cls(side_model, n_slots=3, slot_len=1024, chunk=4, **kw)
    if jits is not None:
        eng._jits = jits
    rids = [eng.submit(encs[0], max_tokens=10), eng.submit(encs[1], question="what?",
                                                           max_tokens=7),
            eng.submit(encs[2], max_tokens=9)]
    out = eng.drain()
    return [out[r] for r in rids]


def test_plain_pool_equals_jax(sides):
    ref, ours = sides("int8")
    want = _pool(ref, [_jax_enc(ref, im) for im in IMAGES], JaxEngine, {})
    got = _pool(ours, [ours.encode_image(im) for im in IMAGES], ContinuousBatchingEngine)
    assert got == want and [r.count("<") for r in got] == [10, 7, 9]


def test_speculative_caption_equals_jax(sides):
    ref, ours = sides("int8")
    spec = dict(GREEDY, speculative=4)
    want = ref.caption(_jax_enc(ref, IMAGES[2]), "normal", settings=spec)["caption"]
    got = ours.caption(IMAGES[2], "normal", settings=spec)["caption"]
    assert got == want == ours.caption(IMAGES[2], "normal", settings=GREEDY)["caption"]


# ------------------------------------------------------------- port only


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
    warm-up, then records the function, which each replay reruns."""
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


def _no_host_reads(monkeypatch):
    for name in HOST_READS:
        def raiser(self, *a, _name=name, **k):
            raise AssertionError(f"host read Tensor.{_name} inside a run")
        monkeypatch.setattr(torch.Tensor, name, raiser)


def test_graphed_int8_caption_and_pool_equal_eager(sides, stand_in_graphs, monkeypatch):
    _, ours = sides("int8+vit-static")
    enc = ours.encode_image(IMAGES[0])
    encs = [ours.encode_image(im) for im in IMAGES]
    s = dict(GREEDY, max_tokens=20)
    ours.graphed = False
    try:
        eager = ours.caption(enc, "normal", settings=s)["caption"]
    finally:
        ours.graphed = True
    eager_pool = _pool(ours, encs, ContinuousBatchingEngine, graphed=False)
    assert stand_in_graphs == []
    assert ours.caption(enc, "normal", settings=s)["caption"] == eager
    assert stand_in_graphs == ["generate_text"] and graphs.REPLAYS["generate_text"] >= 1
    assert _pool(ours, encs, ContinuousBatchingEngine) == eager_pool
    assert stand_in_graphs == ["generate_text", "serve_chunk"]


def test_int8_decode_run_and_pool_chunk_read_nothing_on_the_host(sides, monkeypatch):
    _, ours = sides("int8")
    model = ours.text
    tc = model.config
    pkv = port_text.KVCache.create(tc, 1, torch.float32, "cpu")
    x = np.random.default_rng(35).standard_normal((1, 12, tc.dim)).astype(np.float32)
    port_text.text_decoder(torch.from_numpy(x), model, pkv, 0, 8)
    st, run = port_generate.answer_loop(
        model, pkv, torch.tensor([300]), 12, torch.Generator().manual_seed(0), 0.0, 0.9, -1,
        (3,), 256, True, "test")
    kv = port_text.KVCache.create(tc, 4, torch.float32, "cpu", 256)
    cur = torch.tensor([5, 300, 17, 400], dtype=torch.int32)
    pos = torch.tensor([0, 12, 40, 100], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    budget = torch.tensor([20, 3, 0, 20], dtype=torch.int32)
    before = dict(build.LAUNCHES)
    _no_host_reads(monkeypatch)
    run(port_generate.DONE_CHECK_EVERY)
    res = port_serving.serve_chunk(model, kv, cur, pos, active, budget, None, 0.0, 0.0,
                                   eos_id=-1, suppress_ids=(3,), chunk=8, kv_bound=256)
    monkeypatch.undo()
    assert st.count.tolist() == [8] and st.pos.tolist() == [20]
    assert res.emitted.sum(dim=1).tolist() == [8, 3, 0, 8]
    assert build.launches_since(before) == {}  # the CPU runs the plain versions


def test_load_params_runtime_int8(tmp_path):
    """A checkpoint written here, loaded with runtime_int8=True, equals the
    same load quantized afterwards; runtime_int4 with runtime_int8 raises."""
    from safetensors.torch import save_file

    cfg = port_tiny_config()
    from moondream_tpu_torch.weights import init_params

    dense = init_params(cfg, torch.Generator().manual_seed(2), "cpu", torch.float32)
    flat = {}
    for i, blk in enumerate(dense["text"].blocks):
        p = f"text.blocks.{i}"
        for name, lin in (("attn.qkv", blk.qkv), ("attn.proj", blk.proj),
                          ("mlp.fc1", blk.mlp.fc1), ("mlp.fc2", blk.mlp.fc2)):
            flat[f"{p}.{name}.weight"] = lin.w.t().contiguous()
            flat[f"{p}.{name}.bias"] = lin.b
        flat[f"{p}.ln.weight"], flat[f"{p}.ln.bias"] = blk.ln.weight, blk.ln.bias
    vis = dense["vision"]
    for i, blk in enumerate(vis.blocks):
        p = f"vision.blocks.{i}"
        for name, lin in (("attn.qkv", blk.qkv), ("attn.proj", blk.proj),
                          ("mlp.fc1", blk.mlp.fc1), ("mlp.fc2", blk.mlp.fc2)):
            flat[f"{p}.{name}.weight"] = lin.w.t().contiguous()
            flat[f"{p}.{name}.bias"] = lin.b
        for ln in ("ln1", "ln2"):
            flat[f"{p}.{ln}.weight"] = getattr(blk, ln).weight
            flat[f"{p}.{ln}.bias"] = getattr(blk, ln).bias
    for base, lin in (("vision.patch_emb", vis.patch_emb), ("vision.proj_mlp.fc1", vis.proj_mlp.fc1),
                      ("vision.proj_mlp.fc2", vis.proj_mlp.fc2),
                      ("text.lm_head", dense["text"].lm_head)):
        flat[f"{base}.weight"], flat[f"{base}.bias"] = lin.w.t().contiguous(), lin.b
    for base, ln in (("vision.post_ln", vis.post_ln), ("text.post_ln", dense["text"].post_ln)):
        flat[f"{base}.weight"], flat[f"{base}.bias"] = ln.weight, ln.bias
    flat["vision.pos_emb"] = vis.pos_emb
    flat["text.wte"] = dense["text"].wte
    path = str(tmp_path / "tiny.safetensors")
    save_file({k: v.detach().contiguous() for k, v in flat.items()}, path)

    q = load_params(path, cfg, torch.float32, device="cpu", runtime_int8=True)
    after = load_params(path, cfg, torch.float32, device="cpu")
    port_text.quantize_text_params_int8(after["text"])
    for a, b in zip(q["text"].blocks, after["text"].blocks):
        for la, lb in ((a.qkv, b.qkv), (a.proj, b.proj), (a.mlp.fc1, b.mlp.fc1),
                       (a.mlp.fc2, b.mlp.fc2)):
            assert isinstance(la, Int8Linear)
            assert torch.equal(la.wq, lb.wq) and torch.equal(la.scale, lb.scale)
            assert torch.equal(la.b, lb.b)
    assert not isinstance(q["vision"].blocks[0].qkv, Int8Linear)
    with pytest.raises(ValueError, match="exclusive"):
        load_params(path, cfg, torch.float32, device="cpu", runtime_int4=True,
                    runtime_int8=True)
