"""The port's sharded serving pool, crop-parallel ViT and HTTP server over a
mesh (moondream_tpu_torch/parallel/serving.py, serve_http's mesh=) against
the JAX package's (moondream_tpu/parallel/serving.py), on the CPU in fp32.

One launch of four gloo ranks (dp 2 x tp 2, one torch thread each, a hard
timeout) runs every pool scenario through `make_sharded_serving_engine`:
a plain pool driven from rank 0 through `comm.Controller` while the
others follow, with the crop-parallel ViT; a speculative pool; a pool
serving a LoRA variant row beside a base row and a detect row (the mixed
chunks). The parent runs each scenario once on JAX's sharded pool over the
same dp 2 x tp 2 shape of the 8-device CPU mesh (tests/conftest.py), with
the xla_attn=True its mesh requires and its sharded twin built in the
model's fp32 (it takes the default bf16 otherwise). Result strings
(IdTokenizer: equal text is equal ids) and boxes (decisive under the
peaked region decoders, tests/test_batched.py:86) must be equal, and every
rank's results too.
The rank functions live in tests/torch_parallel_ranks.py, which imports
no JAX."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from PIL import Image

import torch_parallel_ranks as ranks
from moondream_tpu import parallel as jax_parallel
from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.parallel import serving as jax_serving
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.parallel import comm
from moondream_tpu_torch.weights import params_from_jax

AXES = {"dp": 2, "tp": 2}
SHAPES = [(100, 120), (120, 120), (140, 100)]
TIMEOUT_S = 120
ATOL = 1e-6

SCENARIOS = [
    {"name": "plain", "controlled": True, "shard_vision": True, "max_tokens": 8,
     "engine": dict(n_slots=4, slot_len=1024, chunk=4),
     "requests": [("text", 0, {}), ("text", 1, {}), ("text", 2, {"question": "what?"})]},
    {"name": "speculative", "max_tokens": 10,
     "engine": dict(n_slots=4, slot_len=1024, chunk=3, speculative=4),
     "requests": [("text", 0, {}), ("text", 1, {})]},
    {"name": "variant_mixed", "variants": True, "max_tokens": 8,
     "engine": dict(n_slots=4, slot_len=1024, chunk=4, max_objects=3),
     "requests": [("text", 0, {"variant": "v"}), ("text", 1, {}), ("detect", 2, "object")]},
]


def _variant_arrays(tc):
    rng = np.random.default_rng(5)

    def pair(fin, fout, rank=4, b_scale=0.5):
        return {"A": rng.standard_normal((tc.n_layers, rank, fin)).astype(np.float32) * 0.1,
                "B": rng.standard_normal((tc.n_layers, fout, rank)).astype(np.float32) * b_scale}

    return {"attn": {"qkv": pair(tc.dim, tc.qkv_dim), "proj": pair(tc.dim, tc.dim)},
            "mlp": {"fc1": pair(tc.dim, tc.ff_dim), "fc2": pair(tc.ff_dim, tc.dim)}}


def _trees(n_kv_heads=None):
    """(JAX config with xla_attn, tree with peaked region decoders, port
    config, the port's parameters as numpy)."""
    jcfg, pcfg = tiny_test_config(), port_tiny_config()
    if n_kv_heads is not None:
        jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, n_kv_heads=n_kv_heads))
        pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, n_kv_heads=n_kv_heads))
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, xla_attn=True))
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = {"vision": jax_vision.init_vision_params(jcfg.vision, kv, jnp.float32),
            "text": jax_text.init_text_params(jcfg.text, kt, jnp.float32),
            "region": jax_region.init_region_params(jcfg.region, kr, jnp.float32)}
    rng = np.random.default_rng(3)
    for site in ("coord_decoder", "size_decoder"):
        b = np.asarray(tree["region"][site]["fc2"]["b"])
        tree["region"][site]["fc2"]["b"] = jnp.asarray(
            b + rng.standard_normal(b.shape).astype(np.float32) * 50.0)
    return jcfg, tree, pcfg, ranks.state_of(params_from_jax(tree, pcfg))


def _jax_results(jmodel, variants):
    mesh = jax_parallel.create_mesh(AXES)
    images = [Image.fromarray(im) for im in ranks._images(SHAPES)]
    out = []
    for sc in SCENARIOS:
        kw = dict(sc["engine"])
        if sc.get("variants"):
            kw["variants"] = {"v": variants}
        eng = jax_parallel.make_sharded_serving_engine(jmodel, mesh, **kw)
        out.append(ranks._run(eng, sc, images))
    return out


@pytest.fixture(scope="module")
def served():
    mp = pytest.MonkeyPatch()
    mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")  # the JAX model's host crops
    # JAX's sharded engine rebuilds the model with the default dtype (bf16);
    # the reference keeps the fp32 model's, as the port's twin does
    mp.setattr(jax_serving, "MoondreamModel",
               lambda *a, **k: JaxModel(*a, dtype=jnp.float32, **k))
    try:
        jcfg, tree, pcfg, state = _trees()
        arrays = _variant_arrays(pcfg.text)
        jmodel = JaxModel(jcfg, params=tree, tokenizer=ranks.IdTokenizer(), dtype=jnp.float32)
        ref = _jax_results(jmodel, jax.tree.map(jnp.asarray, arrays))
    finally:
        mp.undo()
    outs = comm.launch(4, ranks.pool_rank, AXES, pcfg, state, SCENARIOS, SHAPES, arrays,
                       timeout_s=TIMEOUT_S, device="cpu")
    return {"ref": ref, "outs": outs, "pcfg": pcfg, "state": state, "jmodel": jmodel}


def _same(got, want):
    if isinstance(want, str):
        return got == want
    assert list(got) == list(want)
    for key in want:
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            for k in w:
                assert abs(g[k] - w[k]) <= ATOL, (k, g, w)
    return True


@pytest.mark.parametrize("i", range(len(SCENARIOS)), ids=[s["name"] for s in SCENARIOS])
def test_sharded_pool_matches_jax(served, i):
    got, want = served["outs"][0]["results"][i], served["ref"][i]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _same(g, w), (g, w)


def test_mixed_pool_found_boxes(served):
    """The detect row of the mixed scenario found objects (a box check that
    compares nothing would pass vacuously)."""
    assert served["ref"][2][2]["objects"]


@pytest.mark.parametrize("i", range(len(SCENARIOS)), ids=[s["name"] for s in SCENARIOS])
def test_sharded_pool_ranks_agree(served, i):
    """Every rank's host scheduler ends with the same results, the
    followers of the controlled pool included."""
    first = served["outs"][0]["results"][i]
    for out in served["outs"][1:]:
        assert out["results"][i] == first


def test_sharded_pool_holds_its_slots_and_heads(served):
    tc = served["pcfg"].text
    for out in served["outs"]:
        for shape in out["kv"]:
            assert shape == (tc.n_layers, 4 // AXES["dp"], tc.n_kv_heads // AXES["tp"], 1024,
                             tc.head_dim)


def test_crop_parallel_vit_matches_the_unsharded_encoder(served):
    """Five crops over four ranks (padded to eight, two per rank): the
    gathered features equal the unsharded encoder's up to the GEMMs'
    blocking at another M."""
    for out in served["outs"]:
        sharded, whole = out["vit"]
        assert sharded.shape == whole.shape == (5, 729, served["pcfg"].vision.enc_dim)
        assert np.abs(sharded - whole).max() <= 1e-5 * np.abs(whole).max()


def test_sharded_pool_validation():
    """n_slots not divisible by dp and n_kv_heads not divisible by tp raise
    the JAX package's ValueErrors; a prefix-shared pool and quantized text
    blocks raise too."""
    jcfg, tree, pcfg, state = _trees()
    gcfg, gtree, gpcfg, gstate = _trees(n_kv_heads=1)
    errors = comm.launch(2, ranks.validation_rank, pcfg, gpcfg, state, gstate,
                         timeout_s=TIMEOUT_S, device="cpu")
    assert errors[0] == errors[1]
    want = []
    for model, axes, kw in ((JaxModel(jcfg, params=tree), {"dp": 2, "tp": 1}, {"n_slots": 3}),
                            (JaxModel(gcfg, params=gtree), {"dp": 1, "tp": 2}, {})):
        with pytest.raises(ValueError) as err:
            jax_parallel.make_sharded_serving_engine(model, jax_parallel.create_mesh(axes), **kw)
        want.append(str(err.value))
    assert errors[0][0] == want[0] == "n_slots=3 not divisible by dp=2"
    assert errors[0][2] == want[1] == "n_kv_heads=1 not divisible by tp=2"
    assert "prefix_share" in errors[0][1]
    assert "must be dense" in errors[0][3]


def test_http_caption_over_mesh(served):
    """make_server(mesh=...) on a dp 1 x tp 2 world: rank 0 serves a caption
    over HTTP, rank 1 follows; the caption is the JAX sharded pool's."""
    outs = comm.launch(2, ranks.http_rank, {"dp": 1, "tp": 2}, served["pcfg"], served["state"],
                       SHAPES[0], 8, timeout_s=TIMEOUT_S, device="cpu")
    assert outs == [served["ref"][0][0], "followed"]
