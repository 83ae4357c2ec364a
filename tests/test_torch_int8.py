"""The int8 w8a8 formats of the port against moondream_tpu on the CPU, with
numpy-seeded inputs: the ops, the quantizers and the int8 modules.

* `q8_act` and `int8_linear_plain` equal the JAX package's JITTED
  `_q8_act` / `linear` bit for bit in fp32 (the model runs them under jit,
  where XLA turns the division by 127 into a product with fp32(1/127) and
  contracts the epilogue to one fused multiply-add), dynamic and static,
  with K and N tails (K 100: not a multiple of 32; K 36: not of 8, the
  0.5B ViT's 2690 in small).
* `quantize_text_params_int8`, `quantize_vision_params` (dynamic and
  static) and `collect_vision_act_stats` against JAX's on the tiny config:
  codes bit for bit; scales and inv_a bit for bit, except the static
  format's: its equaliser's powers are taken in float64 here and by XLA's
  fp32 pow in JAX, which is not correctly rounded, so an element of c may
  differ by an ulp and move the scales it feeds by a few ulps (on this
  config 1 scale of 64, by 2 ulps; no code); and the activation
  statistics within rtol 4e-6: the same fp32 encoder, its products summed
  in another order and its tanh-GELU from another library, a few fp32
  ulps apart (measured at most 1.54e-6, on one of the 64 fc2 channels).
* The int8 text decoder (the [BOS, image] prefill, a prompt span, 3 cached
  decode steps) against JAX's in fp32 with the tree carried across by
  `params_from_jax`: hidden states within atol 1e-4, as the dense
  decoder's test holds them. The int8 ViT (dynamic and static) likewise,
  but not to 1e-4: an input an fp32 ulp apart (the two libraries' attention
  and LayerNorm sum in other orders) can cross a rounding boundary, and
  the flipped code moves its row by a whole quantization step, which the
  bidirectional attention then spreads over every token. Its outputs are
  held to a fraction of the int8 format's own error against the dense
  encoder: max |port - JAX| <= 0.75 x max |JAX int8 - JAX dense| and the
  mean <= 0.25 x its mean (measured on three seeds: at most 0.55 and 0.19
  dynamic, 0.27 and 0.02 static).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import generate as jax_gen
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.ops import layers as jax_layers
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import generate
from moondream_tpu_torch.models import vision
from moondream_tpu_torch.models.text import KVCache, quantize_text_params_int8
from moondream_tpu_torch.ops.layers import (
    Int8Linear,
    int8_linear,
    int8_linear_plain,
    pack_int8_weight,
    q8_act,
)
from moondream_tpu_torch.weights import params_from_jax

ATOL = 1e-4
LOGIT_RTOL = 2.0**-7
STATS_RTOL = 4e-6

_jit_linear = jax.jit(jax_layers.linear)
_jit_q8 = jax.jit(jax_layers._q8_act)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _act(rng, m, k) -> np.ndarray:
    """Rows of N(0, 1) with one outlier channel (x 40), one all-zero row (its
    scale takes the 1e-6 floor) and one of half-integers with an amax of
    127, whose codes sit on or a hair past rounding ties."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, k // 3] *= 40.0
    x[-1] = 0.0
    x[0] = np.arange(k) % 254 - 127 + 0.5
    x[0, 0] = 127.0
    return x


@pytest.mark.parametrize("m,k", [(64, 2048), (7, 100), (5, 36), (3, 1152)])
def test_q8_act_equals_jitted_jax(m, k):
    x = _act(np.random.default_rng(m + k), m, k)
    want_codes, want_a = _jit_q8(jnp.asarray(x))
    codes, a = q8_act(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(_bits(a.numpy()), _bits(want_a))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("m,k,n,bias", [(64, 2048, 512, True), (7, 100, 40, True),
                                        (5, 36, 24, True), (3, 1152, 96, True),
                                        (9, 64, 32, False)])
def test_int8_linear_plain_equals_jitted_jax(static, m, k, n, bias):
    rng = np.random.default_rng(m * k + n)
    x = _act(rng, m, k)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.random((1, n)) * 1e-2 + 1e-3).astype(np.float32)
    w = {"wq": jnp.asarray(wq), "scale": jnp.asarray(scale)}
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    w["b"] = None if b is None else jnp.asarray(b)
    inv_a = None
    if static:
        inv_a = (rng.random((1, k)) * 30 + 1).astype(np.float32)
        w["inv_a"] = jnp.asarray(inv_a)
    want = _jit_linear(jnp.asarray(x), w)
    lin = Int8Linear(torch.from_numpy(wq), torch.from_numpy(scale),
                     torch.zeros(n) if b is None else torch.from_numpy(b),
                     None if inv_a is None else torch.from_numpy(inv_a))
    got = int8_linear_plain(torch.from_numpy(x), lin.wq, lin.scale,
                            None if b is None else lin.b, lin.inv_a)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if bias:  # the module's forward is the same function
        np.testing.assert_array_equal(_bits(lin(torch.from_numpy(x)).numpy()), _bits(want))
    # leading axes pass through
    x3 = torch.from_numpy(x).reshape(1, m, k)
    assert torch.equal(int8_linear(x3, lin.wq, lin.scale, lin.b, lin.inv_a)[0],
                       int8_linear(x3[0], lin.wq, lin.scale, lin.b, lin.inv_a))


def test_int8_weight_layout_and_routes():
    """The kernel's layout (N, Kp): transposed, K zero-padded to a multiple
    of 64, codes unchanged; a device with no route raises."""
    rng = np.random.default_rng(0)
    wq = torch.from_numpy(rng.integers(-127, 128, (100, 24)).astype(np.int8))
    packed = pack_int8_weight(wq)
    assert packed.shape == (24, 128) and packed.dtype == torch.int8
    assert torch.equal(packed[:, :100].t(), wq) and not packed[:, 100:].any()
    lin = Int8Linear(wq, torch.ones(1, 24), torch.zeros(24), torch.ones(1, 100))
    assert torch.equal(lin.codes(), wq) and lin.inv_a.shape == (128,)
    assert not lin.inv_a[100:].any()
    with pytest.raises(ValueError, match="no route"):
        int8_linear(torch.zeros(2, 100, device="meta"), lin.wq, lin.scale, lin.b)


@pytest.fixture(scope="module")
def tree():
    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(4))
    return {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }


@pytest.fixture(scope="module")
def calib():
    """5 normalized calibration crops in [-1, 1]."""
    return np.random.default_rng(6).uniform(-1, 1, (5, 378, 378, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_stats(tree, calib):
    cfg = tiny_test_config().vision
    return jax_vision.collect_vision_act_stats(jnp.asarray(calib), tree["vision"], cfg, chunk=2)


_LINEARS = (("attn", "qkv", lambda b: b.qkv), ("attn", "proj", lambda b: b.proj),
            ("mlp", "fc1", lambda b: b.mlp.fc1), ("mlp", "fc2", lambda b: b.mlp.fc2))


# the static format's scales and inv_a: elements that may differ from
# JAX's, and by how many ulps at most (see the module docstring)
STATIC_DIFFER_MAX = 2
STATIC_ULPS = 4


def _assert_same_int8(lin, leaf, layer, static=False) -> int:
    """The port's Int8Linear against layer `layer` of a JAX int8 leaf:
    codes and bias bit for bit; scale and inv_a bit for bit, or with
    `static` at most STATIC_DIFFER_MAX elements STATIC_ULPS ulps apart.
    Returns how many scale and inv_a elements differ."""
    assert isinstance(lin, Int8Linear)
    np.testing.assert_array_equal(lin.codes().numpy(), np.asarray(leaf["wq"][layer]))
    np.testing.assert_array_equal(lin.b.numpy(), np.asarray(leaf["b"][layer]))
    assert (lin.inv_a is None) == ("inv_a" not in leaf)
    pairs = [(lin.scale.numpy(), leaf["scale"])]
    if lin.inv_a is not None:
        pairs.append((lin.inv_a[:lin.in_features].numpy(), leaf["inv_a"]))
    differ = 0
    for got, want in pairs:
        ulps = np.abs(_bits(got).astype(np.int64)
                      - _bits(np.asarray(want[layer]).reshape(-1)).astype(np.int64))
        differ += int((ulps > 0).sum())
        assert ulps.max() <= (STATIC_ULPS if static else 0), (layer, ulps.max())
    assert differ <= (STATIC_DIFFER_MAX if static else 0), (layer, differ)
    return differ


def test_quantize_text_params_int8_equals_jax(tree):
    want = jax_text.quantize_text_params_int8(tree["text"])["blocks"]
    params = params_from_jax(tree, port_tiny_config())
    quantize_text_params_int8(params["text"])
    for i, blk in enumerate(params["text"].blocks):
        for mod, name, get in _LINEARS:
            _assert_same_int8(get(blk), want[mod][name], i)
    # the JAX package's int8 tree carries over with the same codes
    carried = params_from_jax(dict(tree, text=jax_text.quantize_text_params_int8(tree["text"])),
                              port_tiny_config())
    for i, blk in enumerate(carried["text"].blocks):
        for mod, name, get in _LINEARS:
            _assert_same_int8(get(blk), want[mod][name], i)
    assert not isinstance(params["text"].lm_head, Int8Linear)


@pytest.mark.parametrize("n_crops,chunk", [(5, 2), (3, 16)], ids=["tail-dropped", "one-chunk"])
def test_collect_vision_act_stats_equals_jax(tree, calib, n_crops, chunk):
    cfg = tiny_test_config().vision
    want = jax_vision.collect_vision_act_stats(
        jnp.asarray(calib[:n_crops]), tree["vision"], cfg, chunk=chunk)
    params = params_from_jax(tree, port_tiny_config())
    got = vision.collect_vision_act_stats(torch.from_numpy(calib[:n_crops]), params["vision"],
                                          chunk=chunk)
    assert set(got) == set(want) == {"qkv", "proj", "fc1", "fc2"}
    for key in want:
        assert got[key].dtype == torch.float32
        assert tuple(got[key].shape) == (cfg.enc_n_layers, want[key].shape[1])
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_quantize_vision_params_equals_jax(tree, jax_stats, static):
    stats = jax_stats if static else None
    want = jax_vision.quantize_vision_params(tree["vision"], act_stats=stats)["blocks_q"]
    params = params_from_jax(tree, port_tiny_config())
    vision.quantize_vision_params(
        params["vision"],
        act_stats=None if stats is None else {k: torch.from_numpy(np.array(v))
                                              for k, v in stats.items()})
    differ = sum(_assert_same_int8(get(blk), want[mod][name], i, static)
                 for i, blk in enumerate(params["vision"].blocks) for mod, name, get in _LINEARS)
    assert differ <= STATIC_DIFFER_MAX
    carried = params_from_jax(dict(tree, vision=jax_vision.quantize_vision_params(
        tree["vision"], act_stats=stats)), port_tiny_config())
    for i, blk in enumerate(carried["vision"].blocks):
        for mod, name, get in _LINEARS:
            _assert_same_int8(get(blk), want[mod][name], i)
        np.testing.assert_array_equal(blk.ln1.weight.numpy(), np.asarray(want["ln1"]["weight"][i]))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_vision_encoder_matches_jax(tree, jax_stats, static):
    cfg = tiny_test_config().vision
    qtree = dict(tree, vision=jax_vision.quantize_vision_params(
        tree["vision"], act_stats=jax_stats if static else None))
    params = params_from_jax(qtree, port_tiny_config())
    crops = np.random.default_rng(8).uniform(-1, 1, (3, 378, 378, 3)).astype(np.float32)
    want = np.asarray(jax_vision.vision_encoder(jnp.asarray(crops), qtree["vision"], cfg))
    dense = np.asarray(jax_vision.vision_encoder(jnp.asarray(crops), tree["vision"], cfg))
    got = vision.vision_encoder(torch.from_numpy(crops), params["vision"]).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    drift, err = np.abs(got - want), np.abs(want - dense)
    assert drift.max() <= 0.75 * err.max(), (drift.max(), err.max())
    assert drift.mean() <= 0.25 * err.mean(), (drift.mean(), err.mean())


def test_int8_text_decoder_matches_jax(tree):
    """Prefill of a 730-row [BOS, image] span, a 5-token prompt span, then 3
    cached decode steps, hidden states and logits."""
    tcfg = tiny_test_config().text
    jw = jax_text.quantize_text_params_int8(tree["text"])
    model = params_from_jax(dict(tree, text=jw), port_tiny_config())["text"]
    rng = np.random.default_rng(9)
    image = rng.standard_normal((1, 730, tcfg.dim)).astype(np.float32)
    prompt = rng.standard_normal((1, 8, tcfg.dim)).astype(np.float32)
    jkv = jax_text.KVCache.create(tcfg, dtype=jnp.float32)
    tkv = KVCache.create(port_tiny_config().text, dtype=torch.float32)

    def check(got, want):
        (lg, hg), (lw, hw) = got, want
        np.testing.assert_allclose(hg.numpy(), np.asarray(hw), atol=ATOL, rtol=0)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=ATOL, rtol=LOGIT_RTOL)

    *want, jkv = jax_gen.prefill(jw, jkv, jnp.asarray(image), 0, 730, 730, tcfg, kv_bound=768)
    check(generate.prefill(model, tkv, torch.from_numpy(image), 0, 730, 730, kv_bound=768), want)
    *want, jkv = jax_gen.prefill(jw, jkv, jnp.asarray(prompt), 730, 5, 730, tcfg, kv_bound=768)
    check(generate.prefill(model, tkv, torch.from_numpy(prompt), 730, 5, 730, kv_bound=768),
          want)
    for step in range(3):
        emb = rng.standard_normal((1, 1, tcfg.dim)).astype(np.float32) * 0.02
        *want, jkv = jax_gen.decode_step(jw, jkv, jnp.asarray(emb), 735 + step, tcfg,
                                         kv_bound=768)
        check(generate.decode_step(model, tkv, torch.from_numpy(emb), 735 + step, 768), want)
