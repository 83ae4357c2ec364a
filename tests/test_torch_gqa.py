"""Grouped-query attention (n_kv_heads < n_heads) in the port against the
JAX package on the CPU.

  * The plain versions of kernel B's GQA entries against the Pallas kernels
    they replace, run with interpret=True on fp32 inputs, atol 2e-5 / rtol
    1e-4 (the JAX suite's own: the same fp32 math summed in another order):
    `decode_attention_cached` (`_decode_kernel_stacked_gqa`, one layer of a
    stacked cache) and `decode_attention` (`_decode_kernel` at rep 1,
    `_decode_kernel_gqa` above it, a single layer). Caches hold garbage
    (x1000) past every column a row may attend.
  * `text_decoder` at the tiny config with one KV head for its two query
    heads, fp32, bf16-layout and int8 caches, through a prefill, a decode
    token and a prompt span, against JAX's `text_decoder` (atol 1e-4).
  * Greedy ids of `caption` and `query` (plain, streamed, without an image)
    equal `moondream_tpu`'s at that config, with a plain and an int8 cache.
  * The model's device default, the serving pool's GQA refusal and the
    weight helpers at a GQA config.

The GQA entries themselves run only on the card: their `cuda` tests are in
tests/test_torch_attention.py, which imports no jax at module level.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.ops.attention import decode_attention as jax_decode
from moondream_tpu.ops.attention import decode_attention_cached as jax_decode_cached
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.ops.attention import (
    decode_attention,
    decode_attention_cached,
    decode_attention_cached_plain,
    decode_attention_plain,
)
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import init_params, params_from_jax

ATOL, RTOL = 2e-5, 1e-4
L, HKV, D, T = 3, 2, 32, 256
LAYER = 1
GREEDY = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 12}


class IdTokenizer(ByteTokenizer):
    """Renders every id as `<id>`: equal strings mean equal token ids."""

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _normal(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _garbage_after(x, end):
    """x1000 past column `end` of the time axis (-2)."""
    x[..., end:, :] *= 1000
    return x


def _gqa(cfg, kv_int8=False):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, n_kv_heads=1, kv_int8=kv_int8)
    )


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("kv_bound", [None, 128])
@pytest.mark.parametrize("pos,prefix", [(5, 0), (20, 8), (7, 8)])
@pytest.mark.parametrize("rep", [2, 4])
@pytest.mark.parametrize("b", [1, 3])
def test_stacked_gqa_plain_matches_pallas(b, rep, pos, prefix, kv_bound):
    rng = np.random.default_rng(10 + b + rep)
    end = max(pos + 1, prefix)
    k = _garbage_after(_normal(rng, L, b, HKV, T, D), end)
    v = _garbage_after(_normal(rng, L, b, HKV, T, D), end)
    q = _normal(rng, b, HKV * rep, 1, D)
    want = np.asarray(jax_decode_cached(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), LAYER, pos, prefix,
        kv_bound=kv_bound, interpret=True,
    ))
    got = decode_attention_cached(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), LAYER,
        pos, prefix, kv_bound,
    )
    assert got.shape == (b, HKV * rep, 1, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pos,prefix", [(40, 0), (10, 64)])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_single_layer_plain_matches_pallas(rep, pos, prefix):
    """A single (B, Hkv, T, D) layer of 200 columns, as the int8 cache's
    dequantized [0, kv_bound) span reaches it."""
    rng = np.random.default_rng(20 + rep)
    b, t = 2, 200
    end = max(pos + 1, prefix)
    k = _garbage_after(_normal(rng, b, HKV, t, D), end)
    v = _garbage_after(_normal(rng, b, HKV, t, D), end)
    q = _normal(rng, b, HKV * rep, 1, D)
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, prefix, interpret=True
    ))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           pos, prefix)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_stacked_and_single_layer_plain_agree():
    """The stacked GQA plain version at layer l equals the single-layer one
    on cache[l] (exactly: the same arithmetic on the same values)."""
    rng = np.random.default_rng(30)
    k, v = (torch.from_numpy(_normal(rng, L, 2, HKV, T, D)) for _ in range(2))
    q = torch.from_numpy(_normal(rng, 2, HKV * 4, 1, D))
    a = decode_attention_cached_plain(q, k, v, LAYER, 90, 16)
    b = decode_attention_plain(q, k[LAYER], v[LAYER], 90, 16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ text decoder


def _decoder_pair(kv_int8: bool):
    """The JAX text tree of the tiny GQA config and the port's TextModel
    holding the same values."""
    cfg = _gqa(tiny_test_config(), kv_int8)
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, jax.random.PRNGKey(4), jnp.float32),
        "text": jax_text.init_text_params(cfg.text, jax.random.PRNGKey(3), jnp.float32),
    }
    ours = params_from_jax(tree, _gqa(port_tiny_config(), kv_int8))["text"]
    return cfg.text, tree["text"], ours


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["plain-cache", "kv_int8"])
def test_text_decoder_gqa_matches_jax(kv_int8, batch):
    """Prefill 12 rows (bidirectional over 8), one decode token (the GQA
    decode route: stacked entry, or the dequantized single layer), then a
    5-row span (heads repeated, flash) at kv_bound 256, fp32."""
    cfg, tree, ours = _decoder_pair(kv_int8)
    rng = np.random.default_rng(40 + batch)
    jkv = jax_text.KVCache.create(cfg, batch=batch, dtype=jnp.float32)
    pkv = port_text.KVCache.create(ours.config, batch, torch.float32, "cpu")
    pos = 0
    for rows, prefix, bound in ((12, 8, None), (1, 0, 256), (5, 0, 256)):
        x = _normal(rng, batch, rows, cfg.dim, scale=1.0)
        want, jkv = jax_text.text_decoder(
            jnp.asarray(x), tree, jkv, jnp.int32(pos), jnp.int32(prefix), cfg,
            kv_bound=bound,
        )
        got = port_text.text_decoder(torch.from_numpy(x), ours, pkv, pos, prefix, bound)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        pos += rows


# ------------------------------------------------------------ whole model


@pytest.fixture(scope="module", params=[False, True], ids=["plain-cache", "kv_int8"])
def models(request):
    kv_int8 = request.param
    cfg = _gqa(tiny_test_config(), kv_int8)
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
        "region": jax_region.init_region_params(cfg.region, jax.random.PRNGKey(1), jnp.float32),
    }
    ref = JaxModel(cfg, params=tree, tokenizer=IdTokenizer(), dtype=jnp.float32)
    pcfg = _gqa(port_tiny_config(), kv_int8)
    ours = MoondreamModel(pcfg, params=params_from_jax(tree, pcfg),
                          tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).integers(0, 255, (300, 500, 3), dtype=np.uint8)


@pytest.fixture(autouse=True)
def _host_crops(monkeypatch):
    # the JAX model's host crop path (its device path is bit-identical)
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")


def test_gqa_snapshot_layout(models, image):
    _, ours = models
    enc = ours.encode_image(image)
    assert enc.k.shape == (2, 1, 1, 730, 32)
    if ours.config.text.kv_int8:
        assert enc.k.dtype == torch.int8 and enc.ks.shape == (2, 1, 1, 730)


def test_gqa_caption_ids_match_jax(models, image):
    from PIL import Image

    ref, ours = models
    want = ref.caption(Image.fromarray(image), "normal", settings=GREEDY)["caption"]
    got = ours.caption(image, "normal", settings=GREEDY)["caption"]
    assert got == want and got.count("<") == GREEDY["max_tokens"]


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "no-image"])
def test_gqa_query_ids_match_jax(models, image, with_image):
    from PIL import Image

    ref, ours = models
    q = "What is in it?"
    want = ref.query(Image.fromarray(image) if with_image else None, q,
                     settings=GREEDY)["answer"]
    got = ours.query(image if with_image else None, q, settings=GREEDY)["answer"]
    assert got == want and got


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "no-image"])
def test_query_streamed_equals_plain(models, image, with_image):
    _, ours = models
    enc = ours.encode_image(image) if with_image else None
    plain = ours.query(enc, "Why?", settings=GREEDY)["answer"]
    streamed = ours.query(enc, "Why?", stream=True, settings=GREEDY)["answer"]
    assert not isinstance(streamed, str)
    assert "".join(streamed) == plain


def test_query_reasoning_and_spatial_refs_not_ported(models, image):
    """Reasoning and spatial refs, once refused, now run on the GQA config
    and give the JAX package's ids; the argument checks stay."""
    from PIL import Image

    ref, ours = models
    for kw in ({"reasoning": True}, {"spatial_refs": [(0.5, 0.5), (0.1, 0.2, 0.6, 0.7)]}):
        want = ref.query(Image.fromarray(image), "Why?", settings=GREEDY, **kw)
        got = ours.query(image, "Why?", settings=GREEDY, **kw)
        assert got == want and got["answer"]
        assert ("reasoning" in got) == ("reasoning" in kw)
    with pytest.raises(ValueError, match="with an image"):
        ours.query(None, "Why?", spatial_refs=[(0.5, 0.5)])
    with pytest.raises(ValueError, match="question"):
        ours.query(image)


# ------------------------------------------------------- device, pool, weights


def test_model_defaults_to_the_card(monkeypatch):
    """Without a card the default raises and says how to ask for the CPU;
    nothing falls back to it."""
    from moondream_tpu_torch.weights import load_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MoondreamModel(port_tiny_config())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MoondreamModel(port_tiny_config(), device="cuda")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_params("never-read.safetensors", port_tiny_config())
    assert MoondreamModel(port_tiny_config(), device="cpu").device.type == "cpu"


def test_serving_pool_refuses_gqa():
    from moondream_tpu_torch.models.serve import ContinuousBatchingEngine

    model = MoondreamModel(_gqa(port_tiny_config()), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="MHA"):
        ContinuousBatchingEngine(model, n_slots=2)


@pytest.mark.parametrize("n_kv_heads", [1, 2])
def test_weights_at_gqa_config(n_kv_heads):
    """qkv is dim x dim * (1 + 2 Hkv / Hq) in both packages, and
    params_from_jax carries every value over."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, n_kv_heads=n_kv_heads))
    pcfg = port_tiny_config()
    pcfg = dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, n_kv_heads=n_kv_heads))
    qkv_dim = 64 * (1 + 2 * n_kv_heads // 2)
    assert pcfg.text.qkv_dim == cfg.text.qkv_dim == qkv_dim
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, jax.random.PRNGKey(1), jnp.float32),
        "text": jax_text.init_text_params(cfg.text, jax.random.PRNGKey(2), jnp.float32),
    }
    ours = params_from_jax(tree, pcfg)
    blk = ours["text"].blocks[1]
    np.testing.assert_array_equal(
        blk.qkv.w.numpy(), np.asarray(tree["text"]["blocks"]["attn"]["qkv"]["w"][1])
    )
    drawn = init_params(pcfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    assert drawn["text"].blocks[0].qkv.w.shape == (64, qkv_dim)
