"""The quantized caption path of the port against moondream_tpu's on the CPU
at tiny_test_config, fp32: int4 text blocks (the JAX package's
`quantize_text_params`, carried over by `params_from_jax` with the same
packed bytes), an int8 KV cache (`kv_int8`), and both together. As in
tests/test_torch_caption.py: a seeded 756x1008 image (13 crops), greedy
decode of 16 tokens, IdTokenizer; the greedy ids must be identical."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.text import Int4Linear
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

GREEDY = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 16}


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _with_kv_int8(cfg, kv_int8):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_int8=kv_int8))


@pytest.fixture(scope="module")
def tree():
    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    return {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).integers(0, 255, (756, 1008, 3), dtype=np.uint8)


@pytest.mark.parametrize("int4,kv_int8", [(True, False), (False, True), (True, True)],
                         ids=["int4", "kv_int8", "int4+kv_int8"])
def test_quantized_greedy_caption_ids_identical(tree, image, int4, kv_int8, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
    if int4:
        tree = dict(tree, text=jax_text.quantize_text_params(tree["text"]))
    ref = JaxModel(
        _with_kv_int8(tiny_test_config(), kv_int8), params=dict(tree, region=None),
        tokenizer=IdTokenizer(), dtype=jnp.float32,
    )
    cfg = _with_kv_int8(port_tiny_config(), kv_int8)
    ours = MoondreamModel(
        cfg, params=params_from_jax(tree, cfg), tokenizer=IdTokenizer(),
        dtype=torch.float32, device="cpu",
    )
    blk = ours.text.blocks[1]
    assert isinstance(blk.mlp.fc2, Int4Linear) == int4
    if int4:  # the same codes as the JAX package's
        want_packed = np.asarray(tree["text"]["blocks_q"]["mlp"]["fc2"]["packed"][1])
        np.testing.assert_array_equal(blk.mlp.fc2.packed.numpy(), want_packed)

    want = ref.caption(Image.fromarray(image), "normal", settings=GREEDY)["caption"]
    got = ours.caption(image, "normal", settings=GREEDY)["caption"]
    assert got == want
    assert got.count("<") == 16

    enc = ours.encode_image(image)
    assert (enc.k.dtype == torch.int8) == kv_int8
    assert (enc.ks is not None) == kv_int8
    if kv_int8:
        assert tuple(enc.ks.shape) == (cfg.text.n_layers, 1, cfg.text.n_kv_heads // 2, 730)
    streamed = "".join(ours.caption(enc, "normal", stream=True, settings=GREEDY)["caption"])
    assert streamed == got
