"""The whole caption path of the port against moondream_tpu.MoondreamModel
on the CPU at tiny_test_config, fp32, with the same parameters: host crops
of a seeded 756x1008 image (3x4 tiling, 13 crops), ViT, stitch,
projection, [BOS, image] prefill, prompt prefill, greedy decode of 16
tokens. The greedy ids must be identical.

IdTokenizer is the ByteTokenizer with a decode that renders every id as
`<id>`, so equal caption strings mean equal token ids (ByteTokenizer
itself drops the ids below 256 that random weights emit)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine.sampling import apply_top_p_mask as jax_top_p
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine.sampling import apply_top_p_mask, sample_token
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

GREEDY = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 16}


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }
    ref = JaxModel(
        cfg, params=dict(tree, region=None), tokenizer=IdTokenizer(),
        dtype=jnp.float32,
    )
    port_cfg = port_tiny_config()
    ours = MoondreamModel(
        port_cfg, params=params_from_jax(tree, port_cfg), tokenizer=IdTokenizer(),
        dtype=torch.float32, device="cpu",
    )
    return ref, ours


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).integers(0, 255, (756, 1008, 3), dtype=np.uint8)


def test_greedy_caption_ids_identical(models, image, monkeypatch):
    from PIL import Image

    # the JAX model's host crop path (its device path is bit-identical)
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
    ref, ours = models
    want = ref.caption(Image.fromarray(image), "normal", settings=GREEDY)["caption"]
    got = ours.caption(image, "normal", settings=GREEDY)["caption"]
    assert got == want
    assert got.count("<") == 16

    streamed = "".join(ours.caption(image, "normal", stream=True, settings=GREEDY)["caption"])
    assert streamed == got


def test_encoded_image_reuse(models, image):
    _, ours = models
    enc = ours.encode_image(image)
    assert enc.pos == 730 and enc.k.shape[3] == 730
    a = ours.caption(enc, "short", settings=GREEDY)["caption"]
    assert a == ours.caption(image, "short", settings=GREEDY)["caption"]


def test_top_p_mask_matches_jax():
    rng = np.random.default_rng(6)
    probs = rng.dirichlet(np.ones(64) * 0.3, size=3).astype(np.float32)
    probs = -np.sort(-probs, axis=-1)
    for top_p in (0.0, 0.3, 0.9, 1.0):
        got = apply_top_p_mask(torch.from_numpy(probs), top_p).numpy()
        want = np.asarray(jax_top_p(jnp.asarray(probs), top_p))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sampling_stays_in_nucleus_and_is_seeded():
    logits = torch.tensor([4.0, 3.9, 1.0, 0.5, -2.0, 3.95])
    draws = lambda seed: [
        int(sample_token(logits, g, 1.0, 0.5))
        for g in [torch.Generator().manual_seed(seed)] for _ in range(200)
    ]
    a = draws(0)
    # p = (.340, .308, .017, .010, .001, .324): the mass before token 1 is
    # .664 > top_p, so the nucleus is exactly {0, 5}
    assert set(a) == {0, 5}
    assert a == draws(0)
    assert int(sample_token(logits, None, 0.0, 0.0)) == 0
