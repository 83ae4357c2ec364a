"""The port's lockstep batched paths against the JAX package on the CPU, at
tiny_test_config (MHA) and at the same config with one KV head (GQA), fp32,
the same parameters in both packages:

  * `encode_images` snapshots against JAX's `encode_images` and against the
    port's own per-image `encode_image` (atol 1e-4: fp32 sums in another
    order and batch shape);
  * `caption_batch` / `query_batch` greedy ids equal to JAX's, from images
    and from EncodedImages;
  * batched against batch-1 in the port with a peaked lm-head bias, so that
    no greedy pick is a near tie that a batched product's other summation
    order could flip (tests/test_batched.py's oracle);
  * `generate_text_batched`'s per-row EOS, tokens and counts equal to
    JAX's, EOS reached by some rows, by a first token, or never.

IdTokenizer renders every id as `<id>`: equal strings mean equal ids.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import batched as jax_batched
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import batched as port_batched
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.models.moondream import EncodedImage, MoondreamModel
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

GREEDY = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 10}
QUESTION = "What is this?"


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _heads(cfg, n_kv_heads):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, n_kv_heads=n_kv_heads))


@pytest.fixture(scope="module", params=[2, 1], ids=["mha", "gqa"])
def models(request):
    cfg = _heads(tiny_test_config(), request.param)
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }
    ref = JaxModel(cfg, params=dict(tree, region=None), tokenizer=IdTokenizer(),
                   dtype=jnp.float32)
    pcfg = _heads(port_tiny_config(), request.param)
    ours = MoondreamModel(pcfg, params=params_from_jax(tree, pcfg),
                          tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def images():
    """Four images of three sizes: (120, 160) twice, so encode_images forms a
    group of two and two groups of one."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in [(120, 160), (200, 100), (160, 160), (120, 160)]]


@pytest.fixture(autouse=True)
def _host_crops(monkeypatch):
    # the JAX model's host crop path (its device path is bit-identical)
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")


def _pil(images):
    return [Image.fromarray(im) for im in images]


def _unpaired(x, head_dim):
    """A JAX cache leaf (L, B, H/pf, T, pf * Dh), head-paired under MHA, in
    the port's plain (L, B, H, T, Dh) layout."""
    x = np.asarray(x)
    n, b, hp, t, dd = x.shape
    pf = dd // head_dim
    return x.reshape(n, b, hp, t, pf, head_dim).transpose(0, 1, 2, 4, 3, 5).reshape(
        n, b, hp * pf, t, head_dim
    )


def test_encode_images_matches_jax_and_single(models, images):
    ref, ours = models
    got = ours.encode_images(images)
    want = ref.encode_images(_pil(images))
    assert len(got) == len(images)
    for g, w, im in zip(got, want, images):
        single = ours.encode_image(im)
        assert g.pos == w.pos == single.pos == 730
        assert g.k.shape == single.k.shape == (2, 1, ours.config.text.n_kv_heads, 730, 32)
        for a, b in ((g.k, w.k), (g.v, w.v)):
            np.testing.assert_allclose(a.numpy(), _unpaired(b, 32), atol=1e-4, rtol=1e-4)
        for a, b in ((g.k, single.k), (g.v, single.v)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("task", ["caption", "query"])
def test_batch_ids_match_jax(models, images, task):
    ref, ours = models
    if task == "caption":
        want = ref.caption_batch(_pil(images), "normal", settings=GREEDY)
        got = ours.caption_batch(images, "normal", settings=GREEDY)
    else:
        want = ref.query_batch(_pil(images), QUESTION, settings=GREEDY)
        got = ours.query_batch(images, QUESTION, settings=GREEDY)
    assert got == want
    assert all(s.count("<") <= GREEDY["max_tokens"] for s in got) and any(got)


def test_batch_accepts_encoded_images(models, images):
    """EncodedImages, or a mix of them and images, give the ids of images."""
    _, ours = models
    encs = ours.encode_images(images[:2])
    assert all(isinstance(e, EncodedImage) for e in encs)
    from_images = ours.caption_batch(images, "short", settings=GREEDY)
    assert ours.caption_batch(encs + images[2:], "short", settings=GREEDY) == from_images
    assert ours.caption_batch([images[0], encs[1], *images[2:]], "short",
                              settings=GREEDY) == from_images


@pytest.fixture
def peaked(models):
    """The port model with lm_head's bias raised by N(0, 8^2) noise: the
    greedy margins (~2 at the top of 512 such draws) dwarf the reduction-
    order noise of a batched product, yet the argmax still follows the
    hidden state (logits of random weights spread over a few units)."""
    _, ours = models
    b = ours.text.lm_head.b
    orig = b.detach().clone()
    noise = np.random.default_rng(3).standard_normal(b.shape[0]).astype(np.float32) * 8
    with torch.no_grad():
        b += torch.from_numpy(noise)
    yield ours
    with torch.no_grad():
        b.copy_(orig)


@pytest.mark.parametrize("task", ["caption", "query"])
def test_batch_matches_single_with_peaked_decoder(peaked, images, task):
    if task == "caption":
        batch = peaked.caption_batch(images, "normal", settings=GREEDY)
        singles = [peaked.caption(im, "normal", settings=GREEDY)["caption"] for im in images]
    else:
        batch = peaked.query_batch(images, QUESTION, settings=GREEDY)
        singles = [peaked.query(im, QUESTION, settings=GREEDY)["answer"] for im in images]
    assert batch == singles


# (label, eos): a token one row emits mid-way, a row's first token, or none
EOS_CASES = ["mid", "first", "none"]


@pytest.mark.parametrize("case", EOS_CASES)
def test_generate_text_batched_eos_and_counts_match_jax(models, case):
    """Three rows prefilled from the same random embeddings in both packages
    (12 rows, bidirectional over 8), then lockstep greedy generation of up
    to 10 tokens from given first tokens, answer id suppressed."""
    ref, ours = models
    cfg = ref.config.text
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 12, cfg.dim)).astype(np.float32)
    first = np.asarray([5, 300, 17], np.int32)

    def run_jax(eos):
        kv = jax_text.KVCache.create(cfg, batch=3, dtype=jnp.float32)
        _, kv = jax_text.text_decoder(jnp.asarray(x), ref.params["text"], kv,
                                      jnp.int32(0), jnp.int32(8), cfg)
        res = jax_batched.generate_text_batched(
            ref.params["text"], kv, jnp.asarray(first), jnp.int32(12),
            jax.random.PRNGKey(0), jnp.float32(0.0), jnp.float32(0.0), jnp.int32(10),
            cfg, eos, (3,), 64,
        )
        steps = int(res.pos) - 12
        tokens = np.asarray(res.tokens)
        assert not tokens[:, steps:].any()
        return tokens[:, :steps], np.asarray(res.counts)

    free, _ = run_jax(-1)
    eos = {"mid": int(free[1, 4]), "first": 300, "none": -1}[case]
    want_tokens, want_counts = run_jax(eos)

    kv = port_text.KVCache.create(ours.config.text, 3, torch.float32, "cpu")
    port_text.text_decoder(torch.from_numpy(x), ours.text, kv, 0, 8)
    res = port_batched.generate_text_batched(
        ours.text, kv, torch.from_numpy(first), 12, None, 0.0, 0.0, 10, eos, (3,)
    )
    # the port reads its all-done flag every DONE_CHECK_EVERY steps: the
    # steps it runs past JAX's last one emit nothing
    steps = port_batched.batched_steps(int(want_counts.max()), 10)
    assert steps >= want_tokens.shape[1]
    np.testing.assert_array_equal(res.tokens.numpy()[:, :want_tokens.shape[1]], want_tokens)
    assert not res.tokens[:, want_tokens.shape[1]:].any()
    np.testing.assert_array_equal(res.counts.numpy(), want_counts)
    assert res.pos == 12 + steps
    if case == "first":
        assert want_counts[1] == 0
    if case == "mid":
        assert want_counts[1] <= 4 < want_tokens.shape[1]


@pytest.mark.parametrize("max_count,limit,want", [
    (0, 10, 0), (3, 10, 8), (8, 10, 8), (9, 10, 10), (10, 10, 10), (9, 40, 16),
])
def test_batched_steps_stop_at_the_next_flag_read(max_count, limit, want):
    """generate_text_batched reads its all-done flag once every
    DONE_CHECK_EVERY (8) steps: it stops at the first read after the last
    row's EOS, or at the limit."""
    assert port_batched.DONE_CHECK_EVERY == 8
    assert port_batched.batched_steps(max_count, limit) == want
