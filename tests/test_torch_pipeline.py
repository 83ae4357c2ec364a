"""The port's multi-image pipelines (`engine/pipeline.BatchPipeline`,
`PooledPipeline`) and the pool's `submit_many` against the JAX package's on
the CPU, at tiny_test_config in fp32 on the same weights (IdTokenizer ids,
greedy):

  * BatchPipeline caption and query equal JAX's BatchPipeline: five images
    of three sizes at batch 2 (a padded tail batch, several ViT groups per
    batch), one image, none; speculative=3 equals JAX's and the plain
    pipeline's;
  * PooledPipeline with speculative 0 and 3, and a query, equals JAX's;
  * submit_many equals JAX's submit_many, and refuses a burst larger than
    the free slots;
  * the port's BatchPipeline equals its own caption_batch under the peaked
    oracle (lm_head bias + N(0, 8^2): no greedy pick is a near tie);
  * a producer error reaches the caller with no thread left alive;
  * a GQA BatchPipeline(speculative=k) raises a ValueError at its first
    greedy batch, and takes the plain loop for sampled settings.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import pipeline as jax_pipeline
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.models.serve import ContinuousBatchingEngine as JaxEngine
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine.pipeline import BatchPipeline, PooledPipeline
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

GREEDY = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 10}
QUESTION = "What is this?"


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


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


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }
    ref = JaxModel(cfg, params=dict(tree, region=None), tokenizer=IdTokenizer(),
                   dtype=jnp.float32)
    pcfg = port_tiny_config()
    ours = MoondreamModel(pcfg, params=params_from_jax(tree, pcfg), tokenizer=IdTokenizer(),
                          dtype=torch.float32, device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def images():
    """Five images of three sizes: at batch 2 a padded tail and batches of
    one and two ViT groups."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in [(120, 160), (200, 100), (160, 160), (120, 160), (200, 100)]]


def _pil(images):
    return [Image.fromarray(im) for im in images]


@pytest.mark.parametrize("spec", [0, 3], ids=["plain", "spec3"])
@pytest.mark.parametrize("task", ["caption", "query"])
def test_batch_pipeline_matches_jax(models, images, task, spec):
    ref, ours = models
    want_pipe = jax_pipeline.BatchPipeline(ref, batch_size=2, speculative=spec)
    got_pipe = BatchPipeline(ours, batch_size=2, speculative=spec)
    if task == "caption":
        want = want_pipe.caption(_pil(images), "normal", settings=GREEDY)
        got = got_pipe.caption(images, "normal", settings=GREEDY)
    else:
        want = want_pipe.query(_pil(images), QUESTION, settings=GREEDY)
        got = got_pipe.query(images, QUESTION, settings=GREEDY)
    assert got == want and len(got) == len(images)
    assert all(0 < s.count("<") <= GREEDY["max_tokens"] for s in got)


def test_batch_pipeline_single_and_empty(models, images):
    ref, ours = models
    want = jax_pipeline.BatchPipeline(ref, batch_size=2).caption(_pil(images[1:2]), "short",
                                                                 settings=GREEDY)
    pipe = BatchPipeline(ours, batch_size=2)
    assert pipe.caption(images[1:2], "short", settings=GREEDY) == want
    assert pipe.caption([], settings=GREEDY) == []


def test_speculative_batch_pipeline_equals_plain_to_eos(models, images):
    """Without a forced length (the model's EOS, 40 tokens), rows end at
    their own lengths; speculative ids equal the plain pipeline's."""
    _, ours = models
    settings = {**GREEDY, "max_tokens": 40}
    plain = BatchPipeline(ours, batch_size=2).caption(images, "short", settings=settings)
    spec = BatchPipeline(ours, batch_size=2, speculative=3).caption(images, "short",
                                                                    settings=settings)
    assert spec == plain


@pytest.fixture
def peaked(models):
    """The port model with lm_head's bias raised by N(0, 8^2) noise
    (tests/test_torch_batched.py's oracle)."""
    _, ours = models
    b = ours.text.lm_head.b
    orig = b.detach().clone()
    noise = np.random.default_rng(3).standard_normal(b.shape[0]).astype(np.float32) * 8
    with torch.no_grad():
        b += torch.from_numpy(noise)
    yield ours
    with torch.no_grad():
        b.copy_(orig)


def test_batch_pipeline_equals_caption_batch_with_peaked_decoder(peaked, images):
    """The fused [BOS, image, prompt] prefill against encode_images +
    caption_batch's two prefills, per batch of 2 (the tail padded)."""
    got = BatchPipeline(peaked, batch_size=2).caption(images, "normal", settings=GREEDY)
    want = []
    for start in range(0, len(images), 2):
        want += peaked.caption_batch(images[start:start + 2], "normal", settings=GREEDY)
    assert got == want


@pytest.mark.parametrize("spec,task", [(0, "caption"), (3, "caption"), (0, "query")])
def test_pooled_pipeline_matches_jax(models, images, spec, task):
    ref, ours = models
    kw = dict(n_slots=2, slot_len=1024, chunk=4, wave=2, speculative=spec)
    settings = {**GREEDY, "max_tokens": 12}
    want_pipe = jax_pipeline.PooledPipeline(ref, **kw)
    got_pipe = PooledPipeline(ours, **kw)
    if task == "caption":
        want = want_pipe.caption(_pil(images), "short", settings=settings)
        got = got_pipe.caption(images, "short", settings=settings)
    else:
        want = want_pipe.query(_pil(images[:3]), QUESTION, settings=settings)
        got = got_pipe.query(images[:3], QUESTION, settings=settings)
    assert got == want and all(isinstance(t, str) and t for t in got)


def test_submit_many_matches_jax(models, images):
    ref, ours = models
    kw = dict(n_slots=4, slot_len=1024, chunk=4)
    jeng, peng = JaxEngine(ref, **kw), ContinuousBatchingEngine(ours, **kw)
    want_ids = jeng.submit_many(_pil(images[:3]), question=QUESTION, max_tokens=9)
    got_ids = peng.submit_many(images[:3], question=QUESTION, max_tokens=9)
    want, got = jeng.drain(), peng.drain()
    assert [got[r] for r in got_ids] == [want[r] for r in want_ids]
    # the same requests one by one
    singles = ContinuousBatchingEngine(ours, **kw)
    rids = [singles.submit(im, question=QUESTION, max_tokens=9) for im in images[:3]]
    one_by_one = singles.drain()
    assert [one_by_one[r] for r in rids] == [got[r] for r in got_ids]


def test_submit_many_refuses_more_images_than_free_slots(models, images):
    _, ours = models
    eng = ContinuousBatchingEngine(ours, n_slots=2, slot_len=1024, chunk=4)
    eng.submit(images[0], max_tokens=4)
    with pytest.raises(RuntimeError, match="free slots"):
        eng.submit_many(images[:2], max_tokens=4)
    assert len(eng.free_slots()) == 1


class Broken:
    def convert(self, mode):
        raise ValueError("bad image")


@pytest.mark.parametrize("kind", ["batch", "pooled"])
def test_producer_error_reaches_the_caller(models, images, kind):
    _, ours = models
    before = threading.active_count()
    if kind == "batch":
        pipe = BatchPipeline(ours, batch_size=2)
        run = lambda: pipe.caption([images[0], images[1], Broken()], settings=GREEDY)
    else:
        pipe = PooledPipeline(ours, n_slots=2, slot_len=1024, chunk=4, wave=1)
        run = lambda: pipe.caption([images[0], Broken()], settings=GREEDY)
    with pytest.raises(ValueError, match="bad image"):
        run()
    assert threading.active_count() == before


def test_speculative_batch_pipeline_refuses_gqa(images):
    cfg = port_tiny_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, n_kv_heads=1))
    gqa = MoondreamModel(cfg, dtype=torch.float32, device="cpu")
    before = threading.active_count()
    with pytest.raises(ValueError, match="MHA"):
        BatchPipeline(gqa, batch_size=2, speculative=4).caption(images[:2], settings=GREEDY)
    assert threading.active_count() == before
    # sampled settings take the plain loop, which GQA runs
    texts = BatchPipeline(gqa, batch_size=2, speculative=4).caption(
        images[:2], settings={"temperature": 0.7, "top_p": 0.9, "max_tokens": 4})
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
