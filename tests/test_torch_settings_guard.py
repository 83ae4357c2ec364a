"""The port refuses the JAX package's LoRA-variant and steering settings
(`variant`, `variant_tree`, `variant_label`, `steer`, `steer_scale`) with a
NotImplementedError in every entry point that takes settings, and the pool
refuses `variant=` in every submission, instead of answering as the base
model without a word."""

import numpy as np
import pytest
import torch

from moondream_tpu_torch.config import tiny_test_config
from moondream_tpu_torch.engine.pipeline import BatchPipeline, PooledPipeline
from moondream_tpu_torch.models.moondream import UNPORTED_SETTINGS, MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine

IMG = np.zeros((40, 60, 3), dtype=np.uint8)
FACE = {"x_min": 0.3, "x_max": 0.6, "y_min": 0.2, "y_max": 0.5}

ENTRY_POINTS = {
    "encode_image": lambda m, s: m.encode_image(IMG, settings=s),
    "encode_images": lambda m, s: m.encode_images([IMG], settings=s),
    "caption": lambda m, s: m.caption(IMG, settings=s),
    "query": lambda m, s: m.query(IMG, "why?", settings=s),
    "detect": lambda m, s: m.detect(IMG, "cat", settings=s),
    "point": lambda m, s: m.point(IMG, "cat", settings=s),
    "detect_gaze": lambda m, s: m.detect_gaze(IMG, face=FACE, unstable_settings={
        "prioritize_accuracy": True, **s}),
    "caption_batch": lambda m, s: m.caption_batch([IMG], settings=s),
    "query_batch": lambda m, s: m.query_batch([IMG], "why?", settings=s),
    "detect_batch": lambda m, s: m.detect_batch([IMG], "cat", settings=s),
    "point_batch": lambda m, s: m.point_batch([IMG], "cat", settings=s),
    "compile": lambda m, s: m.compile(settings=s),
    "BatchPipeline": lambda m, s: BatchPipeline(m, batch_size=1).caption([IMG], settings=s),
    "PooledPipeline": lambda m, s: PooledPipeline(m, n_slots=2).caption([IMG], settings=s),
}
VALUES = {"variant": "some/adapter", "variant_tree": {"blocks": {}},
          "variant_label": "some/adapter", "steer": np.ones((2, 64), np.float32),
          "steer_scale": 5.0}


@pytest.fixture(scope="module")
def model():
    return MoondreamModel(tiny_test_config(), dtype=torch.float32, seed=1, device="cpu")


def test_every_unported_key_has_a_case():
    assert set(VALUES) == set(UNPORTED_SETTINGS)


@pytest.mark.parametrize("key", sorted(VALUES))
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_refuse_variants_and_steering(model, entry, key):
    with pytest.raises(NotImplementedError, match=key):
        ENTRY_POINTS[entry](model, {"max_tokens": 2, key: VALUES[key]})


def test_unset_keys_are_accepted(model):
    s = {"max_tokens": 2, "temperature": 0.0, "variant": None, "steer": None}
    assert isinstance(model.caption(IMG, settings=s)["caption"], str)


SUBMISSIONS = {
    "submit": lambda e: e.submit(IMG, variant="a"),
    "submit_many": lambda e: e.submit_many([IMG], variant="a"),
    "prepare": lambda e: e.prepare(IMG, variant="a"),
    "submit_detect": lambda e: e.submit_detect(IMG, "cat", variant="a"),
    "submit_point": lambda e: e.submit_point(IMG, "cat", variant="a"),
    "submit_gaze": lambda e: e.submit_gaze(IMG, (0.5, 0.5), variant="a"),
}


@pytest.mark.parametrize("submission", sorted(SUBMISSIONS))
def test_pool_submissions_refuse_variants(model, submission):
    eng = ContinuousBatchingEngine(model, n_slots=2)
    with pytest.raises(NotImplementedError, match="LoRA"):
        SUBMISSIONS[submission](eng)
    assert len(eng.free_slots()) == 2
