"""The port's own host modules against the JAX package's: configuration
(region heads and tokenizer ids included), the offline byte tokenizer,
word-boundary streaming, the gaze outlier filter and the copied constants
(the drafter's n-gram length, the draft seed's width, the mixed pool's
modes). The port keeps copies
so that it never imports the JAX package; these tests hold the copies to
the originals, exactly."""

import dataclasses
import inspect

import numpy as np
import pytest

from moondream_tpu import config as jax_config
from moondream_tpu.engine import drafting as jax_drafting
from moondream_tpu.engine import serving as jax_serving
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu import tokenizer as jax_tokenizer
from moondream_tpu.utils import points as jax_points
from moondream_tpu.utils import streaming as jax_streaming
from moondream_tpu_torch import config, tokenizer
from moondream_tpu_torch.engine import drafting, serving
from moondream_tpu_torch.models import moondream
from moondream_tpu_torch.utils import points, streaming
from moondream_tpu.finetune import finetune_region as jax_ft_region
from moondream_tpu.finetune import finetune_text as jax_ft_text
from moondream_tpu_torch.finetune import finetune_region as ft_region
from moondream_tpu_torch.finetune import finetune_text as ft_text

CONFIGS = {
    "2b": (config.MOONDREAM_2B, jax_config.MOONDREAM_2B),
    "05b": (config.MOONDREAM_05B, jax_config.MOONDREAM_05B),
    "tiny": (config.tiny_test_config(), jax_config.tiny_test_config()),
}
DERIVED = {
    "text": ("head_dim", "qkv_dim", "rope_dim"),
    "vision": ("grid_size", "num_patches", "patch_dim"),
    "region": (),
    "tokenizer": (),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name):
    ours, theirs = CONFIGS[name]
    for part, derived in DERIVED.items():
        mine, ref = getattr(ours, part), getattr(theirs, part)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), (part, f.name)
        for prop in derived:
            assert getattr(mine, prop) == getattr(ref, prop), (part, prop)


TEXTS = ["a cat on a mat", "café — naïve\n", "猫がいる", ""]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_matches_jax(text):
    ours, ref = tokenizer.ByteTokenizer(), jax_tokenizer.ByteTokenizer()
    ids = ref.encode(text)
    assert ours.encode(text) == ids
    # ids below the offset and past offset + 255, as random weights emit
    noisy = [3, *ids, 600, 51199, 17]
    assert ours.decode(noisy) == ref.decode(noisy)
    assert ours.decode(ids) == text


@pytest.mark.parametrize("text", TEXTS + ["two\nlines and words", "tail without space"])
def test_streaming_matches_jax(text):
    tok = tokenizer.ByteTokenizer()
    ids = tok.encode(text)
    want = list(jax_streaming.stream_text(ids, tok.decode))
    assert list(streaming.stream_text(ids, tok.decode)) == want
    assert "".join(want) == text

    ours, ref = streaming.TokenStreamer(tok.decode), jax_streaming.TokenStreamer(tok.decode)
    assert [ours.feed(i) for i in ids] == [ref.feed(i) for i in ids]
    assert ours.finish() == ref.finish()


def test_load_tokenizer():
    assert isinstance(tokenizer.load_tokenizer(), tokenizer.ByteTokenizer)
    assert isinstance(tokenizer.load_tokenizer("byte"), tokenizer.ByteTokenizer)
    with pytest.raises(FileNotFoundError):
        tokenizer.load_tokenizer("no/such/tokenizer.json")


POINT_SETS = {
    "empty": [],
    "one": [(0.5, 0.5)],
    "two": [(0.1, 0.2), (0.9, 0.8)],
    "cluster+outliers": [(0.5 + 0.01 * i, 0.4 - 0.01 * i) for i in range(8)]
    + [(0.05, 0.95), (0.99, 0.01)],
    "random": [tuple(p) for p in np.random.default_rng(3).random((20, 2))],
}


@pytest.mark.parametrize("name", sorted(POINT_SETS))
def test_remove_outlier_points_matches_jax(name):
    pts = POINT_SETS[name]
    for k, thr in ((2, 2.0), (3, 1.5)):
        assert points.remove_outlier_points(pts, k, thr) == jax_points.remove_outlier_points(
            pts, k, thr)
    assert inspect.getsource(points.remove_outlier_points) == inspect.getsource(
        jax_points.remove_outlier_points)


@pytest.mark.parametrize("name,ours,theirs", [
    ("MAX_NGRAM", drafting.MAX_NGRAM, jax_drafting.MAX_NGRAM),
    ("SPEC_SEED_LEN", moondream.SPEC_SEED_LEN, JaxModel.SPEC_SEED_LEN),
    ("MODE_TEXT", serving.MODE_TEXT, jax_serving.MODE_TEXT),
    ("MODE_XN", serving.MODE_XN, jax_serving.MODE_XN),
    ("MODE_Y", serving.MODE_Y, jax_serving.MODE_Y),
    ("MODE_SIZE", serving.MODE_SIZE, jax_serving.MODE_SIZE),
    *((f"finetune_text.{n}", getattr(ft_text, n), getattr(jax_ft_text, n))
      for n in ("ANSWER_EOS", "LR", "EPOCHS", "GRAD_ACCUM_STEPS", "SEQ_BUCKET")),
    *((f"finetune_region.{n}", getattr(ft_region, n), getattr(jax_ft_region, n))
      for n in ("LR", "EPOCHS", "GRAD_ACCUM_STEPS")),
])
def test_copied_constants_match_jax(name, ours, theirs):
    assert ours == theirs, name


@pytest.mark.parametrize("spec", [None, "", "2b", "05b", "tiny", "json"])
def test_resolve_config_matches_jax(spec, tmp_path):
    """finetune.resolve_config, also for a JSON file the JAX package wrote
    (its to_dict, with the text fields the port does not read)."""
    import json

    from moondream_tpu.finetune import resolve_config as jax_resolve
    from moondream_tpu_torch.finetune import resolve_config

    if spec == "json":
        spec = str(tmp_path / "cfg.json")
        with open(spec, "w") as f:
            json.dump(jax_config.tiny_test_config().to_dict(), f)
    ours, theirs = resolve_config(spec), jax_resolve(spec)
    for part in DERIVED:
        mine, ref = getattr(ours, part), getattr(theirs, part)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), (spec, part, f.name)
