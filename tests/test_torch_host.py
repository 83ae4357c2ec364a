"""The port's own host modules against the JAX package's: configuration
(region heads and tokenizer ids included), the offline byte tokenizer,
word-boundary streaming, the gaze outlier filter and the copied constants
(the drafter's n-gram length, the draft seed's width, the mixed pool's
modes), and the HTTP server's and the native BPE wrapper's host code (the
boolean and chat parsers, the metrics' snapshot, the structured batcher's
grouping, the byte-to-unicode map and the pre-tokenizer's regex choice).
The port keeps copies
so that it never imports the JAX package; these tests hold the copies to
the originals, exactly."""

import dataclasses
import inspect
import json
import re

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


# ------------------------------------------------ the front ends' host code
from moondream_tpu import native_bpe as jax_bpe  # noqa: E402
from moondream_tpu import serve_http as jax_http  # noqa: E402
from moondream_tpu_torch import native_bpe, serve_http  # noqa: E402


@pytest.mark.parametrize("value", [True, False, 1, 0, None, "true", " Yes ", "on", "1",
                                   "false", "off", "0", "", "maybe"])
def test_parse_bool_matches_jax(value):
    assert serve_http._parse_bool(value) == jax_http._parse_bool(value)


def _png_url(seed: int) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (20, 30, 3), np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


CHATS = {
    "image and text": {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What"}, {"type": "text", "text": "is it?"},
        {"type": "image_url", "image_url": {"url": _png_url(0)}}]}]},
    "text only": {"messages": [{"role": "system", "content": "be brief"},
                               {"role": "user", "content": " Say something. "}]},
    "follow-up keeps the image": {"messages": [
        {"role": "user", "content": [{"type": "image_url", "image_url": {"url": _png_url(1)}},
                                     {"type": "text", "text": "What is this?"}]},
        {"role": "assistant", "content": "a thing"},
        {"role": "user", "content": "What color?"}]},
    "latest image wins": {"messages": [
        {"role": "user", "content": [{"type": "image_url", "image_url": {"url": _png_url(2)}},
                                     {"type": "image_url", "image_url": {"url": _png_url(3)}},
                                     {"type": "text", "text": "and?"}]}]},
    "remote url": {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "x"},
        {"type": "image_url", "image_url": {"url": "https://example.com/x.png"}}]}]},
    "no messages": {},
    "no user": {"messages": [{"role": "assistant", "content": "hi"}]},
    "no text": {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": _png_url(0)}}]}]},
}


@pytest.mark.parametrize("name", sorted(CHATS))
def test_parse_chat_matches_jax(name):
    """The port decodes the image to a uint8 RGB array where the JAX
    package keeps a PIL image: the pixels, the content key, the question
    and every refusal must be the same."""
    payload = CHATS[name]
    try:
        want = jax_http._parse_chat(payload)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            serve_http._parse_chat(payload)
        return
    image, key, question = serve_http._parse_chat(payload)
    assert (key, question) == want[1:]
    if want[0] is None:
        assert image is None
    else:
        assert image.dtype == np.uint8
        np.testing.assert_array_equal(image, np.asarray(want[0]))


def test_metrics_snapshot_matches_jax(monkeypatch):
    import time

    ours, theirs = serve_http._Metrics(), jax_http._Metrics()
    ours.started = theirs.started = 10.0
    monkeypatch.setattr(time, "monotonic", lambda: 110.0)
    rng = np.random.default_rng(0)
    for i in range(600):  # past the reservoir
        ep = ("caption", "query", "detect")[i % 3]
        args = (ep, float(rng.random()), bool(i % 7), int(rng.integers(0, 9)))
        ours.observe(*args)
        theirs.observe(*args)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.RESERVOIR == theirs.RESERVOIR


def test_structured_batcher_grouping_matches_jax():
    """With requests already pending, the caller leads a group of the
    pending requests of its kind and object (itself the last, within
    max_batch), in arrival order; the others stay pending. Both packages
    pick the same groups."""
    import threading

    def scenario(cls):
        calls = []

        def run(kind, images, obj):
            calls.append((kind, list(images), obj))
            return [f"{kind}:{obj}:{im}" for im in images]

        b = cls(run, window_s=0.0, max_batch=4)
        pending = [("detect", "x"), ("point", "x"), ("detect", "y"), ("detect", "x"),
                   ("detect", "x")]
        b._pending = [{"kind": k, "obj": o, "image": f"p{i}", "ev": threading.Event(),
                       "result": None, "error": None} for i, (k, o) in enumerate(pending)]
        first = b.request("detect", "lead", "x", timeout_s=5.0)
        left = [(i["kind"], i["obj"], i["image"]) for i in b._pending]
        return calls, first, left, b.coalesced

    assert scenario(serve_http._StructuredBatcher) == scenario(jax_http._StructuredBatcher)


def test_byte_to_unicode_matches_jax():
    assert native_bpe._byte_to_unicode() == jax_bpe._byte_to_unicode()
    assert native_bpe._U2B == jax_bpe._U2B and len(native_bpe._B2U) == 256


PRE_TOKENIZERS = {
    "byte-level regex": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
    "byte-level no regex": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False},
    "sequence": {"type": "Sequence", "pretokenizers": [{"type": "ByteLevel"}]},
    "none": None,
    "whitespace": {"type": "Whitespace"},
}


@pytest.mark.parametrize("name", sorted(PRE_TOKENIZERS))
def test_bpe_pre_tokenizer_parsing_matches_jax(name, tmp_path):
    """The same tokenizer.json (the 256 byte symbols and a few merges) under
    each pre-tokenizer: the same regex choice (the same ids) or the same
    refusal in both wrappers."""
    vocab = {native_bpe._B2U[b]: b for b in range(256)}
    merges = []
    for a, b in (("t", "h"), ("th", "e"), ("Ġ", "c"), ("Ġc", "a"), ("a", "t")):
        merges.append(f"{a} {b}")
        vocab.setdefault(a + b, len(vocab))
    spec = {"model": {"type": "BPE", "vocab": vocab, "merges": merges},
            "pre_tokenizer": PRE_TOKENIZERS[name]}
    path = str(tmp_path / "tokenizer.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    try:
        theirs = jax_bpe.NativeBPETokenizer.from_file(path)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            native_bpe.NativeBPETokenizer.from_file(path)
        return
    ours = native_bpe.NativeBPETokenizer.from_file(path)
    text = "the cat sat, then the  cats!"
    assert ours.encode(text) == theirs.encode(text)
    assert ours.decode(ours.encode(text)) == text
