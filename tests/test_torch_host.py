"""The port's own host modules against the JAX package's: configuration,
the offline byte tokenizer and word-boundary streaming. The port keeps
copies so that it never imports the JAX package; these tests hold the copies
to the originals, exactly."""

import dataclasses

import pytest

from moondream_tpu import config as jax_config
from moondream_tpu import tokenizer as jax_tokenizer
from moondream_tpu.utils import streaming as jax_streaming
from moondream_tpu_torch import config, tokenizer
from moondream_tpu_torch.utils import streaming

CONFIGS = {
    "2b": (config.MOONDREAM_2B, jax_config.MOONDREAM_2B),
    "05b": (config.MOONDREAM_05B, jax_config.MOONDREAM_05B),
    "tiny": (config.tiny_test_config(), jax_config.tiny_test_config()),
}
DERIVED = {
    "text": ("head_dim", "qkv_dim", "rope_dim"),
    "vision": ("grid_size", "num_patches", "patch_dim"),
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
