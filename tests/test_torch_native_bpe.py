"""The port's native byte-level BPE (moondream_tpu_torch/native_bpe.py)
against the HF `tokenizers` library and the JAX package's wrapper
(moondream_tpu/native_bpe.py), on a BPE tokenizer trained locally as
tests/test_native_bpe.py trains one; and the MOONDREAM_NATIVE_BPE route of
the port's `load_tokenizer`."""

import json

import pytest

tokenizers = pytest.importorskip("tokenizers")

from moondream_tpu import native_bpe as jax_bpe  # noqa: E402
from moondream_tpu_torch import native_bpe, tokenizer  # noqa: E402
from moondream_tpu_torch.kernels.build import BUILD_DIR  # noqa: E402

CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "Moondream is a small vision language model, isn't it?",
    "import numpy as np\nx = np.zeros((378, 378, 3))",
    "Prices rose 12.5% in 2024 -- unbelievable!",
    "he said: \"don't you'll we've they're I'm it's\"",
    "multi   spaces\tand\nnewlines  everywhere   ",
    "punctuation!!! ??? ;;; ((())) [brackets] {braces}",
    "emails like a.b@c-d.org and urls http://x.y/z?a=1&b=2",
] * 50

TEXTS = [
    "The quick brown fox",
    " leading space",
    "don't we'll they've I'm you're it's he'd",
    "numbers 123 45.67 1,000,000 2024",
    "multi   spaces\tand\ttabs\nnewlines\n\n",
    "",
    "symbols @#$%^&*-_=+ and / \\ | ~ `",
    "unicode café naïve über señor",
    "greek αβγδ and cyrillic привет",
]


def _train(path, use_regex=True):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=use_regex)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=600, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    tok.train_from_iterator(CORPUS, trainer)
    tok.save(str(path))
    return tok


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    hf = _train(path)
    return {"hf": hf, "path": str(path), "port": native_bpe.NativeBPETokenizer.from_file(str(path)),
            "jax": jax_bpe.NativeBPETokenizer.from_file(str(path))}


def test_library_builds_into_the_port(trained):
    assert native_bpe.available()
    assert any(BUILD_DIR.glob("libmdbpe-*.so"))


@pytest.mark.parametrize("text", TEXTS)
def test_encode_matches_hf_and_jax(trained, text):
    ids = trained["port"].encode(text)
    assert ids == trained["hf"].encode(text).ids == trained["jax"].encode(text)
    assert trained["port"].decode(ids) == text


def test_decode_matches_hf(trained):
    ids = trained["hf"].encode("The quick brown fox, isn't it? 123").ids
    assert trained["port"].decode(ids) == trained["hf"].decode(ids) == trained["jax"].decode(ids)


def test_without_regex_matches(tmp_path):
    """A ByteLevel pre-tokenizer with use_regex false: the whole text is one
    word, in the HF library and in both wrappers."""
    path = tmp_path / "noregex.json"
    hf = _train(path, use_regex=False)
    ours = native_bpe.NativeBPETokenizer.from_file(str(path))
    theirs = jax_bpe.NativeBPETokenizer.from_file(str(path))
    for text in TEXTS[:4]:
        assert ours.encode(text) == hf.encode(text).ids == theirs.encode(text)


def test_rejects_non_bpe(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"model": {"type": "WordPiece"}}))
    with pytest.raises(ValueError, match="not a BPE tokenizer"):
        native_bpe.NativeBPETokenizer.from_file(str(path))


def test_load_tokenizer_native_route(trained, tmp_path, monkeypatch):
    """MOONDREAM_NATIVE_BPE picks the native tokenizer for a byte-level BPE
    file and falls through to the HF library for another scheme; without it
    the HF library reads the file."""
    assert isinstance(tokenizer.load_tokenizer(trained["path"]), tokenizer.HFTokenizer)
    monkeypatch.setenv("MOONDREAM_NATIVE_BPE", "1")
    tok = tokenizer.load_tokenizer(trained["path"])
    assert isinstance(tok, native_bpe.NativeBPETokenizer)
    assert tok.encode(TEXTS[2]) == trained["hf"].encode(TEXTS[2]).ids

    from tokenizers import Tokenizer, models, pre_tokenizers

    wp = Tokenizer(models.WordPiece({"[UNK]": 0, "a": 1, "b": 2}, unk_token="[UNK]"))
    wp.pre_tokenizer = pre_tokenizers.Whitespace()
    wp_path = str(tmp_path / "wordpiece.json")
    wp.save(wp_path)
    fallback = tokenizer.load_tokenizer(wp_path)
    assert isinstance(fallback, tokenizer.HFTokenizer)
    assert fallback.encode("a b") == [1, 2]
