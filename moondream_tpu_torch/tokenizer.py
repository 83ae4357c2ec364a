"""Tokenizers of the port (the offline part of `moondream_tpu.tokenizer`).

`ByteTokenizer` is the deterministic byte-level tokenizer the JAX package
uses offline, id for id. `load_tokenizer` also opens a HF tokenizer.json
from a local path through the `tokenizers` library, imported only then, or
through the in-repo C++ byte-level BPE (`native_bpe`) when
MOONDREAM_NATIVE_BPE is set.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


class TokenizerBase:
    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError


class HFTokenizer(TokenizerBase):
    """Wrapper over a HF `tokenizers` tokenizer.json."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(path)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))


class ByteTokenizer(TokenizerBase):
    """Token id = byte value + `offset`; ids below `offset` stay free for the
    special and template ids."""

    def __init__(self, offset: int = 256):
        self.offset = offset

    def encode(self, text: str) -> List[int]:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        # total over any vocab: ids past offset+255 (random weights at a big
        # vocab) fold into byte range
        data = bytes((i - self.offset) % 256 for i in ids if i >= self.offset)
        return data.decode("utf-8", errors="ignore")


def load_tokenizer(spec: Optional[str] = None) -> TokenizerBase:
    """A tokenizer.json path (or MOONDREAM_TOKENIZER) -> HFTokenizer, or
    with MOONDREAM_NATIVE_BPE set the in-repo C++ byte-level BPE
    (`native_bpe`) when it builds here and reads the file (another scheme
    falls through to HFTokenizer, as in moondream_tpu/tokenizer.py:84-93);
    None or "byte" -> ByteTokenizer."""
    spec = spec or os.environ.get("MOONDREAM_TOKENIZER")
    if spec is None or spec == "byte":
        return ByteTokenizer()
    if not os.path.exists(spec):
        raise FileNotFoundError(f"tokenizer file {spec!r} not found")
    if os.environ.get("MOONDREAM_NATIVE_BPE"):
        from .native_bpe import NativeBPETokenizer, available

        if available():
            try:
                return NativeBPETokenizer.from_file(spec)
            except ValueError:
                pass  # not a byte-level BPE: the HF library reads it
    return HFTokenizer(spec)
