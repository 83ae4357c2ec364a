"""The in-repo C++ byte-level BPE tokenizer (`native/bpe.cpp`) through
ctypes (moondream_tpu/native_bpe.py).

It reads any byte-level BPE tokenizer.json (the scheme of both moondream
tokenizer generations), undoes the GPT-2 byte<->unicode mapping and drives
the C library, so that a real tokenizer runs where the HF `tokenizers`
library is not installed. The library is built with g++ at first use into
the port's build directory (`kernels.build.compile_library`), never into
`native/`, and loaded with ctypes; nothing is built at import.

Limitations, as in the JAX package: added and special tokens are not split
out of raw text (prompt templates are id lists, so plain text never holds
them), and tokenizers of another scheme are refused with ValueError.
"""

from __future__ import annotations

import ctypes
import json
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .kernels.build import compile_library
from .tokenizer import TokenizerBase

_NATIVE_SRC = Path(__file__).resolve().parents[1] / "native" / "bpe.cpp"
# The flags of native/Makefile.
_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-march=native"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _byte_to_unicode() -> dict:
    """GPT-2's printable-byte mapping: printable bytes map to themselves,
    the others to U+0100 + i in order."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_B2U = _byte_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}


def _load_lib() -> Optional[ctypes.CDLL]:
    """The tokenizer library, built on first use; None when it cannot be
    built here (no compiler, or the source is missing)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _NATIVE_SRC.exists():
            return None
        try:
            path = compile_library("mdbpe", [_NATIVE_SRC], ["g++"], _CXX_FLAGS)
        except (OSError, RuntimeError):
            return None
        lib = ctypes.CDLL(str(path))
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.bpe_encode.restype = ctypes.c_int32
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.bpe_decode.restype = ctypes.c_int32
        lib.bpe_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.bpe_destroy.restype = None
        lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load_lib() is not None


class NativeBPETokenizer(TokenizerBase):
    """Byte-level BPE over the C++ core. Build one from a tokenizer.json
    with `from_file`."""

    def __init__(self, vocab: dict, merges: List, use_regex: bool = True):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native BPE library unavailable (no g++ or no native/bpe.cpp)")
        self._lib = lib
        n = max(vocab.values()) + 1
        token_bytes = [b""] * n
        for tok_str, tid in vocab.items():
            try:
                raw = bytes(_U2B[ch] for ch in tok_str)
            except KeyError:
                # added and special tokens hold characters outside the byte
                # alphabet; plain-text encoding never meets them
                raw = tok_str.encode("utf-8")
            token_bytes[tid] = raw
        blob = b"".join(token_bytes)
        lens = np.asarray([len(t) for t in token_bytes], np.int32)
        left = np.empty(len(merges), np.int32)
        right = np.empty(len(merges), np.int32)
        for i, m in enumerate(merges):
            a, b = m.split(" ", 1) if isinstance(m, str) else (m[0], m[1])
            left[i] = vocab[a]
            right[i] = vocab[b]
        buf = ctypes.create_string_buffer(blob, len(blob))
        # bpe_create copies the tables, so the buffers need not outlive it
        self._handle = lib.bpe_create(
            buf, lens.ctypes.data, n, left.ctypes.data, right.ctypes.data, len(merges),
            1 if use_regex else 0,
        )

    @classmethod
    def from_file(cls, path: str) -> "NativeBPETokenizer":
        """A byte-level BPE tokenizer.json; ValueError for another model
        type or pre-tokenizer."""
        with open(path) as f:
            spec = json.load(f)
        model = spec.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(f"not a BPE tokenizer: {model.get('type')}")
        pre = spec.get("pre_tokenizer") or {}
        pres = pre.get("pretokenizers", [pre]) if pre else []
        kinds = {p.get("type") for p in pres}
        if pres and "ByteLevel" not in kinds:
            raise ValueError(f"unsupported pre_tokenizer: {kinds}")
        use_regex = all(p.get("use_regex", True) for p in pres) if pres else False
        return cls(model["vocab"], model["merges"], use_regex=use_regex)

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        max_out = max(16, 2 * len(data) + 16)
        out = np.empty(max_out, np.int32)
        n = self._lib.bpe_encode(self._handle, data, len(data), out.ctypes.data, max_out)
        if n == -2:
            raise RuntimeError(
                "bpe_encode: an input byte has no vocab id (the tokenizer's byte alphabet "
                "is incomplete)"
            )
        if n < 0:
            raise RuntimeError("bpe_encode overflow")
        return out[:n].tolist()

    def decode(self, ids: Sequence[int]) -> str:
        arr = np.asarray(list(ids), np.int32)
        max_out = max(16, 8 * len(arr) + 16)
        buf = ctypes.create_string_buffer(max_out)
        n = self._lib.bpe_decode(self._handle, arr.ctypes.data, len(arr), buf, max_out)
        if n < 0:
            raise RuntimeError("bpe_decode overflow")
        return buf.raw[:n].decode("utf-8", errors="replace")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.bpe_destroy(handle)
            self._handle = None
