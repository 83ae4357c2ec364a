"""Word-boundary-safe token streaming, with the flushing rules of
`moondream_tpu.utils.streaming`: flush everything after a newline, flush
through a trailing CJK character, otherwise flush only up to the last
space so that no word is split mid-stream.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence


def is_cjk_char(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class TokenStreamer:
    """Incremental detokenizer: feed() per token returns a printable chunk
    or None; finish() flushes the rest."""

    def __init__(self, decode_fn):
        self._decode = decode_fn
        self._cache: List[int] = []
        self._print_len = 0

    def feed(self, token_id: int) -> Optional[str]:
        self._cache.append(token_id)
        text = self._decode(self._cache)
        if text.endswith("\n"):
            out = text[self._print_len:]
            self._cache = []
            self._print_len = 0
            return out or None
        if text and is_cjk_char(ord(text[-1])):
            out = text[self._print_len:]
            self._print_len += len(out)
            return out or None
        last_space = text.rfind(" ", self._print_len)
        if last_space >= self._print_len:
            out = text[self._print_len:last_space + 1]
            self._print_len += len(out)
            return out or None
        return None

    def finish(self) -> Optional[str]:
        if not self._cache:
            return None
        out = self._decode(self._cache)[self._print_len:]
        self._cache = []
        self._print_len = 0
        return out or None


def stream_text(token_ids: Sequence[int], decode_fn) -> Iterator[str]:
    """The chunks TokenStreamer yields for a complete token sequence."""
    streamer = TokenStreamer(decode_fn)
    for t in token_ids:
        chunk = streamer.feed(int(t))
        if chunk:
            yield chunk
    tail = streamer.finish()
    if tail:
        yield tail
