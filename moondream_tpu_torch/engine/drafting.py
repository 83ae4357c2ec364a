"""Prompt-lookup (n-gram) drafting for the speculative loops
(moondream_tpu/engine/drafting.py). The JAX package's single-stream
`ngram_draft` is `ngram_draft_rows` over one row, as the batch-1 loop
(engine/generate.spec_step) calls it.

A draft never changes what is emitted: every speculative loop verifies it
against the target model's own logits, so drafting only decides how many
tokens one verify forward may advance.

Scheme: the longest suffix match, up to `max_n` tokens (default 8). Anchor
candidates are history positions holding the current token whose
predecessor also matches (the bigram floor); each scores one more per
further consecutive context token that matches, and the winner is the
longest match, ties going to the most recent occurrence. The k-1 tokens
after the anchor are the draft. When no bigram matches anywhere in a row,
the latest bare occurrence of the current token anchors it (the unigram
fallback), and failing that the draft repeats the current token. Seed pads
of -1 match no real token.

Pure tensor code over (B, H) histories: no `.item()`, no `nonzero`, no
boolean-mask indexing, so a serving chunk drafts on the device without a
host sync.
"""

from __future__ import annotations

from typing import Tuple

import torch

MAX_NGRAM = 8


def ngram_draft_rows(
    h: torch.Tensor, cnt1: torch.Tensor, cur: torch.Tensor, spec_k: int,
    max_n: int = MAX_NGRAM,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drafts for (B, H) row histories `h` (a valid prefix per row).

    `cnt1` (B,): valid tokens per row, INCLUDING `cur` (which sits at
    position cnt1 - 1); `cur` (B,): the current token per row. Returns
    (draft (B, spec_k - 1) >= 0 in h's dtype, any_match (B,) bool)."""
    bsz, hlen = h.shape
    dev = h.device
    hl, cnt1, cur = h.long(), cnt1.long(), cur.long()
    t = torch.arange(hlen, device=dev)[None, :]
    rows = torch.arange(bsz, device=dev)

    def ctx(g: int) -> torch.Tensor:
        """The g-th token before cur; -1 where the row is shorter."""
        idx = cnt1 - 1 - g
        return torch.where(idx >= 0, hl[rows, idx.clamp(0, hlen - 1)], -1)

    # an anchor holds cur and is old enough that the token after it exists
    elig = (hl == cur[:, None]) & (t <= (cnt1 - 2)[:, None])
    # tier g also needs h[j - g] == the g-th token before cur; a tier holds
    # only where every shorter one does, so the score is the suffix length
    b = elig & (t >= 1) & (torch.roll(hl, 1, dims=1) == ctx(1)[:, None])
    b1 = b
    score = b.long() * 2
    for g in range(2, max_n):
        b = b & (t >= g) & (torch.roll(hl, g, dims=1) == ctx(g)[:, None])
        score = score + b.long()
    key = torch.where(b1, score * hlen + t, -1)  # the longest match, then the latest
    any_bigram = b1.any(dim=1)
    any_uni = elig.any(dim=1)
    key_uni = torch.where(elig, t, -1)  # the latest bare occurrence of cur
    j_sel = torch.where(any_bigram, key.argmax(dim=1), key_uni.argmax(dim=1))
    any_match = any_bigram | any_uni
    start = (j_sel + 1).clamp(0, hlen - (spec_k - 1))
    gather = start[:, None] + torch.arange(spec_k - 1, device=dev)
    draft = hl.gather(1, gather)
    draft = torch.where(any_match[:, None], draft, cur[:, None])
    return draft.clamp(min=0).to(h.dtype), any_match
