"""Logits and sampling for a batch of rows, one row per serving slot
(moondream_tpu/engine/batched.py:32-75).

Everything stays on the device: greedy rows take an argmax, sampled rows
the nucleus draw of `sampling.sample_token`, with per-row uniforms from an
explicit `torch.Generator`. Nothing is read back to the host, so a serving
chunk can run many steps without a sync.
"""

from __future__ import annotations

from typing import Union

import torch

from ..models.text import TextModel
from .generate import _lm_logits
from .sampling import apply_top_p_mask


def lm_logits_batched(h: torch.Tensor, model: TextModel) -> torch.Tensor:
    """(S, D) hidden -> (S, V) fp32 logits: fp32 accumulation, rounded
    through bf16 (see generate._lm_logits)."""
    return _lm_logits(h, model)


def _nucleus(logits, generator, temperature, top_p) -> torch.Tensor:
    """One draw per row of (S, V) logits under per-row or shared settings,
    as sample_token draws one."""
    t = temperature[:, None] if isinstance(temperature, torch.Tensor) else temperature
    p_lim = top_p[:, None] if isinstance(top_p, torch.Tensor) else top_p
    safe_t = t.clamp_min(1e-6) if isinstance(t, torch.Tensor) else max(t, 1e-6)
    probs = torch.softmax(logits / safe_t, dim=-1)
    probs_desc, order = torch.sort(probs, dim=-1, descending=True)
    cdf = torch.cumsum(apply_top_p_mask(probs_desc, p_lim), dim=-1)
    u = torch.rand(
        (logits.shape[0], 1), generator=generator, device=logits.device
    ) * cdf[:, -1:]
    idx = torch.searchsorted(cdf, u).clamp_(max=cdf.shape[1] - 1)
    return order.gather(1, idx)[:, 0]


def sample_tokens_batched(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: Union[float, torch.Tensor],
    top_p: Union[float, torch.Tensor],
) -> torch.Tensor:
    """(S,) int64 token ids from (S, V) logits. `temperature`/`top_p` are
    Python floats (one setting for the pool: a greedy pool takes the argmax
    with no vocabulary sort) or (S,) device tensors (per-request settings:
    every row is drawn and greedy rows then take their argmax through a
    per-row where, so they stay exact in a mixed pool)."""
    logits = logits.float()
    if not isinstance(temperature, torch.Tensor):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return _nucleus(logits, generator, temperature, top_p)
    return torch.where(
        temperature <= 0.0,
        torch.argmax(logits, dim=-1),
        _nucleus(logits, generator, temperature, top_p),
    )
