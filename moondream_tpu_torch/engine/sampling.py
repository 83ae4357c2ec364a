"""Greedy and temperature + nucleus (top-p) sampling on the device
(moondream_tpu/engine/sampling.py), for one row or per row of a batch.

Sort descending, keep tokens while the probability mass BEFORE each token is
<= top_p, renormalise, draw in sorted space and map back through the sort
order. Draws come from an explicit `torch.Generator`; no host sync, and no
host value inside a draw (temperature and top_p may be device tensors), so
a CUDA graph can capture a sampled decode step; whether a row is greedy or
sampled is the caller's host choice.
"""

from __future__ import annotations

from typing import Union

import torch


def apply_top_p_mask(probs_desc: torch.Tensor, top_p: float) -> torch.Tensor:
    """Filter an already-descending-sorted probability vector."""
    csum = torch.cumsum(probs_desc, dim=-1)
    keep = (csum - probs_desc) <= top_p
    filtered = torch.where(keep, probs_desc, torch.zeros_like(probs_desc))
    return filtered / filtered.sum(dim=-1, keepdim=True)


def target_probs(logits: torch.Tensor, temperature, top_p) -> torch.Tensor:
    """The distribution a nucleus draw at temperature > 0 samples from:
    softmax(logits / T), top-p filtered and renormalised, in vocabulary
    order (moondream_tpu/engine/sampling.py:25). (..., V) logits -> (..., V)
    fp32 probabilities; `temperature`/`top_p` are floats or tensors that
    broadcast against (..., 1). Speculative sampling's accept and residual
    rule reads these probabilities themselves, not just a draw. The sort is
    stable, as JAX's argsort, so ties at the top-p edge resolve alike."""
    logits = logits.float()
    if isinstance(temperature, torch.Tensor):
        safe_t = temperature.float().clamp_min(1e-6)
    else:
        safe_t = max(temperature, 1e-6)
    probs = torch.softmax(logits / safe_t, dim=-1)
    probs_desc, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    filtered = apply_top_p_mask(probs_desc, top_p)
    return torch.zeros_like(filtered).scatter_(-1, order, filtered)


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: float,
    top_p: float,
) -> torch.Tensor:
    """One token id (0-d int64 tensor on logits' device) from (V,) logits.
    temperature <= 0 is argmax (first maximum on ties)."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
    # stable, as JAX's argsort: exact ties keep the lower id first
    probs_desc, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    filtered = apply_top_p_mask(probs_desc, top_p)
    cdf = torch.cumsum(filtered, dim=-1)
    u = torch.rand((1,), generator=generator, device=logits.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u).clamp_(max=cdf.shape[0] - 1)
    return order.gather(0, idx).reshape(())


def _nucleus(logits, generator, temperature, top_p) -> torch.Tensor:
    """One draw per row of (S, V) logits under per-row or shared settings,
    as sample_token draws one."""
    t = temperature[:, None] if isinstance(temperature, torch.Tensor) else temperature
    p_lim = top_p[:, None] if isinstance(top_p, torch.Tensor) else top_p
    safe_t = t.clamp_min(1e-6) if isinstance(t, torch.Tensor) else max(t, 1e-6)
    probs = torch.softmax(logits / safe_t, dim=-1)
    probs_desc, order = torch.sort(probs, dim=-1, descending=True, stable=True)
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
