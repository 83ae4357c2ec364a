"""Partial rotary position embeddings (moondream_tpu/ops/rope.py).

Only the first `rot_dim` channels of each head rotate, with a half-split
(real = first half, imaginary = second half), fp32 math, and the rotated
output re-interleaved as (r0, i0, r1, i1, ...).
"""

from __future__ import annotations

import numpy as np
import torch


def precompute_freqs_cis(
    dim: int, end: int, theta: float = 10000.0, device=None
) -> torch.Tensor:
    """Cos/sin table (end, dim//2, 2) in fp32, built on the host exactly as
    the JAX package builds it: fp32 angles, f64 trig."""
    exponents = np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / np.float32(dim)
    inv_freq = (np.float32(1.0) / np.float32(theta) ** exponents).astype(np.float32)
    angles = (np.arange(end, dtype=np.float32)[:, None] * inv_freq[None, :]).astype(
        np.float32
    )
    table = np.stack(
        [np.cos(angles.astype(np.float64)), np.sin(angles.astype(np.float64))],
        axis=-1,
    ).astype(np.float32)
    return torch.from_numpy(table).to(device)


def apply_rotary_emb(
    x: torch.Tensor,
    freqs_cis: torch.Tensor,
    position_ids: torch.Tensor,
    rot_dim: int = 32,
) -> torch.Tensor:
    """Rotate the leading `rot_dim` channels of each head.
    x: (B, H, T, head_dim); position_ids: (T,) shared across the batch, or
    (B, T) per row (the serving pool's ragged decode). Returns a new
    contiguous tensor of x's shape and dtype."""
    if rot_dim != freqs_cis.shape[-2] * 2:
        raise ValueError(f"rot_dim {rot_dim} does not match the table")
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    half = rot_dim // 2
    xr = x_rot[..., :half].float()
    xi = x_rot[..., half:].float()
    if position_ids.dim() == 2:
        position_ids = position_ids[:, None]  # (B, 1, T): broadcast over H
    cos = freqs_cis[position_ids, :, 0]  # (..., T, half)
    sin = freqs_cis[position_ids, :, 1]
    out_r = xr * cos - xi * sin
    out_i = xr * sin + xi * cos
    rotated = torch.stack([out_r, out_i], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)
