"""SigLIP-style vision encoder and projection (moondream_tpu/models/vision.py).

Linear patch embedding, learned position embeddings, `enc_n_layers` pre-LN
blocks with fused-QKV bidirectional attention and a tanh-GELU MLP, a final
LN, then a projection that mean-pools the stitched local features to the
27x27 grid, concatenates them with the global crop's features and maps to
the text width through a 2-layer MLP.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..config import VisionConfig
from ..ops.layers import MLP, LayerNorm, Linear, attn_core


class VisionBlock(nn.Module):
    def __init__(self, config: VisionConfig, device=None, dtype=None):
        super().__init__()
        d = config.enc_dim
        self.ln1 = LayerNorm(d, device, dtype)
        self.qkv = Linear(d, 3 * d, device, dtype)
        self.proj = Linear(d, d, device, dtype)
        self.ln2 = LayerNorm(d, device, dtype)
        self.mlp = MLP(d, config.enc_ff_dim, d, device, dtype)
        self.n_heads = config.enc_n_heads

    def forward(self, h: torch.Tensor, n_real: int) -> torch.Tensor:
        core = attn_core(self.ln1(h), self.qkv, self.n_heads, n_real=n_real)
        h = h + self.proj(core)
        return h + self.mlp(self.ln2(h))


class VisionModel(nn.Module):
    def __init__(self, config: VisionConfig, device=None, dtype=None):
        super().__init__()
        d = config.enc_dim
        self.config = config
        self.patch_emb = Linear(config.patch_dim, d, device, dtype)
        self.pos_emb = nn.Parameter(
            torch.empty(1, config.num_patches, d, device=device, dtype=dtype),
            requires_grad=False,
        )
        self.blocks = nn.ModuleList(
            VisionBlock(config, device, dtype) for _ in range(config.enc_n_layers)
        )
        self.post_ln = LayerNorm(d, device, dtype)
        self.proj_mlp = MLP(
            2 * d, config.proj_inner_dim, config.proj_out_dim, device, dtype
        )


def create_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, n_patches, C*P*P) in the reference's (C, P, P)
    per-patch order."""
    b, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def vision_encoder(crops_bhwc: torch.Tensor, model: VisionModel) -> torch.Tensor:
    """(B, 378, 378, 3) crops in [-1, 1] -> (B, 729, enc_dim)."""
    x = model.patch_emb(create_patches(crops_bhwc, model.config.enc_patch_size))
    x = x + model.pos_emb
    # Pad the tokens once to the 128 grid (729 -> 768) and slice once at the
    # end. Padding rows never reach real ones: real rows attend only
    # columns < n_real, and every other op is per token.
    n_real = x.shape[1]
    t_pad = -(-n_real // 128) * 128
    x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - n_real))
    for block in model.blocks:
        x = block(x, n_real)
    return model.post_ln(x[:, :n_real])


@lru_cache(maxsize=8)
def _pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic matrix with the bin edges of
    torch's adaptive_avg_pool2d: bin i averages rows
    [floor(i*n/out), ceil((i+1)*n/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def adaptive_avg_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C) adaptive mean pool as two
    fp32 matrix products."""
    ph = torch.from_numpy(_pool_matrix(int(x.shape[-3]), out_hw[0])).to(x.device)
    pw = torch.from_numpy(_pool_matrix(int(x.shape[-2]), out_hw[1])).to(x.device)
    pooled = torch.einsum("oh,...hwc->...owc", ph, x.float())
    pooled = torch.einsum("pw,...owc->...opc", pw, pooled)
    return pooled.to(x.dtype)


def vision_projection(
    global_features: torch.Tensor, reconstructed: torch.Tensor, model: VisionModel
) -> torch.Tensor:
    """global_features (..., 729, enc_dim), reconstructed (..., H, W,
    enc_dim) -> (..., 729, proj_out_dim); leading axes are images."""
    cfg = model.config
    g = cfg.grid_size
    pooled = adaptive_avg_pool2d(reconstructed, (g, g)).reshape(
        *reconstructed.shape[:-3], g * g, cfg.enc_dim
    )
    return model.proj_mlp(torch.cat([global_features, pooled], dim=-1))
