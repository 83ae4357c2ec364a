"""Region (grounding) heads: Fourier-feature coordinate and size codecs
(moondream_tpu/models/region.py).

A coordinate is one normalised float, encoded through sin/cos Fourier
features into a text-width embedding; the decoders map a hidden state to
1024-bin logits (linear bins for coordinates, log2-scale bins for sizes:
bin = (log2(size) + 10) / 10 * 1023). These are plain linears and MLPs,
which the JAX package also computes outside any Pallas kernel.

Weights keep the JAX layouts: Fourier matrices (d_in, n_freq), linears
(in, out).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..config import RegionConfig
from ..ops.layers import MLP, Linear

SpatialRefs = List[Union[Tuple[float, float], Tuple[float, float, float, float]]]


class RegionModel(nn.Module):
    def __init__(self, config: RegionConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d, inner = config.dim, config.inner_dim
        self.coord_features = nn.Parameter(
            torch.empty(1, config.coord_feat_dim // 2, **kw), requires_grad=False
        )
        self.coord_encoder = Linear(config.coord_feat_dim, d, device, dtype)
        self.coord_decoder = MLP(d, inner, config.coord_out_dim, device, dtype)
        self.size_features = nn.Parameter(
            torch.empty(2, config.size_feat_dim // 2, **kw), requires_grad=False
        )
        self.size_encoder = Linear(config.size_feat_dim, d, device, dtype)
        self.size_decoder = MLP(d, inner, config.size_out_dim, device, dtype)


def fourier_features(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ freqs (d_in, n_freq) -> (..., 2 n_freq) cos/sin
    features; the product and the trig in fp32, the result in x's dtype."""
    f = 2 * math.pi * (x.float() @ freqs.float())
    return torch.cat([torch.cos(f), torch.sin(f)], dim=-1).to(x.dtype)


def encode_coordinate(coord: torch.Tensor, region: RegionModel) -> torch.Tensor:
    """(..., 1) coordinates -> (..., dim) embeddings."""
    return region.coord_encoder(fourier_features(coord, region.coord_features))


def decode_coordinate(hidden: torch.Tensor, region: RegionModel) -> torch.Tensor:
    """(..., dim) -> (..., 1024) coordinate-bin logits."""
    return region.coord_decoder(hidden)


def encode_size(size: torch.Tensor, region: RegionModel) -> torch.Tensor:
    """(..., 2) (w, h) -> (..., dim) embeddings."""
    return region.size_encoder(fourier_features(size, region.size_features))


def decode_size(hidden: torch.Tensor, region: RegionModel) -> torch.Tensor:
    """(..., dim) -> (..., 2, 1024) log-scale size-bin logits (w, h)."""
    out = region.size_decoder(hidden)
    return out.reshape(*out.shape[:-1], 2, -1)


def coordinate_value(logits: torch.Tensor) -> torch.Tensor:
    """The greedy coordinate of bin logits (..., n_bins): argmax / n_bins in
    fp32."""
    return torch.argmax(logits, dim=-1).float() / logits.shape[-1]


def size_bin_to_value(bin_idx: torch.Tensor) -> torch.Tensor:
    """Inverse of the log-scale size binning: 2^((bin / 1023) * 10 - 10),
    fp32."""
    return torch.exp2((bin_idx.float() / 1023.0) * 10.0 - 10.0)


def encode_spatial_refs(
    spatial_refs: SpatialRefs, region: RegionModel
) -> Dict[str, Optional[torch.Tensor]]:
    """Prompt-side points and boxes as embeddings: a point gives two
    coordinate embeddings, a box its centre's two and one size embedding.
    Returns {"coords": (N, dim), "sizes": (M, dim) or None}."""
    coords, sizes = [], []
    for ref in spatial_refs:
        if len(ref) == 2:
            coords.extend([ref[0], ref[1]])
        else:
            coords.extend([(ref[0] + ref[2]) / 2, (ref[1] + ref[3]) / 2])
            sizes.append([ref[2] - ref[0], ref[3] - ref[1]])
    w = region.coord_features
    # Python floats rounded once, straight to the weights' dtype
    as_t = lambda v: torch.tensor(v, dtype=torch.float64).to(w.dtype).to(w.device)
    out = {"coords": encode_coordinate(as_t(coords).reshape(-1, 1), region), "sizes": None}
    if sizes:
        out["sizes"] = encode_size(as_t(sizes), region)
    return out
