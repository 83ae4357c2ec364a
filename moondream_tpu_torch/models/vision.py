"""SigLIP-style vision encoder and projection (moondream_tpu/models/vision.py).

Linear patch embedding, learned position embeddings, `enc_n_layers` pre-LN
blocks with fused-QKV bidirectional attention and a tanh-GELU MLP, a final
LN, then a projection that mean-pools the stitched local features to the
27x27 grid, concatenates them with the global crop's features and maps to
the text width through a 2-layer MLP.

The int8 ViT formats (moondream_tpu/models/vision.py:75-242):
`quantize_vision_params` swaps each block's qkv, proj, fc1 and fc2 for
`ops.layers.Int8Linear`s, with activations quantized per row at run time,
or, given the activation statistics of `collect_vision_act_stats`, with
static SmoothQuant-equalised activation scales.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import VisionConfig
from ..ops.layers import MLP, Int8Linear, LayerNorm, Linear, attn_core, gelu_approx
from ..ops.tables import on_device

# the block linears that the int8 formats quantize, by their input
QUANTIZED = ("qkv", "proj", "fc1", "fc2")


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

    def forward(self, h: torch.Tensor, n_real: int, capture: bool = False):
        """One pre-LN block. With `capture`, returns (h, stats): the
        per-channel amax (fp32) of the inputs of qkv, proj, fc1 and fc2
        over the real tokens [:n_real] of every crop, as the JAX package's
        `_encoder_block(..., capture=True)` (moondream_tpu/models/vision.py:
        75-91)."""
        a_qkv = self.ln1(h)
        core = attn_core(a_qkv, self.qkv, self.n_heads, n_real=n_real)
        h = h + self.proj(core)
        a_fc1 = self.ln2(h)
        hid = gelu_approx(self.mlp.fc1(a_fc1))
        h = h + self.mlp.fc2(hid)
        if not capture:
            return h
        amax = lambda t: t[:, :n_real].float().abs().amax(dim=(0, 1))
        return h, {"qkv": amax(a_qkv), "proj": amax(core), "fc1": amax(a_fc1),
                   "fc2": amax(hid)}


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


def _embed(crops_bhwc: torch.Tensor, model: VisionModel):
    """Patch and position embeddings, the tokens padded once to the 128
    grid (729 -> 768); returns (x, n_real). Padding rows never reach real
    ones: real rows attend only columns < n_real, and every other op is
    per token."""
    x = model.patch_emb(create_patches(crops_bhwc, model.config.enc_patch_size))
    x = x + model.pos_emb
    n_real = x.shape[1]
    t_pad = -(-n_real // 128) * 128
    return torch.nn.functional.pad(x, (0, 0, 0, t_pad - n_real)), n_real


def normalize_crops(crops: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 crops (..., 378, 378, 3) -> `dtype` in [-1, 1], as the runtime
    feeds the encoder (and as static int8 calibration must see them)."""
    x = crops.to(dtype) / 255.0
    return (x - 0.5) / 0.5


def vision_encoder(crops_bhwc: torch.Tensor, model: VisionModel) -> torch.Tensor:
    """(B, 378, 378, 3) crops in [-1, 1] -> (B, 729, enc_dim)."""
    x, n_real = _embed(crops_bhwc, model)
    for block in model.blocks:
        x = block(x, n_real)
    return model.post_ln(x[:, :n_real])


@torch.no_grad()
def collect_vision_act_stats(
    crops_bhwc: torch.Tensor, model: VisionModel, chunk: int = 16
) -> Dict[str, torch.Tensor]:
    """Per-layer, per-input-channel amax of the inputs of the ViT blocks'
    qkv, proj, fc1 and fc2, observed by running the encoder, as it is, over
    calibration crops on the model's device (moondream_tpu/models/vision.py:
    94-173). The crops must be NORMALIZED to [-1, 1] (`normalize_crops`,
    what the runtime feeds the encoder), not raw 0-255 pixels. Chunks of `chunk`
    crops, merged by max; when there are more than `chunk` crops the ragged
    tail past the last whole chunk is dropped, as JAX's one compiled chunk
    shape drops it. Returns {"qkv" | "proj" | "fc1" | "fc2": fp32
    (n_layers, in_dim)}, for `quantize_vision_params(act_stats=...)`."""
    dev = model.post_ln.weight.device
    crops = crops_bhwc.to(dev, model.post_ln.weight.dtype)
    n = crops.shape[0]
    if n > chunk:
        n = (n // chunk) * chunk
    merged = None
    for i in range(0, n, chunk):
        x, n_real = _embed(crops[i:i + chunk], model)
        layers = []
        for block in model.blocks:
            x, st = block(x, n_real, capture=True)
            layers.append(st)
        stats = {k: torch.stack([st[k] for st in layers]) for k in QUANTIZED}
        merged = stats if merged is None else {
            k: torch.maximum(merged[k], v) for k, v in stats.items()}
    return merged


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median of a row: the mean of the two middle values of an even
    row, as (lo + hi) * 0.5 in fp32 (torch.median returns the lower)."""
    srt = x.sort().values
    n = x.shape[0]
    lo, hi = srt[(n - 1) // 2], srt[n // 2]
    return (lo + hi) * 0.5


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device (CUDA turns a division by
    a host scalar into a product with its reciprocal)."""
    return t / torch.full_like(t, 127.0)


@torch.no_grad()
def _quantize_vision_linear(
    lin: Linear, amax_in: Optional[torch.Tensor], alpha: float
) -> Int8Linear:
    """One block linear in the JAX package's int8 ViT format (eager there,
    so divisions are true divisions): per-output-channel codes; with
    `amax_in` (K,), the SmoothQuant equaliser c = clip(amax_in^alpha /
    w_amax^(1 - alpha), 1e-3, 1e3) / median(c), the per-tensor activation
    scale a = max(amax_in / c) / 127, scale = s * a and inv_a = 1 / (c * a)
    (moondream_tpu/models/vision.py:203-227)."""
    wt = lin.w.float()  # (K, N)
    if amax_in is None:
        s = _div127(wt.abs().amax(dim=0)).clamp_min(1e-8)
        return Int8Linear(torch.round(wt / s).to(torch.int8), s, lin.b)
    amax_in = amax_in.to(wt.device, torch.float32).clamp_min(1e-6)
    w_amax = wt.abs().amax(dim=1).clamp_min(1e-6)  # (K,)
    # the powers in float64, rounded once: the same bits on the CPU and the
    # card (XLA's fp32 pow is not correctly rounded, so c may differ from
    # JAX's by an ulp; tests/test_torch_int8.py counts what that changes)
    pw = lambda t, e: t.double().pow(e).float()
    c = (pw(amax_in, alpha) / pw(w_amax, 1.0 - alpha)).clamp(1e-3, 1e3)
    c = c / _median(c)
    wt_eq = wt * c[:, None]
    s = _div127(wt_eq.abs().amax(dim=0)).clamp_min(1e-8)  # (N,)
    codes = torch.round(wt_eq / s).to(torch.int8)
    a = _div127((amax_in / c).amax())
    return Int8Linear(codes, s * a, lin.b, torch.reciprocal(c * a))


@torch.no_grad()
def quantize_vision_params(
    model: VisionModel, act_stats: Optional[Dict[str, torch.Tensor]] = None,
    alpha: float = 0.5,
) -> VisionModel:
    """Convert every block's qkv, proj, fc1 and fc2 to int8 in place, on
    their device, with the JAX package's codes (moondream_tpu/models/
    vision.py:176-242); returns the model. LayerNorms, biases, the patch
    and position embeddings and the projection MLP stay as they are.

    Without `act_stats` the activations are quantized dynamically per row
    at run time. With `act_stats` from `collect_vision_act_stats` (which
    must have seen NORMALIZED crops in [-1, 1], as the runtime feeds them)
    the activation codes are static: each linear's `inv_a` folds the
    SmoothQuant equaliser and the per-tensor activation scale, and its
    `scale` the output rescale, so no activation reduction runs."""
    for i, blk in enumerate(model.blocks):
        st = (lambda key: None) if act_stats is None else (
            lambda key: torch.as_tensor(act_stats[key][i]))
        blk.qkv = _quantize_vision_linear(blk.qkv, st("qkv"), alpha)
        blk.proj = _quantize_vision_linear(blk.proj, st("proj"), alpha)
        blk.mlp.fc1 = _quantize_vision_linear(blk.mlp.fc1, st("fc1"), alpha)
        blk.mlp.fc2 = _quantize_vision_linear(blk.mlp.fc2, st("fc2"), alpha)
    return model


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
    sizes = (int(x.shape[-3]), out_hw[0], int(x.shape[-2]), out_hw[1])
    ph, pw = on_device(("pool", *sizes), lambda: (torch.from_numpy(_pool_matrix(*sizes[:2])),
                                                  torch.from_numpy(_pool_matrix(*sizes[2:]))),
                       x.device)
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
