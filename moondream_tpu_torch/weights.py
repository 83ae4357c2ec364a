"""Parameters of the port: `params_from_jax` maps the JAX package's parameter
pytree onto the port's modules, and `init_params` makes seeded random
weights of any configuration directly on the device.

The port's parameters are an `nn.ModuleDict` with "vision"
(`models.vision.VisionModel`) and "text" (`models.text.TextModel`).
Linear weights keep the JAX (in, out) layout; the JAX package stacks block
weights on a leading layer axis, which maps to one module per block here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .config import MoondreamConfig
from .models.text import TextModel
from .models.vision import VisionModel
from .ops.layers import MLP, LayerNorm, Linear


def build_params(config: MoondreamConfig, device=None, dtype=torch.bfloat16) -> nn.ModuleDict:
    """Uninitialised parameters of the caption path."""
    return nn.ModuleDict({
        "vision": VisionModel(config.vision, device, dtype),
        "text": TextModel(config.text, device, dtype),
    })


@torch.no_grad()
def init_params(
    config: MoondreamConfig, generator: torch.Generator, device=None,
    dtype=torch.bfloat16,
) -> nn.ModuleDict:
    """Random weights drawn on `device` from `generator` (which must live on
    that device), with the JAX package's init scales: linear weights
    N(0, 1/fan_in), zero biases, unit LayerNorms, embeddings N(0, 0.02^2).
    Nothing passes through host memory."""
    params = build_params(config, device, dtype)
    for m in params.modules():
        if isinstance(m, Linear):
            m.w.normal_(0.0, m.w.shape[0] ** -0.5, generator=generator)
            m.b.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    params["vision"].pos_emb.normal_(0.0, 0.02, generator=generator)
    params["text"].wte.normal_(0.0, 0.02, generator=generator)
    return params


def _put(dst: torch.Tensor, src) -> None:
    arr = np.array(src, dtype=np.float32)
    if arr.shape != tuple(dst.shape):
        raise ValueError(f"shape {arr.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr))


def _pick(a, layer):
    """Layer `layer` of a stacked JAX leaf, or the whole leaf for None."""
    return a if layer is None else np.asarray(a)[layer]


def _put_linear(lin: Linear, tree: dict, layer=None) -> None:
    _put(lin.w, _pick(tree["w"], layer))
    _put(lin.b, _pick(tree["b"], layer))


def _put_ln(ln: LayerNorm, tree: dict, layer=None) -> None:
    _put(ln.weight, _pick(tree["weight"], layer))
    _put(ln.bias, _pick(tree["bias"], layer))


def _put_mlp(m: MLP, tree: dict, layer=None) -> None:
    _put_linear(m.fc1, tree["fc1"], layer)
    _put_linear(m.fc2, tree["fc2"], layer)


@torch.no_grad()
def params_from_jax(
    tree: dict, config: MoondreamConfig, device=None, dtype=torch.float32
) -> nn.ModuleDict:
    """The JAX pytree {"vision": init_vision_params(...), "text":
    init_text_params(...)} (leaves as numpy or jax arrays, dense weights)
    as the port's modules."""
    params = build_params(config, device, dtype)
    vt, vis = tree["vision"], params["vision"]
    _put_linear(vis.patch_emb, vt["patch_emb"])
    _put(vis.pos_emb, vt["pos_emb"])
    for i, blk in enumerate(vis.blocks):
        b = vt["blocks"]
        _put_ln(blk.ln1, b["ln1"], i)
        _put_linear(blk.qkv, b["attn"]["qkv"], i)
        _put_linear(blk.proj, b["attn"]["proj"], i)
        _put_ln(blk.ln2, b["ln2"], i)
        _put_mlp(blk.mlp, b["mlp"], i)
    _put_ln(vis.post_ln, vt["post_ln"])
    _put_mlp(vis.proj_mlp, vt["proj_mlp"])

    tt, txt = tree["text"], params["text"]
    _put(txt.wte, tt["wte"])
    for i, blk in enumerate(txt.blocks):
        b = tt["blocks"]
        _put_ln(blk.ln, b["ln"], i)
        _put_linear(blk.qkv, b["attn"]["qkv"], i)
        _put_linear(blk.proj, b["attn"]["proj"], i)
        _put_mlp(blk.mlp, b["mlp"], i)
    _put_ln(txt.post_ln, tt["post_ln"])
    _put_linear(txt.lm_head, tt["lm_head"])
    return params
