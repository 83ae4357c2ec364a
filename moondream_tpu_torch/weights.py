"""Parameters of the port: `params_from_jax` maps the JAX package's parameter
pytree (dense, with int4 or int8 text blocks, with int8 ViT blocks) onto
the port's modules and `params_to_jax` carries dense modules back into that
pytree (finetuning saves through it), `load_params` reads a safetensors or
torch checkpoint, and `init_params` makes seeded random weights of any
configuration directly on the device.

The port's parameters are an `nn.ModuleDict` with "vision"
(`models.vision.VisionModel`), "text" (`models.text.TextModel`) and
"region" (`models.region.RegionModel`, absent where a JAX tree or a
checkpoint has no region weights). Linear weights keep the JAX (in, out)
layout; the JAX package stacks block weights on a leading layer axis, which
maps to one module per block here.

The checkpoint loader is the JAX package's (moondream_tpu/weights.py:45-346):
both naming schemes, `model.`/`._orig_mod` prefixes, and the reference's
int4 group-128 checkpoints, dequantized at load time. Region weights stay
dense under runtime_int4 and runtime_int8.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .config import MoondreamConfig
from .models.region import RegionModel
from .models.text import (
    Int4Linear,
    TextModel,
    quantize_text_params,
    quantize_text_params_int8,
)
from .models.vision import VisionModel
from .ops.layers import MLP, Int8Linear, LayerNorm, Linear


def checked_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device when there is no
    card: the port's entry points run on the card unless the caller asks
    for the CPU, and never fall back to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            'device="cpu" to run its plain versions on the CPU'
        )
    return dev


def build_params(
    config: MoondreamConfig, device=None, dtype=torch.bfloat16, region: bool = True
) -> nn.ModuleDict:
    """Uninitialised parameters: vision, text and (with `region`) the region
    heads."""
    params = nn.ModuleDict({
        "vision": VisionModel(config.vision, device, dtype),
        "text": TextModel(config.text, device, dtype),
    })
    if region:
        params["region"] = RegionModel(config.region, device, dtype)
    return params


def _init_dense(root: nn.Module, generator: torch.Generator) -> None:
    for m in root.modules():
        if isinstance(m, Linear):
            m.w.normal_(0.0, m.w.shape[0] ** -0.5, generator=generator)
            m.b.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


@torch.no_grad()
def init_params(
    config: MoondreamConfig, generator: torch.Generator, device=None,
    dtype=torch.bfloat16,
) -> nn.ModuleDict:
    """Random weights drawn on `device` from `generator` (which must live on
    that device), with the JAX package's init scales: linear weights
    N(0, 1/fan_in), zero biases, unit LayerNorms, embeddings N(0, 0.02^2).
    Fourier matrices N(0, 10^2). The region heads are drawn last. Nothing
    passes through host memory."""
    params = build_params(config, device, dtype, region=False)
    _init_dense(params, generator)
    params["vision"].pos_emb.normal_(0.0, 0.02, generator=generator)
    params["text"].wte.normal_(0.0, 0.02, generator=generator)
    region = RegionModel(config.region, device, dtype)
    _init_dense(region, generator)
    region.coord_features.normal_(0.0, 10.0, generator=generator)
    region.size_features.normal_(0.0, 10.0, generator=generator)
    params["region"] = region
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


def _int4_linear(qw: dict, bias, layer: int, device, dtype) -> Int4Linear:
    """Layer `layer` of a stacked JAX int4 tree {packed, scale, zero}, the
    packed bytes carried over as they are."""
    part = lambda name, dt: torch.from_numpy(
        np.array(np.asarray(qw[name])[layer], dtype=dt)
    ).to(device)
    b = torch.from_numpy(np.array(np.asarray(bias)[layer], dtype=np.float32))
    return Int4Linear(
        part("packed", np.uint8), part("scale", np.float32),
        part("zero", np.float32), b.to(device, dtype),
    )


def _int8_linear(tree: dict, layer: int, device, dtype) -> Int8Linear:
    """Layer `layer` of a stacked JAX int8 tree {wq (L, K, N), scale (L, 1,
    N), b[, inv_a (L, 1, K)]}, the codes carried over as they are."""
    part = lambda name, dt: torch.from_numpy(
        np.array(np.asarray(tree[name])[layer], dtype=dt)
    ).to(device)
    inv_a = part("inv_a", np.float32) if "inv_a" in tree else None
    return Int8Linear(part("wq", np.int8), part("scale", np.float32),
                      part("b", np.float32).to(dtype), inv_a)


@torch.no_grad()
def params_from_jax(
    tree: dict, config: MoondreamConfig, device=None, dtype=torch.float32
) -> nn.ModuleDict:
    """The JAX pytree {"vision": init_vision_params(...), "text":
    init_text_params(...), "region": init_region_params(...)} (leaves as
    numpy or jax arrays) as the port's modules; a tree whose "region" is
    missing or None gives no region heads. A text tree from the JAX
    `quantize_text_params` (stacked `blocks_q` {packed, scale, zero},
    biases in `blocks`) gives int4 blocks with the same codes; one from
    `quantize_text_params_int8` (`blocks` linears {wq, scale, b}) int8
    blocks. A vision tree from `quantize_vision_params` (`blocks_q` with
    ln1 / ln2 and {wq, scale, b[, inv_a]} linears, no `blocks`) gives
    int8 ViT blocks, dynamic or static, with the same codes."""
    rt = tree.get("region")
    params = build_params(config, device, dtype, region=rt is not None)
    vt, vis = tree["vision"], params["vision"]
    _put_linear(vis.patch_emb, vt["patch_emb"])
    _put(vis.pos_emb, vt["pos_emb"])
    vq = vt.get("blocks_q")
    for i, blk in enumerate(vis.blocks):
        b = vq if vq is not None else vt["blocks"]
        _put_ln(blk.ln1, b["ln1"], i)
        _put_ln(blk.ln2, b["ln2"], i)
        if vq is None:
            _put_linear(blk.qkv, b["attn"]["qkv"], i)
            _put_linear(blk.proj, b["attn"]["proj"], i)
            _put_mlp(blk.mlp, b["mlp"], i)
            continue
        q = lambda mod, name: _int8_linear(b[mod][name], i, device, dtype)
        blk.qkv, blk.proj = q("attn", "qkv"), q("attn", "proj")
        blk.mlp.fc1, blk.mlp.fc2 = q("mlp", "fc1"), q("mlp", "fc2")
    _put_ln(vis.post_ln, vt["post_ln"])
    _put_mlp(vis.proj_mlp, vt["proj_mlp"])

    tt, txt = tree["text"], params["text"]
    _put(txt.wte, tt["wte"])
    bq = tt.get("blocks_q")
    for i, blk in enumerate(txt.blocks):
        b = tt["blocks"]
        _put_ln(blk.ln, b["ln"], i)
        if bq is None and "wq" in b["attn"]["qkv"]:
            q = lambda mod, name: _int8_linear(b[mod][name], i, device, dtype)
        elif bq is None:
            _put_linear(blk.qkv, b["attn"]["qkv"], i)
            _put_linear(blk.proj, b["attn"]["proj"], i)
            _put_mlp(blk.mlp, b["mlp"], i)
            continue
        else:
            q = lambda mod, name: _int4_linear(
                bq[mod][name], b[mod][name]["b"], i, device, dtype
            )
        blk.qkv, blk.proj = q("attn", "qkv"), q("attn", "proj")
        blk.mlp.fc1, blk.mlp.fc2 = q("mlp", "fc1"), q("mlp", "fc2")
    _put_ln(txt.post_ln, tt["post_ln"])
    _put_linear(txt.lm_head, tt["lm_head"])
    if rt is not None:
        reg = params["region"]
        _put(reg.coord_features, rt["coord_features"])
        _put_linear(reg.coord_encoder, rt["coord_encoder"])
        _put_mlp(reg.coord_decoder, rt["coord_decoder"])
        _put(reg.size_features, rt["size_features"])
        _put_linear(reg.size_encoder, rt["size_encoder"])
        _put_mlp(reg.size_decoder, rt["size_decoder"])
    return params


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _lin_tree(lin: Linear) -> dict:
    return {"w": _np32(lin.w), "b": _np32(lin.b)}


def _ln_tree(ln: LayerNorm) -> dict:
    return {"weight": _np32(ln.weight), "bias": _np32(ln.bias)}


def _mlp_tree(m: MLP) -> dict:
    return {"fc1": _lin_tree(m.fc1), "fc2": _lin_tree(m.fc2)}


def _stack_trees(trees: list):
    """Per-layer trees -> one tree whose leaves stack on a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_jax(params: nn.ModuleDict) -> dict:
    """The port's dense modules as the JAX package's parameter pytree, the
    inverse of params_from_jax: {"vision", "text", "region"} (region only
    where the parameters have region heads), block leaves stacked on a
    leading layer axis, linears (in, out), the text tree's `freqs_cis`
    included; every leaf fp32 numpy. Raises ValueError for int4 or int8
    blocks, which have no dense weights to carry back."""
    vis, txt = params["vision"], params["text"]
    if not all(type(b.qkv) is Linear for b in [*vis.blocks, *txt.blocks]):
        raise ValueError("params_to_jax takes dense parameters, not int4 / int8 blocks")
    tree = {
        "vision": {
            "patch_emb": _lin_tree(vis.patch_emb),
            "pos_emb": _np32(vis.pos_emb),
            "blocks": _stack_trees([{
                "ln1": _ln_tree(b.ln1),
                "attn": {"qkv": _lin_tree(b.qkv), "proj": _lin_tree(b.proj)},
                "ln2": _ln_tree(b.ln2),
                "mlp": _mlp_tree(b.mlp),
            } for b in vis.blocks]),
            "post_ln": _ln_tree(vis.post_ln),
            "proj_mlp": _mlp_tree(vis.proj_mlp),
        },
        "text": {
            "wte": _np32(txt.wte),
            "blocks": _stack_trees([{
                "ln": _ln_tree(b.ln),
                "attn": {"qkv": _lin_tree(b.qkv), "proj": _lin_tree(b.proj)},
                "mlp": _mlp_tree(b.mlp),
            } for b in txt.blocks]),
            "post_ln": _ln_tree(txt.post_ln),
            "lm_head": _lin_tree(txt.lm_head),
            "freqs_cis": _np32(txt.freqs_cis),
        },
    }
    if "region" in params:
        reg = params["region"]
        tree["region"] = {
            "coord_features": _np32(reg.coord_features),
            "coord_encoder": _lin_tree(reg.coord_encoder),
            "coord_decoder": _mlp_tree(reg.coord_decoder),
            "size_features": _np32(reg.size_features),
            "size_encoder": _lin_tree(reg.size_encoder),
            "size_decoder": _mlp_tree(reg.size_decoder),
        }
    return tree


# ------------------------------------------------------------- checkpoints


def lora_from_jax(tree: dict, device=None, dtype=torch.float32) -> dict:
    """A JAX stacked adapter tree (`moondream_tpu.lora.variant_state_dict`'s
    layout; leaves numpy or jax arrays) as the port's: the same nesting,
    each leaf a tensor of `dtype` on `device` (through fp32, so a bf16 leaf
    keeps its value). Groups or sites that are absent stay absent."""
    return {grp: {name: {f: torch.from_numpy(np.array(pair[f], dtype=np.float32))
                         .to(device=device, dtype=dtype) for f in ("A", "B")}
                  for name, pair in sites.items()}
            for grp, sites in tree.items()}


def lora_to_jax(lora: dict) -> dict:
    """The inverse of lora_from_jax: every leaf as fp32 numpy."""
    return {grp: {name: {f: _np32(pair[f]) for f in ("A", "B")}
                  for name, pair in sites.items()}
            for grp, sites in lora.items()}


def dequantize_int4(
    packed: np.ndarray, scale: np.ndarray, zero_point: np.ndarray, out_shape
) -> np.ndarray:
    """Unpack the reference's int4 group-128 checkpoint format: packed
    (N/256, 128) uint8, high nibbles the first half of each 256-element
    strip, low nibbles the second; scale/zero_point (N/128, 1). Returns
    fp32 (moondream_tpu/weights.py:45-59). Not the runtime packing of
    `ops.quant`."""
    step = packed.shape[0]
    w = np.empty((2 * step, packed.shape[1]), dtype=np.float32)
    w[:step] = (packed >> 4).astype(np.float32)
    w[step:] = (packed & 0x0F).astype(np.float32)
    w = (w - zero_point.astype(np.float32)) * scale.astype(np.float32)
    return w.reshape(out_shape)


_LEGACY_VISION = "vision_encoder.encoder.model.visual"


def _legacy_to_new(key: str) -> Optional[str]:
    """A legacy checkpoint key in new-scheme naming, or None
    (moondream_tpu/weights.py:65-109)."""
    k = key
    if k.startswith(_LEGACY_VISION):
        k = k[len(_LEGACY_VISION) + 1 :]
        if k.startswith("patch_embed.linear."):
            return "vision.patch_emb." + k.split(".")[-1]
        if k == "pos_embed":
            return "vision.pos_emb"
        if k.startswith("norm."):
            return "vision.post_ln." + k.split(".")[-1]
        m = re.match(r"blocks\.(\d+)\.(.*)", k)
        if m:
            rest = m.group(2).replace("norm1.", "ln1.").replace("norm2.", "ln2.")
            return f"vision.blocks.{m.group(1)}.{rest}"
        return None
    if key.startswith("vision_encoder.projection.mlp."):
        return "vision.proj_mlp." + key[len("vision_encoder.projection.mlp.") :]
    if key == "text_model.transformer.embd.wte.weight":
        return "text.wte"
    if key.startswith("text_model.lm_head.ln."):
        return "text.post_ln." + key.split(".")[-1]
    if key.startswith("text_model.lm_head.linear."):
        return "text.lm_head." + key.split(".")[-1]
    m = re.match(r"text_model\.transformer\.h\.(\d+)\.(.*)", key)
    if m:
        rest = (
            m.group(2).replace("mixer.Wqkv", "attn.qkv")
            .replace("mixer.out_proj", "attn.proj")
            .replace("mixer", "attn")
        )
        return f"text.blocks.{m.group(1)}.{rest}"
    if key.startswith("region_model."):
        rest = key[len("region_model.") :]
        rest = rest.replace("coordinate_encoder", "coord_encoder").replace(
            "coordinate_decoder", "coord_decoder"
        ).replace("coordinate_features", "coord_features")
        return "region." + rest
    return None


def _normalize_keys(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip model./._orig_mod and map legacy names to the new scheme."""
    any_new = any(
        k.replace("model.", "", 1).startswith(("vision.blocks", "text.blocks"))
        for k in flat
    )
    out = {}
    for k, v in flat.items():
        k = k.replace("._orig_mod", "")
        if k.startswith("model."):
            k = k[len("model.") :]
        if not any_new:
            k = _legacy_to_new(k)
            if k is None:
                continue
        out[k] = v
    return out


def _dequantize_flat(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Replace {base}.weight.packed/scale/zero_point triples with a dense
    {base}.weight, its shape (bias length, rest) taken from the bias."""
    suffixes = (".weight.packed", ".weight.scale", ".weight.zero_point")
    bases = sorted(k[: -len(suffixes[0])] for k in flat if k.endswith(suffixes[0]))
    if not bases:
        return flat
    out = {k: v for k, v in flat.items() if not k.endswith(suffixes)}
    for base in bases:
        packed = flat[base + suffixes[0]]
        bias = flat.get(base + ".bias")
        if bias is None:
            raise ValueError(f"cannot infer dense shape for {base}")
        out_features = bias.shape[0]
        out[base + ".weight"] = dequantize_int4(
            packed, flat[base + suffixes[1]], flat[base + suffixes[2]],
            (out_features, packed.size * 2 // out_features),
        )
    return out


def _to_numpy(t) -> np.ndarray:
    """torch tensor (bf16 through fp32) or array -> numpy."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a .safetensors or torch .pt/.bin checkpoint as numpy."""
    if path.endswith(".safetensors"):
        # imported here: the card's machine need not have safetensors
        from safetensors.torch import load_file

        state = load_file(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _to_numpy(v) for k, v in state.items()}


def _put_ckpt_linear(lin: Linear, flat: dict, base: str) -> None:
    _put(lin.w, np.asarray(flat[base + ".weight"]).T)  # torch (out, in)
    _put(lin.b, flat[base + ".bias"])


def _put_ckpt_ln(ln: LayerNorm, flat: dict, base: str) -> None:
    _put(ln.weight, flat[base + ".weight"])
    _put(ln.bias, flat[base + ".bias"])


@torch.no_grad()
def params_from_flat(
    flat: Dict[str, np.ndarray], config: MoondreamConfig, device=None,
    dtype=torch.bfloat16,
) -> nn.ModuleDict:
    """The port's modules from a flat name -> array dict in either naming
    scheme, int4 checkpoint tensors dequantized; region heads when the dict
    has `region.*` tensors."""
    flat = _dequantize_flat(_normalize_keys(dict(flat)))
    has_region = any(k.startswith("region.") for k in flat)
    params = build_params(config, device, dtype, region=has_region)
    vis, txt = params["vision"], params["text"]
    _put_ckpt_linear(vis.patch_emb, flat, "vision.patch_emb")
    _put(vis.pos_emb, flat["vision.pos_emb"])
    for i, blk in enumerate(vis.blocks):
        p = f"vision.blocks.{i}"
        _put_ckpt_ln(blk.ln1, flat, f"{p}.ln1")
        _put_ckpt_linear(blk.qkv, flat, f"{p}.attn.qkv")
        _put_ckpt_linear(blk.proj, flat, f"{p}.attn.proj")
        _put_ckpt_ln(blk.ln2, flat, f"{p}.ln2")
        _put_ckpt_linear(blk.mlp.fc1, flat, f"{p}.mlp.fc1")
        _put_ckpt_linear(blk.mlp.fc2, flat, f"{p}.mlp.fc2")
    _put_ckpt_ln(vis.post_ln, flat, "vision.post_ln")
    _put_ckpt_linear(vis.proj_mlp.fc1, flat, "vision.proj_mlp.fc1")
    _put_ckpt_linear(vis.proj_mlp.fc2, flat, "vision.proj_mlp.fc2")

    _put(txt.wte, flat["text.wte"])
    for i, blk in enumerate(txt.blocks):
        p = f"text.blocks.{i}"
        _put_ckpt_ln(blk.ln, flat, f"{p}.ln")
        _put_ckpt_linear(blk.qkv, flat, f"{p}.attn.qkv")
        _put_ckpt_linear(blk.proj, flat, f"{p}.attn.proj")
        _put_ckpt_linear(blk.mlp.fc1, flat, f"{p}.mlp.fc1")
        _put_ckpt_linear(blk.mlp.fc2, flat, f"{p}.mlp.fc2")
    _put_ckpt_ln(txt.post_ln, flat, "text.post_ln")
    _put_ckpt_linear(txt.lm_head, flat, "text.lm_head")
    if has_region:
        _put_ckpt_region(params["region"], flat)
    return params


def _put_ckpt_region(reg: RegionModel, flat: dict) -> None:
    """Region tensors of a checkpoint (moondream_tpu/weights.py:233-266). A
    Fourier matrix is stored (n_freq, d_in), as `region.*_features` or
    `region.*_features.weight`, and used (d_in, n_freq)."""
    for name in ("coord", "size"):
        key = f"region.{name}_features"
        if key + ".weight" in flat:
            key += ".weight"
        arr = np.asarray(flat[key])
        if key.endswith(".weight") or arr.shape[0] > arr.shape[-1]:
            arr = arr.T
        _put(getattr(reg, f"{name}_features"), arr)
        _put_ckpt_linear(getattr(reg, f"{name}_encoder"), flat, f"region.{name}_encoder")
        dec = getattr(reg, f"{name}_decoder")
        _put_ckpt_linear(dec.fc1, flat, f"region.{name}_decoder.fc1")
        _put_ckpt_linear(dec.fc2, flat, f"region.{name}_decoder.fc2")


def load_params(
    path: str, config: MoondreamConfig, dtype=torch.bfloat16,
    runtime_int4: bool = False, device="cuda", runtime_int8: bool = False,
) -> nn.ModuleDict:
    """Load a checkpoint into the port's vision, text and region modules, in
    `dtype` on `device` (the card unless the caller asks for the CPU;
    raises without one). runtime_int4=True then quantizes the text blocks'
    qkv, proj, fc1 and fc2 from those `dtype` weights into the runtime int4
    format (`models.text.quantize_text_params`); runtime_int8=True into the
    int8 w8a8 format instead (`models.text.quantize_text_params_int8`:
    per-output-channel codes, activations quantized per row at run time),
    as the JAX package's `load_params` does with the same flags, which are
    exclusive (ValueError). An int4 checkpoint goes through the load-time
    dequant first. The int8 ViT formats are a step of their own:
    `models.vision.quantize_vision_params`, after an optional calibration
    (`collect_vision_act_stats`)."""
    if runtime_int4 and runtime_int8:
        raise ValueError("runtime_int4 and runtime_int8 are exclusive")
    device = checked_device(device)
    params = params_from_flat(load_flat(path), config, device, dtype)
    if runtime_int4:
        quantize_text_params(params["text"])
    elif runtime_int8:
        quantize_text_params_int8(params["text"])
    return params
