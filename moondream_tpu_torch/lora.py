"""LoRA "variant" adapters (moondream_tpu/lora.py): load an adapter file,
rename its keys from the training checkpoint's names, stack it per layer,
fold it into dense weights, and stack several for per-slot serving.

The stacked layout is the JAX package's:

    {"attn": {"qkv": {"A": (L, r, in), "B": (L, out, r)}, "proj": {...}},
     "mlp": {"fc1": {...}, "fc2": {...}}}

with A and B in torch's (out, in) layout, applied as (x @ A^T) @ B^T
(`ops.layers.lora_delta`) at every text forward's qkv, proj, fc1 and fc2
(`models.text.text_decoder(..., lora=)`).

Adapters come from local files only: an existing path, or a file already
in the Hugging Face cache under md_variants/<id>/final.pt. Where the JAX
package downloads a missing adapter from the Moondream endpoint, this
module raises FileNotFoundError.
"""

from __future__ import annotations

import copy
import functools
import os
from pathlib import Path
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .models.text import LORA_SITES, TextModel
from .ops.layers import Linear


def variant_cache_dir() -> Path:
    """Where cached adapters live: $HF_HUB_CACHE/md_variants, else
    $HF_HOME/hub/md_variants, else ~/.cache/huggingface/hub/md_variants
    (moondream_tpu/lora.py:27-34)."""
    hf_hub_cache = os.environ.get("HF_HUB_CACHE")
    if hf_hub_cache is not None:
        return Path(hf_hub_cache) / "md_variants"
    hf_home = os.environ.get("HF_HOME")
    if hf_home is not None:
        return Path(hf_home) / "hub" / "md_variants"
    return Path("~/.cache/huggingface/hub").expanduser() / "md_variants"


def cached_variant_path(variant_id: str) -> Path:
    """The local file of a variant: `variant_id` itself when it is an
    existing path, else the cached md_variants/<id>/final.pt. Raises
    FileNotFoundError otherwise: this package downloads nothing."""
    if os.path.exists(variant_id):
        return Path(variant_id)
    dest = variant_cache_dir() / variant_id / "final.pt"
    if dest.exists():
        return dest
    raise FileNotFoundError(
        f"LoRA variant {variant_id!r}: no such file, and no cached adapter at {dest}. "
        "moondream_tpu_torch loads adapters from local files only and downloads nothing: "
        "pass a path to the adapter's .pt file"
    )


# training checkpoint names -> the text model's (moondream_tpu/lora.py:63-69)
_RENAME_RULES = [
    ("text_model.transformer.h", "text.blocks"),
    (".mixer", ".attn"),
    (".out_proj", ".proj"),
    (".Wqkv", ".qkv"),
    (".parametrizations.weight.0", ""),
]


def _renamed(key: str) -> str:
    for old, new in _RENAME_RULES:
        key = key.replace(old, new)
    return key


@functools.lru_cache(maxsize=5)
def variant_state_dict(variant_id: Optional[str], n_layers: int, dtype: torch.dtype,
                       device) -> Optional[dict]:
    """Load a variant (`cached_variant_path`) as the stacked adapter tree,
    each factor rounded to `dtype` on `device` (moondream_tpu/lora.py:
    82-123); None for no variant. Cached per (id, layers, dtype, device):
    the same variant returns the same tensors, so the CUDA graphs keyed by
    their addresses are reused."""
    if variant_id is None:
        return None
    state = torch.load(cached_variant_path(variant_id), map_location="cpu", weights_only=True)
    flat = {_renamed(key): t for key, t in state.items()}

    def stacked(site: str, factor: str) -> torch.Tensor:
        return torch.stack([flat[f"text.blocks.{i}.{site}.{factor}"].float()
                            for i in range(n_layers)]).to(device=device, dtype=dtype)

    return {grp: {name: {f: stacked(f"{grp}.{name}", f) for f in ("A", "B")}
                  for g, name in LORA_SITES if g == grp}
            for grp in ("attn", "mlp")}


def merge_variant(text_model: TextModel, lora: dict, scale: float = 1.0
                  ) -> Tuple[TextModel, Optional[dict]]:
    """Fold a stacked adapter into a copy of the dense block weights where
    the adapter reads the linear's own input: W (in, out) += scale * A^T
    B^T for qkv, fc1 and fc2, in fp32, rounded back to the weight's dtype
    (moondream_tpu/lora.py:126-185). The proj adapter reads the block
    input, not the proj input, so it cannot fold: it comes back as a
    residual adapter {"attn": {"proj": pair}} (B times `scale`), or None
    when it is identically zero (then the merged model needs no adapter).
    The model passed in is not touched; the copy shares its other tensors.
    Raises ValueError for int4 or int8 text blocks."""
    if not all(type(blk.qkv) is Linear for blk in text_model.blocks):
        raise ValueError(
            "merge_variant needs dense block weights: merge before int4 / int8 quantization"
        )
    # share every tensor and drop the original's CUDA graphs (they bake in
    # its weights' addresses)
    memo = {id(t): t for t in [*text_model.parameters(), *text_model.buffers()]}
    memo[id(text_model.__dict__.get("_cuda_graphs"))] = None
    merged = copy.deepcopy(text_model, memo)

    for layer, blk in enumerate(merged.blocks):
        for lin, (grp, name) in ((blk.qkv, ("attn", "qkv")), (blk.mlp.fc1, ("mlp", "fc1")),
                                 (blk.mlp.fc2, ("mlp", "fc2"))):
            pair = lora[grp][name]
            delta = pair["A"][layer].float().t() @ pair["B"][layer].float().t()
            folded = (lin.w.float() + scale * delta).to(lin.w.dtype)
            lin.w = nn.Parameter(folded, requires_grad=False)

    proj = lora["attn"]["proj"]
    # outside any loop: a host read is fine here
    if not (bool(torch.any(proj["B"])) and bool(torch.any(proj["A"]))):
        return merged, None
    if scale != 1.0:
        proj = {"A": proj["A"], "B": proj["B"] * scale}
    return merged, {"attn": {"proj": proj}}


def stack_variant_pytrees(loras: List[dict]) -> dict:
    """V stacked adapters as one tree with a variant axis after the layer
    axis, for per-slot serving (moondream_tpu/lora.py:188-225): leaves (L,
    V + 1, r_max, in) and (L, V + 1, out, r_max), variant 0 all zeros (no
    adapter), narrower ranks zero-padded to the widest (zero rows add
    nothing to (x @ A^T) @ B^T)."""
    if not loras:
        raise ValueError("stack_variant_pytrees needs at least one adapter")

    def pad_stack(pairs: List[dict]) -> dict:
        rmax = max(int(p["A"].shape[1]) for p in pairs)
        # F.pad takes (left, right) pairs from the last axis backwards
        a_list = [F.pad(p["A"], (0, 0, 0, rmax - p["A"].shape[1])) for p in pairs]
        b_list = [F.pad(p["B"], (0, rmax - p["B"].shape[2])) for p in pairs]
        return {"A": torch.stack([torch.zeros_like(a_list[0])] + a_list, dim=1),
                "B": torch.stack([torch.zeros_like(b_list[0])] + b_list, dim=1)}

    return {grp: {name: pad_stack([lo[grp][name] for lo in loras])
                  for g, name in LORA_SITES if g == grp}
            for grp in ("attn", "mlp")}
