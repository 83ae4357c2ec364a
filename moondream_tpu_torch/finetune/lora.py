"""LoRA adapter finetuning: train the "variants" that `settings={"variant":
path}` serves (moondream_tpu/finetune/lora.py).

Adapters (A, B) for the four sites the inference path patches (qkv, proj,
fc1, fc2 of every block) are trained with the base text model frozen: its
tensors keep requires_grad=False, so the backward computes no weight
gradient for them, gets no `.grad` and leaves their bits alone. The
adapter is the stacked tree of `lora.variant_state_dict` (A (L, r, in), B
(L, out, r)), so the training forward is `models.text.produce_hidden(...,
lora=)` and `optim.AdamW` (optax.adamw inside MultiSteps) updates the
adapter's eight leaves in place: the optimizer state is adapter-sized.
`save_variant` writes the training checkpoint's names, which both
packages' variant loaders rename from.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import TextConfig
from ..models.text import TextModel
from ..weights import checked_device
from .optim import AdamW
from .trainer import TrainState, step_with, text_loss


def _site_dims(config: TextConfig) -> dict:
    """(group, site) -> (in_features, out_features)."""
    return {
        ("attn", "qkv"): (config.dim, config.qkv_dim),
        ("attn", "proj"): (config.dim, config.dim),
        ("mlp", "fc1"): (config.dim, config.ff_dim),
        ("mlp", "fc2"): (config.ff_dim, config.dim),
    }


def init_lora_params(config: TextConfig, rank: int, generator: torch.Generator,
                     dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """A fresh stacked adapter in variant_state_dict's layout: A (L, r, in)
    ~ N(0, 1) / r, drawn from `generator` on its own device (a CPU
    generator gives the same values for any `device`), B (L, out, r) zeros,
    so that a fresh adapter is an exact no-op. `device`: the card unless
    the caller asks for the CPU. The JAX package draws A from a PRNGKey
    instead: the values differ, the distribution does not."""
    dev = checked_device(device)
    out = {"attn": {}, "mlp": {}}
    for (grp, site), (fin, fout) in _site_dims(config).items():
        a = torch.randn((config.n_layers, rank, fin), generator=generator,
                        device=generator.device) / rank
        out[grp][site] = {"A": a.to(dev, dtype),
                          "B": torch.zeros((config.n_layers, fout, rank), dtype=dtype, device=dev)}
    return out


def lora_text_loss(lora: dict, text: TextModel, inputs_embeds: torch.Tensor,
                   labels: torch.Tensor, label_mask: torch.Tensor) -> torch.Tensor:
    """trainer.text_loss's shifted cross-entropy through the adapter's
    cache-free forward (the JAX package's argument order, adapter first)."""
    return text_loss(text, inputs_embeds, labels, label_mask, lora=lora)


def make_lora_train_step(optimizer: AdamW, config: TextConfig):
    """The adapter-only step: train_step(state, text, batch) -> (state,
    loss), state.params the stacked adapter (`optimizer.init(
    optim.named_leaves(adapter))` its state), `text` the frozen base,
    batch {"inputs_embeds", "labels", "label_mask"}. Raises ValueError for
    an adapter whose layers or widths are not `config`'s."""
    dims = _site_dims(config)

    def train_step(state: TrainState, text: TextModel, batch: dict
                   ) -> Tuple[TrainState, torch.Tensor]:
        for (grp, site), (fin, fout) in dims.items():
            a, b = state.params[grp][site]["A"], state.params[grp][site]["B"]
            if (a.shape[0], a.shape[2], b.shape[0], b.shape[1]) != (
                    config.n_layers, fin, config.n_layers, fout):
                raise ValueError(f"adapter {grp}.{site}: A {tuple(a.shape)}, B "
                                 f"{tuple(b.shape)} do not fit the text config")
        return step_with(optimizer, state, lambda: lora_text_loss(
            state.params, text, batch["inputs_embeds"], batch["labels"], batch["label_mask"]))

    return train_step


# the training checkpoint's site names (the inverse of lora._RENAME_RULES)
_SITE_NAMES = {
    ("attn", "qkv"): "mixer.Wqkv",
    ("attn", "proj"): "mixer.out_proj",
    ("mlp", "fc1"): "mlp.fc1",
    ("mlp", "fc2"): "mlp.fc2",
}


def save_variant(path: str, lora: dict) -> None:
    """torch.save the adapter in the training checkpoint's names
    (text_model.transformer.h.{i}.mixer.Wqkv.A, ...), one fp32 CPU tensor
    per layer, site and factor, in the JAX package's key order: a trained
    adapter loads as a variant through either package's
    variant_state_dict."""
    state = {}
    for (grp, site), name in _SITE_NAMES.items():
        for factor in ("A", "B"):
            stacked = lora[grp][site][factor].detach().float().cpu()
            for i in range(stacked.shape[0]):
                state[f"text_model.transformer.h.{i}.{name}.{factor}"] = stacked[i].clone()
    torch.save(state, path)
