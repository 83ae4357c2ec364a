"""Finetuning on the card (moondream_tpu/finetune/): the text decoder
(`finetune_text`) and the region heads (`finetune_region`), through the
cache-free prefix-mask forward (`models.text.produce_hidden`), the
losses and training step of `trainer`, and `optim.AdamW`, a mirror of
optax.adamw inside optax.MultiSteps that updates the weights in place."""

from ..config import MOONDREAM_05B, MOONDREAM_2B, MoondreamConfig, tiny_test_config


def resolve_config(spec):
    """--config value: None/'2b', '05b' and 'tiny' presets, else a JSON path
    (moondream_tpu/finetune/__init__.py)."""
    if spec in (None, "", "2b"):
        return MOONDREAM_2B
    if spec == "05b":
        return MOONDREAM_05B
    if spec == "tiny":  # offline smoke runs / CI
        return tiny_test_config()
    return MoondreamConfig.from_json(spec)
