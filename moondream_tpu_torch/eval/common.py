"""Shared eval-CLI plumbing (moondream_tpu/eval/common.py): the eval model
from a checkpoint path, dense or under a quantized serving config, and a
uniform argparse main. The model runs on the card unless the caller asks
for the CPU (`device="cpu"`, `--device cpu`)."""

from __future__ import annotations

import argparse


def create_model(ckpt_path: str, config_json: str = None, tokenizer: str = None,
                 int4: bool = False, kv_int8: bool = False,
                 vit8: bool = False, device="cuda"):
    """Load an eval model, optionally under a quantized serving config
    (int4 text through the W4A16 kernel / int8 KV cache / int8 ViT
    through the w8a8 kernels) so accuracy can gate quantization; see
    eval/quant_drift.py for the promotion criteria."""
    import dataclasses

    from ..config import MoondreamConfig
    from ..models.moondream import MoondreamModel
    from ..tokenizer import load_tokenizer
    from ..weights import load_params

    config = (
        MoondreamConfig.from_json(config_json) if config_json else MoondreamConfig()
    )
    if kv_int8:
        config = dataclasses.replace(
            config, text=dataclasses.replace(config.text, kv_int8=True)
        )
    params = load_params(ckpt_path, config, runtime_int4=int4, device=device)
    if vit8:
        from ..models.vision import quantize_vision_params

        quantize_vision_params(params["vision"])  # in place
    return MoondreamModel(config, params=params, tokenizer=load_tokenizer(tokenizer),
                          device=device)


def run_cli(eval_fn, format_fn):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--tokenizer", type=str, default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    args = parser.parse_args()

    model = create_model(args.model, args.config, args.tokenizer, device=args.device)
    result = eval_fn(model, debug=args.debug)
    format_fn(result)
    return result
