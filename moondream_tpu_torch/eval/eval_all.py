"""Aggregate eval runner (moondream_tpu/eval/eval_all.py, on the port's
model).

    python -m moondream_tpu_torch.eval.eval_all --model ckpt.safetensors \
        [--int4 --kv-int8 --vit8] [--skip pope ...] [--device cpu]
"""

import argparse
from pprint import pprint

from .chartqa import eval_chartqa
from .coco_map import eval_coco_map
from .common import create_model
from .countbenchqa import eval_countbenchqa
from .docvqa import eval_docvqa
from .mmstar import eval_mmstar
from .naturalbench import eval_naturalbench
from .pope import evaluate_pope
from .realworldqa import eval_realworldqa
from .tallyqa import eval_tallyqa
from .textvqa import eval_textvqa

EVALS = {
    "countbenchqa": eval_countbenchqa,
    "pope": evaluate_pope,
    "realworldqa": eval_realworldqa,
    "chartqa": eval_chartqa,
    "mmstar": eval_mmstar,
    "docvqa": eval_docvqa,
    "coco_map": eval_coco_map,
    "textvqa": eval_textvqa,
    "naturalbench": eval_naturalbench,
    "tallyqa": eval_tallyqa,
}


def eval_all(model, skip=()):
    evals = dict(EVALS)
    for b in skip:
        del evals[b]

    results = {}
    for name, eval_fn in evals.items():
        results[name] = eval_fn(model)
        pprint({k: v for k, v in results[name].items() if k != "results"})
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--tokenizer", type=str, default=None)
    parser.add_argument("--skip", type=str, nargs="*", default=[])
    # quantized-config accuracy gates (eval/quant_drift.py documents the
    # promotion criteria): run the full suite under the exact quantized
    # serving configuration to compare against the bf16 run
    parser.add_argument("--int4", action="store_true",
                        help="runtime-int4 text weights (the W4A16 kernel) — the "
                             "quantized serving config")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 KV cache")
    parser.add_argument("--vit8", action="store_true",
                        help="int8 ViT block matmuls (the w8a8 kernels; gate before "
                             "production use)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    args = parser.parse_args(argv)

    model = create_model(
        args.model, args.config, args.tokenizer,
        int4=args.int4, kv_int8=args.kv_int8, vit8=args.vit8, device=args.device,
    )
    return eval_all(model, skip=args.skip)


if __name__ == "__main__":
    main()
