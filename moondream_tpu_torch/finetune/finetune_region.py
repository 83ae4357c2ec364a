"""Region-head finetuning on moondream/waste_detection, on the card
(moondream_tpu/finetune/finetune_region.py).

    python -m moondream_tpu_torch.finetune.finetune_region --model <ckpt>
    python -m moondream_tpu_torch.finetune.finetune_region --config tiny --synthetic 2 --device cpu

Per class, the boxes become interleaved [x-coord, y-coord, (w, h)-size]
embedding triplets appended to "\\n\\nDetect: {class}\\n\\n"; the loss is
the cross-entropy on the 1024-bin coordinate logits at the positions that
precede each coordinate slot plus that on the log2-scale size bins. Only
the region tree trains: the text hidden state is computed without
gradients (the JAX package treats the text weights as data, so this is
exact), and the region tree's other leaves (Fourier features, encoders)
get zero gradients and decay.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import numpy as np
import torch

from ..models import region as region_ops
from ..models.moondream import MoondreamModel
from ..models.text import TextModel, produce_hidden
from ..tokenizer import load_tokenizer
from ..weights import load_params
from . import resolve_config
from .finetune_text import print_log, save_params
from .optim import AdamW
from .trainer import TrainState, cli_optimizer, init_train_state, region_loss, step_with

LR = 5e-5
EPOCHS = 2
GRAD_ACCUM_STEPS = 16


@torch.no_grad()
def build_class_example(model: MoondreamModel, img_emb: torch.Tensor, class_name: str,
                        boxes) -> dict:
    """One (class, boxes) training sequence; boxes (K, 4) [xc, yc, w, h]
    normalized. Returns {"inputs_embeds" (1, T, D), "labels" (4K,) int64
    [x_bin, y_bin, w_bin, h_bin] per box, "c_idx" (2K,), "s_idx" (K,)}, the
    positions of the coordinate and size slots, on the model's device."""
    wte, region, tok = model.text.wte, model.region, model.config.tokenizer
    dev, dtype = wte.device, model.dtype
    ids = lambda xs: torch.tensor(xs, dtype=torch.long, device=dev)
    instr_ids = model.tokenizer.encode(f"\n\nDetect: {class_name}\n\n")
    cs_embs, cs_labels, c_idx, s_idx = [], [], [], []
    for bb in boxes:
        xc, yc, w, h = (float(v) for v in bb)
        k = len(cs_embs)
        as_t = lambda vals: torch.tensor(vals, dtype=dtype, device=dev)
        cs_embs.append(region_ops.encode_coordinate(as_t([xc]), region))
        cs_embs.append(region_ops.encode_coordinate(as_t([yc]), region))
        cs_embs.append(region_ops.encode_size(as_t([w, h]), region))
        c_idx += [k, k + 1]
        s_idx += [k + 2]
        cs_labels += [int(min(max(round(c * 1023), 0), 1023)) for c in (xc, yc)]
        cs_labels += [
            int(min(max(round((math.log2(max(s, 1 / 1024)) + 10.0) / 10.0 * 1023.0), 0), 1023))
            for s in (w, h)
        ]
    cs_emb = torch.stack(cs_embs)
    inputs_embeds = torch.cat(
        [wte[ids([tok.bos_id])], img_emb, wte[ids(instr_ids)], cs_emb, wte[ids([tok.eos_id])]]
    )[None]
    prefix = inputs_embeds.shape[1] - cs_emb.shape[0]
    return {
        "inputs_embeds": inputs_embeds,
        "labels": ids(cs_labels),
        "c_idx": ids(c_idx) + prefix,
        "s_idx": ids(s_idx) + prefix,
    }


def make_train_step(optimizer: AdamW, text: TextModel):
    """The region training step: train_step(state, batch) -> (state, loss),
    state.params the RegionModel, batch from build_class_example. The
    hidden state comes from `text` without gradients."""

    def train_step(state: TrainState, batch: dict):
        with torch.no_grad():
            hidden = produce_hidden(batch["inputs_embeds"], text)
        return step_with(optimizer, state, lambda: region_loss(
            state.params, hidden, batch["labels"], batch["c_idx"], batch["s_idx"]))

    return train_step


def synthetic_dataset(n: int) -> list:
    """The JAX CLI's --synthetic samples: 378x378 uint8 RGB images from
    default_rng(0), one "widget" box [xc, yc, w, h] each."""
    rng = np.random.default_rng(0)
    return [
        {"image": rng.integers(0, 255, (378, 378, 3), np.uint8),
         "boxes": [[0.4 + 0.01 * k, 0.5, 0.3, 0.4]], "labels": ["widget"]}
        for k in range(n)
    ]


def train(model: MoondreamModel, dataset, epochs: int, lr: float, grad_accum: int,
          log=None) -> TrainState:
    """The CLI's loop: per sample, the frozen image embedding, then one
    mini-step per class of its boxes; `log(step, loss)` every `grad_accum`
    samples, as the JAX CLI reports."""
    total_steps = epochs * len(dataset) // grad_accum
    optimizer = cli_optimizer(lr, total_steps, grad_accum)
    state = init_train_state(model.region, optimizer)
    train_step = make_train_step(optimizer, model.text)
    i = 0
    for _ in range(epochs):
        for sample in dataset:
            i += 1
            with torch.no_grad():
                img_emb = model._run_vision_encoder(sample["image"])
            boxes_by_class = {}
            for box, cls in zip(sample["boxes"], sample["labels"]):
                boxes_by_class.setdefault(cls, []).append(box)
            for class_name, boxes in boxes_by_class.items():
                batch = build_class_example(model, img_emb, class_name, boxes)
                state, loss = train_step(state, batch)
            if i % grad_accum == 0 and log is not None:
                log(i // grad_accum, loss)
    return state


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default=None,
                        help="checkpoint; omit for random weights (only "
                             "sensible with --synthetic smoke runs)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--tokenizer", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--lr", type=float, default=LR)
    parser.add_argument("--grad-accum", type=int, default=GRAD_ACCUM_STEPS)
    parser.add_argument("--save", type=str, default="moondream_region_finetune.safetensors",
                        help=".safetensors, else a torch .pt")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic box samples instead of "
                             "the HF dataset (offline smoke run)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the card unless 'cpu' is asked for")
    args = parser.parse_args(argv)

    config = resolve_config(args.config)
    params = load_params(args.model, config, device=args.device) if args.model else None
    model = MoondreamModel(config, params=params, tokenizer=load_tokenizer(args.tokenizer),
                           device=args.device)
    log = print_log(args.wandb, "moondream-tpu-ft-region",
                    {"EPOCHS": args.epochs, "LR": args.lr})
    if args.synthetic:
        dataset = synthetic_dataset(args.synthetic)
    else:
        from datasets import load_dataset

        dataset = load_dataset("moondream/waste_detection", split="train").shuffle(seed=111)
    train(model, dataset, args.epochs, args.lr, args.grad_accum, log)
    save_params(args.save, model)
    print(f"saved to {args.save}")


if __name__ == "__main__":
    main()
