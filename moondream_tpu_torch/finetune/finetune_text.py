"""Text-decoder finetuning on DOCCI captions, on the card
(moondream_tpu/finetune/finetune_text.py).

    python -m moondream_tpu_torch.finetune.finetune_text --model <ckpt> [--config <json>]
    python -m moondream_tpu_torch.finetune.finetune_text --config tiny --synthetic 2 --device cpu

The vision encoder is frozen: each example is [BOS, image, question,
answer] embeddings (the ViT's image embedding through kernel A on the
card, and the current `wte` rows), padded to a multiple of SEQ_BUCKET;
the loss is the shifted cross-entropy on the answer span; the optimizer
is the JAX CLI's adamw (warmup + cosine LR, optax's default weight decay)
inside MultiSteps of --grad-accum, in place (finetune/optim.py). Saves the
whole model in the interchange checkpoint layout (save_params), as
.safetensors or torch .pt, which `weights.load_params` and the JAX
package's loader read.

With --lora-rank r only a rank-r adapter at qkv, proj, fc1 and fc2 trains
(finetune/lora.py; the base stays frozen, bit for bit); --save-every
checkpoints the adapter, and --save writes it as a variant file
(save_variant) that `settings={"variant": path}` serves. Its A starts from
a torch generator seeded 0, where the JAX CLI's starts from PRNGKey(0).

Needs nothing beyond torch and numpy with --synthetic; the HF dataset
needs `datasets`, --wandb needs `wandb`, a .safetensors save needs
`safetensors`.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.moondream import MoondreamModel
from ..tokenizer import load_tokenizer
from ..weights import load_params, params_to_jax
from . import resolve_config
from .lora import init_lora_params, make_lora_train_step, save_variant
from .trainer import TrainState, cli_optimizer, init_train_state, make_train_step, save_checkpoint

ANSWER_EOS = "<|endoftext|>"
LR = 3e-6
EPOCHS = 3
GRAD_ACCUM_STEPS = 128
SEQ_BUCKET = 128  # pad [BOS, img, Q, A] sequences to multiples of this
QUESTION = "\n\nQuestion: Describe this image.\n\nAnswer:"


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@torch.no_grad()
def build_example(model: MoondreamModel, image, question: str, answer: str) -> dict:
    """One training example: {"inputs_embeds" (1, T, D), "labels" (1, T)
    int64, "label_mask" (1, T) fp32} on the model's device, T the sequence
    [BOS, image, question, answer] padded with zeros to SEQ_BUCKET.
    labels[t] is the target emitted at position t (the loss shifts)."""
    img_emb = model._run_vision_encoder(image)  # (729, D), frozen
    wte = model.text.wte
    ids = lambda xs: torch.tensor(xs, dtype=torch.long, device=wte.device)
    q_ids = model.tokenizer.encode(question)
    a_ids = model.tokenizer.encode(answer)
    embeds = torch.cat([
        wte[ids([model.config.tokenizer.bos_id])], img_emb, wte[ids(q_ids)], wte[ids(a_ids)],
    ])
    seq = embeds.shape[0]
    pad = _ceil_to(seq, SEQ_BUCKET)
    embeds = F.pad(embeds, (0, 0, 0, pad - seq))
    labels = torch.zeros(pad, dtype=torch.long)
    mask = torch.zeros(pad, dtype=torch.float32)
    a_start = 1 + img_emb.shape[0] + len(q_ids)
    labels[a_start:a_start + len(a_ids)] = torch.tensor(a_ids)
    mask[a_start:a_start + len(a_ids)] = 1.0
    return {
        "inputs_embeds": embeds[None],
        "labels": labels[None].to(wte.device),
        "label_mask": mask[None].to(wte.device),
    }


def synthetic_dataset(n: int) -> list:
    """The JAX CLI's --synthetic samples: 378x378 uint8 RGB images from
    default_rng(0), captions "synthetic sample number k"."""
    rng = np.random.default_rng(0)
    return [
        {"image": rng.integers(0, 255, (378, 378, 3), np.uint8),
         "description": f"synthetic sample number {k}"}
        for k in range(n)
    ]


def train(
    model: MoondreamModel, dataset, epochs: int, lr: float, grad_accum: int,
    save_every: int = 0, ckpt_dir: str = "checkpoints", log=None, lora_rank: int = 0,
) -> TrainState:
    """The CLI's loop: one example per mini-step, an optimizer update every
    `grad_accum` mini-steps, a checkpoint of the trained tree every
    `save_every` updates. `log(step, loss)` is called at each update. With
    `lora_rank`, the trained tree is a fresh rank-`lora_rank` adapter (A
    from a CPU generator seeded 0) over the frozen text model."""
    total_steps = epochs * len(dataset) // grad_accum
    optimizer = cli_optimizer(lr, total_steps, grad_accum)
    if lora_rank:
        lora = init_lora_params(model.config.text, lora_rank, torch.Generator().manual_seed(0),
                                device=model.device)
        state = init_train_state(lora, optimizer)
        lora_step = make_lora_train_step(optimizer, model.config.text)
        train_step = lambda state, batch: lora_step(state, model.text, batch)
    else:
        state = init_train_state(model.text, optimizer)
        train_step = make_train_step(optimizer)
    i = 0
    for _ in range(epochs):
        for sample in dataset:
            i += 1
            batch = build_example(model, sample["image"], QUESTION,
                                  f"{sample['description']}{ANSWER_EOS}")
            state, loss = train_step(state, batch)
            if i % grad_accum == 0:
                step = i // grad_accum
                if log is not None:
                    log(step, loss)
                if save_every and step % save_every == 0:
                    os.makedirs(ckpt_dir, exist_ok=True)
                    save_checkpoint(os.path.join(ckpt_dir, f"step_{step}.pt"), state)
    return state


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default=None,
                        help="checkpoint; omit for random weights (only "
                             "sensible with --synthetic smoke runs)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--tokenizer", type=str, default=None)
    parser.add_argument("--dataset", type=str, default="google/docci")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--lr", type=float, default=LR)
    parser.add_argument("--grad-accum", type=int, default=GRAD_ACCUM_STEPS)
    parser.add_argument("--save", type=str, default="moondream_finetune.safetensors",
                        help=".safetensors, else a torch .pt")
    parser.add_argument("--save-every", type=int, default=0,
                        help="checkpoint the text tree every N optimizer steps")
    parser.add_argument("--ckpt-dir", type=str, default="checkpoints")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic image/caption pairs "
                             "instead of a HF dataset (offline smoke run)")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="train a LoRA adapter of this rank (the base stays frozen) "
                             "and save it as a variant file")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the card unless 'cpu' is asked for")
    args = parser.parse_args(argv)

    config = resolve_config(args.config)
    params = load_params(args.model, config, device=args.device) if args.model else None
    model = MoondreamModel(config, params=params, tokenizer=load_tokenizer(args.tokenizer),
                           device=args.device)
    log = print_log(args.wandb, "moondream-tpu-ft", {
        "EPOCHS": args.epochs, "GRAD_ACCUM_STEPS": args.grad_accum, "LR": args.lr})
    if args.synthetic:
        dataset = synthetic_dataset(args.synthetic)
    else:
        from datasets import load_dataset

        dataset = load_dataset(args.dataset, trust_remote_code=True)["train"]
    state = train(model, dataset, args.epochs, args.lr, args.grad_accum, args.save_every,
                  args.ckpt_dir, log, args.lora_rank)
    if args.lora_rank:
        save_variant(args.save, state.params)
    else:
        save_params(args.save, model)
    print(f"saved to {args.save}")


def print_log(use_wandb: bool, project: str, run_config: dict):
    """log(step, loss): a line per optimizer update, and wandb with
    --wandb."""
    if use_wandb:
        import wandb

        wandb.init(project=project, config=run_config)

    def log(step: int, loss: torch.Tensor) -> None:
        print(f"step {step} loss {float(loss):.6f}", flush=True)
        if use_wandb:
            wandb.log({"loss/train": float(loss)})

    return log


def save_params(path: str, model: MoondreamModel) -> None:
    """The whole model (vision, text, region) as an interchange checkpoint,
    the JAX package's save_params layout: per-layer names, linears torch
    (out, in), fp32, no RoPE table; .safetensors through `safetensors`,
    any other path through torch.save. Dense weights only."""
    flat = {}

    def add(prefix, tree):
        for k, v in tree.items():
            name = f"{prefix}.{k}"
            if isinstance(v, dict):
                add(name, v)
            else:
                flat[name] = v

    for part, tree in params_to_jax(model.params).items():
        add(part, tree)
    flat.pop("text.freqs_cis")

    # safetensors serializes raw buffers: transposed views must be compacted
    out = {}
    for name, arr in flat.items():
        if ".blocks." in name:
            head, tail = name.split(".blocks.", 1)
            for i in range(arr.shape[0]):
                out.update(_interchange(f"{head}.blocks.{i}.{tail}", arr[i]))
        else:
            out.update(_interchange(name, arr))
    if path.endswith(".safetensors"):
        from safetensors.numpy import save_file  # only this format needs it

        save_file(out, path)
    else:
        # cloned: a layer's bias is a view of its stacked array, whose whole
        # storage torch.save would write
        torch.save({k: torch.from_numpy(v).clone() for k, v in out.items()}, path)


def _interchange(name: str, arr: np.ndarray) -> dict:
    """One leaf under its checkpoint name: `.w` -> `.weight` (out, in),
    `.b` -> `.bias`, anything else as it is."""
    if name.endswith(".w"):
        return {name[:-2] + ".weight": np.ascontiguousarray(arr.T)}
    if name.endswith(".b"):
        return {name[:-2] + ".bias": np.ascontiguousarray(arr)}
    return {name: np.ascontiguousarray(arr)}


if __name__ == "__main__":
    main()
