"""Accuracy gates for quantized serving configurations
(moondream_tpu/eval/quant_drift.py, on the port's model).

The port serves int4 text blocks (the W4A16 kernel), int8 w8a8 text and
ViT blocks (the w8a8 kernels) and an int8 KV cache. Before a quantized
config is promoted, it must pass the gates below:

  * ``vision_projection_drift`` — error of the int8-ViT image embeddings
    (the 729 x dim tensor every downstream token attends to) vs the bf16
    encoder on the same crops.
  * ``caption_agreement`` — fraction of greedy caption tokens identical
    to the bf16 model's under a quantized config (text int4 / text int8 /
    kv int8 / vit int8, composable).
  * ``check_gates`` — the promotion thresholds, one place, machine-read.

PROMOTION CRITERIA (gates): a quantized config may be promoted to the
default serving config when, on a REAL checkpoint over the gate corpus
(synthetic + natural images):

  * vision int8:  relative L2 drift of the projected image embedding
                  <= 2% (rel_l2), max absolute element error <= 0.15
                  (bf16 embeds are O(1) after projection), AND greedy
                  caption-token agreement >= 95%.
  * kv int8 / text int4 / text int8 (w8a8): greedy caption-token
                  agreement >= 95% and no eval-suite benchmark regressing
                  > 1 point (run ``eval_all --int4 --kv-int8`` vs the
                  bf16 run).

With random weights (no --model) every function runs and the report is
printed, but the gates mean nothing: a mechanism check only.

Two things differ from the JAX package's module:
  * the port's quantizers convert modules IN PLACE, so every quantized
    twin (`quantized_twin`) is a second MoondreamModel over copies of the
    modules it quantizes (their dense tensors shared, their CUDA graphs
    not) and shares the others; the dense model stays dense;
  * static int8-ViT calibration runs on NORMALIZED crops in [-1, 1], as
    the runtime feeds the encoder (`models.vision.normalize_crops`); the
    JAX package calibrates on raw 0-255 pixels there.

Run directly (the card unless --device cpu):
    python -m moondream_tpu_torch.eval.quant_drift --config 05b --vit8
    python -m moondream_tpu_torch.eval.quant_drift --model ckpt.st --vit8 --kv8
"""

import argparse
import copy
import dataclasses
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

# one place for the numbers quoted in the docstring
GATES = {
    "vit8_rel_l2_max": 0.02,
    "vit8_abs_err_max": 0.15,
    "caption_agreement_min": 0.95,
}


def _images(n: int = 6, seed: int = 0) -> List["object"]:
    """Gate corpus: structured synthetics spanning the activation range —
    flat colors, gradients, high-frequency noise, checkerboard. Real
    checkpoints should extend this with natural images (pass your own
    list to the functions below)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    h, w = 378, 504
    yy, xx = np.mgrid[0:h, 0:w]
    out.append(Image.new("RGB", (w, h), (127, 127, 127)))
    out.append(Image.fromarray(
        np.stack([(xx * 255 // w), (yy * 255 // h), ((xx + yy) % 256)],
                 axis=-1).astype(np.uint8)))
    out.append(Image.fromarray(
        rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)))
    out.append(Image.fromarray(
        (((xx // 14 + yy // 14) % 2) * 255).astype(np.uint8)[..., None]
        .repeat(3, -1)))
    for _ in range(max(0, n - 4)):
        out.append(Image.fromarray(
            rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)))
    return out[:n]


def dense_vision(model) -> bool:
    """Whether the model's ViT blocks are dense (not int8)."""
    from ..ops.layers import Linear

    return isinstance(model.vision.blocks[0].qkv, Linear)


def _calibration_stats(model) -> Dict[str, torch.Tensor]:
    """Static int8-ViT activation statistics of the model's dense ViT over
    a DISJOINT synthetic corpus (seed 1), so that the gate is not
    self-calibrated on its measurement images; the crops are normalized to
    [-1, 1] first."""
    from ..models.vision import collect_vision_act_stats, normalize_crops
    from ..ops.image_crops import overlap_crop_image

    cfg = model.config.vision
    cal = np.concatenate([
        overlap_crop_image(
            np.asarray(im.convert("RGB")),
            overlap_margin=cfg.overlap_margin, max_crops=cfg.max_crops,
        )["crops"]
        for im in _images(6, seed=1)
    ])
    crops = normalize_crops(torch.from_numpy(cal).to(model.device), model.dtype)
    return collect_vision_act_stats(crops, model.vision)


def _structure_copy(module):
    """A copy of `module`'s submodules that shares every parameter and
    buffer and none of the CUDA graphs the original carries (a graph bakes
    in the original's addresses; `engine/graphs.cache_of`). The quantizers
    replace the copy's linears by new modules, so the original keeps its
    own."""
    memo = {id(t): t for t in [*module.parameters(), *module.buffers()]}
    for m in module.modules():
        memo[id(m.__dict__.get("_cuda_graphs"))] = None
    return copy.deepcopy(module, memo)


def quantized_twin(model, int4: bool = False, int8_text: bool = False,
                   kv8: bool = False, vit8: bool = False, vit8_static: bool = False):
    """A second MoondreamModel on the model's device and dtype under a
    quantized config: int4 (ahead of int8) or int8 (w8a8) text blocks, an
    int8 KV cache, an int8 ViT (dynamic, or with `vit8_static` statically
    calibrated). Each quantized module is a copy of the model's
    (`_structure_copy`: the quantizers convert in place) and every other
    module is shared. The model stays as it is;
    a model whose ViT is int8 already raises ValueError under vit8."""
    from ..models.moondream import MoondreamModel

    config = model.config
    if kv8:
        config = dataclasses.replace(
            config, text=dataclasses.replace(config.text, kv_int8=True)
        )
    params = torch.nn.ModuleDict(dict(model.params.items()))
    if int4 or int8_text:
        from ..models.text import quantize_text_params, quantize_text_params_int8

        quantize = quantize_text_params if int4 else quantize_text_params_int8
        params["text"] = quantize(_structure_copy(model.text))
    if vit8 or vit8_static:
        from ..models.vision import quantize_vision_params

        if not dense_vision(model):
            raise ValueError("model already holds quantized vision params; "
                             "run drift from the bf16 model")
        stats = _calibration_stats(model) if vit8_static else None
        params["vision"] = quantize_vision_params(_structure_copy(model.vision),
                                                  act_stats=stats)
    return MoondreamModel(config, params=params, tokenizer=model.tokenizer,
                          dtype=model.dtype, device=model.device, graphed=model.graphed)


@torch.no_grad()
def vision_projection_drift(
    model, images: Optional[list] = None, static: bool = False
) -> Dict[str, float]:
    """int8-ViT drift of the projected image embeddings vs the model's
    own bf16 ViT, per image; returns max/mean absolute error, relative
    L2, and the bf16 embedding scale for context. The model must hold a
    DENSE ViT; the quantized twin is derived here (`quantized_twin`), with
    `static` from statically calibrated activation scales."""
    model_q = quantized_twin(model, vit8=True, vit8_static=static)

    images = images if images is not None else _images()
    abs_errs, rel_l2s, scales = [], [], []
    for im in images:
        emb_bf16 = model._run_vision_encoder(im).float().cpu().numpy()
        emb_q = model_q._run_vision_encoder(im).float().cpu().numpy()
        diff = emb_q - emb_bf16
        abs_errs.append(float(np.abs(diff).max()))
        rel_l2s.append(
            float(np.linalg.norm(diff) / max(np.linalg.norm(emb_bf16), 1e-9))
        )
        scales.append(float(np.abs(emb_bf16).mean()))
    return {
        "max_abs_err": max(abs_errs),
        "mean_abs_err": float(np.mean(abs_errs)),
        "rel_l2": float(np.mean(rel_l2s)),
        "worst_rel_l2": max(rel_l2s),
        "bf16_mean_abs": float(np.mean(scales)),
        "n_images": len(images),
    }


def caption_agreement(
    model_ref, model_q, images: Optional[list] = None, max_tokens: int = 32
) -> Dict[str, float]:
    """Greedy caption-token agreement between a reference (bf16) model and
    a quantized twin: fraction of positions where the emitted token ids
    match, prefix-aligned (first divergence ends the credited prefix —
    downstream tokens condition on the divergent one)."""
    images = images if images is not None else _images()
    greedy = {"temperature": 0.0, "top_p": 0.0, "max_tokens": max_tokens}
    agree, total = 0, 0
    exact = 0
    for im in images:
        a = model_ref.caption(im, "normal", settings=greedy)["caption"]
        b = model_q.caption(im, "normal", settings=greedy)["caption"]
        ta = model_ref._encode_text(a) if a else []
        tb = model_q._encode_text(b) if b else []
        n = max(len(ta), len(tb), 1)
        k = 0
        while k < min(len(ta), len(tb)) and ta[k] == tb[k]:
            k += 1
        # identical sequences are full agreement even when empty (a tiny
        # random model can greedily emit EOS immediately)
        agree += n if ta == tb else k
        total += n
        exact += int(a == b)
    return {
        "token_agreement": agree / total,
        "exact_caption_rate": exact / len(images),
        "n_images": len(images),
    }


def check_gates(report: Dict[str, float]) -> Dict[str, bool]:
    """Evaluate the promotion gates against a drift report (missing
    metrics are skipped). Returns {gate_name: passed}."""
    out = {}
    if "rel_l2" in report:
        out["vit8_rel_l2"] = report["rel_l2"] <= GATES["vit8_rel_l2_max"]
    if "max_abs_err" in report:
        out["vit8_abs_err"] = (
            report["max_abs_err"] <= GATES["vit8_abs_err_max"]
        )
    if "token_agreement" in report:
        out["caption_agreement"] = (
            report["token_agreement"] >= GATES["caption_agreement_min"]
        )
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None,
                    help="checkpoint path (omit for random weights — "
                         "mechanism check only, gates are meaningless "
                         "without real weights)")
    ap.add_argument("--config", default="2b", choices=["2b", "05b"])
    ap.add_argument("--vit8", action="store_true")
    ap.add_argument("--vit8-static", action="store_true",
                    help="int8 ViT with statically calibrated activation "
                         "scales (collect_vision_act_stats on normalized crops)")
    ap.add_argument("--int4", action="store_true")
    ap.add_argument("--int8-text", action="store_true",
                    help="int8 w8a8 text blocks "
                         "(models.text.quantize_text_params_int8)")
    ap.add_argument("--kv8", action="store_true")
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    from .. import config as configs
    from ..models.moondream import MoondreamModel
    from ..tokenizer import ByteTokenizer, load_tokenizer
    from ..weights import load_params

    config = configs.MOONDREAM_2B if args.config == "2b" else configs.MOONDREAM_05B
    if args.model:
        params = load_params(args.model, config, device=args.device)
        tok = load_tokenizer()
    else:
        print("WARNING: random weights — mechanism check only",
              file=sys.stderr)
        params, tok = None, ByteTokenizer()
    model = MoondreamModel(config, params=params, tokenizer=tok, seed=0,
                           device=args.device)

    report = {}
    if args.vit8 or args.vit8_static:
        report.update(
            vision_projection_drift(model, static=args.vit8_static)
        )

    if args.vit8 or args.vit8_static or args.int4 or args.int8_text \
            or args.kv8:
        model_q = quantized_twin(
            model, int4=args.int4, int8_text=args.int8_text,
            kv8=args.kv8, vit8=args.vit8, vit8_static=args.vit8_static,
        )
        report.update(
            caption_agreement(model, model_q, max_tokens=args.max_tokens)
        )

    report["gates"] = check_gates(report)
    report["gates_apply"] = bool(args.model)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
