"""Waste detection P/R/F1 (companion eval to finetune_region;
moondream_tpu/eval/waste_detection.py, on the port's model)."""

from collections import defaultdict

from tqdm import tqdm

from .metrics import greedy_match, precision_recall_f1


def _rows(split="test"):
    from datasets import load_dataset

    for s in load_dataset("moondream/waste_detection", split=split):
        lbl_to_boxes = defaultdict(list)
        for (xc, yc, bw, bh), lbl in zip(s["boxes"], s["labels"]):
            lbl_to_boxes[lbl].append(
                (xc - bw / 2, yc - bh / 2, xc + bw / 2, yc + bh / 2)
            )
        yield {"image": s["image"], "gt": lbl_to_boxes}


def evaluate(model, iou_thr=0.5, debug=False):
    TP = FP = FN = 0
    for s in tqdm(_rows(), disable=debug, desc="Waste"):
        enc = model.encode_image(s["image"])
        for lbl, gt_boxes in s["gt"].items():
            preds = [
                (o["x_min"], o["y_min"], o["x_max"], o["y_max"])
                for o in model.detect(enc, lbl)["objects"]
            ]
            tp, fp, fn = greedy_match(gt_boxes, preds, iou_thr)
            TP, FP, FN = TP + tp, FP + fp, FN + fn

    out = precision_recall_f1(TP, FP, FN)
    out.update(tp=TP, fp=FP, fn=FN)
    return out


def eval_waste_detection(model, debug=False):
    return evaluate(model, 0.5, debug)


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        eval_waste_detection,
        lambda r: print(
            f"Precision: {r['precision']*100:.2f}%\n"
            f"Recall: {r['recall']*100:.2f}%\n"
            f"F1 Score:  {r['f1']*100:.2f}%\n"
            f"TP: {r['tp']}  FP: {r['fp']}  FN: {r['fn']}"
        ),
    )
