"""COCO mAP@0.5 via detect() over per-image present labels
(moondream_tpu/eval/coco_map.py, on the port's model)."""

import json

from tqdm import tqdm

from .metrics import aggregate_map, average_precision

COCO_CLASSES = [
    "None", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "street sign",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "hat", "backpack",
    "umbrella", "shoe", "eye glasses", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "plate", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana",
    "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
    "donut", "cake", "chair", "couch", "potted plant", "bed", "mirror",
    "dining table", "window", "desk", "toilet", "door", "tv", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "blender", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush", "hair brush",
]

COCO_LABELS = dict(enumerate(COCO_CLASSES))


def eval_coco_map(model, iou_threshold=0.5, debug=False):
    import datasets

    dataset = datasets.load_dataset(
        "moondream/coco-val-2017-bbox-cleaned", split="validation"
    )

    results_by_label = {}
    frequency_by_label = {}
    for row in tqdm(dataset, disable=debug, desc="COCO mAP"):
        width, height = row["image"].width, row["image"].height
        objects = json.loads(row["objects"])

        gt_by_label = {}
        for bbox, label in zip(objects["bbox"], objects["label"]):
            x1, y1, w, h = bbox
            gt_by_label.setdefault(label, []).append((x1, y1, x1 + w, y1 + h))

        for label in set(objects["label"]):
            enc = model.encode_image(row["image"])
            detected = model.detect(enc, COCO_LABELS[label])["objects"]
            preds = [
                (
                    b["x_min"] * width,
                    b["y_min"] * height,
                    b["x_max"] * width,
                    b["y_max"] * height,
                    1.0,
                )
                for b in detected
            ]
            ap = average_precision(gt_by_label[label], preds, iou_threshold)
            results_by_label.setdefault(label, []).append(ap)
            frequency_by_label[label] = frequency_by_label.get(label, 0) + 1

    return {"total_map": aggregate_map(results_by_label, frequency_by_label)}


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        eval_coco_map,
        lambda r: print(f"Overall MAP: {r['total_map'] * 100:.2f}"),
    )
