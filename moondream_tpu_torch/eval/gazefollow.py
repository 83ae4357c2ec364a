"""GazeFollow: mean/min L2 gaze error via detect_gaze(force_detect)
(moondream_tpu/eval/gazefollow.py, on the port's model)."""

import math

from tqdm import tqdm


def eval_gazefollow(model, debug=False):
    import datasets

    dataset = datasets.load_dataset("vikhyatk/gazefollow", split="test")

    mean_l2_error, min_l2_error = [], []
    total = 0
    for row in tqdm(dataset, total=len(dataset), desc="GazeFollow"):
        # Group annotations by (approximately) identical head boxes.
        heads = []
        for gaze in row["gazes"]:
            bbox = gaze["head_bbox"]
            target = (gaze["gaze"]["x"], gaze["gaze"]["y"])
            for head in heads:
                hb = head["head_bbox"]
                if all(
                    abs(hb[k] - bbox[k]) < 0.001
                    for k in ("xmin", "xmax", "ymin", "ymax")
                ):
                    head["gazes"].append(target)
                    break
            else:
                heads.append(
                    {
                        "head_bbox": bbox,
                        "eye_coord": (gaze["eye"]["x"], gaze["eye"]["y"]),
                        "gazes": [target],
                    }
                )

        for head in heads:
            pred = model.detect_gaze(
                row["image"],
                eye=head["eye_coord"],
                face={
                    "x_min": head["head_bbox"]["xmin"],
                    "y_min": head["head_bbox"]["ymin"],
                    "x_max": head["head_bbox"]["xmax"],
                    "y_max": head["head_bbox"]["ymax"],
                },
                unstable_settings={"force_detect": True},
            )["gaze"]

            mean_target = (
                sum(g[0] for g in head["gazes"]) / len(head["gazes"]),
                sum(g[1] for g in head["gazes"]) / len(head["gazes"]),
            )
            mean_l2_error.append(
                math.dist(mean_target, (pred["x"], pred["y"]))
            )
            min_l2_error.append(
                min(
                    math.dist(t, (pred["x"], pred["y"]))
                    for t in head["gazes"]
                )
            )
            total += 1

    return {
        "mean_l2": sum(mean_l2_error) / total,
        "min_l2": sum(min_l2_error) / total,
    }


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        eval_gazefollow,
        lambda r: print(
            f"Mean L2 error: {r['mean_l2']:.4f}\nMin L2 error: {r['min_l2']:.4f}"
        ),
    )
