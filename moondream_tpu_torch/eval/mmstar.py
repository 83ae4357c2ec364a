"""MMStar: letter-option accuracy with per-category breakdown
(moondream_tpu/eval/mmstar.py, on the port's model)."""

from tqdm import tqdm

SUFFIX = (
    " Please answer directly with only the letter of the correct option and "
    "nothing else."
)


def eval_mmstar(model, debug=False):
    import datasets

    dataset = datasets.load_dataset("Lin-Chen/MMStar", split="val")

    correct = total = 0
    category_stats = {}
    results = []
    for row in tqdm(dataset, disable=debug, desc="MMStar"):
        question = row["question"] + SUFFIX
        model_answer = model.query(row["image"], question)["answer"]
        is_correct = model_answer.strip().lower() == row["answer"].strip().lower()

        category = f"{row['category']} / {row['l2_category']}"
        stats = category_stats.setdefault(category, {"correct": 0, "total": 0})
        total += 1
        stats["total"] += 1
        correct += is_correct
        stats["correct"] += is_correct

        results.append(
            {
                "question": question,
                "ground_truth": row["answer"],
                "model_answer": model_answer,
                "is_correct": is_correct,
                "category": category,
            }
        )

    return {
        "acc": correct * 100 / total,
        "correct_count": correct,
        "total_count": total,
        "category_stats": category_stats,
        "results": results,
    }


if __name__ == "__main__":
    from .common import run_cli

    run_cli(eval_mmstar, lambda r: print(f"Accuracy: {r['acc']:.2f}"))
