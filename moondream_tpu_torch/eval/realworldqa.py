"""RealWorldQA: exact-match accuracy
(moondream_tpu/eval/realworldqa.py, on the port's model)."""

from tqdm import tqdm


def eval_realworldqa(model, debug=False):
    import datasets

    dataset = datasets.load_dataset("lmms-lab/RealWorldQA", split="test")

    correct = total = 0
    results = []
    for row in tqdm(dataset, disable=debug, desc="RealWorldQA"):
        model_answer = model.query(row["image"], row["question"])["answer"]
        is_correct = (
            model_answer.strip().lower() == row["answer"].strip().lower()
        )
        results.append(
            {
                "question": row["question"],
                "ground_truth": row["answer"],
                "model_answer": model_answer,
                "is_correct": is_correct,
            }
        )
        total += 1
        correct += is_correct

    return {
        "acc": correct * 100 / total,
        "correct_count": correct,
        "total_count": total,
        "results": results,
    }


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        eval_realworldqa,
        lambda r: print(
            f"Accuracy: {r['acc']:.2f}\nCorrect: {r['correct_count']} / {r['total_count']}"
        ),
    )
