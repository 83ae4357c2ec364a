"""CountBenchQA: exact-match counting accuracy
(moondream_tpu/eval/countbenchqa.py, on the port's model)."""

from tqdm import tqdm


PREFIX = (
    "Look at the image carefully and count the objects. "
    "Answer with just a number, without any additional text. "
)


def eval_countbenchqa(model, debug=False):
    import datasets

    dataset = datasets.load_dataset("vikhyatk/CountBenchQA", split="test")

    correct = total = 0
    results = []
    for row in tqdm(dataset, disable=debug, desc="CountBenchQA"):
        enc = model.encode_image(row["image"])
        question = PREFIX + row["question"]
        answer = str(row["number"])
        model_answer = model.query(enc, question)["answer"]
        is_correct = model_answer.strip().lower() == answer.strip().lower()
        results.append(
            {
                "question": question,
                "ground_truth": answer,
                "model_answer": model_answer,
                "is_correct": is_correct,
            }
        )
        total += 1
        correct += is_correct
        if debug:
            print(f"{correct}/{total} = {correct * 100 / total:.2f}%")

    return {
        "acc": correct * 100 / total,
        "correct_count": correct,
        "total_count": total,
        "results": results,
    }


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        eval_countbenchqa,
        lambda r: print(
            f"Accuracy: {r['acc']:.2f}\nCorrect: {r['correct_count']}, Total: {r['total_count']}"
        ),
    )
