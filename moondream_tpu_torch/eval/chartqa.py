"""ChartQA: relaxed-correctness accuracy, human/total split
(moondream_tpu/eval/chartqa.py, on the port's model)."""

import json

from tqdm import tqdm

from .metrics import relaxed_correctness

PREFIX = (
    "Analyze the chart carefully, consider both visual features and data "
    "values, and provide a precise answer without any additional explanation "
    "or formatting. "
)


def eval_chartqa(model, debug=False):
    import datasets

    dataset = datasets.load_dataset("vikhyatk/chartqa", split="test")

    correct = total = human_correct = human_total = 0
    results = []
    for row in tqdm(dataset, disable=debug, desc="ChartQA"):
        enc = model.encode_image(row["image"])
        result = []
        for qa in row["qa"]:
            question = PREFIX + qa["question"]
            answer = qa["answer"]
            model_answer = model.query(enc, question)["answer"]

            # Lists compare element-wise when both sides parse as
            # equal-length JSON lists; otherwise string comparison.
            try:
                answer_list = json.loads(answer)
                model_answer_list = json.loads(model_answer)
                if not (
                    isinstance(answer_list, list)
                    and isinstance(model_answer_list, list)
                    and len(answer_list) == len(model_answer_list)
                ):
                    raise ValueError
            except Exception:
                answer_list = [answer]
                model_answer_list = [model_answer]

            total += 1
            human_total += qa["source"] == "human"

            is_correct = all(
                relaxed_correctness(
                    str(a).strip().lower(), str(m).strip().lower()
                )
                for a, m in zip(answer_list, model_answer_list)
            )
            correct += is_correct
            human_correct += is_correct and qa["source"] == "human"
            result.append(
                {
                    "question": question,
                    "ground_truth": answer_list,
                    "model_answer": model_answer_list,
                    "is_correct": is_correct,
                    "source": qa["source"],
                }
            )
        results.append(result)

    return {
        "human_acc": human_correct * 100 / human_total,
        "total_acc": correct * 100 / total,
        "results": results,
    }


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        eval_chartqa,
        lambda r: print(
            f"Human Accuracy: {r['human_acc']:.2f}\nTotal Accuracy: {r['total_acc']:.2f}"
        ),
    )
