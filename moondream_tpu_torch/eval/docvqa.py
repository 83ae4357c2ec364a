"""DocVQA: ANLS (moondream_tpu/eval/docvqa.py, on the port's model)."""

from tqdm import tqdm

from .metrics import anls

SUFFIX = " The answer should be a short text span taken verbatim from the document."


def eval_docvqa(model, debug=False):
    from datasets import load_dataset

    dataset = load_dataset("vikhyatk/docvqa-val", split="validation")

    scores = []
    results = []
    for row in tqdm(dataset, disable=debug, desc="DocVQA"):
        enc = model.encode_image(row["image"])
        result = []
        for qa in row["qa"]:
            model_answer = model.query(enc, qa["question"] + SUFFIX)["answer"]
            score = max(anls(model_answer, gt) for gt in qa["answers"])
            scores.append(score)
            result.append(
                {
                    "question": qa["question"],
                    "ground_truth": qa["answers"],
                    "model_answer": model_answer,
                    "anls": score,
                }
            )
        results.append(result)

    return {"anls": sum(scores) / len(scores), "results": results}


if __name__ == "__main__":
    from .common import run_cli

    run_cli(eval_docvqa, lambda r: print(f"ANLS: {r['anls']:.4f}"))
