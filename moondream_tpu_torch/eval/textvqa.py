"""TextVQA: official VQA score
(moondream_tpu/eval/textvqa.py, on the port's model)."""

from tqdm import tqdm

from .metrics import VQAScorer

PREFIX_TEXTVQA = (
    "Read the text in the image and provide a brief lowercase answer. "
    "Respond 'unanswerable' only if there is no plausible answer. "
)


def eval_textvqa(model, debug=False):
    import datasets

    dataset = datasets.load_dataset("vikhyatk/textvqa_val", split="validation")

    scorer = VQAScorer()
    total_score = total = 0
    results = []
    for row in tqdm(dataset, disable=debug, desc="TextVQA"):
        enc = model.encode_image(row["image"])
        question = PREFIX_TEXTVQA + row["question"]
        model_answer = model.query(enc, question)["answer"]
        score = scorer.compute_score(model_answer, row["answers"])
        total_score += score
        total += 1
        results.append(
            {
                "question": question,
                "ground_truth": row["answers"],
                "model_answer": model_answer,
                "score": score,
            }
        )

    return {"score": total_score * 100 / total, "results": results}


if __name__ == "__main__":
    from .common import run_cli

    run_cli(eval_textvqa, lambda r: print(f"Score: {r['score']}"))
