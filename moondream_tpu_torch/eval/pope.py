"""POPE object-hallucination probe: yes/no accuracy over the random /
popular / adversarial splits (moondream_tpu/eval/pope.py, on the port's model)."""

from tqdm import tqdm


def evaluate_pope(model, debug=False):
    from datasets import load_dataset

    dataset = load_dataset("vikhyatk/POPE", split="test")

    stats = {s: [0, 0] for s in ("random", "popular", "adversarial")}
    for row in tqdm(dataset, disable=debug, desc="POPE"):
        enc = model.encode_image(row["image"])
        for split in ("adversarial", "popular", "random"):
            for qa in row[split]:
                prompt = f"{qa['question']}\nAnswer yes or no."
                model_answer = model.query(enc, prompt)["answer"].strip()
                stats[split][0] += model_answer.lower() == qa["answer"].lower()
                stats[split][1] += 1

    return {s: c * 100.0 / n for s, (c, n) in stats.items()}


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        evaluate_pope,
        lambda r: print(
            f"Random Accuracy: {r['random']:.2f}\n"
            f"Popular Accuracy: {r['popular']:.2f}\n"
            f"Adversarial Accuracy: {r['adversarial']:.2f}"
        ),
    )
