"""TallyQA: simple/full counting accuracy
(moondream_tpu/eval/tallyqa.py, on the port's model)."""

from tqdm import tqdm

PREFIX = (
    "Look at the image carefully and count the objects. "
    "Answer with just a number, without any additional text. "
)


def eval_tallyqa(model, debug=False):
    import datasets

    dataset = datasets.load_dataset("vikhyatk/tallyqa-test", split="test")

    total = total_simple = correct = correct_simple = 0
    for row in tqdm(dataset, disable=debug, desc="TallyQA"):
        enc = model.encode_image(row["image"])
        for qa in row["qa"]:
            question = PREFIX + qa["question"]
            answer = str(qa["answer"])
            model_answer = model.query(enc, question)["answer"]
            ok = model_answer.strip().lower() == answer.strip().lower()
            total += 1
            correct += ok
            if qa["is_simple"]:
                total_simple += 1
                correct_simple += ok

    return {
        "simple_acc": correct_simple * 100 / total_simple,
        "full_acc": correct * 100 / total,
    }


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        eval_tallyqa,
        lambda r: print(
            f"Simple acc: {r['simple_acc']:.2f}\nFull acc: {r['full_acc']:.2f}"
        ),
    )
