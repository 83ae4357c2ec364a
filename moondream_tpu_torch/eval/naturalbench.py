"""NaturalBench: acc / image-acc / question-acc / group-acc over
(2 images x 2 questions) groups
(moondream_tpu/eval/naturalbench.py, on the port's model)."""

from tqdm import tqdm


def eval_naturalbench(model, debug=False):
    from datasets import load_dataset

    # The benchmark test set is stored in the 'train' split upstream.
    dataset = load_dataset("BaiqiL/NaturalBench", split="train")

    acc, q_acc, i_acc, g_acc = [], [], [], []
    for row in tqdm(dataset, disable=debug, desc="NaturalBench"):
        suffix = " Answer yes or no." if row["Question_Type"] == "yes_no" else ""

        images = [row["Image_0"], row["Image_1"], row["Image_0"], row["Image_1"]]
        prompts = [
            row["Question_0"] + suffix,
            row["Question_0"] + suffix,
            row["Question_1"] + suffix,
            row["Question_1"] + suffix,
        ]
        expected = [
            row["Image_0_Question_0"].strip().lower(),
            row["Image_1_Question_0"].strip().lower(),
            row["Image_0_Question_1"].strip().lower(),
            row["Image_0_Question_1"].strip().lower(),
        ]

        answers = []
        for img, prompt in zip(images, prompts):
            enc = model.encode_image(img)
            answers.append(model.query(enc, prompt)["answer"].strip().lower())

        ok = [a == e for a, e in zip(answers, expected)]
        acc.extend(ok)
        i_acc.extend([ok[0] and ok[2], ok[1] and ok[3]])
        q_acc.extend([ok[0] and ok[1], ok[2] and ok[3]])
        g_acc.append(all(ok))

    return {
        "overall_acc": sum(acc) / len(acc),
        "image_acc": sum(i_acc) / len(i_acc),
        "question_acc": sum(q_acc) / len(q_acc),
        "group_acc": sum(g_acc) / len(g_acc),
    }


if __name__ == "__main__":
    from .common import run_cli

    run_cli(
        eval_naturalbench,
        lambda r: print(
            f"Overall Accuracy: {r['overall_acc']:.4f}\n"
            f"Image Accuracy: {r['image_acc']:.4f}\n"
            f"Question Accuracy: {r['question_acc']:.4f}\n"
            f"Group Accuracy: {r['group_acc']:.4f}"
        ),
    )
