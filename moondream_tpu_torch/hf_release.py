"""Push a checkpoint to the Hugging Face hub (moondream_tpu/hf_release.py).

Run: python -m moondream_tpu_torch.hf_release --model ckpt.safetensors --repo you/name
"""

import argparse


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--repo", type=str, required=True)
    args = parser.parse_args()

    from huggingface_hub import HfApi

    api = HfApi()
    api.create_repo(args.repo, exist_ok=True)
    api.upload_file(
        path_or_fileobj=args.model,
        path_in_repo="model.safetensors",
        repo_id=args.repo,
    )
    if args.config:
        api.upload_file(
            path_or_fileobj=args.config,
            path_in_repo="config.json",
            repo_id=args.repo,
        )
    print(f"pushed {args.model} to {args.repo}")


if __name__ == "__main__":
    main()
