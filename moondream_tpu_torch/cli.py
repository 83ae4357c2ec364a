"""CLI: a demo of every capability, and a benchmark mode
(moondream_tpu/cli.py).

    python -m moondream_tpu_torch.cli --image x.jpg --prompt "..." --model ckpt.safetensors
    python -m moondream_tpu_torch.cli --demo [--benchmark] [--device cpu]

Captions (short and normal), a query, a reasoning query, detect (with a box
overlay), a spatial-ref query, point (with a dot overlay) and gaze, each
streamed where the JAX package streams it; `--benchmark` reports image
encode ms and streamed query tokens/s (5 warm-ups, 10 timed runs). The
model runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", "-i", type=str, default=None)
    parser.add_argument("--prompt", "-p", type=str, default=None)
    parser.add_argument("--demo", action="store_true",
                        help="run every capability once on --image (or a generated test "
                             "image); no prompt needed")
    parser.add_argument("--model", "-m", type=str, default=None,
                        help="checkpoint path (omit for random weights)")
    parser.add_argument("--config", "-c", type=str, default=None)
    parser.add_argument("--tokenizer", type=str, default=None)
    parser.add_argument("--max-tokens", "-t", type=int, default=200)
    parser.add_argument("--sampler", "-s", type=str, default="greedy")
    parser.add_argument("--benchmark", "-b", action="store_true")
    parser.add_argument("--int4", action="store_true",
                        help="text weights packed int4 through the W4A16 kernel")
    parser.add_argument("--int8-text", action="store_true",
                        help="text weights as int8 w8a8 (the int8 tensor-core kernels)")
    parser.add_argument("--kv-int8", action="store_true",
                        help="the KV cache as int8 codes and per-row scales")
    parser.add_argument("--spec", type=int, default=0, metavar="K",
                        help="speculative greedy decoding with K-token n-gram drafts "
                             "(outputs equal plain greedy's)")
    parser.add_argument("--int8-vision", action="store_true",
                        help="the ViT block matmuls in int8 w8a8, activations quantized "
                             "per row at run time")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu' (the "
                             "kernels' plain versions)")
    return parser


def build_model(args):
    """The model the arguments describe: a checkpoint or random weights,
    quantized as asked, on args.device."""
    from .finetune import resolve_config
    from .models.moondream import MoondreamModel
    from .tokenizer import load_tokenizer
    from .weights import load_params

    config = resolve_config(args.config)  # None/'2b'/'05b'/'tiny' or a JSON path
    if args.kv_int8:
        config = dataclasses.replace(config, text=dataclasses.replace(config.text, kv_int8=True))
    params = (load_params(args.model, config, runtime_int4=args.int4,
                          runtime_int8=args.int8_text, device=args.device)
              if args.model else None)
    model = MoondreamModel(config, params=params, tokenizer=load_tokenizer(args.tokenizer),
                           device=args.device)
    if params is None and (args.int4 or args.int8_text):
        # random weights: quantize the freshly drawn text blocks
        from .models.text import quantize_text_params, quantize_text_params_int8

        (quantize_text_params if args.int4 else quantize_text_params_int8)(model.text)
    if args.int8_vision:
        from .models.vision import quantize_vision_params

        quantize_vision_params(model.vision)
    return model


def demo_image():
    """The generated test image: noise with a white square to find."""
    import numpy as np

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
    arr[160:320, 220:420] = (250, 250, 250)
    return arr


def _stream(chunks) -> None:
    for t in chunks:
        print(t, end="", flush=True)
    print("\n")


def main():
    parser = _parser()
    args = parser.parse_args()

    import torch

    from .weights import checked_device

    device = checked_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Device: {device} ({name})")
    model = build_model(args)

    if args.image:
        if not os.path.exists(args.image):
            raise FileNotFoundError(f"Image not found at {args.image}")
        from PIL import Image

        image = Image.open(args.image)
    elif args.demo:
        image = demo_image()
        print("(no --image given: using a generated test image)")
    else:
        parser.error("--image is required unless --demo is given")

    if args.prompt is None:
        if not args.demo:
            parser.error("--prompt is required unless --demo is given")
        args.prompt = "What is the white shape in this image?"

    settings = {"max_tokens": args.max_tokens}
    if args.sampler == "greedy":
        settings["temperature"] = 0.0
    if args.spec:
        settings["speculative"] = args.spec

    if args.benchmark:
        _benchmark(model, image, args.prompt, settings)
        return

    encoded_image = model.encode_image(image)

    for length in ("short", "normal"):
        print(f"Caption: {length}")
        _stream(model.caption(encoded_image, length, stream=True, settings=settings)["caption"])

    print("Query:", args.prompt)
    _stream(model.query(encoded_image, args.prompt, stream=True, settings=settings)["answer"])

    reasoning_prompt = "How many objects are in this image?"
    print("Query (reasoning):", reasoning_prompt)
    resp = model.query(encoded_image, reasoning_prompt, reasoning=True, stream=True,
                       settings=settings)
    print("Reasoning:", resp["reasoning"])
    _stream(resp["answer"])

    obj = "object"
    print(f"Detect: {obj}")
    objs = model.detect(encoded_image, obj)["objects"]
    print(f"Found {len(objs)}")
    from PIL import Image, ImageDraw

    img = image if isinstance(image, Image.Image) else Image.fromarray(image)
    draw = ImageDraw.Draw(img)
    for o in objs:
        draw.rectangle([o["x_min"] * img.width, o["y_min"] * img.height,
                        o["x_max"] * img.width, o["y_max"] * img.height],
                       outline="red", width=2)
    img.save("detect.jpg")

    if objs:
        print("Spatial query: What is this?")
        box = (objs[0]["x_min"], objs[0]["y_min"], objs[0]["x_max"], objs[0]["y_max"])
        _stream(model.query(encoded_image, "What is this?", spatial_refs=[box], stream=True,
                            settings=settings)["answer"])

    print("Point: object")
    points = model.point(encoded_image, "object")["points"]
    print(f"Found {len(points)}")
    for p in points:
        x, y = p["x"] * img.width, p["y"] * img.height
        draw.ellipse([x - 5, y - 5, x + 5, y + 5], fill="red")
    img.save("point.jpg")

    print("Gaze:", model.detect_gaze(encoded_image, (0.5, 0.5))["gaze"])


def _benchmark(model, image, prompt, settings) -> dict:
    """Image encode ms (to the card's last kernel) and the streamed query's
    rate over 10 runs after 5 warm-ups. The rate counts the chunks the
    stream yields, as the reference and the JAX package count them (words,
    not tokens: the stream flushes on word boundaries). Prints both blocks
    and returns {"encode_ms", "query_s", "chunks", "chunks_per_s"}, one
    entry per timed run."""
    import torch

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    for _ in range(5):
        encoded_image = model.encode_image(image)
        for _ in model.query(encoded_image, prompt, stream=True, settings=settings)["answer"]:
            pass

    encode_times, query_speeds, counts, seconds = [], [], [], []
    for _ in range(10):
        sync()
        t0 = time.perf_counter()
        encoded_image = model.encode_image(image)
        sync()
        encode_times.append((time.perf_counter() - t0) * 1000)

        tokens = []
        t0 = time.perf_counter()
        for t in model.query(encoded_image, prompt, stream=True, settings=settings)["answer"]:
            tokens.append(t)
        dt = time.perf_counter() - t0
        query_speeds.append(len(tokens) / dt if dt > 0 else 0.0)
        counts.append(len(tokens))
        seconds.append(dt)

    print("\nBenchmark Results (10 runs):")
    print("Image Encoding Time (ms):")
    print(f"  Mean: {sum(encode_times)/len(encode_times):.2f}")
    print(f"  Min:  {min(encode_times):.2f}")
    print(f"  Max:  {max(encode_times):.2f}")
    print("\nQuery Speed (tokens/sec; streamed chunks):")
    print(f"  Mean: {sum(query_speeds)/len(query_speeds):.2f}")
    print(f"  Min:  {min(query_speeds):.2f}")
    print(f"  Max:  {max(query_speeds):.2f}")
    return {"encode_ms": encode_times, "query_s": seconds, "chunks": counts,
            "chunks_per_s": query_speeds}


if __name__ == "__main__":
    main()
