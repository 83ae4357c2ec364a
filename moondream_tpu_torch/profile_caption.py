"""Where the time of the 2B caption path, of another decode loop, or of one
serving-pool chunk, goes on one CUDA card.

    python3 -m moondream_tpu_torch.profile_caption [--tokens 64] [--top 12]
        [--int4 | --int8-text] [--int8-vision dynamic|static] [--kv-int8]
        [--gqa] [--loop spec|reasoning|detect]
        [--pool plain|shared|spec|mixed] [--pipeline] [--eager] [--crops]
        [--train] [--bucket-elements N]

Builds MOONDREAM_2B with seeded random weights on the card (with --int4, the
text blocks quantized to int4; with --int8-text, to the int8 w8a8 format;
with --int8-vision, the ViT blocks to int8 with dynamic activation codes,
or static ones calibrated on the normalized crops of the profiled image;
with --kv-int8, an int8 KV cache; with --gqa, 8 KV heads for the 32 query
heads) and runs the path
once to warm it (which captures the answer loop's CUDA graphs). Then it
profiles, with torch.profiler, one `encode_image` of a seeded 756x1008 image
(13 crops) and one greedy `caption` of up to `--tokens` tokens from that
encoding, whose decode runs replay the graphs. For each it prints the wall
time (host clock, after synchronising; the profiler adds host time), the
device's busy time (the union of its kernel and copy intervals), the idle
share 1 - busy / wall, the device launches it saw beside the CUDA graph
replays (engine/graphs.py), and the device kernels that took the most time,
with their launch counts. --eager runs the decode steps from Python instead
(no graphs), for comparison.

With --loop, the profiled call after the encode is another loop's, warmed
the same way: a speculative caption (k 8, up to --tokens tokens), a query
with reasoning (up to --tokens tokens in each phase) or a detect of up to
50 objects.

With --pool, it profiles instead one `step()` (one 8-step chunk, token
read-back included) of a ContinuousBatchingEngine with 8 slots of 1024,
after a warm-up chunk of the same pool (which captures the chunk's graph,
replayed by the profiled one): every slot decoding a caption of that image
(eos off), plain, prefix-shared (4 prefix entries) or speculative (k 8,
`spec`); or (`mixed`) four caption rows beside two detect, a point and a
gaze row (the mixed chunk).

With --pipeline, it profiles instead a BatchPipeline (engine/pipeline.py,
batch 8, up to --tokens tokens) over 16 seeded images of three sizes
(two batches), then the same images through encode_images + caption_batch
per batch of 8, each after a warm-up run of itself.

With --crops, it builds no model and profiles instead 20 calls of the
device crop kernel (`ops.device_preprocess.device_overlap_crops_batched`)
on seeded 756x1008 images (13 crops each) at batch 1 and batch 8, and
prints each device kernel's time per call and per launch beside the
launches that LAUNCHES counted; then the kernel's device-only µs per call
(20 calls from a CUDA graph) under the default tile plan and under other
(TH, TW, chunk rows) for both crop sets, at both batches.

With --train, it builds the 2B text model alone (bf16, seeded, 24 layers)
in an NCCL process group of one rank and profiles one training step of a
seeded 2 x 768 batch (labels and label_mask > 0.3, as the smoke's "4 2B
multi-GPU training") on each path in turn: the unsharded
`finetune.trainer.make_train_step`, GPipe at pp 1 x dp 1 over 2
microbatches (`parallel.pipeline.make_pp_train_step`), and the dp 1 x tp 1
and dp 1 x sp 1 steps; each after 2 warm steps, then 5 timed steps (median
ms, host clock). Beside the report it prints the host time of the
collectives' calls (torch.profiler's `c10d::` and `nccl:` CPU events: calls
and µs per call) and the collectives per step (`comm.COLLECTIVES`).
`--bucket-elements N` sets how many fp32 elements `parallel.grad.
sum_gradients` packs into one collective (1: one collective per leaf).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import MOONDREAM_2B
from .engine import graphs
from .engine.pipeline import BatchPipeline
from .models.moondream import MoondreamModel
from .models.serve import ContinuousBatchingEngine
from .models.text import quantize_text_params, quantize_text_params_int8
from .models.vision import collect_vision_act_stats, normalize_crops, quantize_vision_params
from .tokenizer import ByteTokenizer
from .weights import init_params


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def report(label: str, fn, top: int, calls: int = 0, cpu_events=None) -> list:
    """Profile one run of `fn` and print its wall time, busy time, idle share,
    the host's kernel launch calls and top kernels; with `calls`, also each
    kernel's µs per call and per launch when `fn` makes that many calls;
    with `cpu_events` (a dict of [µs, count]), add to it the host events of
    the collectives (names starting "c10d::" or "nccl:"). Returns the
    device events as (start µs, end µs, name), in order of start."""
    replays = sum(graphs.REPLAYS.values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, per_kernel = [], defaultdict(lambda: [0.0, 0])
    host_launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            host_launches += e.name == "cudaLaunchKernel"
            if cpu_events is not None and e.name.startswith(("c10d::", "nccl:")):
                cpu_events[e.name][0] += e.time_range.end - e.time_range.start
                cpu_events[e.name][1] += 1
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t, e.name))
        per_kernel[e.name][0] += t - s
        per_kernel[e.name][1] += 1
    if not spans:
        raise RuntimeError("torch.profiler recorded no device events")
    spans.sort()
    busy_ms = _busy_us([span[:2] for span in spans]) / 1e3
    print(f"== {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, device launches {len(spans)}, "
          f"cudaLaunchKernel calls {host_launches}, "
          f"graph replays {sum(graphs.REPLAYS.values()) - replays}")
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in ranked[:top]:
        per = f"  {us / calls:8.2f} us per call, {us / n:8.2f} per launch" if calls else ""
        print(f"  {us / 1e3:9.2f} ms  n={n:6d}{per}  {name[:100]}")
    return spans


def graph_us(fn, reps: int = 20) -> float:
    """Device-only µs of one call: `reps` calls captured in one CUDA graph,
    replayed between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) * 1e3 / reps


# (TH, TW, chunk rows) of the --crops sweep, every set's alike
CROP_PLANS = ((32, 64, 32), (32, 64, 16), (32, 64, 8), (16, 64, 16), (8, 64, 16), (16, 32, 16),
              (8, 32, 16))


def profile_crops(top: int) -> None:
    """--crops: 20 calls of the crop kernel at 756x1008, batch 1 and 8, then
    its device-only time under each plan of CROP_PLANS."""
    from .kernels import preprocess as kp
    from .kernels.build import LAUNCHES
    from .kernels.preprocess import LANCZOS
    from .ops import device_preprocess as devpre

    rng = np.random.default_rng(0)
    tiling = devpre.preprocess_tiling(756, 1008, 378, 14, 4, 12)
    per_image = tiling[0] * tiling[1] + 1
    for bsz in (1, 8):
        x = torch.from_numpy(rng.integers(0, 256, (bsz, 756, 1008, 3), dtype=np.uint8)).cuda()
        out = torch.empty((bsz * per_image, 378, 378, 3), dtype=torch.uint8, device="cuda")
        call = lambda: devpre.device_overlap_crops_batched(x, tiling, out=out)  # noqa: E731
        call()  # builds the kernel
        before = LAUNCHES[LANCZOS]
        spans = report(f"crops, batch {bsz} x 756x1008 ({per_image} crops each), 20 calls",
                       lambda: [call() for _ in range(20)], top, calls=20)
        per_call = (LAUNCHES[LANCZOS] - before) // 20
        print(f"  {LANCZOS} launches per call: {per_call}")
        if len(spans) != 20 * per_call:
            raise RuntimeError(f"{len(spans)} device events for {20 * per_call} launches")
        for i in range(per_call):  # the i-th launch of each call, in launch order
            mine = spans[i::per_call]
            us = sum(e - s for s, e, _ in mine) / len(mine)
            name = mine[0][2].replace("(anonymous namespace)::", "").split("(")[0]
            print(f"  launch {i + 1} of {per_call}: {us:.2f} us, {name}")
        sets = devpre.overlap_sets(tiling)
        print(f"  default plan {devpre.tile_plan(756, 1008, sets)}: "
              f"device only {graph_us(call):.2f} us per call")
        host = [(s.size, *devpre.set_bands(756, 1008, s, "cpu")) for s in sets]
        bands = [devpre.set_bands(756, 1008, s, x.device) for s in sets]
        for th, tw, ring in CROP_PLANS:
            plan = kp.plan_crops(host, tile=(th, tw), ring_rows=ring)
            us = graph_us(lambda: kp.lanczos_crops(x, out, sets, bands, (378, 378), per_image,
                                                   plan))
            print(f"  plan TH {th} TW {tw} chunks of {ring} rows ({plan.smem} bytes): {us:.2f} us")


def profile_train(top: int, device: str = "cuda") -> None:
    """--train: one profiled step of each training path at world 1 over
    NCCL (see the module docstring); `device` "cpu" runs the same paths
    over gloo (a rehearsal: the profile then has no device events)."""
    import torch.distributed as dist

    from .finetune import trainer
    from .parallel import comm
    from .parallel.mesh import create_mesh, shard_batch, shard_text_model
    from .parallel.pipeline import make_pp_train_step, shard_params_pp

    tc = MOONDREAM_2B.text
    gen = torch.Generator(device).manual_seed(0)
    text = init_params(MOONDREAM_2B, gen, device, torch.bfloat16)["text"]
    b, t = 2, 768
    batch = {
        "inputs_embeds": torch.randn(b, t, tc.dim, generator=gen, device=device).bfloat16(),
        "labels": torch.randint(0, tc.vocab_size, (b, t), generator=gen, device=device),
        "label_mask": (torch.rand(b, t, generator=gen, device=device) > 0.3).float(),
    }
    meshes = {"pp": create_mesh({"pp": 1, "dp": 1}, device=device)}
    want = "nccl" if device == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(f"profile_caption --train: backend {dist.get_backend()}, not {want}")
    meshes["tp"] = create_mesh({"dp": 1, "tp": 1}, device=device)
    meshes["sp"] = create_mesh({"dp": 1, "sp": 1}, device=device)
    opt = trainer.make_optimizer(lr=1e-5)
    paths = {
        "unsharded": (text, trainer.make_train_step(opt), batch),
        "pp 1 x dp 1, M 2": (shard_params_pp(text, meshes["pp"]),
                             make_pp_train_step(opt, tc, meshes["pp"], 2), batch),
        "dp 1 x tp 1": (shard_text_model(text, meshes["tp"]), trainer.make_train_step(opt),
                        shard_batch(batch, meshes["tp"])),
        "dp 1 x sp 1": (text, trainer.make_train_step(opt),
                        shard_batch(batch, meshes["sp"], seq_axis="sp")),
    }
    try:
        for label, (model, step, data) in paths.items():
            box = [trainer.init_train_state(model, opt)]

            def one():
                box[0], loss = step(box[0], data)
                return loss

            for _ in range(2):
                one()
            ms = []
            comm.reset_collective_counts()
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            colls = {k: v // 5 for k, v in comm.COLLECTIVES.items() if v}
            print(f"-- {label}: {sorted(ms)[2]:.1f} ms per step (median of 5, host clock), "
                  f"collectives per step {colls}")
            host = defaultdict(lambda: [0.0, 0])
            report(f"train step, {label}", one, top, cpu_events=host)
            for name, (us, n) in sorted(host.items()):
                print(f"  host {name}: {n} calls, {us / n:.1f} us per call, {us / 1e3:.2f} ms")
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    fmt = ap.add_mutually_exclusive_group()
    fmt.add_argument("--int4", action="store_true", help="int4 text block weights")
    fmt.add_argument("--int8-text", action="store_true", help="int8 w8a8 text block weights")
    ap.add_argument("--int8-vision", choices=("dynamic", "static"),
                    help="int8 ViT blocks, dynamic or calibrated static activation codes")
    ap.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    ap.add_argument("--gqa", action="store_true", help="8 KV heads (GQA)")
    ap.add_argument("--loop", choices=("spec", "reasoning", "detect"),
                    help="profile this loop's call instead of a plain caption")
    ap.add_argument("--pool", choices=("plain", "shared", "spec", "mixed"),
                    help="profile one chunk of an 8-slot serving pool instead")
    ap.add_argument("--pipeline", action="store_true",
                    help="profile a BatchPipeline run against encode_images + caption_batch")
    ap.add_argument("--eager", action="store_true",
                    help="decode steps from Python, without CUDA graphs")
    ap.add_argument("--crops", action="store_true",
                    help="profile the device crop kernel alone (no model)")
    ap.add_argument("--train", action="store_true",
                    help="profile a 2B training step of each path at world 1 over NCCL")
    ap.add_argument("--bucket-elements", type=int,
                    help="with --train: fp32 elements per gradient-sum collective")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_caption: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip())
    if args.crops:
        profile_crops(args.top)
        return
    if args.train:
        from .parallel import grad

        if args.bucket_elements:
            grad.BUCKET_ELEMENTS = args.bucket_elements
        print(f"gradient sums: at most {grad.BUCKET_ELEMENTS} fp32 elements per collective")
        profile_train(args.top)
        return

    cfg = MOONDREAM_2B
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, kv_int8=args.kv_int8, n_kv_heads=8 if args.gqa else cfg.text.n_kv_heads))
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    if args.int4:
        quantize_text_params(params["text"])
    elif args.int8_text:
        quantize_text_params_int8(params["text"])
    model = MoondreamModel(
        cfg, params, tokenizer=ByteTokenizer(), dtype=torch.bfloat16, seed=0,
        device="cuda", graphed=not args.eager,
    )
    img = np.random.default_rng(0).integers(0, 256, (756, 1008, 3), dtype=np.uint8)
    if args.int8_vision:
        stats = None
        if args.int8_vision == "static":
            crops = torch.from_numpy(model._crops(img)[0]).to("cuda")
            stats = collect_vision_act_stats(normalize_crops(crops, torch.bfloat16), model.vision)
        quantize_vision_params(model.vision, stats)
    greedy = {"temperature": 0.0, "max_tokens": args.tokens}
    if args.pipeline:
        rng = np.random.default_rng(1)
        images = [rng.integers(0, 256, shape, dtype=np.uint8)
                  for shape in [(756, 1008, 3), (378, 378, 3), (600, 800, 3)] * 6][:16]
        pipe = BatchPipeline(model, batch_size=8)  # the model's EOS, as caption_batch

        def serial():
            for start in range(0, len(images), 8):
                model.caption_batch(model.encode_images(images[start:start + 8]), "normal",
                                    settings=greedy)

        for name, call in ((f"BatchPipeline, 16 images, batch 8, {args.tokens} tokens",
                            lambda: pipe.caption(images, "normal", settings=greedy)),
                           ("encode_images + caption_batch, the same batches", serial)):
            call()  # warm
            report(name, call, args.top)
        return
    enc = model.encode_image(img)
    if args.pool:
        shared, mixed = args.pool == "shared", args.pool == "mixed"
        eng = ContinuousBatchingEngine(
            model, n_slots=8, slot_len=1024, chunk=8, eos_id=None if mixed else -1,
            prefix_share=shared, prefix_entries=4 if shared else None,
            speculative=8 if args.pool == "spec" else 0, graphed=not args.eager,
        )
        for max_tokens in (8, 32):  # a warm-up chunk, then the profiled pool
            for _ in range(4 if mixed else 8):
                eng.submit(enc, max_tokens=max_tokens)
            if mixed:
                eng.submit_detect(enc, "object")
                eng.submit_detect(enc, "thing")
                eng.submit_point(enc, "object")
                eng.submit_gaze(enc, (0.45, 0.3))
            eng.step()
            if mixed and max_tokens == 8:
                eng.drain()
        report(f"pool chunk ({args.pool}, 8 slots x 8 steps)", eng.step, args.top)
        eng.drain()
        return
    calls = {
        None: ("caption", lambda: model.caption(enc, "normal", settings=greedy)),
        "spec": ("speculative caption (k 8)", lambda: model.caption(
            enc, "normal", settings={**greedy, "speculative": 8})),
        "reasoning": ("query with reasoning", lambda: model.query(
            enc, "What is it?", reasoning=True, settings=greedy)),
        "detect": ("detect (<= 50 objects)", lambda: model.detect(enc, "object")),
    }
    name, call = calls[args.loop]
    call()  # warm

    report("encode_image", lambda: model.encode_image(img), args.top)
    report(f"{name} (greedy, <= {args.tokens} tokens)", call, args.top)


if __name__ == "__main__":
    main()
