"""The plain reference against the port's plain CPU path, and the harness's
runs on the CPU at a tiny size: a sound run comes out correct, a run with
the timed path broken underneath does not, and the fp8 control is not
correct.

These runs skip the harness's look for a card: `run_cell(device="cpu")`
drives the rest of a run (the cell's driver, the window, the reference
check) on the tiny test configuration with lighter traffic."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import harness, weights  # noqa: E402
from gpubench.reference import plain  # noqa: E402
from moondream_tpu_torch.config import tiny_test_config  # noqa: E402

TINY = tiny_test_config().to_dict()
SEED = 2 ** 31 + 4242
LIGHT = {
    "md2b-serve-caption": {"rate_per_s": 3.0, "warm_s": 1.0, "output_tokens": [8, 24],
                           "timeout_s": 20.0},
    "md05b-batch-caption": {"output_tokens": 8, "stream": 200},
}
# the serve driver's query requests, on the caption cell
QUERY = {"rate_per_s": 4.0, "warm_s": 1.0, "sample": 6, "timeout_s": 20.0, "request": "query",
         "output_tokens": [1, 16], "question_tokens": [4, 16], "end_to_end": []}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # host crops (the native library) and few threads: the CPU stands in for the card
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    yield
    torch.set_num_threads(threads)


def _run(cell, seconds=2.0, dtype="float32", control=False, seed=SEED, over=None):
    return harness.run_cell(cell, seed, seconds, False, device="cpu",
                            cell_overrides=over or LIGHT[cell],
                            cfg_overrides={"model": TINY, "dtype": dtype}, control=control)


# ------------------------------------------------- reference vs the program

def test_reference_matches_the_programs_plain_path():
    cfg = {"model": TINY, "dtype": "float32"}
    model = harness.build_model(cfg, SEED, torch.device("cpu"), "float32")
    ref = plain.Model(TINY, weights.Leaves(TINY, SEED, "cpu", torch.float32), "cpu")
    image = np.random.default_rng(1).integers(0, 256, (600, 800, 3), dtype=np.uint8)
    with torch.no_grad():
        got = model._run_vision_encoder(image).float()
        want = ref.image_embedding(image)
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
        prompt = TINY["tokenizer"]["templates"]["caption"]["normal"]
        enc = model.encode_image(image)
        kv = model.load_encoded_image(enc)
        logits, _, first, _, _ = model._prefill_prompt(kv, prompt, enc.pos, 0.0, 0.0)
        ref_logits = ref.sequence_logits(image, prompt, [int(first)])[0]
    # the program rounds its logits through bf16
    assert torch.allclose(logits, ref_logits, rtol=2 ** -8, atol=1e-4)
    assert plain.gaps(ref_logits[None], [int(first)], [])[0] <= 2 ** -7 * ref_logits.abs().max()


def test_reference_crops_are_pillows():
    from PIL import Image

    img = np.random.default_rng(2).integers(0, 256, (378, 378, 3), dtype=np.uint8)
    crops, tiling = plain.overlap_crops(img, TINY["vision"])
    assert tiling == (1, 1) and crops.shape == (2, 378, 378, 3)
    assert np.array_equal(crops[0], np.asarray(Image.fromarray(img).resize(
        (378, 378), resample=Image.Resampling.LANCZOS)))


# ------------------------------------------------------------ sound runs

@pytest.mark.parametrize("cell, over", [(c, None) for c in sorted(LIGHT)] + [
    ("md2b-serve-caption", QUERY)], ids=sorted(LIGHT) + ["query-requests"])
def test_a_sound_run_is_correct(cell, over):
    out = _run(cell, over=over)
    assert out["correct"], out["checks"]
    assert out["readings"]["gap"] < 0.02  # fp32 against fp32: the program's bf16 logits


# ------------------------------------------------------- the broken program

def _alter_tokens(monkeypatch):
    """A token altered where it is produced: every sampled id moves by one."""
    from moondream_tpu_torch.engine import batched, serving

    for mod in (serving, batched):
        orig = mod.sample_tokens_batched

        def shifted(logits, *a, _orig=orig, **kw):
            return (_orig(logits, *a, **kw) + 1) % logits.shape[-1]

        monkeypatch.setattr(mod, "sample_tokens_batched", shifted)


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged: once the window opens, the
    pool's chunk and the lockstep decode step leave their state as they
    found it (set-up's own requests would otherwise never end)."""
    from moondream_tpu_torch.engine import generate, serving

    broken = {"on": False}
    chunk, step = serving.serve_chunk, generate.answer_step

    def frozen_chunk(model, kv, cur, pos, active, budget, *a, chunk, **kw):
        if not broken["on"]:
            return chunk_fn(model, kv, cur, pos, active, budget, *a, chunk=chunk, **kw)
        z = torch.zeros((cur.shape[0], chunk), dtype=torch.int32, device=cur.device)
        return serving.ServeChunkResult(tokens=z, emitted=z.bool(), active=active, pos=pos,
                                        cur=cur, budget=budget)

    chunk_fn = chunk
    open_window = harness.Run.open_window

    def opened(self, t0):
        open_window(self, t0)
        broken["on"] = True

    monkeypatch.setattr(serving, "serve_chunk", frozen_chunk)
    monkeypatch.setattr(generate, "answer_step",
                        lambda model, kv, st, *a, **kw: st if broken["on"] else step(
                            model, kv, st, *a, **kw))
    monkeypatch.setattr(harness.Run, "open_window", opened)


def _half_batch(monkeypatch):
    """Half of the batch left out: the lockstep decode's second half of rows
    takes the first half's tokens."""
    from moondream_tpu_torch.engine import batched, pipeline

    orig = batched.generate_text_batched

    def half(*a, **kw):
        res = orig(*a, **kw)
        toks = res.tokens.clone()
        h = toks.shape[0] // 2
        toks[h:2 * h] = toks[:h]
        return res._replace(tokens=toks)

    monkeypatch.setattr(batched, "generate_text_batched", half)
    monkeypatch.setattr(pipeline.batched_engine, "generate_text_batched", half)


@pytest.mark.parametrize("cell, fault", [
    ("md2b-serve-caption", _alter_tokens),
    ("md2b-serve-caption", _unchanged_state),
    ("md05b-batch-caption", _alter_tokens),
    ("md05b-batch-caption", _unchanged_state),
    ("md05b-batch-caption", _half_batch),
], ids=["serve-altered-token", "serve-unchanged-state", "batch-altered-token",
        "batch-unchanged-state", "batch-half-left-out"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    over = dict(LIGHT[cell])
    if cell.startswith("md2b-serve"):
        over["timeout_s"] = 4.0
    if cell.startswith("md05b"):
        over["sample"] = 8  # a whole batch: the left-out half is in it
    # the batch cells' window holds batches dispatched after the fault is on
    seconds = 6.0 if cell.startswith("md05b") else 2.0
    out = harness.run_cell(cell, SEED, seconds, False, device="cpu", cell_overrides=over,
                           cfg_overrides={"model": TINY, "dtype": "float32"})
    assert not out["correct"], out["checks"]


# ------------------------------------------------------------- the control

def test_the_control_is_not_correct():
    """The fp8 control (the reference with every linear on e4m3 operands)
    over the served tokens of a sound bf16 run, on three seeds, at the tiny
    widths with the published vocabulary (51200 ids, so that near ties are
    as common as at full size): its widest gap exceeds the batch cell's
    limit, which the program's stays under, and reads at least three times
    the program's widest (the same rule that set the limit on the card)."""
    tiny = tiny_test_config(vocab_size=51200).to_dict()
    limit = harness.load_cell("md05b-batch-caption")[0]["limits"]["gap"]
    prog, ctl = [], []
    for seed in (11, 12, 13):
        out = harness.run_cell("md05b-batch-caption", seed, 12.0, False, device="cpu",
                               cell_overrides={"output_tokens": 64, "stream": 200, "sample": 8},
                               cfg_overrides={"model": tiny, "dtype": "bfloat16"}, control=True)
        prog.append(out["readings"]["gap"])
        ctl.append(out["readings"]["control_gap"])
    assert max(prog) <= limit < min(ctl), (prog, ctl, limit)
    assert min(ctl) >= 3 * max(prog), (prog, ctl)
