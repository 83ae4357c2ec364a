"""The port's eval harness (moondream_tpu_torch/eval/) against the JAX
package's (moondream_tpu/eval/), on the CPU at tiny_test_config in fp32
with one tree (`params_from_jax`), IdTokenizer (equal text is equal ids),
peaked region decoders, 4 greedy tokens through the `_settings` override
of tests/test_eval_orchestration.py and at most 3 objects per detect.

Each of the twelve per-benchmark loops runs in both packages over the same
synthetic rows (`datasets` replaced by a stand-in module); half of the gold
answers and boxes are the JAX model's own, so every scoring branch counts
hits. The result dicts must be equal: strings, ints and bools exactly,
floats within 1e-6 absolute (box and gaze coordinates come from fp32
region heads). eval_all with `skip=` gives the same; `create_model` loads a
checkpoint written from the tree into the modules that `params_from_jax`
and the port's quantizers give; the eval CLIs run with --device cpu."""

import copy
import dataclasses
import functools
import json
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from moondream_tpu import config as jax_config
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import moondream as jax_moondream
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch import config as port_config
from moondream_tpu_torch.models import moondream as port_moondream
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

LOOPS = {  # module: (function, dataset path)
    "chartqa": ("eval_chartqa", "vikhyatk/chartqa"),
    "coco_map": ("eval_coco_map", "moondream/coco-val-2017-bbox-cleaned"),
    "countbenchqa": ("eval_countbenchqa", "vikhyatk/CountBenchQA"),
    "docvqa": ("eval_docvqa", "vikhyatk/docvqa-val"),
    "gazefollow": ("eval_gazefollow", "vikhyatk/gazefollow"),
    "mmstar": ("eval_mmstar", "Lin-Chen/MMStar"),
    "naturalbench": ("eval_naturalbench", "BaiqiL/NaturalBench"),
    "pope": ("evaluate_pope", "vikhyatk/POPE"),
    "realworldqa": ("eval_realworldqa", "lmms-lab/RealWorldQA"),
    "tallyqa": ("eval_tallyqa", "vikhyatk/tallyqa-test"),
    "textvqa": ("eval_textvqa", "vikhyatk/textvqa_val"),
    "waste_detection": ("eval_waste_detection", "moondream/waste_detection"),
}


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _eos7(cfg):
    """The tiny config with EOS id 7: gaze's force_detect puts token 0 in
    front of the EOS check (in both packages), so under the default EOS 0
    every GazeFollow prediction would be None."""
    return dataclasses.replace(cfg, tokenizer=dataclasses.replace(cfg.tokenizer, eos_id=7))


@functools.lru_cache(maxsize=None)
def _tree(seed=4):
    """The fp32 tree of both models (read only), region decoders' fc2 biases
    peaked (+ N(0, 1) x 50 from `seed`) so that detect finds objects; under
    seed 4 the boxes lie inside the image, as the recipes' box filter asks."""
    cfg = jax_config.tiny_test_config()
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    init = lambda fn, c, key: jax.jit(lambda k: fn(c, k, jnp.float32))(key)  # one compile
    tree = copy.deepcopy({
        "vision": init(jax_vision.init_vision_params, cfg.vision, kv),
        "text": init(jax_text.init_text_params, cfg.text, kt),
        "region": init(jax_region.init_region_params, cfg.region, kr),
    })
    rng = np.random.default_rng(seed)
    for site in ("coord_decoder", "size_decoder"):
        b = np.asarray(tree["region"][site]["fc2"]["b"])
        tree["region"][site]["fc2"]["b"] = jnp.asarray(
            b + rng.standard_normal(b.shape).astype(np.float32) * 50.0)
    return tree


@functools.lru_cache(maxsize=None)
def models():
    """(JAX model, port model) on one tree, both decoding 4 greedy tokens
    whatever the settings say; built once per process and shared with
    tests/test_torch_quant_drift.py and tests/test_torch_recipes.py (the
    JAX model's compiles dominate). Neither is changed by a test."""
    tree = _tree()
    port_cfg = _eos7(port_config.tiny_test_config())
    ref = JaxModel(_eos7(jax_config.tiny_test_config()), params=tree, tokenizer=IdTokenizer(),
                   dtype=jnp.float32)
    ours = MoondreamModel(port_cfg, params=params_from_jax(tree, port_cfg),
                          tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
    for m in (ref, ours):
        m._settings = lambda s: (4, 0.0, 0.0)
    return ref, ours


def small_budgets(mp):
    """JAX's host crops (the port's), and at most 3 objects per detect in
    both packages: the peaked decoders repeat one box up to the limit."""
    mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
    mp.setattr(jax_moondream, "DEFAULT_MAX_OBJECTS", 3)
    mp.setattr(port_moondream, "DEFAULT_MAX_OBJECTS", 3)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    small_budgets(mp)
    yield models()
    mp.undo()


def _img(seed, size):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (size[0], size[1], 3), np.uint8))


def _rows(ref):
    """{dataset path: rows} for every loop; the gold answers marked `own`
    are the JAX model's answers to the loop's exact prompt, the boxes its
    detections."""
    from moondream_tpu.eval import chartqa, countbenchqa, docvqa, mmstar, tallyqa, textvqa
    from moondream_tpu.eval.metrics import VQAScorer

    im = [_img(s, size) for s, size in enumerate([(64, 80), (96, 128), (120, 72), (80, 200)])]
    own = lambda image, prompt: ref.query(image, prompt)["answer"]
    det = lambda image, what: [(o["x_min"], o["y_min"], o["x_max"], o["y_max"])
                               for o in ref.detect(image, what)["objects"]]
    person, bottle = det(im[1], "person"), det(im[2], "bottle")
    assert person and bottle, "the peaked decoders find objects"
    w, h = im[1].width, im[1].height
    gaze = lambda hb, eye, target: {
        "head_bbox": dict(zip(("xmin", "ymin", "xmax", "ymax"), hb)),
        "eye": {"x": eye[0], "y": eye[1]}, "gaze": {"x": target[0], "y": target[1]}}
    return {
        "vikhyatk/chartqa": [{"image": im[0], "qa": [
            {"question": "what?", "source": "human",
             "answer": own(im[0], chartqa.PREFIX + "what?")},
            {"question": "which?", "source": "augmented", "answer": '["a", "b"]'}]}],
        "moondream/coco-val-2017-bbox-cleaned": [{"image": im[1], "objects": json.dumps({
            "bbox": [[b[0] * w, b[1] * h, (b[2] - b[0]) * w, (b[3] - b[1]) * h]
                     for b in person] + [[3.0, 4.0, 20.0, 30.0]],
            "label": [1] * len(person) + [3]})}],
        "vikhyatk/CountBenchQA": [
            {"image": im[0], "question": "how many?",
             "number": own(im[0], countbenchqa.PREFIX + "how many?")},
            {"image": im[3], "question": "how many cats?", "number": 7}],
        "vikhyatk/docvqa-val": [{"image": im[2], "qa": [
            {"question": "title?", "answers": ["x", own(im[2], "title?" + docvqa.SUFFIX)]},
            {"question": "date?", "answers": ["1999"]}]}],
        "vikhyatk/gazefollow": [{"image": im[1], "gazes": [
            gaze((0.1, 0.1, 0.3, 0.3), (0.2, 0.2), (0.6, 0.7)),
            gaze((0.1, 0.1, 0.3, 0.3), (0.2, 0.2), (0.5, 0.8)),
            gaze((0.6, 0.2, 0.8, 0.4), (0.7, 0.3), (0.1, 0.9))]}],
        "Lin-Chen/MMStar": [
            {"image": im[3], "question": "A or B?", "category": "c", "l2_category": "d",
             "answer": own(im[3], "A or B?" + mmstar.SUFFIX)},
            {"image": im[0], "question": "C or D?", "category": "c", "l2_category": "e",
             "answer": "C"}],
        "BaiqiL/NaturalBench": [{
            "Question_Type": "yes_no", "Image_0": im[0], "Image_1": im[2],
            "Question_0": "is it red?", "Question_1": "is it blue?",
            "Image_0_Question_0": own(im[0], "is it red? Answer yes or no."),
            "Image_1_Question_0": own(im[2], "is it red? Answer yes or no."),
            "Image_0_Question_1": "no", "Image_1_Question_1": "yes"}],
        "vikhyatk/POPE": [{"image": im[3],
                           "random": [{"question": "a dog?", "answer": "no"}],
                           "popular": [{"question": "a cat?",
                                        "answer": own(im[3], "a cat?\nAnswer yes or no.")}],
                           "adversarial": [{"question": "a car?", "answer": "yes"}]}],
        "lmms-lab/RealWorldQA": [
            {"image": im[1], "question": "where?", "answer": own(im[1], "where?")},
            {"image": im[2], "question": "when?", "answer": "now"}],
        "vikhyatk/tallyqa-test": [{"image": im[2], "qa": [
            {"question": "cars?", "answer": own(im[2], tallyqa.PREFIX + "cars?"),
             "is_simple": True},
            {"question": "dogs?", "answer": 3, "is_simple": False}]}],
        "vikhyatk/textvqa_val": [
            {"image": im[0], "question": "sign?",
             # as the scorer normalizes the answer when all ten agree
             "answers": [VQAScorer().process_answer(
                 own(im[0], textvqa.PREFIX_TEXTVQA + "sign?"))] * 10},
            {"image": im[3], "question": "brand?", "answers": ["acme"] * 6 + ["ajax"] * 4}],
        "moondream/waste_detection": [
            {"image": im[2], "labels": ["bottle"] * len(bottle) + ["can"],
             "boxes": [[(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, b[2] - b[0], b[3] - b[1]]
                       for b in bottle] + [[0.5, 0.5, 0.2, 0.2]]}],
    }


@pytest.fixture(scope="module")
def rows(pair):
    return _rows(pair[0])


@pytest.fixture
def datasets_stub(rows, monkeypatch):
    """`datasets` as a stand-in whose load_dataset returns the rows of the
    path asked for."""
    stub = types.ModuleType("datasets")
    stub.load_dataset = lambda path, split=None: list(rows[path])
    monkeypatch.setitem(sys.modules, "datasets", stub)
    return stub


def _same(got, want, where="result"):
    """Equal results: floats within 1e-6 absolute, all else exactly."""
    if isinstance(want, float):
        assert isinstance(got, float) and got == pytest.approx(want, abs=1e-6), where
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{where}[{i}]")
    else:
        assert type(got) is type(want) and got == want, where


def _loop(package, name):
    import importlib

    return getattr(importlib.import_module(f"{package}.eval.{name}"), LOOPS[name][0])


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_loop_matches_jax(pair, datasets_stub, name):
    ref, ours = pair
    want = _loop("moondream_tpu", name)(ref, debug=True)
    got = _loop("moondream_tpu_torch", name)(ours, debug=True)
    _same(got, want)
    scores = [v for k, v in want.items() if isinstance(v, float) and "l2" not in k]
    assert not scores or any(v > 0 for v in scores), want  # the gold answers hit


def test_eval_all_matches_jax(pair, datasets_stub):
    from moondream_tpu.eval import eval_all as jax_eval_all
    from moondream_tpu_torch.eval import eval_all

    assert list(eval_all.EVALS) == list(jax_eval_all.EVALS)
    skip = [n for n in eval_all.EVALS if n not in ("countbenchqa", "pope", "coco_map")]
    want = jax_eval_all.eval_all(pair[0], skip=skip)
    got = eval_all.eval_all(pair[1], skip=skip)
    assert list(got) == ["countbenchqa", "pope", "coco_map"]
    _same(got, want)


@pytest.fixture(scope="module")
def checkpoint(pair, tmp_path_factory):
    """(checkpoint path, config JSON path) written from the port's fp32
    modules of the tree."""
    from moondream_tpu_torch.finetune.finetune_text import save_params

    d = tmp_path_factory.mktemp("eval_ckpt")
    save_params(str(d / "m.safetensors"), pair[1])
    with open(d / "config.json", "w") as f:
        json.dump(port_config.tiny_test_config().to_dict(), f)
    return str(d / "m.safetensors"), str(d / "config.json")


@pytest.mark.parametrize("quant", ["dense", "int4+kv8+vit8"])
def test_create_model_loads_the_quantized_modules(checkpoint, quant):
    from moondream_tpu_torch.eval.common import create_model
    from moondream_tpu_torch.models.text import quantize_text_params
    from moondream_tpu_torch.models.vision import quantize_vision_params

    on = quant != "dense"
    model = create_model(*checkpoint, int4=on, kv_int8=on, vit8=on, device="cpu")
    cfg = port_config.tiny_test_config()
    want = params_from_jax(_tree(), cfg, device="cpu", dtype=torch.bfloat16)
    if on:
        quantize_text_params(want["text"])
        quantize_vision_params(want["vision"])
    got = model.params.state_dict()
    assert got.keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    assert model.config.text.kv_int8 is on and model.device.type == "cpu"
    assert type(model.text.blocks[0].qkv) is type(want["text"].blocks[0].qkv)
    assert type(model.vision.blocks[0].qkv) is type(want["vision"].blocks[0].qkv)


def test_eval_clis_run_on_the_cpu(checkpoint, datasets_stub, monkeypatch, capsys):
    """eval_all's main and a loop's run_cli, --device cpu, quantized."""
    from moondream_tpu_torch.eval import countbenchqa, eval_all
    from moondream_tpu_torch.eval.common import run_cli

    monkeypatch.setattr(MoondreamModel, "_settings", lambda self, s: (2, 0.0, 0.0))
    ckpt, cfg = checkpoint
    skip = [n for n in eval_all.EVALS if n != "countbenchqa"]
    out = eval_all.main(["--model", ckpt, "--config", cfg, "--device", "cpu",
                         "--int4", "--kv-int8", "--vit8", "--skip", *skip])
    assert list(out) == ["countbenchqa"] and out["countbenchqa"]["total_count"] == 2
    monkeypatch.setattr(sys, "argv", ["countbenchqa", "--model", ckpt, "--config", cfg,
                                      "--device", "cpu", "--debug"])
    res = run_cli(countbenchqa.eval_countbenchqa, lambda r: print("ACC", r["acc"]))
    assert res["total_count"] == 2 and "ACC" in capsys.readouterr().out
