"""The port's accuracy gates for quantized configs
(moondream_tpu_torch/eval/quant_drift.py) against the JAX package's
(moondream_tpu/eval/quant_drift.py), on the CPU at tiny_test_config in fp32
with the models of tests/test_torch_eval.py (one tree, IdTokenizer).

The int8-ViT drift reports must equal JAX's within 3e-2 relative (the
dense scale within 1e-6, n_images exactly; `_close` says why): the dynamic
one against JAX's own, the static one against JAX's functions calibrated
on NORMALIZED crops (the port's deliberate deviation:
JAX's `static=True` calibrates on raw 0-255 pixels). Caption agreement of
an int4 + int8 KV twin and of an int8-text twin must equal JAX's exactly,
and the dense model must stay dense after every twin is built (the port's
quantizers convert in place). The gate logic and the gate corpus equal
JAX's; `main` runs at the tiny config with --device cpu."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from moondream_tpu.eval import quant_drift as jax_qd
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch import config as port_config
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.eval import quant_drift
from moondream_tpu_torch.ops.layers import Int8Linear, Linear
from test_torch_eval import IdTokenizer, models, small_budgets


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    small_budgets(mp)
    yield models()
    mp.undo()


def _small_images(n=2):
    rng = np.random.default_rng(5)
    return [Image.fromarray(rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
            for _ in range(n)]


def _assert_dense(model):
    assert quant_drift.dense_vision(model)
    for blk in (*model.vision.blocks, *model.text.blocks):
        assert all(type(m) is Linear for m in (blk.qkv, blk.proj, blk.mlp.fc1, blk.mlp.fc2))


def _close(got, want):
    """Drift values within 3e-2 relative, the dense embeddings' scale within
    1e-6, n_images exactly. Not tighter: an fp32 ulp between the two
    libraries' attention and LayerNorm sums can flip an int8 activation code
    at a rounding boundary (tests/test_torch_int8.py), and a flipped code
    moves one image's largest error; measured at most 1.7e-2 (mean_abs_err,
    the mean of the per-image maxima, dynamic), 6e-4 static."""
    assert got.keys() == want.keys()
    assert got["n_images"] == want["n_images"]
    assert got["bf16_mean_abs"] == pytest.approx(want["bf16_mean_abs"], rel=1e-6)
    for k in ("max_abs_err", "mean_abs_err", "rel_l2", "worst_rel_l2"):
        assert got[k] == pytest.approx(want[k], rel=3e-2), k


def test_dynamic_vision_drift_matches_jax(pair):
    ref, ours = pair
    want = jax_qd.vision_projection_drift(ref, images=_small_images())
    got = quant_drift.vision_projection_drift(ours, images=_small_images())
    _close(got, want)
    assert 0 < got["rel_l2"] < 0.2, got
    _assert_dense(ours)


def test_static_vision_drift_matches_jax_on_normalized_crops(pair, monkeypatch):
    """JAX's static path with its calibration crops normalized as the
    runtime normalizes them, against the port's static path."""
    ref, ours = pair
    collect = jax_vision.collect_vision_act_stats
    normalized = lambda crops, w, cfg, **kw: collect(
        (jnp.asarray(crops).astype(jnp.float32) / 255.0 - 0.5) / 0.5, w, cfg, **kw)
    monkeypatch.setattr(jax_vision, "collect_vision_act_stats", normalized)
    want = jax_qd.vision_projection_drift(ref, images=_small_images(), static=True)
    got = quant_drift.vision_projection_drift(ours, images=_small_images(), static=True)
    _close(got, want)
    twin = quant_drift.quantized_twin(ours, vit8_static=True)
    assert twin.vision.blocks[0].qkv.inv_a is not None  # static codes
    _assert_dense(ours)


def test_caption_agreement_of_identical_models(pair):
    rep = quant_drift.caption_agreement(pair[1], pair[1], images=_small_images(), max_tokens=4)
    assert rep == {"token_agreement": 1.0, "exact_caption_rate": 1.0, "n_images": 2}


@pytest.mark.parametrize("quant", ["int4+kv8", "int8_text"])
def test_twin_caption_agreement_matches_jax(pair, quant):
    ref, ours = pair
    int4 = quant == "int4+kv8"
    cfg = ref.config
    if int4:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_int8=True))
    qtext = (jax_text.quantize_text_params if int4 else jax_text.quantize_text_params_int8)
    jax_twin = JaxModel(cfg, params={**ref.params, "text": qtext(ref.params["text"])},
                        tokenizer=IdTokenizer(), dtype=jnp.float32)
    # the text model carries its CUDA graphs on the card; a lock stands in
    # for a captured graph, which cannot be copied either
    entries = graphs.cache_of(ours.text).entries
    entries["captured"] = graphs.Entry(threading.Lock())
    try:
        twin = quant_drift.quantized_twin(ours, int4=int4, int8_text=not int4, kv8=int4)
    finally:
        entries.pop("captured")
    _assert_dense(ours)
    assert twin.text is not ours.text and twin.vision is ours.vision
    assert not graphs.cache_of(twin.text).entries  # the twin's graphs are its own
    assert twin.text.wte is ours.text.wte  # the dense tensors are shared
    assert twin.config.text.kv_int8 is int4 and not ours.config.text.kv_int8
    want = jax_qd.caption_agreement(ref, jax_twin, images=_small_images(), max_tokens=4)
    got = quant_drift.caption_agreement(ours, twin, images=_small_images(), max_tokens=4)
    assert got == want


def test_drift_refuses_a_quantized_model(pair):
    twin = quant_drift.quantized_twin(pair[1], vit8=True)
    assert isinstance(twin.vision.blocks[0].qkv, Int8Linear)
    with pytest.raises(ValueError, match="quantized vision"):
        quant_drift.vision_projection_drift(twin, images=_small_images(1))
    _assert_dense(pair[1])


def test_gates_and_corpus_match_jax():
    assert quant_drift.GATES == jax_qd.GATES
    g = jax_qd.GATES
    for report in ({"rel_l2": g["vit8_rel_l2_max"] / 2, "max_abs_err": g["vit8_abs_err_max"] / 2,
                    "token_agreement": 1.0},
                   {"rel_l2": g["vit8_rel_l2_max"] * 2, "token_agreement": 0.5},
                   {"max_abs_err": g["vit8_abs_err_max"]}, {}):
        assert quant_drift.check_gates(report) == jax_qd.check_gates(report)
    for seed in (0, 1):
        for a, b in zip(quant_drift._images(6, seed), jax_qd._images(6, seed)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_main_runs_on_the_cpu(monkeypatch, capsys):
    """Random weights at the tiny config (in place of the 2B), every gate
    mode, --device cpu."""
    monkeypatch.setattr(port_config, "MOONDREAM_2B", port_config.tiny_test_config())
    monkeypatch.setattr(quant_drift, "_images", lambda n=6, seed=0: _small_images(2))
    report = quant_drift.main(["--vit8", "--vit8-static", "--int4", "--kv8",
                               "--max-tokens", "3", "--device", "cpu"])
    assert report["n_images"] == 2 and report["gates_apply"] is False
    assert set(report["gates"]) == {"vit8_rel_l2", "vit8_abs_err", "caption_agreement"}
    assert 0 <= report["token_agreement"] <= 1 and report["rel_l2"] > 0
    assert '"gates_apply": false' in capsys.readouterr().out
