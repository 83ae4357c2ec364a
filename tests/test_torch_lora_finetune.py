"""LoRA adapter finetuning in the port (`moondream_tpu_torch/finetune/
lora.py`) against the JAX package's (`moondream_tpu/finetune/lora.py`) on
the CPU, at tiny_test_config in fp32, mirroring tests/test_lora_finetune.py:

  * a fresh adapter (B = 0) is an exact no-op, in both packages;
  * `lora_text_loss` equals JAX's (rtol 1e-5) under a nonzero adapter, and
    its gradient of every adapter leaf equals jax.grad's within 1e-5 of
    max|ref| (measured <= 7e-7);
  * six steps of `make_lora_train_step` (AdamW at lr 1e-2, grad-accum 1
    and 2) from JAX's initial adapter give JAX's optax losses (rtol 1e-5)
    and adapter leaves within STEPS_REL = 1e-3 of max|ref| (measured
    3.4e-4 on qkv's B, L2 1.4e-5): Adam's m / (sqrt(v) + eps) turns the
    gradients' last-bit differences into update differences where a
    gradient element nearly cancels, as tests/test_torch_finetune.py found
    for the full finetune. The base text model stays bit for bit with no
    `.grad`, and the optimizer state holds adapter-sized leaves only;
  * `save_variant` writes JAX's keys and tensors, and the file loads
    through both packages' `variant_state_dict`;
  * `merge_variant` of a trained adapter matches the adapter's forward,
    and a quantized base is refused;
  * `init_lora_params`: shapes, zero B and A ~ N(0, 1) / r.
"""

import copy
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import moondream_tpu.lora as jax_lora
from moondream_tpu.config import tiny_test_config
from moondream_tpu.finetune import lora as jax_ft_lora
from moondream_tpu.finetune import trainer as jax_trainer
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu_torch import lora as port_lora
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.finetune import lora as ft_lora
from moondream_tpu_torch.finetune import trainer
from moondream_tpu_torch.finetune.optim import AdamW, named_leaves, trainable
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.weights import lora_from_jax, lora_to_jax, params_from_jax

CFG = tiny_test_config()
PCFG = port_tiny_config()
RANK = 4
REL = 1e-5
STEPS_REL = 1e-3
LR = 1e-2
_JITS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sides():
    """(JAX text params, the port's TextModel) of one seeded fp32 tree."""
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = {"vision": jax_vision.init_vision_params(CFG.vision, kv, jnp.float32),
            "text": jax_text.init_text_params(CFG.text, kt, jnp.float32),
            "region": jax_region.init_region_params(CFG.region, kr, jnp.float32)}
    return tree["text"], params_from_jax(tree, PCFG, device="cpu", dtype=torch.float32)["text"]


def _batch(seed=0, bsz=2, t=16):
    """(JAX batch, port batch) of one seeded example batch."""
    rng = np.random.default_rng(seed)
    embeds = (rng.standard_normal((bsz, t, CFG.text.dim)) * 0.1).astype(np.float32)
    labels = rng.integers(0, CFG.text.vocab_size, (bsz, t)).astype(np.int32)
    mask = np.ones((bsz, t), np.float32)
    mask[:, :3] = 0.0
    jb = {"inputs_embeds": jnp.asarray(embeds), "labels": jnp.asarray(labels),
          "label_mask": jnp.asarray(mask)}
    pb = {"inputs_embeds": torch.from_numpy(embeds), "labels": torch.from_numpy(labels),
          "label_mask": torch.from_numpy(mask)}
    return jb, pb


def _jax_adapter(seed: int, b_scale: float = 0.0) -> dict:
    """JAX's fresh adapter from PRNGKey(seed), B ~ N(0, 1) x b_scale when
    nonzero (numpy leaves)."""
    lora = jax_ft_lora.init_lora_params(CFG.text, RANK, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return {g: {s: {"A": np.asarray(p["A"]),
                    "B": (rng.standard_normal(p["B"].shape) * b_scale).astype(np.float32)}
                for s, p in sites.items()} for g, sites in lora.items()}


def _jax_loss(lora, text, jb):
    fn = _JITS.setdefault("loss", jax.jit(lambda lo, tp, b: jax_ft_lora.lora_text_loss(
        lo, tp, b["inputs_embeds"], b["labels"], b["label_mask"], CFG.text)))
    return float(fn(jax.tree.map(jnp.asarray, lora), text, jb))


def _loss(lora, text, pb):
    with torch.no_grad():
        return float(ft_lora.lora_text_loss(lora, text, pb["inputs_embeds"], pb["labels"],
                                            pb["label_mask"]))


def test_a_fresh_adapter_is_an_exact_noop(sides):
    jtext, text = sides
    jb, pb = _batch()
    fresh = _jax_adapter(1)
    with torch.no_grad():
        base = float(trainer.text_loss(text, pb["inputs_embeds"], pb["labels"],
                                       pb["label_mask"]))
    assert _loss(lora_from_jax(fresh), text, pb) == base
    np.testing.assert_allclose(base, _jax_loss(fresh, jtext, jb), rtol=REL)


def test_lora_text_loss_equals_jax(sides):
    jtext, text = sides
    jb, pb = _batch()
    lora = _jax_adapter(2, b_scale=0.05)
    got, want = _loss(lora_from_jax(lora), text, pb), _jax_loss(lora, jtext, jb)
    np.testing.assert_allclose(got, want, rtol=REL)
    assert abs(want - _jax_loss(_jax_adapter(2), jtext, jb)) > 1e-3  # the adapter matters


def test_adapter_gradients_equal_jax(sides):
    """The backward reaches the adapter's eight leaves only, with jax.grad's
    values."""
    jtext, text = sides
    jb, pb = _batch(4)
    lora = _jax_adapter(3, b_scale=0.01)
    fn = _JITS.setdefault("grad", jax.jit(jax.grad(lambda lo, tp, b: jax_ft_lora.lora_text_loss(
        lo, tp, b["inputs_embeds"], b["labels"], b["label_mask"], CFG.text))))
    want = fn(jax.tree.map(jnp.asarray, lora), jtext, jb)
    plora = lora_from_jax(lora)
    leaves = named_leaves(plora)
    with trainable(leaves):
        ft_lora.lora_text_loss(plora, text, pb["inputs_embeds"], pb["labels"],
                               pb["label_mask"]).backward()
    for name, t in leaves:
        grp, site, f = name.split(".")
        w = np.asarray(want[grp][site][f])
        assert np.abs(t.grad.numpy() - w).max() <= REL * np.abs(w).max(), name
    assert all(t.grad is None for _, t in named_leaves(text))


def _jax_steps(lora, jtext, batches, grad_accum):
    opt = jax_trainer.make_optimizer(lr=LR)
    if grad_accum > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=grad_accum)
    step = _JITS.setdefault(("step", grad_accum), jax_ft_lora.make_lora_train_step(opt, CFG.text))
    params = jax.tree.map(jnp.array, lora)
    state = jax_trainer.TrainState(params, opt.init(params), jnp.int32(0))
    losses = []
    for jb in batches:
        state, loss = step(state, jtext, jb)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_six_adapter_steps_equal_optax_and_freeze_the_base(sides, grad_accum):
    jtext, text = sides
    init = _jax_adapter(3)
    pairs = [_batch(seed) for seed in (4, 5)] * 3
    want_losses, want = _jax_steps(init, jtext, [jb for jb, _ in pairs], grad_accum)

    base = {n: t.clone() for n, t in named_leaves(text)}
    lora = lora_from_jax(init)
    opt = trainer.make_optimizer(lr=LR)
    opt = AdamW(opt.learning_rate, opt.b1, opt.b2, opt.eps, opt.weight_decay, every_k=grad_accum)
    state = trainer.init_train_state(lora, opt)
    assert [t.shape for t in state.opt_state.mu] == [t.shape for _, t in named_leaves(lora)]
    step = ft_lora.make_lora_train_step(opt, PCFG.text)
    losses = []
    for _, pb in pairs:
        state, loss = step(state, text, pb)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=REL)
    assert losses[-1] < losses[0]
    got = lora_to_jax(state.params)
    for grp, site in port_text.LORA_SITES:
        for f in ("A", "B"):
            w = want[grp][site][f]
            assert np.abs(got[grp][site][f] - w).max() <= STEPS_REL * np.abs(w).max(), (
                grp, site, f)
    assert np.abs(got["attn"]["qkv"]["B"]).max() > 0
    assert state.opt_state.count == 6 // grad_accum and state.step == 6
    for name, t in named_leaves(text):
        assert torch.equal(t, base[name]) and t.grad is None and not t.requires_grad, name
    assert all(t.grad is None and not t.requires_grad for _, t in named_leaves(state.params))
    with pytest.raises(ValueError, match="do not fit"):
        small = ft_lora.init_lora_params(
            dataclasses.replace(PCFG.text, ff_dim=64), RANK,
            torch.Generator().manual_seed(0), device="cpu")
        step(trainer.init_train_state(small, opt), text, pairs[0][1])


def test_save_variant_equals_jax_and_loads_in_both(sides, tmp_path):
    lora = _jax_adapter(6, b_scale=0.05)
    ours, theirs = str(tmp_path / "ours.pt"), str(tmp_path / "theirs.pt")
    ft_lora.save_variant(ours, lora_from_jax(lora))
    jax_ft_lora.save_variant(theirs, lora)
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert list(a) == list(b) and len(a) == 8 * CFG.text.n_layers
    for key in a:
        assert a[key].dtype == b[key].dtype == torch.float32 and torch.equal(a[key], b[key]), key
    loaded = {"port": lora_to_jax(port_lora.variant_state_dict(
        ours, CFG.text.n_layers, torch.float32, "cpu")),
        "jax": jax_lora.variant_state_dict(ours, n_layers=CFG.text.n_layers,
                                           dtype_str="float32")}
    for tree_ in loaded.values():
        for grp, site in port_text.LORA_SITES:
            for f in ("A", "B"):
                np.testing.assert_array_equal(np.asarray(tree_[grp][site][f]),
                                              lora[grp][site][f])


def test_merge_variant_of_a_trained_adapter_matches_its_forward(sides):
    """A few adapter steps (so that every factor is nonzero), then the
    merged weights plus the residual proj adapter give the adapter's loss
    and hidden states; a quantized base is refused."""
    _, text = sides
    _, pb = _batch(7)
    opt = trainer.make_optimizer(lr=LR)
    state = trainer.init_train_state(lora_from_jax(_jax_adapter(8)), opt)
    step = ft_lora.make_lora_train_step(opt, PCFG.text)
    for _ in range(3):
        state, _ = step(state, text, pb)
    lora = state.params
    merged, residual = port_lora.merge_variant(text, lora)
    assert residual is not None
    x = pb["inputs_embeds"]
    with torch.no_grad():
        want = port_text.produce_hidden(x, text, lora=lora)
        got = port_text.produce_hidden(x, merged, lora=residual)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=REL, atol=REL)
    np.testing.assert_allclose(_loss(residual, merged, pb), _loss(lora, text, pb), rtol=REL)
    quantized = port_text.quantize_text_params(copy.deepcopy(text))
    with pytest.raises(ValueError, match="dense"):
        port_lora.merge_variant(quantized, lora)


def test_init_lora_params_shapes_zero_b_and_scale():
    cfg = PCFG.text
    rank = 8
    lora = ft_lora.init_lora_params(cfg, rank, torch.Generator().manual_seed(0), device="cpu")
    dims = {"qkv": (cfg.dim, cfg.qkv_dim), "proj": (cfg.dim, cfg.dim),
            "fc1": (cfg.dim, cfg.ff_dim), "fc2": (cfg.ff_dim, cfg.dim)}
    assert [n for n, _ in named_leaves(lora)] == [
        f"{g}.{s}.{f}" for g, s in port_text.LORA_SITES for f in ("A", "B")]
    for grp, site in port_text.LORA_SITES:
        a, b = lora[grp][site]["A"], lora[grp][site]["B"]
        fin, fout = dims[site]
        assert a.shape == (cfg.n_layers, rank, fin) and b.shape == (cfg.n_layers, fout, rank)
        assert a.dtype == b.dtype == torch.float32 and not b.any()
        assert abs(float(a.std()) * rank - 1.0) < 0.1
    again = ft_lora.init_lora_params(cfg, rank, torch.Generator().manual_seed(0),
                                     dtype=torch.bfloat16, device="cpu")
    assert torch.equal(again["mlp"]["fc2"]["A"], lora["mlp"]["fc2"]["A"].to(torch.bfloat16))
