"""The two oracles of the port's sharded training tests
(tests/test_torch_parallel_training.py, tests/test_torch_pipeline_parallel.py),
on the JAX package's tiny pipeline config (dim 64, ff 128, 4 layers, vocab
256, prefix 4; B 8, T 16, label_mask drawn as rng.random(...) > 0.3, as
tests/test_pipeline_parallel.py draws it), fp32 on the CPU:

  (a) the port's own unsharded step (finetune.trainer.text_loss and
      make_train_step on the whole model);
  (b) the JAX package's single-device text_loss under jax.value_and_grad
      and its make_train_step, from the same tree.

Both packages start from one JAX tree, every leaf but the RoPE table moved
off its init (biases and norms nonzero); the ranks rebuild the port's model
from its state (`weights.params_from_jax`). Results are keyed by the port's
leaf names (`finetune.optim.named_leaves`); the JAX trees are mapped onto
them by `port_named`. JAX's jits are built once per config and shared."""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_training_ranks as ranks
from moondream_tpu.config import TextConfig as JaxTextConfig
from moondream_tpu.config import tiny_test_config as jax_tiny_config
from moondream_tpu.finetune import trainer as jtrainer
from moondream_tpu.models import region as jregion
from moondream_tpu.models import text as jtext
from moondream_tpu.models import vision as jvision
from moondream_tpu_torch.config import TextConfig, tiny_test_config
from moondream_tpu_torch.parallel.mesh import cut_text_tensor
from moondream_tpu_torch.weights import params_from_jax
from test_torch_finetune import assert_moved_alike, max_rel  # noqa: F401

TEXT = dict(dim=64, ff_dim=128, n_layers=4, vocab_size=256, max_context=64, n_heads=4,
            n_kv_heads=4, prefix_attn=4)
KINDS = {"mha": {}, "gqa": {"n_heads": 8, "n_kv_heads": 2}}
B, T = 8, 16
TIMEOUT_S = 120  # every launch's hard limit
_JITS: dict = {}


def configs(kind: str):
    """(JAX text config, port text config) of a kind."""
    fields = {**TEXT, **KINDS[kind]}
    return JaxTextConfig(**fields), TextConfig(**fields)


def _nudge(rng):
    def nudge(path, x):
        x = np.asarray(x)
        if path[-1].key == "freqs_cis":
            return x
        return (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)

    return nudge


def _init(fn, cfg, key) -> dict:
    """A JAX init function's tree, jitted (eager, its many small ops take
    seconds to dispatch)."""
    return jax.jit(lambda k: fn(cfg, k, jnp.float32))(key)


@functools.lru_cache(None)
def tree(kind: str) -> dict:
    """The JAX text tree of a kind (numpy leaves)."""
    t = _init(jtext.init_text_params, configs(kind)[0], jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(_nudge(np.random.default_rng(1)), t)


@functools.lru_cache(None)
def whole_tree() -> dict:
    """The JAX tree of the whole tiny model with the mha text: vision, text
    and region. Only the placement of the vision and region leaves is
    compared, so they are seeded normals of their init's shapes (traced
    for the shapes alone: compiling the two inits took ~3 s)."""
    cfg = jax_tiny_config()
    shapes = jax.eval_shape(lambda k: {
        "vision": jvision.init_vision_params(cfg.vision, k, jnp.float32),
        "region": jregion.init_region_params(cfg.region, k, jnp.float32)}, jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    t = jax.tree.map(lambda s: (0.02 * rng.standard_normal(s.shape)).astype(s.dtype), shapes)
    return {"vision": t["vision"], "text": tree("mha"), "region": t["region"]}


def port_config(kind: str = "mha"):
    """The whole port config around a kind's text config."""
    return dataclasses.replace(tiny_test_config(), text=configs(kind)[1])


def port_params(kind: str = "mha"):
    t = whole_tree() if kind == "mha" else {"vision": whole_tree()["vision"], "text": tree(kind)}
    return params_from_jax(t, port_config(kind), device="cpu", dtype=torch.float32)


@functools.lru_cache(None)
def port_state(kind: str) -> Dict[str, np.ndarray]:
    """The port text model's state of a kind (what the ranks get)."""
    return {k: v.numpy() for k, v in port_params(kind)["text"].state_dict().items()}


@functools.lru_cache(None)
def whole_state() -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in port_params("mha").state_dict().items()}


def batch(seed: int, zero_rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
    """A host batch; `zero_rows`: rows whose label_mask is all 0."""
    rng = np.random.default_rng(seed)
    out = {"inputs_embeds": (rng.standard_normal((B, T, TEXT["dim"])) * 0.1).astype(np.float32),
           "labels": rng.integers(0, TEXT["vocab_size"], (B, T)).astype(np.int32),
           "label_mask": (rng.random((B, T)) > 0.3).astype(np.float32)}
    if zero_rows is not None:
        out["label_mask"][zero_rows] = 0.0
    return out


def named_nodes(tree_part: dict, n_layers: Optional[int] = None) -> Dict[str, tuple]:
    """A JAX tree (text, vision or region) under the port's leaf names:
    name -> (the tree's leaf, its layer index in a stacked block leaf or
    None); "attn" dropped from block paths. `n_layers`: the block count of
    a tree whose leaves have no shape (shardings)."""
    out: Dict[str, tuple] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif path[0] == "blocks":
            rest = ".".join(p for p in path[1:] if p != "attn")
            for i in range(node.shape[0] if n_layers is None else n_layers):
                out[f"blocks.{i}.{rest}"] = (node, i)
        else:
            out[".".join(path)] = (node, None)

    walk(tree_part, ())
    return out


def port_named(tree_part: dict) -> Dict[str, np.ndarray]:
    """A JAX tree's leaves as numpy arrays under the port's names, stacked
    block leaves split per layer."""
    return {name: np.asarray(a) if i is None else np.asarray(a)[i]
            for name, (a, i) in named_nodes(tree_part).items()}


def _tensors(b: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


@functools.lru_cache(None)
def port_oracle(kind: str, seed: int, seed2: int, zero: Optional[tuple] = None) -> dict:
    """(a): the port's unsharded make_train_step, two steps from the same
    state: the first's loss, gradients and updated leaves, the second's
    loss."""
    zero_rows = slice(*zero) if zero else None
    model = ranks.text_model(configs(kind)[1], port_state(kind))
    from moondream_tpu_torch.finetune import trainer

    return ranks._step_twice(trainer.make_train_step, model,
                             _tensors(batch(seed, zero_rows)), _tensors(batch(seed2)))


def _jit(name, build):
    if name not in _JITS:
        _JITS[name] = build()
    return _JITS[name]


@functools.lru_cache(None)
def jax_oracle(kind: str, seed: int, zero: Optional[tuple] = None) -> dict:
    """(b): the JAX package's text_loss under value_and_grad, by port names."""
    jcfg = configs(kind)[0]
    b = batch(seed, slice(*zero) if zero else None)
    vg = _jit(("vg", kind), lambda: jax.jit(jax.value_and_grad(
        lambda p, e, l, m: jtrainer.text_loss(p, e, l, m, jcfg))))
    loss, grads = vg(tree(kind), b["inputs_embeds"], b["labels"], b["label_mask"])
    return {"loss": float(loss), "grads": port_named(grads)}


@functools.lru_cache(None)
def jax_step(kind: str, seed: int) -> dict:
    """(b): one step of the JAX package's make_train_step
    (make_optimizer(lr=1e-3)): the updated leaves and the start, by port
    names."""
    jcfg = configs(kind)[0]
    opt = jtrainer.make_optimizer(lr=ranks.LR)
    step = _jit(("step", kind), lambda: jtrainer.make_train_step(opt, jcfg))
    state = jtrainer.init_train_state(jax.tree.map(jnp.array, tree(kind)), opt)
    state, _ = step(state, {k: jnp.asarray(v) for k, v in batch(seed).items()})
    return {"params": port_named(state.params), "start": port_named(tree(kind))}


def cut(full: np.ndarray, name: str, kind: str, tp: int, rank: int) -> np.ndarray:
    """A whole-model leaf cut for tp rank `rank` (`mesh.cut_text_tensor`)."""
    return cut_text_tensor(torch.tensor(full), name, configs(kind)[1], tp, rank).numpy()


def global_name(name: str, first_layer: int) -> str:
    """A pipeline stage's leaf name in the whole model."""
    if not name.startswith("blocks."):
        return name
    _, i, rest = name.split(".", 2)
    return f"blocks.{first_layer + int(i)}.{rest}"
