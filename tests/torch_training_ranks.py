"""What the ranks of tests/test_torch_parallel_training.py and
tests/test_torch_pipeline_parallel.py run (`parallel.comm.launch` pickles
these functions by name, so they live in a module that imports neither jax
nor the JAX package).

Every rank rebuilds the same fp32 port text model on the CPU from `state`
(the parent's `TextModel.state_dict()` as numpy arrays, from the JAX
package's tree through `weights.params_from_jax`), trains its part and
returns plain data: losses, and its gradients and updated leaves by the
names of its own shard or stage (`finetune.optim.named_leaves`)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from moondream_tpu_torch.finetune import trainer
from moondream_tpu_torch.finetune.optim import named_leaves
from moondream_tpu_torch.models.text import TextModel

LR = 1e-3  # the JAX tests' make_optimizer(lr=1e-3)


def text_model(cfg, state: Dict[str, np.ndarray]) -> TextModel:
    model = TextModel(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def leaves_np(model) -> Dict[str, np.ndarray]:
    return {n: t.detach().numpy().copy() for n, t in named_leaves(model)}


def recording(opt):
    """Wrap opt.update so that it records the gradients it is handed (the
    step's summed gradients, None as zeros) into the returned dict."""
    seen: Dict[str, np.ndarray] = {}
    inner = opt.update

    def update(state, leaves):
        seen.clear()
        seen.update({n: (p.grad.numpy().copy() if p.grad is not None
                         else np.zeros(tuple(p.shape), np.float32)) for n, p in leaves})
        return inner(state, leaves)

    opt.update = update
    return seen


def _step_twice(step, model, batch, batch2) -> dict:
    """Two steps of `step` from a fresh optimizer state: the first's loss,
    gradients and updated leaves, and the second's loss."""
    opt = trainer.make_optimizer(lr=LR)
    seen = recording(opt)
    step = step(opt)
    state = trainer.init_train_state(model, opt)
    state, loss = step(state, batch)
    out = {"loss": float(loss), "grads": dict(seen), "params": leaves_np(model),
           "step": state.step}
    state, loss2 = step(state, batch2)
    out["loss2"] = float(loss2)
    return out


# ------------------------------------------------------------ dp x tp, dp x sp


def train_rank(rank: int, axes: dict, cases: List[dict], ckpt: Optional[str] = None,
               whole: Optional[tuple] = None, bad: Optional[str] = None) -> dict:
    """Each case {"cfg", "state", "batch", "batch2", "seq_axis"} on the mesh
    `axes`: the rank's shard (`shard_text_model` where the mesh has "tp",
    else the whole model) trained two steps by `make_train_step` on
    `shard_batch(batch, mesh, seq_axis)`. With `ckpt`, the first case's
    state after its first step is saved there, then loaded back into a
    fresh shard (equal leaves, step 1). With `whole` = (MoondreamConfig,
    state of the whole model's parameters), `shard_params`' cut of it, and
    the ValueError of a ViT MLP width that does not split. With `bad` (a
    sequence axis), shard_batch's ValueErrors for 7 rows and 15
    positions."""
    from moondream_tpu_torch.parallel.mesh import create_mesh, shard_batch, shard_text_model

    mesh = create_mesh(axes, device="cpu")
    out = {"cases": []}

    def shard(model):
        return shard_text_model(model, mesh) if "tp" in axes else model

    for c in cases:
        b1 = shard_batch(c["batch"], mesh, c.get("seq_axis"))
        b2 = shard_batch(c["batch2"], mesh, c.get("seq_axis"))
        model = shard(text_model(c["cfg"], c["state"]))
        out["cases"].append(_step_twice(trainer.make_train_step, model, b1, b2))
    if ckpt is not None:
        c = cases[0]
        opt = trainer.make_optimizer(lr=LR)
        model = shard(text_model(c["cfg"], c["state"]))
        state, _ = trainer.make_train_step(opt)(trainer.init_train_state(model, opt),
                                                shard_batch(c["batch"], mesh, c.get("seq_axis")))
        trainer.save_checkpoint(ckpt, state)
        fresh = shard(text_model(c["cfg"], c["state"]))
        restored = trainer.load_checkpoint(ckpt, trainer.init_train_state(fresh, opt), opt)
        out["ckpt"] = {"step": restored.step, "equal": all(
            torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(fresh), named_leaves(model)))}
    if whole is not None:
        from moondream_tpu_torch.parallel.mesh import shard_params
        from moondream_tpu_torch.weights import build_params

        cfg, state = whole
        params = build_params(cfg, "cpu", torch.float32)
        params.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        out["shard_params"] = {n: t.numpy().copy() for n, t in shard_params(params, mesh).items()}
        odd = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, enc_ff_dim=63))
        out["indivisible"] = _raised(lambda: shard_params(build_params(odd, "cpu"), mesh))
    if bad is not None:
        b = cases[0]["batch"]
        out["bad"] = [_raised(lambda: shard_batch({k: v[:7] for k, v in b.items()}, mesh, bad)),
                      _raised(lambda: shard_batch({k: v[:, :15] for k, v in b.items()}, mesh,
                                                  bad))]
    return out


def _raised(fn) -> str:
    """The message of the ValueError fn() raises ("" when it returns)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


# ------------------------------------------------------------------ pp x dp


def pp_rank(rank: int, axes: dict, cases: List[dict], train: Optional[dict] = None,
            ckpt: Optional[str] = None, errors: Optional[dict] = None) -> dict:
    """On the pp x dp mesh `axes`: each case {"cfg", "state", "batch", "M"}
    through make_pp_loss_and_grads on the rank's stage (its loss and
    gradients); with `train` (a case with "batch2"), two steps of
    make_pp_train_step (losses, the gradients the optimizer got and the
    updated leaves); with `ckpt`, the trained state saved there, loaded into
    a fresh stage (equal leaves, step 1) and trained one more step; with
    `errors` {"cfg3": a 3-layer config, "batch", "M"}, the ValueErrors of a
    layer count and a batch that do not split."""
    from moondream_tpu_torch.parallel.mesh import create_mesh
    from moondream_tpu_torch.parallel.pipeline import (
        make_pp_loss_and_grads, make_pp_train_step, shard_params_pp)

    mesh = create_mesh(axes, device="cpu")
    out = {"cases": []}
    for c in cases:
        stage = shard_params_pp(text_model(c["cfg"], c["state"]), mesh)
        loss, grads = make_pp_loss_and_grads(c["cfg"], mesh, c["M"])(stage, c["batch"])
        out["cases"].append({
            "loss": float(loss), "first_layer": stage.stage.first_layer,
            "grads": {n: (g.numpy().copy() if g is not None else None) for n, g in grads.items()}})
    if train is not None:
        stage = shard_params_pp(text_model(train["cfg"], train["state"]), mesh)
        opt = trainer.make_optimizer(lr=LR)
        seen = recording(opt)
        step = make_pp_train_step(opt, train["cfg"], mesh, train["M"])
        state = trainer.init_train_state(stage, opt)
        state, loss = step(state, train["batch"])
        res = {"loss": float(loss), "grads": dict(seen), "params": leaves_np(stage),
               "step": state.step}
        if ckpt is not None:
            trainer.save_checkpoint(ckpt, state)
            fresh = shard_params_pp(text_model(train["cfg"], train["state"]), mesh)
            restored = trainer.load_checkpoint(ckpt, trainer.init_train_state(fresh, opt), opt)
            res["ckpt"] = {"step": restored.step, "equal": all(
                torch.equal(a, b)
                for (_, a), (_, b) in zip(named_leaves(fresh), named_leaves(stage)))}
            restored, loss3 = step(restored, train["batch2"])
            res["ckpt"]["loss_after"] = float(loss3)
        state, loss2 = step(state, train["batch2"])
        res["loss2"], res["step2"] = float(loss2), state.step
        out["train"] = res
    if errors is not None:
        out["errors"] = [
            _raised(lambda: make_pp_loss_and_grads(errors["cfg3"], mesh, 1)),
            _raised(lambda: make_pp_loss_and_grads(errors["cfg"], mesh, errors["M"])(
                shard_params_pp(text_model(errors["cfg"], errors["state"]), mesh),
                errors["batch"]))]
    return out
