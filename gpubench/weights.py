"""The model's weights, drawn by the harness from the run's seed.

Both sides take them from here: `load_into` writes them into the
program's parameters during set-up, and the plain reference draws them
again from the same seed after the window (`Leaves`), so that it takes
nothing the program made. Every random leaf is drawn in ONE call, a
normal sample over all of them on the run's device in the served dtype,
then scaled in place: linear weights N(0, 1/fan_in), token embeddings
N(0, 1), biases and position embeddings N(0, 0.02^2), LayerNorm weights
1 + N(0, 0.1^2) and biases N(0, 0.02^2). The leaves' names and layouts
(linear weights (in, out)) are the harness's record of the model, read by
both sides.

Imports torch only.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

# (name, shape, std, mean)
Leaf = Tuple[str, Tuple[int, ...], float, float]


def _linear(name: str, n_in: int, n_out: int) -> List[Leaf]:
    return [(f"{name}.w", (n_in, n_out), n_in ** -0.5, 0.0), (f"{name}.b", (n_out,), 0.02, 0.0)]


def _norm(name: str, dim: int) -> List[Leaf]:
    return [(f"{name}.weight", (dim,), 0.1, 1.0), (f"{name}.bias", (dim,), 0.02, 0.0)]


def leaves(cfg: dict) -> List[Leaf]:
    """Every weight of the vision encoder and the text model, in draw
    order."""
    v, t = cfg["vision"], cfg["text"]
    d, patch = v["enc_dim"], v["enc_patch_size"] ** 2 * v["in_channels"]
    n_patches = (v["crop_size"] // v["enc_patch_size"]) ** 2
    out: List[Leaf] = []
    out += _linear("vision.patch_emb", patch, d)
    out.append(("vision.pos_emb", (1, n_patches, d), 0.02, 0.0))
    for i in range(v["enc_n_layers"]):
        b = f"vision.blocks.{i}"
        out += _norm(f"{b}.ln1", d) + _linear(f"{b}.qkv", d, 3 * d) + _linear(f"{b}.proj", d, d)
        out += _norm(f"{b}.ln2", d) + _linear(f"{b}.mlp.fc1", d, v["enc_ff_dim"])
        out += _linear(f"{b}.mlp.fc2", v["enc_ff_dim"], d)
    out += _norm("vision.post_ln", d)
    out += _linear("vision.proj_mlp.fc1", 2 * d, v["proj_inner_dim"])
    out += _linear("vision.proj_mlp.fc2", v["proj_inner_dim"], v["proj_out_dim"])
    dt = t["dim"]
    qkv = int(dt * (1 + 2 * t["n_kv_heads"] / t["n_heads"]))
    # unit-normal token embeddings: at 0.02 (a training init) the current
    # token barely moves the next state, and greedy decoding of random
    # weights locks into one repeated token, which leaves the output check
    # few decisions to test
    out.append(("text.wte", (t["vocab_size"], dt), 1.0, 0.0))
    for i in range(t["n_layers"]):
        b = f"text.blocks.{i}"
        out += _norm(f"{b}.ln", dt) + _linear(f"{b}.qkv", dt, qkv) + _linear(f"{b}.proj", dt, dt)
        out += _linear(f"{b}.mlp.fc1", dt, t["ff_dim"]) + _linear(f"{b}.mlp.fc2", t["ff_dim"], dt)
    out += _norm("text.post_ln", dt) + _linear("text.lm_head", dt, t["vocab_size"])
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw_flat(cfg: dict, seed: int, device, dtype) -> torch.Tensor:
    """The unit normal sample every leaf is cut from."""
    total = sum(_numel(s) for _, s, _, _ in leaves(cfg))
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    return torch.randn(total, generator=gen, device=device, dtype=dtype)


def _place(flat: torch.Tensor, cfg: dict) -> Iterator[Tuple[str, torch.Tensor, float, float]]:
    off = 0
    for name, shape, std, mean in leaves(cfg):
        n = _numel(shape)
        yield name, flat[off:off + n].view(shape), std, mean
        off += n


def _scale_(t: torch.Tensor, std: float, mean: float) -> torch.Tensor:
    """In place, in t's dtype: the one rounding rule both sides share."""
    t.mul_(std)
    if mean:
        t.add_(mean)
    return t


@torch.no_grad()
def load_into(params: torch.nn.Module, cfg: dict, seed: int) -> None:
    """Write the seed's weights into `params` (the program's vision and text
    parameters, named as `leaves` names them), on their device and in their
    dtype. Every leaf must be there, and nothing else may be."""
    named = dict(params.named_parameters())
    first = next(iter(named.values()))
    flat = draw_flat(cfg, seed, first.device, first.dtype)
    seen = set()
    for name, view, std, mean in _place(flat, cfg):
        p = named[name]
        if tuple(p.shape) != tuple(view.shape):
            raise ValueError(f"{name}: program shape {tuple(p.shape)} != {tuple(view.shape)}")
        _scale_(p.copy_(view), std, mean)
        seen.add(name)
    missing = sorted(set(named) - seen)
    if missing:
        raise ValueError(f"program parameters the harness does not draw: {missing[:5]}")


class Leaves:
    """The seed's weights again, for the reference: each leaf made on demand
    from one sample, in the served dtype (then widened by the caller)."""

    def __init__(self, cfg: dict, seed: int, device, dtype):
        self._flat = draw_flat(cfg, seed, device, dtype)
        self._where: Dict[str, Tuple[torch.Tensor, float, float]] = {
            name: (view, std, mean) for name, view, std, mean in _place(self._flat, cfg)}

    def __getitem__(self, name: str) -> torch.Tensor:
        view, std, mean = self._where[name]
        return _scale_(view.clone(), std, mean)

    def __contains__(self, name: str) -> bool:
        return name in self._where
