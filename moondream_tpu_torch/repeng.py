"""Representation engineering: control vectors that steer generation
(moondream_tpu/repeng.py).

  * `HiddenStateCollector.collect` generates a continuation for each
    (image, prompt) sample with the model's own answer loop, unsteered and
    without an adapter, then runs ONE cache-free full-sequence forward
    (`models.text.produce_hidden_layers`) over [BOS, image, prompt,
    generated] and keeps every layer's residual stream at the generated
    tokens' positions. Causality makes these the states the incremental
    generation saw.
  * `train_control_vectors` is the paired-difference PCA of numpy (an SVD
    per layer), the JAX package's arithmetic bit for bit.
  * Steering is `settings={"steer": ControlVector, "steer_scale": s}` in
    `MoondreamModel.caption` / `query`: the pre-scaled (n_layers, dim)
    vector is added to each block's output in the answer's text forwards
    (`models.text.text_decoder(..., steer=)`).

    reps = HiddenStateCollector(model)
    pos_h = reps.collect(images, positive_prompt, samples_per_image=2)
    neg_h = reps.collect(images, negative_prompt, samples_per_image=2)
    cv = train_control_vectors(pos_h, neg_h)
    model.query(img, "Describe this image.", settings={"steer": cv, "steer_scale": 4.2})

A ControlVector's .npz file (`directions`, `default_scale`) is the JAX
package's: either package loads what the other saves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .models.moondream import STEER_SETTINGS, VARIANT_SETTINGS
from .models.text import produce_hidden_layers

CAPTURE_BUCKET = 128  # captured sequences pad to multiples of this
DEFAULT_SCALE = 4.2  # the reference notebook's steering strength


@dataclass
class ControlVector:
    """Per-layer steering directions, (n_layers, dim), unit-norm rows."""

    directions: np.ndarray
    default_scale: float = DEFAULT_SCALE

    def scaled(self, scale: Optional[float] = None, device=None) -> torch.Tensor:
        """The directions times `scale` (default_scale when None) as an fp32
        tensor on `device` (the CPU when None), as the JAX package's
        `jnp.asarray(directions, float32) * scale` computes it."""
        s = self.default_scale if scale is None else scale
        return torch.as_tensor(np.asarray(self.directions, np.float32), device=device) * s

    def __neg__(self) -> "ControlVector":
        return ControlVector(-self.directions, self.default_scale)

    def save(self, path: str) -> None:
        np.savez(path, directions=self.directions, default_scale=self.default_scale)

    @classmethod
    def load(cls, path: str) -> "ControlVector":
        z = np.load(path)
        return cls(z["directions"], float(z["default_scale"]))


class HiddenStateCollector:
    """Per-layer hidden states of generated tokens, over a MoondreamModel
    with dense text blocks (the capture forward reads the dense weights)."""

    def __init__(self, model):
        self.model = model

    @torch.no_grad()
    def collect(
        self,
        images: Sequence,
        prompt: str,
        samples_per_image: int = 2,
        max_tokens: int = 48,
        temperature: float = 0.5,
        settings: Optional[dict] = None,
    ) -> List[np.ndarray]:
        """One (n_layers, dim) fp32 array per generated token, over every
        image and sample: generate from the query template around `prompt`
        (temperature as given, the settings' top_p, default 0.3, and
        max_tokens), then capture the states of [BOS, image, prompt,
        generated] padded with zeros to CAPTURE_BUCKET. A sample that
        generates nothing adds nothing.

        Raises NotImplementedError for a steering vector or a LoRA variant
        in `settings`: the JAX package's collector passes them to nothing
        (its prefill and its capture run unsteered and without an adapter),
        so the port refuses them rather than drop them."""
        for key in STEER_SETTINGS + VARIANT_SETTINGS:
            if (settings or {}).get(key) is not None:
                raise NotImplementedError(
                    f"settings[{key!r}]: HiddenStateCollector.collect generates and captures "
                    "with the base model, unsteered (the JAX package's ignores the setting); "
                    "leave it out"
                )
        model = self.model
        dev = model.device
        templates = model.config.tokenizer.templates["query"]
        prompt_ids = (list(templates["prefix"]) + model._encode_text(prompt)
                      + list(templates["suffix"]))
        gen_settings = {"max_tokens": max_tokens, "temperature": temperature, **(settings or {})}
        wte = model.text.wte
        ids = lambda xs: torch.tensor(xs, dtype=torch.long, device=dev)

        out: List[np.ndarray] = []
        for image in images:
            enc = model.encode_image(image)
            img_emb = None
            for _ in range(samples_per_image):
                kv = model.load_encoded_image(enc)
                _, _, next_token, pos, kv = model._prefill_prompt(
                    kv, prompt_ids, enc.pos, gen_settings["temperature"], 0.0)
                gen_ids = model._generate_answer_tokens(kv, next_token, pos, gen_settings)
                model._recycle_kv(kv)
                if not gen_ids:
                    continue
                if img_emb is None:
                    img_emb = model._run_vision_encoder(image)  # (729, D)
                seq = torch.cat([wte[ids([model.config.tokenizer.bos_id])], img_emb,
                                 wte[ids(prompt_ids + gen_ids)]]).to(model.dtype)
                total = seq.shape[0]
                padded = math.ceil(total / CAPTURE_BUCKET) * CAPTURE_BUCKET
                seq = F.pad(seq, (0, 0, 0, padded - total))[None]
                layers = produce_hidden_layers(seq, model.text)[:, 0]  # (L, T_pad, D)
                # the hidden state at position p predicts token p + 1: the
                # states OF the generated tokens sit at their own positions
                states = layers[:, total - len(gen_ids):total].float().cpu().numpy()
                out.extend(states.transpose(1, 0, 2))  # per token (L, D)
        return out


def train_control_vectors(positive: List[np.ndarray],
                          negative: List[np.ndarray]) -> ControlVector:
    """Paired-difference PCA per layer (the reference notebook's recipe):
    center each +/- pair at its midpoint, mean-center the population, take
    the top principal direction by SVD, and orient it so that positive
    samples project higher. Raises ValueError without a pair."""
    n = min(len(positive), len(negative))
    if n == 0:
        raise ValueError("need at least one positive and one negative sample")
    pos = np.stack(positive[:n])  # (N, L, D)
    neg = np.stack(negative[:n])
    n_layers = pos.shape[1]

    directions = np.zeros((n_layers, pos.shape[2]), np.float32)
    for layer in range(n_layers):
        p, q = pos[:, layer], neg[:, layer]  # (N, D)
        center = (p + q) / 2
        train = np.concatenate([p - center, q - center], axis=0)
        train = train - train.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(train, full_matrices=False)
        d = vt[0]
        d = d / (np.linalg.norm(d) + 1e-8)
        if np.mean(p @ d) < np.mean(q @ d):
            d = -d
        directions[layer] = d
    return ControlVector(directions)
