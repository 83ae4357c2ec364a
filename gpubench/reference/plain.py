"""The plain reference of moondream's image-to-text forward, in float32.

Written from the model's published description, independent of the code
under test: Pillow's Lanczos overlap crops (a global 378x378 crop and a
grid of overlapping local crops), a SigLIP-style ViT (patch embedding,
learned positions, pre-LayerNorm blocks with bidirectional attention and
a tanh-GELU MLP), the local crops' features stitched without their inner
margins and mean-pooled to the 27x27 grid, a two-layer projection of the
global and pooled features, then a Phi-style decoder (one LayerNorm per
block feeding attention and the MLP in parallel, partial rotary
embeddings on the first 32 channels of each head, attention
bidirectional over [BOS, image] and causal after) and the LM head.

Every product runs in float32 with TF32 off. `quant="fp8"` computes
every linear on fp8 e4m3 operands instead (the weight and the activation
each rounded to e4m3 under one scale per tensor, as Hopper's fp8 tensor
cores take them): the control that the comparison must catch. The weights come from `gpubench.weights.Leaves`, drawn again from
the seed. Imports torch, numpy and Pillow only.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def strict_fp32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# -------------------------------------------------------------------- crops

def _tiling(h: int, w: int, crop: int, max_crops: int) -> Tuple[int, int]:
    if h <= crop or w <= crop:
        return 1, 1
    min_h, min_w = math.ceil(h / crop), math.ceil(w / crop)
    if min_h * min_w > max_crops:
        r = math.sqrt(max_crops / (min_h * min_w))
        return max(1, math.floor(min_h * r)), max(1, math.floor(min_w * r))
    ht = max(math.floor(math.sqrt(max_crops * h / w)), min_h)
    wt = max(math.floor(math.sqrt(max_crops * w / h)), min_w)
    if ht * wt > max_crops:
        if wt > ht:
            wt = math.floor(max_crops / ht)
        else:
            ht = math.floor(max_crops / wt)
    return max(1, ht), max(1, wt)


def overlap_crops(image: np.ndarray, vcfg: dict) -> Tuple[np.ndarray, Tuple[int, int]]:
    """(n, 378, 378, 3) uint8 crops, the global crop first, and the grid."""
    from PIL import Image

    base = vcfg["crop_size"]
    margin = vcfg["enc_patch_size"] * vcfg["overlap_margin"]
    window = base - 2 * margin
    h, w = image.shape[:2]
    rows, cols = _tiling(h - 2 * margin, w - 2 * margin, window, vcfg["max_crops"])
    pil = Image.fromarray(image)
    out = np.zeros((rows * cols + 1, base, base, 3), np.uint8)
    out[0] = np.asarray(pil.resize((base, base), resample=Image.Resampling.LANCZOS))
    big = np.asarray(pil.resize((cols * window + 2 * margin, rows * window + 2 * margin),
                                resample=Image.Resampling.LANCZOS))
    for r in range(rows):
        for c in range(cols):
            tile = big[r * window:r * window + base, c * window:c * window + base]
            out[1 + r * cols + c, :tile.shape[0], :tile.shape[1]] = tile
    return out, (rows, cols)


# ------------------------------------------------------------------ layers

class Model:
    """The reference forward over the seed's weights, in float32 (or with
    fp8 linears, quant="fp8"). Leaves are widened to float32 as they are
    used."""

    def __init__(self, cfg: dict, leaves, device, quant: Optional[str] = None):
        self.cfg, self.leaves, self.device, self.quant = cfg, leaves, device, quant

    def w(self, name: str) -> torch.Tensor:
        return self.leaves[name].to(self.device, torch.float32)

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.w(f"{name}.w"), self.w(f"{name}.b")
        if self.quant == "fp8":
            w, x = _fp8(w), _fp8(x)
        return x @ w + b

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w(f"{name}.weight"),
                            self.w(f"{name}.bias"), 1e-5)

    def mlp(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.linear(F.gelu(self.linear(x, f"{name}.fc1"), approximate="tanh"),
                           f"{name}.fc2")

    # ----------------------------------------------------------- vision
    def vit(self, crops: np.ndarray) -> torch.Tensor:
        """uint8 crops (n, 378, 378, 3) -> features (n, 729, enc_dim)."""
        v = self.cfg["vision"]
        p, d, heads = v["enc_patch_size"], v["enc_dim"], v["enc_n_heads"]
        x = torch.from_numpy(crops).to(self.device, torch.float32)
        x = (x / 255.0 - 0.5) / 0.5
        n, hh, ww, c = x.shape
        # patches flattened in (channel, row, column) order
        x = x.reshape(n, hh // p, p, ww // p, p, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(n, (hh // p) * (ww // p), c * p * p)
        x = self.linear(x, "vision.patch_emb") + self.w("vision.pos_emb")
        for i in range(v["enc_n_layers"]):
            b = f"vision.blocks.{i}"
            a = self.norm(x, f"{b}.ln1")
            q, k, val = self.linear(a, f"{b}.qkv").split(d, dim=-1)
            att = _attention(*(t.reshape(n, -1, heads, d // heads).transpose(1, 2)
                               for t in (q, k, val)), mask=None)
            x = x + self.linear(att.transpose(1, 2).reshape(n, -1, d), f"{b}.proj")
            x = x + self.mlp(self.norm(x, f"{b}.ln2"), f"{b}.mlp")
        return self.norm(x, "vision.post_ln")

    def image_embedding(self, image: np.ndarray) -> torch.Tensor:
        """uint8 (H, W, 3) -> (729, text dim)."""
        v = self.cfg["vision"]
        crops, (rows, cols) = overlap_crops(image, v)
        feats = self.vit(crops)
        g = v["crop_size"] // v["enc_patch_size"]
        local = feats[1:].reshape(rows * cols, g, g, -1)
        m = v["overlap_margin"]  # in patches
        inner = g - 2 * m
        # each tile's inner patches, plus the outer border of the edge tiles
        stitched = torch.cat([
            torch.cat([local[r * cols + c,
                             (0 if r == 0 else m):(g if r == rows - 1 else g - m),
                             (0 if c == 0 else m):(g if c == cols - 1 else g - m)]
                       for c in range(cols)], dim=1)
            for r in range(rows)], dim=0)
        assert stitched.shape[:2] == (rows * inner + 2 * m, cols * inner + 2 * m)
        pooled = F.adaptive_avg_pool2d(stitched.permute(2, 0, 1)[None], (g, g))[0]
        pooled = pooled.permute(1, 2, 0).reshape(g * g, -1)
        return self.mlp(torch.cat([feats[0], pooled], dim=-1), "vision.proj_mlp")

    # ------------------------------------------------------------- text
    def hidden(self, embeds: torch.Tensor) -> torch.Tensor:
        """(T, dim) inputs at positions 0..T-1 -> (T, dim) final hidden
        states, before the last LayerNorm."""
        t = self.cfg["text"]
        n_t, dim, heads = embeds.shape[0], t["dim"], t["n_heads"]
        hd = dim // heads
        kvh = t["n_kv_heads"]
        rot = dim // (2 * heads)
        cos, sin = _rope_table(rot, n_t, self.device)
        rows = torch.arange(n_t, device=self.device)
        prefix = t["prefix_attn"]
        mask = (rows[None, :] <= rows[:, None]) | ((rows[:, None] < prefix) & (rows[None, :] < prefix))
        x = embeds
        for i in range(t["n_layers"]):
            b = f"text.blocks.{i}"
            a = self.norm(x, f"{b}.ln")
            qkv = self.linear(a, f"{b}.qkv")
            q, k, val = qkv.split([heads * hd, kvh * hd, kvh * hd], dim=-1)
            q = _rotate(q.reshape(n_t, heads, hd).transpose(0, 1), cos, sin, rot)
            k = _rotate(k.reshape(n_t, kvh, hd).transpose(0, 1), cos, sin, rot)
            val = val.reshape(n_t, kvh, hd).transpose(0, 1)
            if kvh != heads:
                k = k.repeat_interleave(heads // kvh, dim=0)
                val = val.repeat_interleave(heads // kvh, dim=0)
            att = _attention(q, k, val, mask).transpose(0, 1).reshape(n_t, dim)
            x = x + self.linear(att, f"{b}.proj") + self.mlp(a, f"{b}.mlp")
        return x

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.linear(self.norm(hidden, "text.post_ln"), "text.lm_head")

    def sequence_logits(self, image: np.ndarray, prompt: Sequence[int],
                        served: Sequence[int]) -> torch.Tensor:
        """Logits (len(served), vocab) of the positions that chose each served
        token: the prompt's last row, then each served token's row but the
        last's."""
        t = self.cfg["text"]
        bos = self.cfg["tokenizer"]["bos_id"]
        ids = torch.tensor([bos, *prompt, *served[:-1]], device=self.device)
        wte = self.w("text.wte")
        tok = wte[ids]
        img = self.image_embedding(image)
        embeds = torch.cat([tok[:1], img, tok[1:]])
        h = self.hidden(embeds)
        start = 1 + img.shape[0] + len(prompt) - 1
        return self.logits(h[start:start + len(served)])


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 under one scale for the tensor (its largest
    magnitude to e4m3's largest, 448), returned in float32."""
    s = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _attention(q, k, v, mask) -> torch.Tensor:
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def _rope_table(rot: int, n: int, device):
    inv = 1.0 / (10000.0 ** (torch.arange(0, rot, 2, dtype=torch.float64) / rot))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    return ang.cos().float().to(device), ang.sin().float().to(device)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rot: int) -> torch.Tensor:
    """The first `rot` channels of each head rotate as rot/2 complex pairs
    (real parts first, imaginary second), written back interleaved."""
    half = rot // 2
    re, im = x[..., :half], x[..., half:rot]
    out = torch.stack([re * cos - im * sin, re * sin + im * cos], dim=-1).flatten(-2)
    return torch.cat([out, x[..., rot:]], dim=-1)


# --------------------------------------------------------------- comparison

def gaps(logits: torch.Tensor, chosen: Sequence[int], suppress: Sequence[int]) -> List[float]:
    """Per position, how far the reference's logit of the chosen token lies
    below its best. Row 0 is the prompt's last row, which picks among every
    token; later rows never pick a suppressed id."""
    lg = logits.clone()
    if len(suppress) and lg.shape[0] > 1:
        lg[1:, list(suppress)] = float("-inf")
    best = lg.max(dim=-1).values
    pick = lg.gather(1, torch.tensor(list(chosen), device=lg.device)[:, None])[:, 0]
    return (best - pick).tolist()


def control_choices(logits: torch.Tensor, suppress: Sequence[int]) -> List[int]:
    """The tokens a model with these logits puts first, under the same
    suppression."""
    lg = logits.clone()
    if len(suppress) and lg.shape[0] > 1:
        lg[1:, list(suppress)] = float("-inf")
    return lg.argmax(dim=-1).tolist()
