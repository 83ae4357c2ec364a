"""Operations, bytes and model FLOPs of the port's work, counted from shapes.

The attention and crop arithmetic is the bound arithmetic of the repo's
`chip_smoke.py` (copied, not imported): a kernel's least time is the larger
of the bytes its function must move (each input read once, each output
written once) over the card's bandwidth and its operations over the card's
peak. Model FLOPs count the products a forward pass needs (2 per
multiply-add): the linears, the attention's QK^T and PV over the pairs
the mask lets attend, and the LM head; not layer norms or activations.

Shapes are what the model needs, not what a kernel pads to: a ViT crop has
729 tokens and a batch the crops its images have, so that a kernel that
computes padding reads below its roofline, never above it.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

from .common import PEAK_BF16_FLOP_S, PEAK_BYTES_S

# int8 tensor-core operations per second: the crop kernel's operations bound
# (chip_smoke.py: three int8 products over a tap's digit planes)
PEAK_INT8_OP_S = 1979e12


def least_seconds(nbytes: float, flops: float, peak_ops: float = PEAK_BF16_FLOP_S) -> float:
    """The least time the card could take for work that moves `nbytes` and
    does `flops` operations."""
    return max(nbytes / PEAK_BYTES_S, flops / peak_ops)


# ---------------------------------------------------------------- attention

def mask_pairs(tq: int, tk: int, pos: int, prefix: int) -> int:
    """Attended (query, key) pairs of one head under the unified mask: query
    row i at pos + i sees key j when j <= pos + i, or when both lie in the
    bidirectional prefix."""
    total = 0
    for i in range(tq):
        row = pos + i
        if row < prefix:
            total += min(tk, max(prefix, row + 1))
        else:
            total += min(tk, row + 1)
    return total


def attn_call(b: int, h: int, tq: int, tk: int, d: int, attended: int,
              elem: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of one attention call: q (b, h, tq, d), k and v (b, h,
    tk, d) read once, the output (q's shape) written once; QK^T and PV over
    `attended` pairs summed over the batch rows, per head."""
    nbytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * elem
    return nbytes, 4 * h * d * attended


def ragged_call(h: int, d: int, tq: int, positions: Sequence[int], slots: int,
                elem: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of one pool decode layer (kernel C): q read and the
    output written for every slot; each listed slot's attended columns
    (pos + tq of them) read once; QK^T and PV over its causal pairs."""
    ncols = sum(p + tq for p in positions)
    pairs = sum(p + i + 1 for p in positions for i in range(tq))
    return 2 * h * ncols * d * elem + 2 * slots * h * tq * d * elem, 4 * h * d * pairs


def vit_attention(cfg: dict, crops: int) -> Tuple[int, int]:
    """One ViT layer's attention over `crops` crops of 729 tokens, each
    token attending every token of its crop."""
    v = cfg["vision"]
    n = (v["crop_size"] // v["enc_patch_size"]) ** 2
    d = v["enc_dim"] // v["enc_n_heads"]
    return attn_call(crops, v["enc_n_heads"], n, n, d, crops * n * n)


def text_attention(cfg: dict, rows: int, pos: int, batch: int = 1) -> Tuple[int, int]:
    """One text layer's attention for `batch` sequences of `rows` query rows
    at pos .. pos + rows - 1 over the columns they need (bidirectional over
    the image prefix, causal after)."""
    t = cfg["text"]
    d = t["dim"] // t["n_heads"]
    cols = max(pos + rows, t["prefix_attn"] if pos < t["prefix_attn"] else 0)
    pairs = mask_pairs(rows, cols, pos, t["prefix_attn"])
    return attn_call(batch, t["n_heads"], rows, cols, d, batch * pairs)


# -------------------------------------------------------------------- crops

_SUPPORT = 3.0
_PRECISION_BITS = 22


def _lanczos(x: float) -> float:
    if -_SUPPORT <= x < _SUPPORT:
        if x == 0.0:
            return 1.0
        a = x * math.pi
        b = (x / _SUPPORT) * math.pi
        return (math.sin(a) / a) * (math.sin(b) / b)
    return 0.0


@lru_cache(maxsize=64)
def lanczos_taps(in_size: int, out_size: int) -> int:
    """Non-zero fixed-point taps of Pillow's Lanczos resize from in_size to
    out_size (its precompute_coeffs and 22-bit normalisation)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ss = 1.0 / filterscale
    nnz = 0
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax - xmin)]
        ww = 0.0
        for v in w:
            ww += v
        for v in w:
            c = (v / ww if ww != 0.0 else v) * (1 << _PRECISION_BITS)
            nnz += int(c + 0.5 if c >= 0 else c - 0.5) != 0
    return nnz


def select_tiling(height: int, width: int, crop: int, max_crops: int) -> Tuple[int, int]:
    """The tile grid of moondream's overlap crops."""
    if height <= crop or width <= crop:
        return (1, 1)
    min_h, min_w = math.ceil(height / crop), math.ceil(width / crop)
    if min_h * min_w > max_crops:
        ratio = math.sqrt(max_crops / (min_h * min_w))
        return max(1, math.floor(min_h * ratio)), max(1, math.floor(min_w * ratio))
    h_tiles = max(math.floor(math.sqrt(max_crops * height / width)), min_h)
    w_tiles = max(math.floor(math.sqrt(max_crops * width / height)), min_w)
    if h_tiles * w_tiles > max_crops:
        if w_tiles > h_tiles:
            w_tiles = math.floor(max_crops / h_tiles)
        else:
            h_tiles = math.floor(max_crops / w_tiles)
    return max(1, h_tiles), max(1, w_tiles)


def image_tiling(cfg: dict, h: int, w: int) -> Tuple[int, int]:
    v = cfg["vision"]
    margin = v["enc_patch_size"] * v["overlap_margin"]
    window = v["crop_size"] - 2 * margin
    return select_tiling(h - 2 * margin, w - 2 * margin, window, v["max_crops"])


def image_crops(cfg: dict, h: int, w: int) -> int:
    """Crops of an image: its tiles and the global crop."""
    r, c = image_tiling(cfg, h, w)
    return r * c + 1


def lanczos_work(cfg: dict, h: int, w: int) -> Tuple[int, int]:
    """(bytes, operations) of one image's crops: the raw image read once and
    the crop stack written once; 2 operations per non-zero tap, channel and
    output pixel of each pass that runs (the global crop's and the grid's),
    times 3 (an int8 product per digit plane of a 22-bit tap)."""
    v = cfg["vision"]
    base, margin = v["crop_size"], v["enc_patch_size"] * v["overlap_margin"]
    window = base - 2 * margin
    rows, cols = image_tiling(cfg, h, w)
    macs = 0
    for th, tw in ((base, base), (rows * window + 2 * margin, cols * window + 2 * margin)):
        if w != tw:
            macs += h * lanczos_taps(w, tw)
        if h != th:
            macs += tw * lanczos_taps(h, th)
    nbytes = h * w * 3 + (rows * cols + 1) * base * base * 3
    return nbytes, 2 * 3 * 3 * macs


# -------------------------------------------------------------- model FLOPs

def text_linear_params(cfg: dict) -> int:
    """Multiply-adds per token of one text forward's linears, the LM head
    included."""
    t = cfg["text"]
    d, ff = t["dim"], t["ff_dim"]
    qkv = d * int(d * (1 + 2 * t["n_kv_heads"] / t["n_heads"]))
    per_layer = qkv + d * d + 2 * d * ff
    return t["n_layers"] * per_layer + d * t["vocab_size"]


def text_token_flops(cfg: dict, pos: int, attended: int) -> int:
    """FLOPs of one text token at `pos` that attends `attended` columns."""
    t = cfg["text"]
    return 2 * text_linear_params(cfg) + 4 * t["n_layers"] * t["dim"] * attended


def text_span_flops(cfg: dict, pos: int, rows: int) -> int:
    """FLOPs of `rows` tokens at pos .. pos + rows - 1 under the model's mask
    (bidirectional over the image prefix, causal after)."""
    t = cfg["text"]
    cols = max(pos + rows, t["prefix_attn"] if pos < t["prefix_attn"] else 0)
    pairs = mask_pairs(rows, cols, pos, t["prefix_attn"])
    return rows * 2 * text_linear_params(cfg) + 4 * t["n_layers"] * t["dim"] * pairs


def decode_row_flops(cfg: dict, pos: int) -> int:
    """FLOPs of one decode row whose token sits at `pos` (it attends pos + 1
    columns)."""
    return text_token_flops(cfg, pos, pos + 1)


def vit_crop_flops(cfg: dict) -> int:
    """FLOPs of one 378x378 crop through the patch embedding and the ViT."""
    v = cfg["vision"]
    n = (v["crop_size"] // v["enc_patch_size"]) ** 2
    d, ff = v["enc_dim"], v["enc_ff_dim"]
    patch = v["enc_patch_size"] ** 2 * v["in_channels"] * d
    per_layer = 3 * d * d + d * d + 2 * d * ff
    return 2 * n * (patch + v["enc_n_layers"] * per_layer) + 4 * v["enc_n_layers"] * d * n * n


def projection_flops(cfg: dict) -> int:
    """FLOPs of one image's projection MLP (729 tokens of the global and the
    pooled local features)."""
    v = cfg["vision"]
    n = (v["crop_size"] // v["enc_patch_size"]) ** 2
    return 2 * n * (2 * v["enc_dim"] * v["proj_inner_dim"] + v["proj_inner_dim"] * v["proj_out_dim"])


def image_prefix_len(cfg: dict) -> int:
    return cfg["text"]["prefix_attn"]


def encode_flops(cfg: dict, h: int, w: int) -> int:
    """FLOPs of one image's encode: its crops through the ViT, the
    projection and the [BOS, image] prefill."""
    return (image_crops(cfg, h, w) * vit_crop_flops(cfg) + projection_flops(cfg)
            + text_span_flops(cfg, 0, image_prefix_len(cfg)))


def prepare_flops(cfg: dict, h: int, w: int, prompt_len: int) -> int:
    """FLOPs of a request's admission: the encode and the prompt prefill."""
    return encode_flops(cfg, h, w) + text_span_flops(cfg, image_prefix_len(cfg), prompt_len)


def caption_flops(cfg: dict, h: int, w: int, prompt_len: int, tokens: int) -> int:
    """FLOPs of one image's caption of `tokens` tokens: its admission, then
    tokens - 1 decode rows (the first token comes from the prompt
    prefill)."""
    pos = image_prefix_len(cfg) + prompt_len
    return prepare_flops(cfg, h, w, prompt_len) + sum(
        decode_row_flops(cfg, pos + j) for j in range(tokens - 1))


# --------------------------------------------------- per-call kernel bounds

def encode_kernel_a(cfg: dict, h: int, w: int, prompt_len: int = 0,
                    batch_rows: int = 0) -> float:
    """Least seconds of the attention kernel A's share of one image's encode
    (the ViT's layers over its crops, the [BOS, image] prefill) and, with
    `prompt_len`, of its prompt rows prefilled with it."""
    v, t = cfg["vision"], cfg["text"]
    total = v["enc_n_layers"] * least_seconds(*vit_attention(cfg, image_crops(cfg, h, w)))
    rows = image_prefix_len(cfg) + prompt_len
    total += t["n_layers"] * least_seconds(*text_attention(cfg, rows, 0))
    return total


def pool_step_kernel(cfg: dict, positions: Sequence[int], slots: int) -> float:
    """Least seconds of one pool decode step's attention (kernel C, all
    layers) for the active rows at `positions`."""
    t = cfg["text"]
    d = t["dim"] // t["n_heads"]
    return t["n_layers"] * least_seconds(*ragged_call(t["n_heads"], d, 1, positions, slots))


def lockstep_step_kernel(cfg: dict, batch: int, pos: int) -> float:
    """Least seconds of one lockstep decode step's attention (kernel B, all
    layers): `batch` rows at one position."""
    t = cfg["text"]
    d = t["dim"] // t["n_heads"]
    return t["n_layers"] * least_seconds(*attn_call(batch, t["n_heads"], 1, pos + 1, d,
                                                    batch * (pos + 1)))
