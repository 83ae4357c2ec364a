"""Overlap crops on the card: PIL-exact Lanczos resize of the raw uint8
image and tile extraction, the counterpart of
moondream_tpu/ops/device_preprocess.py (which this module cannot import).

The host ships the raw image once; the card resizes it to the 378x378
global crop and to the tiling's grid target and writes the crop stack
(crop 0 = global, then the tiles row-major), uint8-equal to the host path
(`ops.image_crops.overlap_crop_image`: native C++ or PIL).

PIL's 8-bit resampler is fixed-point integer arithmetic (Pillow
Resample.c), and so is this module's:

  * tap weights are computed in float64 over the clipped window,
    normalised by their sequential sum and rounded half away from zero to
    int32 with PRECISION_BITS = 22 fractional bits (`_pil_coeffs`, a copy
    of the JAX package's, op for op);
  * a HORIZONTAL pass runs first over uint8 pixels with an int32
    accumulator seeded with 2**21, and `clip8` gives a uint8 intermediate
    (0 at or below 0, 255 at or above 2**30, else acc >> 22);
  * a VERTICAL pass repeats that on the intermediate;
  * a pass whose size does not change is skipped (a copy).

Each output pixel reads a band of at most `ksize` inputs: the tap table of
an (in, out) size pair is kept as (start (out,), taps (out, ksize)) int32,
cached on the host and on each device. A crop call (`device_resize`,
`device_overlap_crops_batched`) is one launch of the hand-written kernel of
`csrc/lanczos_resize.cu` (`kernels.preprocess`) on a CUDA tensor, tiled as
`tile_plan` plans from the host bands; on the CPU it is one call of its
plain version, `crops_plain`, whose passes do the same integer arithmetic
one tap at a time. |acc| <= 255 * sum|tap| < 2**31 for Lanczos-3, so
neither can overflow and both are exact.

`mode()` parses MOONDREAM_DEVICE_PREPROCESS as the JAX package does:
0/off/no (host crops), 1/on/yes/adaptive (the default) or eager. The port
compiles nothing per image shape, so "adaptive" and "eager" both crop on
the card at once (ROADMAP, "Deliberate deviations").
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .image_crops import select_tiling
from .tables import on_device

_FALSY = ("0", "", "false", "off", "no", "n")
_TRUTHY = ("1", "true", "on", "yes", "y")


def mode() -> str:
    """MOONDREAM_DEVICE_PREPROCESS: 'off' (host crops), 'adaptive' (the
    default) or 'eager'; both of the latter crop on the card. Any other
    value raises, so that a mistyped opt-out never leaves the card route on."""
    raw = os.environ.get("MOONDREAM_DEVICE_PREPROCESS", "1").lower()
    if raw in _FALSY:
        return "off"
    if raw in _TRUTHY or raw == "adaptive":
        return "adaptive"
    if raw == "eager":
        return "eager"
    raise ValueError(
        f"MOONDREAM_DEVICE_PREPROCESS={raw!r} not understood: use one of "
        "0/off/no (host), 1/on/yes/adaptive (default), or eager"
    )


def enabled() -> bool:
    """Crops on the card unless MOONDREAM_DEVICE_PREPROCESS=0."""
    return mode() != "off"


_SUPPORT = 3.0
PRECISION_BITS = 22  # Pillow 8bpc fixed point: 32 - 8 - 2
# The JAX package's limit on taps per output (its f32 digit-plane sums stay
# exact up to 258 taps). The port's integer passes have no such limit, but
# keep it so that both packages route the same images to the host.
_EXACT_MAX_TAPS = 258


def _lanczos_f64(x: float) -> float:
    """Pillow's lanczos_filter / sinc_filter in float64, op for op: sin at
    x*pi, then at (x/3)*pi."""
    if -_SUPPORT <= x < _SUPPORT:
        if x == 0.0:
            return 1.0
        a = x * math.pi
        b = (x / _SUPPORT) * math.pi
        return (math.sin(a) / a) * (math.sin(b) / b)
    return 0.0


@lru_cache(maxsize=64)
def _pil_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int32 fixed-point taps, as Pillow's
    precompute_coeffs + normalize_coeffs_8bpc compute them: float64 taps
    over the clipped window, their sequential sum, rounding half away from
    zero at 22 bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ss = 1.0 / filterscale
    if 2 * math.ceil(support) + 1 > _EXACT_MAX_TAPS:
        raise ValueError(
            f"resize {in_size}->{out_size} needs more taps than the "
            "exact-f32 device path guarantees; pre-shrink on host"
        )
    m = np.zeros((out_size, in_size), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(center - support + 0.5)  # C cast: trunc toward zero
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        n = xmax - xmin
        w = [0.0] * n
        ww = 0.0
        for x in range(n):  # sequential sum, like Pillow's `ww += w`
            v = _lanczos_f64((x + xmin - center + 0.5) * ss)
            w[x] = v
            ww += v
        for x in range(n):
            c = w[x] / ww if ww != 0.0 else w[x]
            scaled = c * (1 << PRECISION_BITS)
            m[xx, xmin + x] = int(
                scaled + 0.5 if scaled >= 0 else scaled - 0.5
            )
    return m


def exact_path_supported(h: int, w: int, base_size: int = 378) -> bool:
    """True when every resize of the crop pipeline keeps within
    _EXACT_MAX_TAPS taps (the global crop's downscale binds: the grid
    target is never smaller than base_size)."""
    scale = max(h, w) / base_size
    return 2 * math.ceil(_SUPPORT * max(scale, 1.0)) + 1 <= _EXACT_MAX_TAPS


def preprocess_tiling(h: int, w: int, crop_size: int, patch_size: int,
                      overlap_margin: int, max_crops: int) -> Tuple[int, int]:
    """The tiling overlap_crop_image chooses for an (h, w) image."""
    margin_px = patch_size * overlap_margin
    window = (crop_size // patch_size - 2 * overlap_margin) * patch_size
    return select_tiling(h - 2 * margin_px, w - 2 * margin_px, window, max_crops)


# Images sent to each crop route since the last reset_route_counts().
ROUTES: Dict[str, int] = {"device": 0, "host": 0}


def reset_route_counts() -> None:
    for name in ROUTES:
        ROUTES[name] = 0


def device_route(h: int, w: int, base_size: int = 378) -> bool:
    """Whether an (h, w) image crops on the card: MOONDREAM_DEVICE_PREPROCESS
    is not 0 and the image is within exact_path_supported. Counted in
    ROUTES. Nothing else picks the host route: a kernel that fails raises."""
    on = enabled() and exact_path_supported(h, w, base_size)
    ROUTES["device" if on else "host"] += 1
    return on


class Band(NamedTuple):
    """The taps of one (in, out) size pair: output o reads inputs
    [start[o], start[o] + ksize) of n_in with weights taps[o]."""

    start: torch.Tensor  # (out,) int32
    taps: torch.Tensor  # (out, ksize) int32
    n_in: int


@lru_cache(maxsize=64)
def _host_band(in_size: int, out_size: int) -> Band:
    """The dense tap matrix cut to a band per output: ksize is the widest
    span of non-zero taps of any output, and each output's window is moved
    left where it would pass the last input (the taps it gains are zero)."""
    m = _pil_coeffs(in_size, out_size)
    nz = m != 0
    first = nz.argmax(axis=1)
    last = in_size - 1 - nz[:, ::-1].argmax(axis=1)
    ksize = int((last - first).max()) + 1
    start = np.minimum(first, in_size - ksize).astype(np.int32)
    cols = start[:, None] + np.arange(ksize)
    taps = np.ascontiguousarray(np.take_along_axis(m, cols, axis=1))
    if (np.abs(taps).sum(axis=1, dtype=np.int64)
            != np.abs(m).sum(axis=1, dtype=np.int64)).any():
        raise AssertionError(f"band {in_size}->{out_size} lost taps")
    return Band(torch.from_numpy(start), torch.from_numpy(taps), in_size)


def band(in_size: int, out_size: int, device) -> Band:
    """The tap band of an (in, out) size pair on `device` (on a card it goes
    up once, without a host sync: `ops.tables.on_device`)."""
    start, taps = on_device(("lanczos band", in_size, out_size),
                            lambda: _host_band(in_size, out_size)[:2], device)
    return Band(start, taps, in_size)


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    """Pillow's clip8 of an int32 accumulator holding the 2**21 rounding
    constant (0 at or below 0, 255 at or above 2**30, else acc >> 22),
    written as clamp(acc >> 22, 0, 255), which gives the same bytes.
    Updates `acc` in place."""
    return acc.bitwise_right_shift_(PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def _pass_plain(x: torch.Tensor, b: Band, axis: int) -> torch.Tensor:
    """One plain pass of uint8 x along `axis`: the resampled axis is moved to
    the front, and each tap adds whole gathered rows times its weight to
    the int32 accumulator."""
    xt = x.movedim(axis, 0)
    xi = xt.reshape(xt.shape[0], -1).to(torch.int32)
    start, taps = b.start.long(), b.taps
    acc = torch.full((start.shape[0], xi.shape[1]), 1 << (PRECISION_BITS - 1),
                     dtype=torch.int32, device=x.device)
    for k in range(taps.shape[1]):
        acc.addcmul_(xi.index_select(0, start + k), taps[:, k, None])
    out = _clip8(acc).view(start.shape[0], *xt.shape[1:])
    return out.movedim(0, axis).contiguous()


def resize_h_plain(x: torch.Tensor, b: Band) -> torch.Tensor:
    """Plain horizontal pass: (B, H, W, 3) uint8 -> (B, H, out, 3) uint8."""
    return _pass_plain(x, b, 2)


def resize_v_plain(x: torch.Tensor, b: Band) -> torch.Tensor:
    """Plain vertical pass: (B, H, W, 3) uint8 -> (B, out, W, 3) uint8."""
    return _pass_plain(x, b, 1)


def v_crops_plain(src: torch.Tensor, out: torch.Tensor, b: Optional[Band], crop_hw,
                  window: int, tiling, crop0: int, per_image: int) -> None:
    """The vertical pass of crops_plain, into a crop stack: the vertical
    pass of src (B, H, W, 3) (skipped when `b` is None), and
    crops of crop_hw cut from it at (r * window, c * window) for the
    tiling's rows and columns, written row-major to crops crop0, crop0 + 1,
    ... of each image's `per_image` in out (B * per_image, ch, cw, 3)."""
    full = src if b is None else resize_v_plain(src, b)
    ch, cw = crop_hw
    crops = out.view(src.shape[0], per_image, *out.shape[1:])
    for r in range(tiling[0]):
        for c in range(tiling[1]):
            y0, x0 = r * window, c * window
            crops[:, crop0 + r * tiling[1] + c] = full[:, y0:y0 + ch, x0:x0 + cw]


class CropSet(NamedTuple):
    """One resize of a crop call and the crops cut from it: the images
    resized to `size` (out_h, out_w), then tiling[0] x tiling[1] crops at
    (r * window, c * window), written to crops crop0 + r * tiling[1] + c of
    each image's stack."""

    size: Tuple[int, int]
    tiling: Tuple[int, int]
    window: int
    crop0: int


def overlap_sets(tiling: Tuple[int, int], base_size: int = 378, patch_size: int = 14,
                 overlap_margin: int = 4) -> Tuple[CropSet, CropSet]:
    """The crop sets of an overlap-crop call: the global crop (the whole
    base_size resize) and the tiling's grid."""
    margin_px = patch_size * overlap_margin
    window = base_size - 2 * margin_px
    grid = (tiling[0] * window + 2 * margin_px, tiling[1] * window + 2 * margin_px)
    return (CropSet((base_size, base_size), (1, 1), window, 0),
            CropSet(grid, tuple(tiling), window, 1))


def set_bands(h: int, w: int, s: CropSet, device) -> Tuple[Optional[Band], Optional[Band]]:
    """A set's (horizontal, vertical) bands on `device`, None for a pass
    whose size does not change (Pillow skips it)."""
    oh, ow = s.size
    return (None if w == ow else band(w, ow, device), None if h == oh else band(h, oh, device))


@lru_cache(maxsize=64)
def tile_plan(h: int, w: int, sets: Tuple[CropSet, ...]):
    """The crop kernel's plan (kernels.preprocess.plan_crops) for (h, w)
    images and `sets`, from the host bands: a call reads nothing from the
    card for it. Raises past the sizes the bands take."""
    from ..kernels.preprocess import plan_crops

    return plan_crops([(s.size, *set_bands(h, w, s, "cpu")) for s in sets])


def crops_plain(images: torch.Tensor, out: torch.Tensor, sets, crop_hw, per_image: int) -> None:
    """Plain version of the crop kernel, one call per launch: for each set,
    the plain horizontal pass of the (B, H, W, 3) images to the set's width
    (skipped where it does not change), then the vertical pass into the
    set's crops of crop_hw in out (B * per_image, ch, cw, 3)."""
    h, w = images.shape[1:3]
    for s in sets:
        hb, vb = set_bands(h, w, s, images.device)
        src = images if hb is None else resize_h_plain(images, hb)
        v_crops_plain(src, out, vb, crop_hw, s.window, s.tiling, s.crop0, per_image)


def _crops(images: torch.Tensor, out: torch.Tensor, sets, crop_hw, per_image: int,
           plain: bool) -> None:
    """One crop call: the kernel on a card, the plain version on the CPU or
    with `plain`."""
    if plain or images.device.type == "cpu":
        return crops_plain(images, out, sets, crop_hw, per_image)
    from ..kernels.preprocess import lanczos_crops

    h, w = images.shape[1:3]
    lanczos_crops(images, out, sets, [set_bands(h, w, s, images.device) for s in sets],
                  crop_hw, per_image, tile_plan(h, w, tuple(sets)))


def _check_images(images: torch.Tensor) -> None:
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[3] != 3:
        raise ValueError(f"images must be uint8 (B, H, W, 3), got {images.dtype} "
                         f"{tuple(images.shape)}")


def device_resize(image_u8: torch.Tensor, out_h: int, out_w: int,
                  plain: bool = False) -> torch.Tensor:
    """(H, W, 3) uint8 -> (out_h, out_w, 3) uint8, exactly
    PIL.Image.resize((out_w, out_h), LANCZOS), on the image's device (the
    kernel on a card, the plain passes on the CPU or with `plain`)."""
    x = image_u8[None]
    _check_images(x)
    out = torch.empty((1, out_h, out_w, 3), dtype=torch.uint8, device=x.device)
    _crops(x, out, (CropSet((out_h, out_w), (1, 1), 0, 0),), (out_h, out_w), 1, plain)
    return out[0]


def device_overlap_crops_batched(
    images_u8: torch.Tensor,
    tiling: Tuple[int, int],
    base_size: int = 378,
    patch_size: int = 14,
    overlap_margin: int = 4,
    out: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 images of one shape -> (B * (rows * cols + 1),
    base, base, 3) uint8 crops, image-major, each image's global crop first
    and then its tiles row-major: the host path's crops. `out` receives
    them when given (a contiguous slice of a larger stack). One launch for
    the whole batch: both crop sets (overlap_sets) of every image, both
    passes of each (a copy where a size does not change)."""
    _check_images(images_u8)
    per_image = tiling[0] * tiling[1] + 1
    shape = (images_u8.shape[0] * per_image, base_size, base_size, 3)
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=images_u8.device)
    elif tuple(out.shape) != shape or out.dtype != torch.uint8 or not out.is_contiguous():
        raise ValueError(f"out must be contiguous uint8 {shape}, got {tuple(out.shape)}")
    _crops(images_u8, out, overlap_sets(tiling, base_size, patch_size, overlap_margin),
           (base_size, base_size), per_image, plain)
    return out


def device_overlap_crops(
    image_u8: torch.Tensor,
    tiling: Tuple[int, int],
    base_size: int = 378,
    patch_size: int = 14,
    overlap_margin: int = 4,
    out: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """(H, W, 3) uint8 -> (rows * cols + 1, base, base, 3) uint8 crops, equal
    to ops.image_crops.overlap_crop_image's, same geometry."""
    return device_overlap_crops_batched(image_u8[None], tiling, base_size, patch_size,
                                        overlap_margin, out, plain)
