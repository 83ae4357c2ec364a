"""ctypes bindings of the Lanczos crop kernels in `csrc/lanczos_resize.cu`:
the horizontal pass and the vertical pass that writes into the crop stack.
Their plain versions and the crop pipeline that calls them live in
`moondream_tpu_torch.ops.device_preprocess`.

Each wrapper checks device, dtype, shape and contiguity, launches on
`torch.cuda.current_stream()` without synchronising, raises when the C
entry point reports a CUDA error, and adds one to LAUNCHES["lanczos_resize"]
for each launch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import LAUNCHES, load_cuda_library

LANCZOS = "lanczos_resize"
LAUNCHES.update({LANCZOS: 0})


def _lib() -> ctypes.CDLL:
    lib = load_cuda_library(LANCZOS, ["lanczos_resize.cu"])
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("lanczos_h_u8", [ptr] * 4 + [ll] + [i] * 3 + [ptr]),
                       ("lanczos_v_crops_u8", [ptr] * 4 + [i] * 12 + [ptr])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype = i
            fn.argtypes = args
    return lib


LOADERS = (_lib,)


def _check(t: torch.Tensor, dev: torch.device, dtype, what: str) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{LANCZOS}: {what} must be contiguous {dtype} on {dev}, got "
                         f"{t.dtype} on {t.device}")


def _check_band(band, n_out: int, n_in: int, dev: torch.device) -> None:
    """A band (ops.device_preprocess.Band) made for n_in -> n_out: then every
    start[o] + ksize <= n_in, which the kernel does not check."""
    start, taps, band_in = band
    _check(start, dev, torch.int32, "start")
    _check(taps, dev, torch.int32, "taps")
    if band_in != n_in or start.shape != (n_out,) or taps.dim() != 2 \
            or taps.shape[0] != n_out or not 0 < taps.shape[1] <= n_in:
        raise ValueError(f"{LANCZOS}: band {band_in} -> {tuple(start.shape)} / "
                         f"{tuple(taps.shape)} does not fit {n_in} -> {n_out}")


def _launched(rc: int, dev: torch.device) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{LANCZOS} launch failed: CUDA error {rc} ({torch.cuda.get_device_name(dev)})")
    LAUNCHES[LANCZOS] += 1


def lanczos_h(x: torch.Tensor, band) -> torch.Tensor:
    """The horizontal pass: x (B, H, W, 3) uint8 on a card -> (B, H, out, 3)
    uint8 over a W -> out band (ops.device_preprocess.Band)."""
    dev = x.device
    if dev.type != "cuda" or x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"{LANCZOS}: x must be a CUDA (B, H, W, 3) tensor")
    _check(x, dev, torch.uint8, "x")
    bsz, h, w, _ = x.shape
    n_out = band.start.shape[0]
    _check_band(band, n_out, w, dev)
    out = torch.empty((bsz, h, n_out, 3), dtype=torch.uint8, device=dev)
    _launched(_lib().lanczos_h_u8(
        x.data_ptr(), out.data_ptr(), band.start.data_ptr(), band.taps.data_ptr(), bsz * h, w,
        n_out, band.taps.shape[1], torch.cuda.current_stream(dev).cuda_stream), dev)
    return out


def lanczos_v_crops(src: torch.Tensor, out: torch.Tensor, band, crop_hw: Tuple[int, int],
                    window: int, tiling: Tuple[int, int], crop0: int, per_image: int) -> None:
    """The vertical pass into a crop stack: src (B, H, W, 3) uint8, resized
    over an H -> OH band (ops.device_preprocess.Band) or copied when `band`
    is None,
    and cut into the tiling's crops of crop_hw at (r * window, c * window),
    written to crops crop0 ... of each image's `per_image` in out (B *
    per_image, ch, cw, 3) uint8."""
    dev = src.device
    if dev.type != "cuda" or src.dim() != 4 or src.shape[3] != 3:
        raise ValueError(f"{LANCZOS}: src must be a CUDA (B, H, W, 3) tensor")
    _check(src, dev, torch.uint8, "src")
    _check(out, dev, torch.uint8, "out")
    bsz, h, w, _ = src.shape
    ch, cw = crop_hw
    if tuple(out.shape) != (bsz * per_image, ch, cw, 3):
        raise ValueError(f"{LANCZOS}: out {tuple(out.shape)} does not hold {bsz} x "
                         f"{per_image} crops of {crop_hw}")
    start = taps = None
    n_out, k = h, 0
    if band is not None:
        n_out, k = band.taps.shape
        _check_band(band, n_out, h, dev)
        start, taps = band.start.data_ptr(), band.taps.data_ptr()
    _launched(_lib().lanczos_v_crops_u8(
        src.data_ptr(), out.data_ptr(), start, taps, bsz, h, w, n_out, k, ch, cw, window,
        tiling[0], tiling[1], crop0, per_image, torch.cuda.current_stream(dev).cuda_stream), dev)
