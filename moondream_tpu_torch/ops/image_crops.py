"""Overlap-crop image tiling on the host, and the feature-plane stitch.

Same geometry as `moondream_tpu.ops.image_crops` (a global crop resized to
378x378 plus a grid of overlapping local crops), which this module cannot
import: that package's `ops/__init__.py` pulls in jax. The LANCZOS resize
and tile extraction run in one call into the in-repo C++ library
`native/preprocess.cpp` (bit-exact with PIL), built with g++ at first use
into the port's build directory and loaded with ctypes. PIL is imported
only on the fallback path, when no compiler is present or
MOONDREAM_NO_NATIVE is set.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from pathlib import Path
from typing import Optional, Tuple, TypedDict

import numpy as np
import torch

from ..kernels.build import compile_library
from .tables import on_device

_NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "preprocess.cpp"
# The same flags as native/Makefile, so crops match the JAX package's build.
_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-march=native"]

_lock = threading.Lock()
_native: Optional[ctypes.CDLL] = None
_native_tried = False


def load_native() -> Optional[ctypes.CDLL]:
    """The native crop library, built on first use; None when disabled or
    when it cannot be built here (callers then take the PIL path)."""
    global _native, _native_tried
    if os.environ.get("MOONDREAM_NO_NATIVE"):
        return None
    with _lock:
        if not _native_tried:
            _native_tried = True
            if _NATIVE_SRC.exists():
                try:
                    path = compile_library(
                        "mdpreprocess", [_NATIVE_SRC], ["g++"], _CXX_FLAGS
                    )
                except (OSError, RuntimeError):
                    path = None
                if path is not None:
                    lib = ctypes.CDLL(str(path))
                    lib.md_overlap_crops.restype = ctypes.c_int
                    lib.md_overlap_crops.argtypes = [
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int,
                    ]
                    _native = lib
        return _native


def select_tiling(
    height: int, width: int, crop_size: int, max_crops: int
) -> Tuple[int, int]:
    """(rows, cols) tile grid covering the image with <= max_crops tiles of
    `crop_size` usable pixels (moondream_tpu/ops/image_crops.py:32-60)."""
    if height <= crop_size or width <= crop_size:
        return (1, 1)

    min_h = math.ceil(height / crop_size)
    min_w = math.ceil(width / crop_size)

    if min_h * min_w > max_crops:
        ratio = math.sqrt(max_crops / (min_h * min_w))
        return (
            max(1, math.floor(min_h * ratio)),
            max(1, math.floor(min_w * ratio)),
        )

    h_tiles = max(math.floor(math.sqrt(max_crops * height / width)), min_h)
    w_tiles = max(math.floor(math.sqrt(max_crops * width / height)), min_w)

    if h_tiles * w_tiles > max_crops:
        if w_tiles > h_tiles:
            w_tiles = math.floor(max_crops / h_tiles)
        else:
            h_tiles = math.floor(max_crops / w_tiles)

    return (max(1, h_tiles), max(1, w_tiles))


class OverlapCropOutput(TypedDict):
    crops: np.ndarray  # (n_tiles + 1, base, base, C) uint8; index 0 = global
    tiling: Tuple[int, int]


def overlap_crop_image(
    image: np.ndarray,
    overlap_margin: int,
    max_crops: int,
    base_size: Tuple[int, int] = (378, 378),
    patch_size: int = 14,
) -> OverlapCropOutput:
    """A global crop plus overlapping local crops of a uint8 (H, W, C) image
    (moondream_tpu/ops/image_crops.py:68-122)."""
    orig_h, orig_w = image.shape[:2]
    channels = image.shape[2]

    margin_px = patch_size * overlap_margin
    both_margins = 2 * margin_px
    patches_per_side = base_size[0] // patch_size
    window_px = (patches_per_side - 2 * overlap_margin) * patch_size

    tiling = select_tiling(
        orig_h - both_margins, orig_w - both_margins, window_px, max_crops
    )
    n_rows, n_cols = tiling
    out = np.zeros(
        (n_rows * n_cols + 1, base_size[0], base_size[1], channels), np.uint8
    )

    lib = load_native() if base_size[0] == base_size[1] else None
    if lib is not None and channels in (1, 3, 4):
        src = np.ascontiguousarray(image, dtype=np.uint8)
        rc = lib.md_overlap_crops(
            src.ctypes.data, orig_h, orig_w, channels, out.ctypes.data,
            base_size[0], margin_px, n_rows, n_cols, 0,
        )
        if rc == 0:
            return {"crops": out, "tiling": tiling}
        out[:] = 0

    from PIL import Image

    target_h = n_rows * window_px + both_margins
    target_w = n_cols * window_px + both_margins
    pil = Image.fromarray(image)
    resized = np.asarray(
        pil.resize((target_w, target_h), resample=Image.Resampling.LANCZOS)
    )
    out[0] = np.asarray(
        pil.resize((base_size[1], base_size[0]), resample=Image.Resampling.LANCZOS)
    )
    for r in range(n_rows):
        for c in range(n_cols):
            y0 = r * window_px
            x0 = c * window_px
            tile = resized[y0 : y0 + base_size[0], x0 : x0 + base_size[1]]
            out[1 + r * n_cols + c, : tile.shape[0], : tile.shape[1]] = tile
    return {"crops": out, "tiling": tiling}


def reconstruct_from_crops(
    crops: torch.Tensor,
    tiling: Tuple[int, int],
    overlap_margin: int,
    patch_size: int = 14,
) -> torch.Tensor:
    """Stitch (..., n_tiles, H, W, C) per-crop planes into one plane each,
    dropping interior margins and keeping the outer border, as one index
    gather (moondream_tpu/ops/image_crops.py:125-173); leading axes are
    images of one tiling."""
    n_rows, n_cols = tiling
    tile_h, tile_w = int(crops.shape[-3]), int(crops.shape[-2])
    margin = overlap_margin * patch_size
    inner_h, inner_w = tile_h - 2 * margin, tile_w - 2 * margin
    out_h = inner_h * n_rows + 2 * margin
    out_w = inner_w * n_cols + 2 * margin

    def axis_index(out_len, inner, n_tiles, tile_len):
        pos = np.arange(out_len)
        tile = np.clip((pos - margin) // max(inner, 1), 0, n_tiles - 1)
        off = np.clip(pos - tile * inner, 0, tile_len - 1)
        return tile, off

    def indices():
        tile_r, off_r = axis_index(out_h, inner_h, n_rows, tile_h)
        tile_c, off_c = axis_index(out_w, inner_w, n_cols, tile_w)
        return tuple(map(torch.from_numpy, (tile_r[:, None] * n_cols + tile_c[None, :],
                                            off_r[:, None], off_c[None, :])))

    key = ("stitch", n_rows, n_cols, tile_h, tile_w, margin)
    tile_idx, off_r, off_c = on_device(key, indices, crops.device)
    lead = crops.shape[:-4]
    flat = crops.reshape(-1, *crops.shape[-4:])
    out = flat[:, tile_idx, off_r, off_c]
    return out.reshape(*lead, *out.shape[1:])
