"""ctypes binding of the Lanczos crop kernel in `csrc/lanczos_resize.cu`, and
its tile plan. The plain version and the crop pipeline that calls them live
in `moondream_tpu_torch.ops.device_preprocess`.

One launch writes a whole crop call: up to two crop sets (a resize of the
batch and the crops cut from it) of every image. `plan_crops` chooses each
set's CTA tile (TH rows x TW columns of its resized image) and the rows of
each chunk that streams its source rows through the horizontal pass, and
the dynamic shared memory the largest tile needs, from the host bands
alone (no device read). `lanczos_crops` checks device, dtype, shape,
contiguity, the bands and the plan, launches on `torch.cuda.current_stream()`
without synchronising, raises when the C entry point reports a CUDA error,
and adds one to LAUNCHES["lanczos_resize"] per launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .build import LAUNCHES, load_cuda_library

LANCZOS = "lanczos_resize"
LAUNCHES.update({LANCZOS: 0})

SMEM_LIMIT = 232448  # dynamic shared memory a CTA may use on sm_90
# (TH, TW) a set's tiles may take, tried in order, largest first (TW a
# multiple of 8: whole words per intermediate row).
TILES = ((32, 64), (16, 64), (16, 32), (8, 64), (8, 32), (8, 16))
# The fewest source rows a chunk of the horizontal pass stages (fewer only
# where a window has fewer).
MIN_RING = 8
# The most shared memory a plan takes by choice: four CTAs (half the SM's
# threads) stay resident. A plan goes past it only where nothing smaller fits.
OCCUPANCY_SMEM = SMEM_LIMIT // 4


class CropPlan(NamedTuple):
    tiles: Tuple[Tuple[int, int], ...]  # (TH, TW) of each set's tiles
    rings: Tuple[int, ...]  # each set's source rows a chunk stages (at most a window's rows)
    smem: int  # dynamic shared memory bytes: the largest tile's
    macs: int  # multiply-adds one image's tiles issue (halo rows and identity taps included)


def _axis_windows(start: Optional[np.ndarray], k: int, n_out: int,
                  tile: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per tile of `tile` outputs along one axis (the last one shorter): the
    first source index of its window and the window's length, [min start,
    max start + k), as the kernel reduces them. `start` None: an identity
    pass (start o, one tap)."""
    if start is None:
        start, k = np.arange(n_out), 1
    cuts = np.arange(0, n_out, tile)
    lo = np.minimum.reduceat(start, cuts)
    return lo, np.maximum.reduceat(start, cuts) + k - lo


def _band_parts(band) -> Tuple[Optional[np.ndarray], int]:
    return (None, 1) if band is None else (band.start.numpy(), band.taps.shape[1])


def tile_windows(size: Tuple[int, int], hband, vband, th: int, tw: int) -> tuple:
    """The source windows of a set's tiles: (row_lo, rows) per tile row and
    (col_lo, cols) per tile column of its (out_h, out_w) = `size` resize,
    from the host bands (ops.device_preprocess.Band, or None for an
    identity pass)."""
    (hs, kh), (vs, kv) = _band_parts(hband), _band_parts(vband)
    return (*_axis_windows(vs, kv, size[0], th), *_axis_windows(hs, kh, size[1], tw))


def _tile_smem(th: int, tw: int, kh: int, kv: int, rows, cols, ring_rows: int):
    """Dynamic shared-memory bytes of a tile whose window is rows x cols,
    in the kernel's layout: 4 limits, TW + TH starts, TH crop-row ranges,
    the taps at odd row strides, n = min(ring_rows, rows) ring rows of
    cols | 1 RGBX words; from the next 16-byte boundary two buffers of n
    raw rows, each cols x 3 bytes and up to 15 of lead rounded up to 16;
    then the uint8 intermediate, rows of TW x 3 bytes and a pad word."""
    rows, cols = np.asarray(rows), np.asarray(cols)
    ring = np.minimum(ring_rows, rows)
    words = 4 + tw + 2 * th + tw * (kh | 1) + th * (kv | 1) + ring * (cols | 1)
    raw_row = (cols * 3 + 30) // 16 * 16
    return -(-4 * words // 16) * 16 + 2 * ring * raw_row + rows * (tw * 3 + 4)


def plan_crops(sets: Sequence[tuple], tile: Optional[Tuple[int, int]] = None,
               ring_rows: Optional[int] = None, limit: int = SMEM_LIMIT) -> CropPlan:
    """The launch's plan for `sets`, each ((out_h, out_w), hband, vband)
    with host bands (None for an identity pass): per set the first (TH, TW)
    of TILES whose largest tile fits `limit` with chunks of MIN_RING rows;
    then the set's window rows in as few chunks of equal rows as keep its
    tiles within OCCUPANCY_SMEM, else chunks of MIN_RING. `tile` /
    `ring_rows` force one for every set (for measurements and checks).
    Raises where nothing fits: the kernel has no other route."""
    tiles, rings, smem, macs = [], [], 0, 0
    for size, hband, vband in sets:
        kh, kv = _band_parts(hband)[1], _band_parts(vband)[1]
        for th, tw in (tile,) if tile else TILES:
            _, rows, _, cols = tile_windows(size, hband, vband, th, tw)

            def need(ring: int) -> int:  # the set's largest tile's bytes
                return int(_tile_smem(th, tw, kh, kv, rows[:, None], cols[None, :], ring).max())

            if need(ring_rows or MIN_RING) <= limit:
                break
        else:
            raise ValueError(f"{LANCZOS}: no tile plan fits {limit} bytes of shared memory "
                             f"for {size} (tile {tile}, ring {ring_rows})")
        most = int(rows.max())
        ring = ring_rows or next(
            (r for r in (-(-most // n) for n in range(1, most + 1))
             if r > MIN_RING and need(r) <= OCCUPANCY_SMEM), min(MIN_RING, most))
        tiles.append((th, tw))
        rings.append(ring)
        smem = max(smem, need(ring))
        # each tile's window rows x its columns, then each output once
        macs += 3 * size[1] * (int(rows.sum()) * kh + size[0] * kv)
    return CropPlan(tuple(tiles), tuple(rings), smem, macs)


class _Set(ctypes.Structure):
    _fields_ = [("hstart", ctypes.c_void_p), ("htaps", ctypes.c_void_p),
                ("vstart", ctypes.c_void_p), ("vtaps", ctypes.c_void_p),
                *((name, ctypes.c_int) for name in (
                    "kh", "kv", "oh", "ow", "n_rows", "n_cols", "window", "crop0", "th", "tw",
                    "tiles_y", "tiles_x", "ring_rows"))]


class _Launch(ctypes.Structure):
    _fields_ = [("set", _Set * 2),
                *((name, ctypes.c_int) for name in (
                    "n_sets", "B", "H", "W", "ch", "cw", "per_image", "smem"))]


def _lib() -> ctypes.CDLL:
    lib = load_cuda_library(LANCZOS, ["lanczos_resize.cu"])
    if lib.lanczos_crops_u8.argtypes is None:
        lib.lanczos_crops_prepare.restype = ctypes.c_int
        lib.lanczos_crops_prepare.argtypes = []
        lib.lanczos_crops_u8.restype = ctypes.c_int
        lib.lanczos_crops_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.POINTER(_Launch), ctypes.c_void_p]
    return lib


LOADERS = (_lib,)
_prepared = set()  # devices whose kernel may use SMEM_LIMIT bytes


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


def _prepare(dev: torch.device) -> None:
    """Lets the kernel use SMEM_LIMIT bytes on `dev`: once per device, never
    inside a stream capture."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index in _prepared:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{LANCZOS}: the first call on cuda:{index} must not be captured")
    with torch.cuda.device(index):
        rc = _lib().lanczos_crops_prepare()
    if rc != 0:
        raise RuntimeError(f"{LANCZOS}: cudaFuncSetAttribute failed: CUDA error {rc}")
    _prepared.add(index)


def lanczos_crops(images: torch.Tensor, out: torch.Tensor, sets: Sequence, bands: Sequence,
                  crop_hw: Tuple[int, int], per_image: int, plan: CropPlan) -> None:
    """One launch of the crop kernel: images (B, H, W, 3) uint8 on a card;
    for each set (ops.device_preprocess.CropSet: size, tiling, window,
    crop0) and its (horizontal, vertical) device bands (each None where the
    set's width or height is the image's), the images resized to the set's
    size and cut into the tiling's crops of crop_hw at (r * window, c *
    window), written to crops crop0 + r * cols + c of each image's
    `per_image` in out (B * per_image, ch, cw, 3) uint8; `plan` from
    plan_crops over the same sets."""
    dev = images.device
    if dev.type != "cuda" or images.dim() != 4 or images.shape[3] != 3:
        raise ValueError(f"{LANCZOS}: images must be a CUDA (B, H, W, 3) tensor")
    _check(images, dev, torch.uint8, "images")
    _check(out, dev, torch.uint8, "out")
    bsz, h, w, _ = images.shape
    ch, cw = crop_hw
    if tuple(out.shape) != (bsz * per_image, ch, cw, 3):
        raise ValueError(f"{LANCZOS}: out {tuple(out.shape)} does not hold {bsz} x "
                         f"{per_image} crops of {crop_hw}")
    if not 1 <= len(sets) == len(bands) <= 2:
        raise ValueError(f"{LANCZOS}: {len(sets)} crop sets, {len(bands)} band pairs")
    if plan.smem > SMEM_LIMIT or not len(plan.tiles) == len(plan.rings) == len(sets) \
            or any(t not in TILES for t in plan.tiles) or min(plan.rings) < 1:
        raise ValueError(f"{LANCZOS}: plan {plan} does not fit the kernel")
    launch = _Launch(n_sets=len(sets), B=bsz, H=h, W=w, ch=ch, cw=cw, per_image=per_image,
                     smem=plan.smem)
    for i, ((oh, ow), (rows, cols), window, crop0) in enumerate(sets):
        hband, vband = bands[i]
        if (hband is None and ow != w) or (vband is None and oh != h):
            raise ValueError(f"{LANCZOS}: set {i} resizes {h}x{w} to {oh}x{ow} without a band")
        if min(rows, cols) < 1 or window < 0 or (window == 0 and rows * cols > 1) \
                or (rows - 1) * window + ch > oh or (cols - 1) * window + cw > ow \
                or crop0 < 0 or crop0 + rows * cols > per_image:
            raise ValueError(f"{LANCZOS}: a {rows}x{cols} tiling of {crop_hw} crops at "
                             f"{window} does not fit {oh}x{ow} (crops {crop0}.. of {per_image})")
        s = launch.set[i]
        for band, n_out, n_in, pre in ((hband, ow, w, "h"), (vband, oh, h, "v")):
            if band is not None:
                _check_band(band, n_out, n_in, dev)
                setattr(s, pre + "start", band.start.data_ptr())
                setattr(s, pre + "taps", band.taps.data_ptr())
        s.kh = 1 if hband is None else hband.taps.shape[1]
        s.kv = 1 if vband is None else vband.taps.shape[1]
        s.oh, s.ow, s.n_rows, s.n_cols, s.window, s.crop0 = oh, ow, rows, cols, window, crop0
        s.th, s.tw = plan.tiles[i]
        s.tiles_y, s.tiles_x = -(-oh // s.th), -(-ow // s.tw)
        s.ring_rows = plan.rings[i]
    _prepare(dev)
    rc = _lib().lanczos_crops_u8(images.data_ptr(), out.data_ptr(), ctypes.byref(launch),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{LANCZOS} launch failed: CUDA error {rc} ({torch.cuda.get_device_name(dev)})")
    LAUNCHES[LANCZOS] += 1
