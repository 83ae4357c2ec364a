"""The Lanczos crop kernel's tile plan (`kernels.preprocess.plan_crops`, via
`ops.device_preprocess.tile_plan`), on the CPU without a card:

  * over the band pairs of the kernel tests' resizes and crops, the smoke's
    crop shapes and the widest image `exact_path_supported` admits, every
    tile's source window holds every tap of each of its rows and columns,
    and the plan's shared memory is at least the largest tile's need (the
    kernel's layout, counted here again) and at most what a CTA may use;
  * the plan raises past the admitted sizes and where nothing fits;
  * a numpy walk of the kernel's tiles, driven by the plan (per tile: the
    horizontal pass over the window into a uint8 tile, then the vertical
    pass, written to every crop that holds a pixel), equals the plain crops
    byte for byte, and issues the multiply-adds the plan counts.
"""

import numpy as np
import pytest
import torch

from moondream_tpu_torch.kernels import preprocess as kp
from moondream_tpu_torch.ops import device_preprocess as devpre

from test_torch_lanczos_kernel import CROPS, RESIZES

SMOKE_SHAPES = [(756, 1008), (378, 378), (600, 800), (1080, 1440), (240, 320), (2160, 3840),
                (700, 900)]
WIDEST = [(16128, 16128), (64, 16128), (16128, 64)]  # exact_path_supported's edge


def _crop_sets(h, w):
    return devpre.overlap_sets(devpre.preprocess_tiling(h, w, 378, 14, 4, 12))


CASES = ([(shape, (devpre.CropSet(out, (1, 1), 0, 0),)) for shape, out in RESIZES]
         + [(shape, _crop_sets(*shape)) for shape in sorted(set(CROPS + SMOKE_SHAPES + WIDEST))])


def _host_bands(h, w, s):
    oh, ow = s.size
    return (None if w == ow else devpre._host_band(w, ow),
            None if h == oh else devpre._host_band(h, oh))


def _band_arrays(band, n_out):
    """(start, taps) as numpy, the identity pass's one tap of 1 << 22 where
    `band` is None (as the kernel stages it)."""
    if band is None:
        return np.arange(n_out), np.full((n_out, 1), 1 << 22, np.int64)
    return band.start.numpy().astype(np.int64), band.taps.numpy().astype(np.int64)


def _clip8(acc):
    return np.clip(acc >> 22, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape,sets", CASES, ids=lambda v: str(v) if len(v) == 2 else "")
def test_windows_cover_every_tap_and_plan_holds_the_largest_tile(shape, sets):
    h, w = shape
    plan = devpre.tile_plan(h, w, sets)
    assert len(plan.tiles) == len(sets) and all(t in kp.TILES for t in plan.tiles)
    need = 0
    for s, (th, tw), ring_rows in zip(sets, plan.tiles, plan.rings):
        hband, vband = _host_bands(h, w, s)
        row_lo, rows, col_lo, cols = kp.tile_windows(s.size, hband, vband, th, tw)
        for axis, (lo, span, band, tile) in enumerate(((row_lo, rows, vband, th),
                                                       (col_lo, cols, hband, tw))):
            n_out = s.size[axis]
            start, taps = _band_arrays(band, n_out)
            t = np.arange(n_out) // tile  # each output's tile
            assert len(lo) == t[-1] + 1
            # every tap of every output inside its tile's window, inside the image
            assert (start >= lo[t]).all() and (start + taps.shape[1] <= lo[t] + span[t]).all()
            assert lo.min() >= 0 and (lo + span).max() <= shape[axis]
        kh = 1 if hband is None else hband.taps.shape[1]
        kv = 1 if vband is None else vband.taps.shape[1]
        for r in rows:  # the kernel's layout: words, two raw buffers, the intermediate
            for c in cols:
                ring = min(ring_rows, r)
                words = 4 + tw + 2 * th + tw * (kh | 1) + th * (kv | 1) + ring * (c | 1)
                raw_row = 16 * ((15 + 3 * c + 15) // 16)  # up to 15 bytes of lead
                need = max(need, 16 * ((4 * words + 15) // 16) + 2 * ring * raw_row
                           + r * (tw * 3 + 4))
    assert need <= plan.smem <= kp.SMEM_LIMIT
    assert need == plan.smem


def test_plan_raises_past_the_admitted_sizes():
    assert devpre.exact_path_supported(16128, 16128)
    assert not devpre.exact_path_supported(16129, 16129)
    for h, w in [(16129, 16129), (64, 16129), (16129, 64)]:
        with pytest.raises(ValueError):
            devpre.tile_plan(h, w, _crop_sets(h, w))
    sets = [(s.size, *_host_bands(16128, 16128, s)) for s in _crop_sets(16128, 16128)]
    with pytest.raises(ValueError, match="no tile plan fits"):
        kp.plan_crops(sets, limit=64 * 1024)
    with pytest.raises(ValueError, match="no tile plan fits"):
        kp.plan_crops(sets, tile=(32, 64))  # the widest tile does not fit 227 KB


def test_plan_prefers_occupancy_then_shrinks_tiles():
    """The largest tiles that fit; each set's window rows in as few equal
    chunks as keep four CTAs an SM; the widest image's tiles shrink until
    they fit."""
    host = [(s.size, *_host_bands(756, 1008, s)) for s in _crop_sets(756, 1008)]
    plan = devpre.tile_plan(756, 1008, _crop_sets(756, 1008))
    assert plan.tiles == ((32, 64), (32, 64))
    assert plan.rings[1] == 32  # the grid's upscale windows: one chunk
    assert plan.smem <= kp.OCCUPANCY_SMEM
    # one chunk fewer for the global crop's 74-row windows leaves 3 CTAs an SM
    more = kp.plan_crops(host[:1], ring_rows=-(-74 // (-(-74 // plan.rings[0]) - 1)))
    assert more.smem > kp.OCCUPANCY_SMEM
    assert devpre.tile_plan(2160, 3840, _crop_sets(2160, 3840)).rings == (8, 10)
    widest = devpre.tile_plan(16128, 16128, _crop_sets(16128, 16128))
    assert widest.tiles[0] not in kp.TILES[:2] and widest.smem <= kp.SMEM_LIMIT


def _emulate(images, sets, crop_hw, per_image, plan):
    """The kernel's tile walk in numpy: each tile's window sliced out first
    (an index past it fails), the horizontal pass into a uint8 tile, the
    vertical pass over it, the tile's pixels written to every crop holding
    them. Returns the crop stack and the multiply-adds per image."""
    bsz, h, w, _ = images.shape
    ch, cw = crop_hw
    out = np.zeros((bsz, per_image, ch, cw, 3), np.uint8)
    written = np.zeros((per_image, ch, cw), np.int64)
    macs = 0
    for s in sets:
        oh, ow = s.size
        hband, vband = _host_bands(h, w, s)
        hs, ht = _band_arrays(hband, ow)
        vs, vt = _band_arrays(vband, oh)
        th, tw = plan.tiles[sets.index(s)]
        row_lo, rows, col_lo, cols = kp.tile_windows(s.size, hband, vband, th, tw)
        for ty, (r0, nr) in enumerate(zip(row_lo, rows)):
            gy = np.arange(ty * th, min(oh, (ty + 1) * th))
            for tx, (c0, nc) in enumerate(zip(col_lo, cols)):
                gx = np.arange(tx * tw, min(ow, (tx + 1) * tw))
                win = images[:, r0:r0 + nr, c0:c0 + nc].astype(np.int64)
                acc = np.full((bsz, nr, len(gx), 3), 1 << 21, np.int64)
                for k in range(ht.shape[1]):
                    acc += win[:, :, hs[gx] - c0 + k] * ht[gx, k][None, None, :, None]
                mid = _clip8(acc)
                acc = np.full((bsz, len(gy), len(gx), 3), 1 << 21, np.int64)
                for k in range(vt.shape[1]):
                    acc += mid[:, vs[gy] - r0 + k].astype(np.int64) * vt[gy, k][None, :, None,
                                                                                None]
                tile = _clip8(acc)
                macs += 3 * len(gx) * (nr * ht.shape[1] + len(gy) * vt.shape[1])
                for r in range(s.tiling[0]):
                    for c in range(s.tiling[1]):
                        y = gy - r * s.window
                        x = gx - c * s.window
                        ys, xs = (y >= 0) & (y < ch), (x >= 0) & (x < cw)
                        j = s.crop0 + r * s.tiling[1] + c
                        out[:, j, y[ys][:, None], x[xs][None, :]] = tile[:, ys][:, :, xs]
                        written[j, y[ys][:, None], x[xs][None, :]] += 1
    assert (written > 0).all()  # every crop pixel of the stack comes from some tile
    return out.reshape(bsz * per_image, ch, cw, 3), macs


@pytest.mark.parametrize("shape,batch", [((756, 1008), 2), ((378, 378), 2), ((97, 203), 2),
                                         ((500, 378), 2), ((2160, 3840), 1)])
def test_tile_walk_equals_plain_crops(shape, batch):
    h, w = shape
    images = np.random.default_rng(h + w).integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    tiling = devpre.preprocess_tiling(h, w, 378, 14, 4, 12)
    sets = devpre.overlap_sets(tiling)
    per_image = tiling[0] * tiling[1] + 1
    plan = devpre.tile_plan(h, w, sets)
    got, macs = _emulate(images, sets, (378, 378), per_image, plan)
    want = devpre.device_overlap_crops_batched(torch.from_numpy(images), tiling).numpy()
    np.testing.assert_array_equal(got, want)
    assert macs == plan.macs


def test_tile_walk_equals_plain_resize():
    """device_resize's one set (a crop of the whole resize, no window)."""
    img = np.random.default_rng(5).integers(0, 256, (1, 500, 400, 3), dtype=np.uint8)
    sets = (devpre.CropSet((882, 1162), (1, 1), 0, 0),)
    plan = devpre.tile_plan(500, 400, sets)
    got, _ = _emulate(img, sets, (882, 1162), 1, plan)
    want = devpre.device_resize(torch.from_numpy(img[0]), 882, 1162).numpy()
    np.testing.assert_array_equal(got[0], want)
