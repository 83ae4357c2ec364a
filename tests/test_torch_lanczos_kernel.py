"""The port's device preprocessing (`moondream_tpu_torch.ops.device_preprocess`)
against PIL and the port's host crops, without JAX:

  * the plain resize is uint8-equal to PIL.Image.resize(LANCZOS) over the
    JAX package's shape corpus (up- and downscale, both identity cases,
    an odd size, 4K -> 378);
  * the plain crops equal `ops.image_crops.overlap_crop_image`'s, single
    and batched, and fill a larger stack in place;
  * on a card (marked `cuda`, skipped here) the Lanczos kernel is
    uint8-equal to the plain version and PIL over the resizes, and to the
    plain version and the host crops over the crops, 2160x3840 and a
    batched call; each crop call is one launch; its one entry raises on
    what it does not take.

The kernel cases run on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_lanczos_kernel.py`.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from moondream_tpu_torch.ops import device_preprocess as devpre
from moondream_tpu_torch.ops.image_crops import overlap_crop_image

RESIZES = [
    ((240, 320), (378, 378)),  # upscale both axes
    ((1080, 1440), (378, 378)),  # downscale to the global crop
    ((1080, 1440), (910, 1176)),  # downscale to a 3x4 grid
    ((500, 400), (882, 1162)),  # upscale to a grid
    ((378, 378), (378, 378)),  # identity: both passes skipped
    ((500, 378), (378, 378)),  # one pass skipped
    ((97, 203), (378, 378)),  # odd small
    ((2160, 3840), (378, 378)),  # 4K downscale (wide tap windows)
]
CROPS = [(800, 600), (1080, 1440), (240, 320), (756, 1008), (378, 378), (600, 800)]


def _image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


def _pil_resize(img, out):
    return np.asarray(Image.fromarray(img).resize((out[1], out[0]), Image.Resampling.LANCZOS))


def _host(img):
    out = overlap_crop_image(img, overlap_margin=4, max_crops=12)
    return out["crops"], tuple(out["tiling"])


@pytest.mark.parametrize("shape,out", RESIZES)
def test_plain_resize_equals_pil(shape, out):
    img = _image(shape)
    got = devpre.device_resize(torch.from_numpy(img), *out)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*out, 3)
    np.testing.assert_array_equal(got.numpy(), _pil_resize(img, out))


@pytest.mark.parametrize("shape", CROPS)
def test_plain_crops_equal_host_crops(shape):
    img = _image(shape, seed=1)
    want, tiling = _host(img)
    assert devpre.preprocess_tiling(*shape, 378, 14, 4, 12) == tiling
    got = devpre.device_overlap_crops(torch.from_numpy(img), tiling)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_batched_crops_fill_a_larger_stack():
    imgs = [_image((700, 900), seed=s) for s in range(3)]
    host = [_host(im) for im in imgs]
    tiling = host[0][1]
    want = np.concatenate([c for c, _ in host])
    stack = torch.full((want.shape[0] + 2, 378, 378, 3), 7, dtype=torch.uint8)
    out = devpre.device_overlap_crops_batched(torch.from_numpy(np.stack(imgs)), tiling,
                                              out=stack[1:1 + want.shape[0]])
    np.testing.assert_array_equal(out.numpy(), want)
    assert bool((stack[0] == 7).all()) and bool((stack[-1] == 7).all())


def test_band_covers_every_tap():
    """Each output's band holds all its non-zero taps, inside the input."""
    for n_in, n_out in [(1008, 378), (756, 910), (3840, 378), (378, 379), (5, 378)]:
        b = devpre.band(n_in, n_out, "cpu")
        dense = devpre._pil_coeffs(n_in, n_out)
        k = b.taps.shape[1]
        assert int(b.start.min()) >= 0 and int(b.start.max()) + k <= n_in
        rebuilt = np.zeros_like(dense)
        for o in range(n_out):
            rebuilt[o, b.start[o]:b.start[o] + k] = b.taps[o].numpy()
        np.testing.assert_array_equal(rebuilt, dense)


# ----------------------------------------------------------------- card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out", RESIZES)
def test_kernel_resize_equals_plain_and_pil(cuda, shape, out):
    img = _image(shape)
    x = torch.from_numpy(img).to(cuda)
    got = devpre.device_resize(x, *out)
    plain = devpre.device_resize(x, *out, plain=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), _pil_resize(img, out))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CROPS + [(2160, 3840)])
def test_kernel_crops_equal_plain_and_host(cuda, shape):
    from moondream_tpu_torch.kernels.build import LAUNCHES
    from moondream_tpu_torch.kernels.preprocess import LANCZOS

    img = _image(shape, seed=2)
    want, tiling = _host(img)
    x = torch.from_numpy(img).to(cuda)
    before = LAUNCHES.get(LANCZOS, 0)
    got = devpre.device_overlap_crops(x, tiling)
    launched = LAUNCHES[LANCZOS] - before
    plain = devpre.device_overlap_crops(x, tiling, plain=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert launched == 1


@pytest.mark.cuda
def test_kernel_batched_crops_equal_host(cuda):
    imgs = [_image((700, 900), seed=s) for s in range(3)]
    host = [_host(im) for im in imgs]
    x = torch.from_numpy(np.stack(imgs)).to(cuda)
    got = devpre.device_overlap_crops_batched(x, host[0][1])
    plain = devpre.device_overlap_crops_batched(x, host[0][1], plain=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), np.concatenate([c for c, _ in host]))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    from moondream_tpu_torch.kernels.preprocess import lanczos_crops

    x = torch.zeros((1, 40, 50, 3), dtype=torch.uint8, device=cuda)
    sets = (devpre.CropSet((20, 20), (1, 1), 0, 0),)
    bands = [(devpre.band(50, 20, cuda), devpre.band(40, 20, cuda))]
    plan = devpre.tile_plan(40, 50, sets)
    out = torch.empty((1, 20, 20, 3), dtype=torch.uint8, device=cuda)
    lanczos_crops(x, out, sets, bands, (20, 20), 1, plan)  # what it takes
    with pytest.raises(ValueError):  # wrong dtype
        lanczos_crops(x.float(), out, sets, bands, (20, 20), 1, plan)
    with pytest.raises(ValueError):  # a strided input
        lanczos_crops(x[:, :, ::2], out, sets, bands, (20, 20), 1, plan)
    with pytest.raises(ValueError):  # a band made for another width
        lanczos_crops(x, out, sets, [(devpre.band(60, 20, cuda), bands[0][1])], (20, 20), 1,
                      plan)
    with pytest.raises(ValueError):  # an out that does not hold the stack
        lanczos_crops(x, out[:, :10], sets, bands, (20, 20), 1, plan)
    stack = torch.empty((3, 40, 50, 3), dtype=torch.uint8, device=cuda)
    tall = (devpre.CropSet((40, 50), (2, 1), 10, 0),)
    with pytest.raises(ValueError):  # the second crop passes the image's last row
        lanczos_crops(x, stack, tall, [(None, None)], (40, 50), 3, plan)
    torch.cuda.synchronize()
