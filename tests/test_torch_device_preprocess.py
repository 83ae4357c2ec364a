"""The port's device preprocessing (`moondream_tpu_torch.ops.device_preprocess`
and the model's crop routing) against the JAX package's on the CPU:

  * the copies: `_pil_coeffs` entry for entry, `mode()` for every value and
    the typo that raises, `exact_path_supported` and `preprocess_tiling`;
  * the plain resize equals JAX's jitted `device_resize` (three corpus
    shapes and a gradient / hard-edge image that reaches both clip8
    branches); the plain crops equal JAX's `device_overlap_crops` and the
    port's host crops;
  * at tiny_test_config in fp32 on one set of weights: `encode_image` and
    `encode_images` give bit-identical embeddings and KV on the device route
    (the default) and the host route (MOONDREAM_DEVICE_PREPROCESS=0); the
    port's encode equals the JAX model's under "eager"; an image past
    `exact_path_supported` takes the host route and still equals JAX's;
    BatchPipeline gives the same tokens on both routes; the routes are
    counted, and a typo raises.

JAX's host crops are never called through its native library here (its
in-place `make` races under xdist): the JAX model runs under "eager", and
its one host-route encode under MOONDREAM_NO_NATIVE=1 (PIL).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.ops import device_preprocess as jax_devpre
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine.pipeline import BatchPipeline
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.ops import device_preprocess as devpre
from moondream_tpu_torch.ops.image_crops import overlap_crop_image
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

ENV = "MOONDREAM_DEVICE_PREPROCESS"
# The JAX test's size pairs and the smoke's (756x1008, 378x378, 600x800,
# 1080x1440, 240x320, 2160x3840 and 700x900 to their global crops and grids).
COEFF_PAIRS = [(1080, 882), (100, 378), (378, 378), (37, 200), (756, 378), (1008, 378),
               (756, 910), (1008, 1176), (600, 378), (800, 378), (600, 644), (800, 1176),
               (1080, 910), (1440, 1176), (240, 378), (320, 378), (2160, 378), (3840, 378),
               (2160, 644), (3840, 1176), (700, 378), (900, 378), (700, 644), (900, 910)]


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- copies
@pytest.mark.parametrize("pair", COEFF_PAIRS)
def test_pil_coeffs_equal_jax(pair):
    np.testing.assert_array_equal(devpre._pil_coeffs(*pair), jax_devpre._pil_coeffs(*pair))


@pytest.mark.parametrize("value", [None, "0", "", "false", "off", "no", "n", "1", "true", "on",
                                   "yes", "y", "adaptive", "eager", "EAGER", "Off"])
def test_mode_equals_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, value)
    assert devpre.mode() == jax_devpre.mode()
    assert devpre.enabled() == jax_devpre.enabled()


def test_mode_typo_raises_in_both(monkeypatch):
    monkeypatch.setenv(ENV, "of")
    for module in (devpre, jax_devpre):
        with pytest.raises(ValueError):
            module.mode()


def test_support_and_tiling_equal_jax():
    sizes = [(h, w) for h in (16, 97, 240, 378, 600, 756, 1080, 2160, 9000, 16128, 16129)
             for w in (64, 320, 378, 800, 1008, 1440, 3840, 16500)]
    for h, w in sizes:
        assert devpre.exact_path_supported(h, w) == jax_devpre.exact_path_supported(h, w)
        assert devpre.preprocess_tiling(h, w, 378, 14, 4, 12) == \
            jax_devpre.preprocess_tiling(h, w, 378, 14, 4, 12)
    assert devpre.exact_path_supported(64, 16128) and not devpre.exact_path_supported(64, 16129)


# -------------------------------------------------------- plain versus JAX
def _jax_resize(img, out):
    return np.asarray(jax.jit(lambda x: jax_devpre.device_resize(x, *out))(jnp.asarray(img)))


@pytest.mark.parametrize("shape,out", [((240, 320), (378, 378)), ((500, 378), (378, 378)),
                                       ((97, 203), (378, 378))])
def test_plain_resize_equals_jax(shape, out):
    img = _image(shape)
    got = devpre.device_resize(torch.from_numpy(img), *out).numpy()
    np.testing.assert_array_equal(got, _jax_resize(img, out))


def test_gradient_image_reaches_both_clip8_branches():
    h, w = 730, 1311
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // (w - 1)).astype(np.uint8),
                    ((yy > h // 2) * 255).astype(np.uint8),
                    ((xx % 7 == 0) * 255).astype(np.uint8)], axis=-1)
    # the two passes' accumulators (2**21 + taps . pixels) pass both clip8
    # limits: <= 0 (clipped to 0) and >= 2**30 (clipped to 255)
    acc_h = img.astype(np.int64).transpose(0, 2, 1) @ devpre._pil_coeffs(w, 378).T.astype(
        np.int64) + (1 << 21)
    mid = np.clip(acc_h >> 22, 0, 255)  # (h, 3, 378)
    acc_v = devpre._pil_coeffs(h, 378).astype(np.int64) @ mid.reshape(h, -1) + (1 << 21)
    acc = np.concatenate([acc_h.ravel(), acc_v.ravel()])
    assert (acc <= 0).any() and (acc >= 1 << 30).any()
    got = devpre.device_resize(torch.from_numpy(img), 378, 378).numpy()
    np.testing.assert_array_equal(got, _jax_resize(img, (378, 378)))


@pytest.mark.parametrize("shape", [(800, 600), (1080, 1440), (240, 320)])
def test_plain_crops_equal_jax_and_host(shape):
    img = _image(shape, seed=1)
    host = overlap_crop_image(img, overlap_margin=4, max_crops=12)
    tiling = tuple(host["tiling"])
    want = np.asarray(jax.jit(lambda x: jax_devpre.device_overlap_crops(x, tiling))(
        jnp.asarray(img)))
    got = devpre.device_overlap_crops(torch.from_numpy(img), tiling).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host["crops"])


# ------------------------------------------------------------------- models
@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(3))
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }
    ref = JaxModel(cfg, params=dict(tree, region=None), tokenizer=IdTokenizer(),
                   dtype=jnp.float32)
    pcfg = port_tiny_config()
    ours = MoondreamModel(pcfg, params=params_from_jax(tree, pcfg), tokenizer=IdTokenizer(),
                          dtype=torch.float32, device="cpu")
    return ref, ours


IMAGES = [_image((600, 800), 4), _image((378, 378), 5), _image((120, 160), 6),
          _image((600, 800), 7)]


def _unpaired(x, head_dim):
    """A JAX cache leaf (L, B, H/pf, T, pf * Dh), head-paired under MHA, in
    the port's (L, B, H, T, Dh) layout."""
    x = np.asarray(x)
    n, b, hp, t, dd = x.shape
    pf = dd // head_dim
    return x.reshape(n, b, hp, t, pf, head_dim).transpose(0, 1, 2, 4, 3, 5).reshape(
        n, b, hp * pf, t, head_dim)


def _encodings(model):
    return ([model._run_vision_encoder(im) for im in IMAGES[:2]],
            [model.encode_image(im) for im in IMAGES[:2]], model.encode_images(IMAGES))


def test_both_routes_bit_identical(models, monkeypatch):
    _, ours = models
    monkeypatch.delenv(ENV, raising=False)
    devpre.reset_route_counts()
    device = _encodings(ours)
    assert devpre.ROUTES == {"device": 8, "host": 0}
    monkeypatch.setenv(ENV, "0")
    host = _encodings(ours)
    assert devpre.ROUTES == {"device": 8, "host": 8}
    for a, b in zip(device[0], host[0]):
        assert torch.equal(a, b)
    for a, b in zip(device[1] + device[2], host[1] + host[2]):
        assert a.pos == b.pos == 730 and torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_encode_equals_jax_under_eager(models, monkeypatch):
    ref, ours = models
    monkeypatch.setenv(ENV, "eager")
    devpre.reset_route_counts()
    for im in IMAGES[:2]:
        got, want = ours.encode_image(im), ref.encode_image(Image.fromarray(im))
        hd = ours.config.text.head_dim
        for a, b in ((got.k, want.k), (got.v, want.v)):
            np.testing.assert_allclose(a.numpy(), _unpaired(b, hd), atol=1e-4, rtol=1e-4)
    assert devpre.ROUTES == {"device": 2, "host": 0}


def test_oversize_image_takes_host_route_and_equals_jax(models, monkeypatch):
    ref, ours = models
    img = _image((64, 16500), 8)
    monkeypatch.delenv(ENV, raising=False)
    devpre.reset_route_counts()
    got = ours.encode_image(img)
    assert devpre.ROUTES == {"device": 0, "host": 1}
    monkeypatch.setenv(ENV, "eager")
    monkeypatch.setenv("MOONDREAM_NO_NATIVE", "1")  # JAX's host crops through PIL
    want = ref.encode_image(Image.fromarray(img))
    hd = ours.config.text.head_dim
    np.testing.assert_allclose(got.k.numpy(), _unpaired(want.k, hd), atol=1e-4, rtol=1e-4)


def test_batch_pipeline_same_tokens_on_both_routes(models, monkeypatch):
    _, ours = models
    greedy = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 6}
    pipe = BatchPipeline(ours, batch_size=2)
    monkeypatch.delenv(ENV, raising=False)
    devpre.reset_route_counts()
    device = pipe.caption(IMAGES[:3], settings=greedy)
    assert devpre.ROUTES == {"device": 4, "host": 0}  # a padded tail batch of 2
    monkeypatch.setenv(ENV, "0")
    host = pipe.caption(IMAGES[:3], settings=greedy)
    assert device == host and all(t.count("<") == 6 for t in device)


def test_typo_raises_at_encode(models, monkeypatch):
    _, ours = models
    monkeypatch.setenv(ENV, "devce")
    with pytest.raises(ValueError, match="not understood"):
        ours.encode_image(IMAGES[2])
