"""The port's crops, vision encoder and projection against moondream_tpu on
the CPU at tiny_test_config widths, through params_from_jax. fp32, atol
1e-4: two encoder layers and the projection MLP of the same fp32 math,
summed in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.ops.image_crops import overlap_crop_image as jax_crops
from moondream_tpu.ops.image_crops import reconstruct_from_crops as jax_rec
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models import vision
from moondream_tpu_torch.ops.image_crops import overlap_crop_image, reconstruct_from_crops
from moondream_tpu_torch.weights import params_from_jax

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(1))
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }
    return cfg, tree, params_from_jax(tree, port_tiny_config())


@pytest.mark.parametrize("shape", [(756, 1008), (200, 150)])
def test_overlap_crops_identical(shape):
    img = np.random.default_rng(0).integers(0, 255, (*shape, 3), dtype=np.uint8)
    got = overlap_crop_image(img, overlap_margin=4, max_crops=12)
    want = jax_crops(img, overlap_margin=4, max_crops=12)
    assert got["tiling"] == want["tiling"]
    np.testing.assert_array_equal(got["crops"], want["crops"])


def test_create_patches_order():
    x = np.random.default_rng(1).standard_normal((2, 28, 42, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        vision.create_patches(torch.from_numpy(x), 14).numpy(),
        np.asarray(jax_vision.create_patches(jnp.asarray(x), 14)),
    )


def test_encoder_and_projection(models):
    cfg, tree, params = models
    rng = np.random.default_rng(2)
    crops = rng.uniform(-1, 1, (5, 378, 378, 3)).astype(np.float32)
    want = np.array(jax_vision.vision_encoder(jnp.asarray(crops), tree["vision"], cfg.vision))
    got = vision.vision_encoder(torch.from_numpy(crops), params["vision"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    g, tiling = cfg.vision.grid_size, (2, 2)
    local = want[1:].reshape(-1, g, g, cfg.vision.enc_dim)
    recon_j = jax_rec(jnp.asarray(local), tiling, overlap_margin=4, patch_size=1)
    proj_j = jax_vision.vision_projection(jnp.asarray(want[0]), recon_j, tree["vision"], cfg.vision)
    recon_t = reconstruct_from_crops(torch.from_numpy(local), tiling, 4, 1)
    proj_t = vision.vision_projection(torch.from_numpy(want[0]), recon_t, params["vision"])
    np.testing.assert_allclose(proj_t.numpy(), np.asarray(proj_j), atol=ATOL, rtol=0)


def test_adaptive_pool_matches_torch():
    x = torch.randn(40, 31, 6, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.adaptive_avg_pool2d(x.permute(2, 0, 1), (27, 27))
    got = vision.adaptive_avg_pool2d(x, (27, 27)).permute(2, 0, 1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
