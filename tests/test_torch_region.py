"""The port's region heads (moondream_tpu_torch/models/region.py) against
moondream_tpu.models.region on the CPU, fp32, the same weights through
`params_from_jax`: Fourier features, the coordinate and size codecs,
`encode_spatial_refs` and `size_bin_to_value`, each within 1e-5 of the
largest |JAX| value, at tiny_test_config's region widths and at the 2B's
Fourier and bin widths (a narrower inner width). Inputs are made from a
seed with numpy."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import RegionConfig as JaxRegionConfig
from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu_torch.config import RegionConfig
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models import region
from moondream_tpu_torch.weights import init_params, params_from_jax

TOL = 1e-5
# (label, region widths): the tiny config's, and the 2B's Fourier and bin
# widths over a 64-wide text model with a narrow MLP
WIDTHS = {
    "tiny": {},
    "2b-codecs": {"coord_feat_dim": 256, "size_feat_dim": 512, "inner_dim": 128},
}


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def heads(request):
    """(JAX region tree, the port's RegionModel) with the same weights."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, region=dataclasses.replace(cfg.region, **WIDTHS[request.param]))
    pcfg = port_tiny_config()
    pcfg = dataclasses.replace(pcfg, region=dataclasses.replace(pcfg.region, **WIDTHS[request.param]))
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(3), 3)
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
        "region": jax_region.init_region_params(cfg.region, kr, jnp.float32),
    }
    # nonzero biases, so that a bias dropped or misplaced shows
    rng = np.random.default_rng(4)
    for site in ("coord_encoder", "size_encoder"):
        b = tree["region"][site]["b"]
        tree["region"][site]["b"] = jnp.asarray(rng.standard_normal(b.shape), jnp.float32)
    for site in ("coord_decoder", "size_decoder"):
        for fc in ("fc1", "fc2"):
            b = tree["region"][site][fc]["b"]
            tree["region"][site][fc]["b"] = jnp.asarray(
                rng.standard_normal(b.shape) * 0.1, jnp.float32)
    return tree["region"], params_from_jax(tree, pcfg)["region"]


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", [(1,), (5, 1), (3, 4, 1)])
def test_encode_coordinate_matches_jax(heads, shape):
    w, ours = heads
    x = np.random.default_rng(10).random(shape).astype(np.float32)
    _close(region.fourier_features(torch.from_numpy(x), ours.coord_features),
           jax_region.fourier_features(jnp.asarray(x), w["coord_features"]))
    _close(region.encode_coordinate(torch.from_numpy(x), ours),
           jax_region.encode_coordinate(jnp.asarray(x), w))


@pytest.mark.parametrize("shape", [(2,), (5, 2)])
def test_encode_size_matches_jax(heads, shape):
    w, ours = heads
    wh = np.random.default_rng(11).random(shape).astype(np.float32)
    _close(region.encode_size(torch.from_numpy(wh), ours),
           jax_region.encode_size(jnp.asarray(wh), w))


@pytest.mark.parametrize("rows", [None, 3])
def test_decoders_match_jax(heads, rows):
    w, ours = heads
    dim = ours.coord_encoder.w.shape[1]
    h = np.random.default_rng(12).standard_normal((dim,) if rows is None else (rows, dim))
    h = h.astype(np.float32)
    _close(region.decode_coordinate(torch.from_numpy(h), ours),
           jax_region.decode_coordinate(jnp.asarray(h), w))
    got = region.decode_size(torch.from_numpy(h), ours)
    if rows is None:  # JAX's decode_size takes one hidden vector
        _close(got, jax_region.decode_size(jnp.asarray(h), w))
    else:
        for r in range(rows):
            _close(got[r], jax_region.decode_size(jnp.asarray(h[r]), w))


SPATIAL_REFS = {
    "points": [(0.25, 0.75), (0.5, 0.125)],
    "box": [(0.1, 0.2, 0.6, 0.9)],
    "mixed": [(0.3, 0.4), (0.05, 0.5, 0.45, 0.95), (0.9, 0.1)],
}


@pytest.mark.parametrize("name", sorted(SPATIAL_REFS))
def test_encode_spatial_refs_matches_jax(heads, name):
    w, ours = heads
    refs = SPATIAL_REFS[name]
    got = region.encode_spatial_refs(refs, ours)
    want = jax_region.encode_spatial_refs(refs, w)
    _close(got["coords"], want["coords"])
    assert (got["sizes"] is None) == (want["sizes"] is None)
    if want["sizes"] is not None:
        _close(got["sizes"], want["sizes"])


def test_size_bin_to_value_and_coordinate_value_match_jax():
    bins = np.arange(0, 1024, dtype=np.int64)
    got = region.size_bin_to_value(torch.from_numpy(bins))
    assert got.dtype == torch.float32
    _close(got, jax_region.size_bin_to_value(jnp.asarray(bins, jnp.int32)))
    logits = np.random.default_rng(13).standard_normal((4, 1024)).astype(np.float32)
    want = np.argmax(logits, -1).astype(np.float32) / 1024
    np.testing.assert_array_equal(region.coordinate_value(torch.from_numpy(logits)).numpy(), want)


def test_region_config_and_init_shapes_match_jax():
    assert [f.name for f in dataclasses.fields(RegionConfig)] == [
        f.name for f in dataclasses.fields(JaxRegionConfig)]
    cfg, pcfg = tiny_test_config(), port_tiny_config()
    want = jax_region.init_region_params(cfg.region, jax.random.PRNGKey(0), jnp.float32)
    got = init_params(pcfg, torch.Generator().manual_seed(0), "cpu", torch.float32)["region"]
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        names = [p.key for p in path]
        mod = got
        for n in names:
            mod = getattr(mod, n)
        assert tuple(mod.shape) == leaf.shape, names
    # the Fourier matrices' scale: N(0, 10^2)
    assert 3.0 < got.coord_features.std().item() < 30.0
