"""The port's checkpoint loader against the JAX package's.

Synthetic flat checkpoints at tiny_test_config, made with numpy from a
seed: torch (out, in) linears in the new naming scheme (with `model.`
prefixes), the same tensors in the legacy scheme, and a copy whose text
block linears are packed in the reference's int4 checkpoint format
(256-element strips, `weight.packed/scale/zero_point`). Region tensors
are at the tiny config's region widths, Fourier matrices stored (n_freq,
d_in) as the checkpoints store them. Every file must load to the same
tensors through `moondream_tpu.weights.load_params` and the port's
`load_params`, exactly, region heads included; with runtime_int4=True,
the packed bytes must be equal too and the region heads stay dense.
"""

import re

import numpy as np
import pytest
import torch

from moondream_tpu.config import tiny_test_config
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models.text import Int4Linear
from moondream_tpu_torch.weights import dequantize_int4, load_params, params_from_jax

TEXT_LINEARS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


def _new_flat(seed: int) -> dict:
    """New-scheme tensors of the tiny config, torch layouts, fp32."""
    cfg = tiny_test_config()
    v, t = cfg.vision, cfg.text
    rng = np.random.default_rng(seed)
    flat = {}

    def lin(base, n_out, n_in):
        flat[base + ".weight"] = (rng.standard_normal((n_out, n_in)) * n_in ** -0.5).astype(np.float32)
        flat[base + ".bias"] = (rng.standard_normal(n_out) * 0.02).astype(np.float32)

    def ln(base, dim):
        flat[base + ".weight"] = (1 + rng.standard_normal(dim) * 0.1).astype(np.float32)
        flat[base + ".bias"] = (rng.standard_normal(dim) * 0.1).astype(np.float32)

    lin("vision.patch_emb", v.enc_dim, v.patch_dim)
    flat["vision.pos_emb"] = (rng.standard_normal((1, v.num_patches, v.enc_dim)) * 0.02).astype(np.float32)
    for i in range(v.enc_n_layers):
        p = f"vision.blocks.{i}"
        ln(f"{p}.ln1", v.enc_dim)
        lin(f"{p}.attn.qkv", 3 * v.enc_dim, v.enc_dim)
        lin(f"{p}.attn.proj", v.enc_dim, v.enc_dim)
        ln(f"{p}.ln2", v.enc_dim)
        lin(f"{p}.mlp.fc1", v.enc_ff_dim, v.enc_dim)
        lin(f"{p}.mlp.fc2", v.enc_dim, v.enc_ff_dim)
    ln("vision.post_ln", v.enc_dim)
    lin("vision.proj_mlp.fc1", v.proj_inner_dim, 2 * v.enc_dim)
    lin("vision.proj_mlp.fc2", v.proj_out_dim, v.proj_inner_dim)

    flat["text.wte"] = (rng.standard_normal((t.vocab_size, t.dim)) * 0.02).astype(np.float32)
    for i in range(t.n_layers):
        p = f"text.blocks.{i}"
        ln(f"{p}.ln", t.dim)
        lin(f"{p}.attn.qkv", t.qkv_dim, t.dim)
        lin(f"{p}.attn.proj", t.dim, t.dim)
        lin(f"{p}.mlp.fc1", t.ff_dim, t.dim)
        lin(f"{p}.mlp.fc2", t.dim, t.ff_dim)
    ln("text.post_ln", t.dim)
    lin("text.lm_head", t.vocab_size, t.dim)

    r = cfg.region
    flat["region.coord_features"] = rng.standard_normal((r.coord_feat_dim // 2, 1)).astype(np.float32)
    flat["region.size_features"] = rng.standard_normal((r.size_feat_dim // 2, 2)).astype(np.float32)
    lin("region.coord_encoder", r.dim, r.coord_feat_dim)
    lin("region.coord_decoder.fc1", r.inner_dim, r.dim)
    lin("region.coord_decoder.fc2", r.coord_out_dim, r.inner_dim)
    lin("region.size_encoder", r.dim, r.size_feat_dim)
    lin("region.size_decoder.fc1", r.inner_dim, r.dim)
    lin("region.size_decoder.fc2", r.size_out_dim, r.inner_dim)
    return flat


def _legacy_name(key: str) -> str:
    """Independent new -> legacy rename table (the inverse of the
    reference's weight map)."""
    fixed = {
        "vision.patch_emb.weight": "vision_encoder.encoder.model.visual.patch_embed.linear.weight",
        "vision.patch_emb.bias": "vision_encoder.encoder.model.visual.patch_embed.linear.bias",
        "vision.pos_emb": "vision_encoder.encoder.model.visual.pos_embed",
        "vision.post_ln.weight": "vision_encoder.encoder.model.visual.norm.weight",
        "vision.post_ln.bias": "vision_encoder.encoder.model.visual.norm.bias",
        "text.wte": "text_model.transformer.embd.wte.weight",
        "text.post_ln.weight": "text_model.lm_head.ln.weight",
        "text.post_ln.bias": "text_model.lm_head.ln.bias",
        "text.lm_head.weight": "text_model.lm_head.linear.weight",
        "text.lm_head.bias": "text_model.lm_head.linear.bias",
    }
    if key in fixed:
        return fixed[key]
    if key.startswith("vision.proj_mlp."):
        return "vision_encoder.projection.mlp." + key[len("vision.proj_mlp."):]
    m = re.match(r"vision\.blocks\.(\d+)\.(.*)", key)
    if m:
        rest = m.group(2).replace("ln1.", "norm1.").replace("ln2.", "norm2.")
        return f"vision_encoder.encoder.model.visual.blocks.{m.group(1)}.{rest}"
    m = re.match(r"text\.blocks\.(\d+)\.(.*)", key)
    if m:
        rest = m.group(2).replace("attn.qkv", "mixer.Wqkv").replace("attn.proj", "mixer.out_proj")
        return f"text_model.transformer.h.{m.group(1)}.{rest}"
    rest = key[len("region."):].replace("coord_", "coordinate_")
    return "region_model." + rest


def _pack_reference_int4(shape, rng):
    """(packed, scale, zero_point, dense) in the reference checkpoint's int4
    format: numel/128 groups, two codes per byte, high nibbles the first
    half of each 256-element strip."""
    n = int(np.prod(shape))
    step = n // 256
    codes = rng.integers(0, 16, size=(2 * step, 128), dtype=np.uint8)
    scale = (rng.random((n // 128, 1)) * 0.05 + 0.01).astype(np.float32)
    zero = rng.integers(0, 16, size=(n // 128, 1)).astype(np.float32)
    packed = (codes[:step] << 4) | codes[step:]
    dense = (codes.astype(np.float32) - zero) * scale
    return packed, scale, zero, dense.reshape(shape)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{"new", "legacy", "int4", "int4_dense"} checkpoint paths."""
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("ckpt")
    flat = _new_flat(0)
    int4, int4_dense = dict(flat), dict(flat)
    rng = np.random.default_rng(1)
    for i in range(tiny_test_config().text.n_layers):
        for mod in TEXT_LINEARS:
            base = f"text.blocks.{i}.{mod}"
            packed, scale, zero, dense = _pack_reference_int4(flat[base + ".weight"].shape, rng)
            del int4[base + ".weight"]
            int4[base + ".weight.packed"] = packed
            int4[base + ".weight.scale"] = scale
            int4[base + ".weight.zero_point"] = zero
            int4_dense[base + ".weight"] = dense
    paths = {}
    for name, f in (
        ("new", {"model." + k: v for k, v in flat.items()}),
        ("legacy", {_legacy_name(k): v for k, v in flat.items()}),
        ("int4", int4),
        ("int4_dense", int4_dense),
    ):
        paths[name] = str(d / f"{name}.safetensors")
        save_file(f, paths[name])
    return paths


def _jax_loaded(path, runtime_int4=False):
    from moondream_tpu.weights import load_params as jax_load_params

    tree = jax_load_params(path, tiny_test_config(), dtype=np.float32,
                           runtime_int4=runtime_int4)
    return tree, params_from_jax(tree, port_tiny_config())


def _assert_same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


@pytest.mark.parametrize("name", ["new", "legacy", "int4"])
def test_loads_the_same_tensors_as_jax(files, name):
    ours = load_params(files[name], port_tiny_config(), dtype=torch.float32, device="cpu")
    assert "region" in ours
    _assert_same(ours, _jax_loaded(files[name])[1])
    if name == "legacy":
        _assert_same(ours, load_params(files["new"], port_tiny_config(),
                                       dtype=torch.float32, device="cpu"))


def test_int4_checkpoint_dequantizes_to_the_dense_values(files):
    ours = load_params(files["int4"], port_tiny_config(), dtype=torch.float32, device="cpu")
    dense = load_params(files["int4_dense"], port_tiny_config(), dtype=torch.float32, device="cpu")
    _assert_same(ours, dense)


def test_dequantize_int4_matches_jax():
    from moondream_tpu.weights import dequantize_int4 as jax_dequantize_int4

    packed, scale, zero, dense = _pack_reference_int4((24, 64), np.random.default_rng(2))
    got = dequantize_int4(packed, scale, zero, (24, 64))
    np.testing.assert_array_equal(got, jax_dequantize_int4(packed, scale, zero, (24, 64)))
    np.testing.assert_allclose(got, dense, rtol=1e-6)


@pytest.mark.parametrize("name", ["new", "int4"])
def test_runtime_int4_same_packed_bytes_as_jax(files, name):
    ours = load_params(files[name], port_tiny_config(), dtype=torch.float32, runtime_int4=True,
                       device="cpu")
    tree, _ = _jax_loaded(files[name], runtime_int4=True)
    bq = tree["text"]["blocks_q"]
    for i, blk in enumerate(ours["text"].blocks):
        for mod, lin in zip(TEXT_LINEARS, (blk.qkv, blk.proj, blk.mlp.fc1, blk.mlp.fc2)):
            part, sub = mod.split(".")
            want = bq[part][sub]
            assert isinstance(lin, Int4Linear)
            np.testing.assert_array_equal(lin.packed.numpy(), np.asarray(want["packed"][i]))
            np.testing.assert_array_equal(lin.scale.numpy(), np.asarray(want["scale"][i]))
            np.testing.assert_array_equal(lin.zero.numpy(), np.asarray(want["zero"][i]))
    # region weights stay dense under runtime_int4
    assert not any(isinstance(m, Int4Linear) for m in ours["region"].modules())
    np.testing.assert_array_equal(ours["region"].coord_decoder.fc1.w.numpy(),
                                  np.asarray(tree["region"]["coord_decoder"]["fc1"]["w"]))


def test_region_features_weight_key_and_no_region(tmp_path):
    """Fourier matrices stored as `region.*_features.weight` load transposed
    as the JAX loader loads them; a checkpoint without region tensors gives
    no region heads."""
    from safetensors.numpy import save_file

    flat = _new_flat(2)
    for name in ("coord", "size"):
        flat[f"region.{name}_features.weight"] = flat.pop(f"region.{name}_features")
    save_file(flat, str(tmp_path / "w.safetensors"))
    ours = load_params(str(tmp_path / "w.safetensors"), port_tiny_config(),
                       dtype=torch.float32, device="cpu")
    _assert_same(ours, _jax_loaded(str(tmp_path / "w.safetensors"))[1])
    assert ours["region"].coord_features.shape == (1, 8)

    save_file({k: v for k, v in flat.items() if not k.startswith("region.")},
              str(tmp_path / "n.safetensors"))
    bare = load_params(str(tmp_path / "n.safetensors"), port_tiny_config(),
                       dtype=torch.float32, device="cpu")
    assert "region" not in bare
