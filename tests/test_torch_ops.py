"""Port primitives (moondream_tpu_torch.ops) against moondream_tpu.ops on the
CPU, fp32, atol 1e-5: both sides do the same fp32 arithmetic, so only the
summation order differs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moondream_tpu.ops import layers as jl
from moondream_tpu.ops import rope as jr
from moondream_tpu_torch.ops import layers as tl
from moondream_tpu_torch.ops import rope as trope
from moondream_tpu_torch.ops.image_crops import reconstruct_from_crops

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _linear(rng, n_in, n_out):
    lin = tl.Linear(n_in, n_out, dtype=torch.float32)
    w, b = _rand(rng, n_in, n_out, scale=n_in**-0.5), _rand(rng, n_out, scale=0.1)
    lin.w.copy_(torch.from_numpy(w))
    lin.b.copy_(torch.from_numpy(b))
    return lin, {"w": jnp.asarray(w), "b": jnp.asarray(b)}


def test_linear():
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 7, 48)
    lin, jw = _linear(rng, 48, 40)
    _close(lin(torch.from_numpy(x)), jl.linear(jnp.asarray(x), jw))


def test_layer_norm():
    rng = np.random.default_rng(1)
    x = _rand(rng, 5, 64, scale=3.0) + 2.0
    w, b = 1.0 + _rand(rng, 64, scale=0.1), _rand(rng, 64, scale=0.1)
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    want = jl.layer_norm(jnp.asarray(x), {"weight": jnp.asarray(w), "bias": jnp.asarray(b)})
    _close(got, want)


def test_gelu_approx():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(tl.gelu_approx(torch.from_numpy(x)), jl.gelu_approx(jnp.asarray(x)))


def test_mlp():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 9, 32)
    m = tl.MLP(32, 64, 24, dtype=torch.float32)
    fc1, j1 = _linear(rng, 32, 64)
    fc2, j2 = _linear(rng, 64, 24)
    m.fc1, m.fc2 = fc1, fc2
    _close(m(torch.from_numpy(x)), jl.mlp(jnp.asarray(x), {"fc1": j1, "fc2": j2}))


def test_freqs_table_identical():
    got = trope.precompute_freqs_cis(16, 1024).numpy()
    want = np.asarray(jr.precompute_freqs_cis(16, 1024))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pos,t", [(0, 730), (730, 8), (900, 1)])
def test_apply_rotary_emb(pos, t):
    rng = np.random.default_rng(3)
    rot_dim, head_dim = 16, 32
    x = _rand(rng, 1, 2, t, head_dim)
    table = trope.precompute_freqs_cis(rot_dim, 1024)
    ids = np.arange(pos, pos + t, dtype=np.int32)
    got = trope.apply_rotary_emb(torch.from_numpy(x), table, torch.from_numpy(ids), rot_dim)
    want = jr.apply_rotary_emb(
        jnp.asarray(x), jnp.asarray(table.numpy()), jnp.asarray(ids), rot_dim
    )
    _close(got, want)


def test_reconstruct_from_crops():
    from moondream_tpu.ops.image_crops import reconstruct_from_crops as jrec

    rng = np.random.default_rng(4)
    crops = _rand(rng, 12, 27, 27, 5)
    for tiling in ((3, 4), (1, 1), (2, 5)):
        n = tiling[0] * tiling[1]
        got = reconstruct_from_crops(torch.from_numpy(crops[:n]), tiling, 4, 1)
        np.testing.assert_array_equal(got.numpy(), jrec(crops[:n], tiling, 4, 1))
