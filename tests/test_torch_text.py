"""The port's text decoder against moondream_tpu on the CPU at
tiny_test_config widths, through params_from_jax: the 730-token
[BOS, image] prefill (flash attention), a span-8 prompt prefill (stacked
decode attention), then 4 decode steps.

fp32; hidden states atol 1e-4 (the same fp32 math in another summation
order). Logits are rounded through bf16 on both sides, so a value that
sits on a rounding boundary may land one bf16 step apart: rtol 2^-7."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import generate as jax_gen
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import generate
from moondream_tpu_torch.models.text import KVCache
from moondream_tpu_torch.weights import params_from_jax

ATOL = 1e-4
LOGIT_RTOL = 2.0**-7


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(2))
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }
    return cfg, tree, params_from_jax(tree, port_tiny_config())


def _check(got, want):
    (lg, hg), (lw, hw) = got, want
    np.testing.assert_allclose(hg.numpy(), np.asarray(hw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=ATOL, rtol=LOGIT_RTOL)


def test_prefill_then_decode(models):
    cfg, tree, params = models
    tcfg, jw, model = cfg.text, tree["text"], params["text"]
    rng = np.random.default_rng(3)
    image = rng.standard_normal((1, 730, tcfg.dim)).astype(np.float32)
    prompt = rng.standard_normal((1, 8, tcfg.dim)).astype(np.float32)

    jkv = jax_text.KVCache.create(tcfg, dtype=jnp.float32)
    tkv = KVCache.create(port_tiny_config().text, dtype=torch.float32)

    *want, jkv = jax_gen.prefill(
        jw, jkv, jnp.asarray(image), 0, 730, 730, tcfg, kv_bound=768
    )
    got = generate.prefill(model, tkv, torch.from_numpy(image), 0, 730, 730, kv_bound=768)
    _check(got, want)

    *want, jkv = jax_gen.prefill(
        jw, jkv, jnp.asarray(prompt), 730, 5, 730, tcfg, kv_bound=768
    )
    got = generate.prefill(model, tkv, torch.from_numpy(prompt), 730, 5, 730, kv_bound=768)
    _check(got, want)

    for step in range(4):
        emb = rng.standard_normal((1, 1, tcfg.dim)).astype(np.float32) * 0.02
        *want, jkv = jax_gen.decode_step(
            jw, jkv, jnp.asarray(emb), 735 + step, tcfg, kv_bound=768
        )
        got = generate.decode_step(model, tkv, torch.from_numpy(emb), 735 + step, 768)
        _check(got, want)

    # the caches agree where they were written
    pf = jkv.k.shape[-1] // tcfg.head_dim
    jk = np.stack([np.asarray(jax_text.unpair_kv(jkv.k[l], pf)) for l in range(tcfg.n_layers)])
    np.testing.assert_allclose(tkv.k[:, :, :, :739].numpy(), jk[:, :, :, :739], atol=ATOL, rtol=0)
