"""The port's mesh, shard cut and ShardedTextEngine (moondream_tpu_torch/
parallel/) against the JAX package's (moondream_tpu/parallel/), on the CPU
in fp32.

The port runs one process per rank: each case launches gloo ranks through
`parallel.comm.launch` (one torch thread each, a hard timeout per launch),
whose functions live in tests/torch_parallel_ranks.py and import no JAX.
The parent computes the JAX references once per case on the 8-device CPU
mesh of tests/conftest.py: JAX's ShardedTextEngine on the same dp x tp
shape, with the xla_attn=True its mesh requires (the port keeps its own
attention on each rank's heads). Both packages start from one tree
(`params_from_jax`). Logits agree within 1e-4 of max|logit|, greedy tokens
exactly, and every rank returns the same tokens."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from moondream_tpu import parallel as jax_parallel
from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu_torch.config import TextConfig as PortTextConfig
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.parallel import comm
from moondream_tpu_torch.parallel.mesh import (
    default_mesh_axes, qkv_columns, text_param_shardings)
from moondream_tpu_torch.weights import params_from_jax

LOGIT_TOL = 1e-4  # of max|logit|
STEPS = 12
TIMEOUT_S = 120

# case -> (mesh axes, batch, text config changes)
CASES = {
    "tp2": ({"dp": 1, "tp": 2}, 2, {}),
    "dp2_tp2": ({"dp": 2, "tp": 2}, 4, {}),
    "gqa_tp2": ({"dp": 1, "tp": 2}, 2, {"n_heads": 4, "n_kv_heads": 2}),
    "kv_int8_tp2": ({"dp": 1, "tp": 2}, 2, {"kv_int8": True}),
}


def _configs(changes):
    jcfg, pcfg = tiny_test_config(), port_tiny_config()
    return (dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, **changes)),
            dataclasses.replace(pcfg, text=dataclasses.replace(pcfg.text, **changes)))


def _pair(changes):
    """(JAX config, JAX tree, port config, the port's parameters as numpy)."""
    jcfg, pcfg = _configs(changes)
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    tree = {"vision": jax_vision.init_vision_params(jcfg.vision, kv, jnp.float32),
            "text": jax_text.init_text_params(jcfg.text, kt, jnp.float32)}
    return jcfg, tree, pcfg, ranks.state_of(params_from_jax(tree, pcfg))


def _jax_reference(axes, jcfg, tree, embeds):
    mesh = jax_parallel.create_mesh(axes)
    eng = jax_parallel.ShardedTextEngine(tree["text"], jcfg.text, mesh)
    n = embeds.shape[1]
    logits, _, kv = eng.prefill(jnp.asarray(embeds), pos=0, length=n, prefix_len=0)
    res = eng.generate(kv, jnp.argmax(logits, -1).astype(jnp.int32), n, max_tokens=STEPS,
                       eos_id=-1, buffer=64)
    return np.asarray(logits), np.asarray(res.tokens), np.asarray(res.counts)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    axes, batch, changes = CASES[request.param]
    jcfg, tree, pcfg, state = _pair(changes)
    embeds = (np.random.default_rng(1).standard_normal((batch, 16, jcfg.text.dim))
              .astype(np.float32) * 0.5)
    ref = _jax_reference(axes, jcfg, tree, embeds)
    world = int(np.prod(list(axes.values())))
    outs = comm.launch(world, ranks.text_engine_rank, axes, pcfg, state, embeds, STEPS,
                       timeout_s=TIMEOUT_S, device="cpu")
    return {"name": request.param, "axes": axes, "cfg": pcfg, "ref": ref, "outs": outs,
            "batch": batch}


def test_sharded_text_engine_matches_jax(case):
    logits_ref, tokens_ref, counts_ref = case["ref"]
    out = case["outs"][0]
    scale = np.abs(logits_ref).max()
    assert out["logits"].shape == logits_ref.shape
    assert np.abs(out["logits"] - logits_ref).max() <= LOGIT_TOL * scale
    np.testing.assert_array_equal(out["counts"], counts_ref)
    assert (counts_ref == STEPS).all()
    np.testing.assert_array_equal(out["tokens"][:, :STEPS], tokens_ref[:, :STEPS])
    assert out["hidden_shape"] == (case["batch"], case["cfg"].text.dim)


def test_sharded_text_engine_ranks_agree(case):
    first = case["outs"][0]
    for out in case["outs"][1:]:
        np.testing.assert_array_equal(out["tokens"], first["tokens"])
        np.testing.assert_array_equal(out["logits"], first["logits"])
        assert out["pos"] == first["pos"] == 16 + STEPS


def test_sharded_cache_holds_rank_rows_and_heads(case):
    """(L, B/dp, Hkv/tp, T, D) on every rank; int8 scales one per head and
    token, as the JAX package's under a mesh."""
    tc, axes = case["cfg"].text, case["axes"]
    dp, tp = axes["dp"], axes["tp"]
    want = (tc.n_layers, case["batch"] // dp, tc.n_kv_heads // tp, tc.max_context, tc.head_dim)
    for out in case["outs"]:
        assert out["cache"]["k"] == want and out["cache"]["v"] == want
        if tc.kv_int8:
            assert out["cache"]["ks"] == want[:4]
        assert out["spec"] == (None, "dp", "tp", None, None)


def test_default_mesh_axes_match_jax():
    for n in range(1, 17):
        assert default_mesh_axes(n) == jax_parallel.default_mesh_axes(n)


def test_text_param_shardings_follow_jax():
    """The port's split of each text parameter is JAX's PartitionSpec without
    its stacked layer axis; `wte` stays whole (a deliberate deviation)."""
    mesh = jax_parallel.create_mesh({"dp": 1, "tp": 2})
    from moondream_tpu.config import MoondreamConfig

    jax_specs = jax_parallel.text_param_shardings(mesh, MoondreamConfig(text=tiny_test_config().text))
    port = text_param_shardings()
    names = {("blocks", "attn", "qkv"): "blocks.*.qkv", ("blocks", "attn", "proj"): "blocks.*.proj",
             ("blocks", "mlp", "fc1"): "blocks.*.mlp.fc1", ("blocks", "mlp", "fc2"): "blocks.*.mlp.fc2",
             ("lm_head",): "lm_head"}
    for path, name in names.items():
        node = jax_specs
        for p in path:
            node = node[p]
        for leaf in ("w", "b"):
            spec = tuple(node[leaf].spec)
            if path[0] == "blocks":
                spec = spec[1:]
            spec = spec + (None,) * ((2 if leaf == "w" else 1) - len(spec))
            assert port.get(f"{name}.{leaf}", (None,) * len(spec)) == spec, (name, leaf)
    assert tuple(jax_specs["wte"].spec) == (None, "tp") and port["wte"] == (None, None)


@pytest.mark.parametrize("n_heads,n_kv_heads,tp", [(32, 32, 4), (32, 8, 2), (4, 2, 2)])
def test_qkv_columns_cut_by_heads(n_heads, n_kv_heads, tp):
    """Each rank's q heads and the K/V heads they read; the ranks' columns
    cover the fused axis once."""
    tc = PortTextConfig(dim=64 * n_heads, n_heads=n_heads, n_kv_heads=n_kv_heads)
    hd = tc.head_dim
    cols = [qkv_columns(tc, tp, r) for r in range(tp)]
    assert sorted(torch.cat(cols).tolist()) == list(range(tc.qkv_dim))
    for r, c in enumerate(cols):
        q, k, v = c.split([n_heads // tp * hd, n_kv_heads // tp * hd, n_kv_heads // tp * hd])
        assert q[0] == r * n_heads // tp * hd
        assert k[0] == n_heads * hd + r * n_kv_heads // tp * hd
        assert v[0] == (n_heads + n_kv_heads) * hd + r * n_kv_heads // tp * hd
        assert (q[0] // hd) // (n_heads // n_kv_heads) == (k[0] - n_heads * hd) // hd


@pytest.fixture(scope="module")
def mesh_world():
    _, _, pcfg, state = _pair({})
    return pcfg, state, comm.launch(2, ranks.mesh_rank, pcfg, state, timeout_s=TIMEOUT_S,
                                    device="cpu")


def test_create_mesh_axes_and_oversize(mesh_world):
    _, _, outs = mesh_world
    for r, out in enumerate(outs):
        assert out["oversize"] == "mesh needs 4 devices, have 2"
        assert out["axes"] == {"dp": (1, 0), "tp": (2, r), "pp": (1, 0)}


def test_shard_cut_shapes(mesh_world):
    pcfg, state, outs = mesh_world
    tc = pcfg.text
    qkv = state["text.blocks.0.qkv.w"]
    for r, out in enumerate(outs):
        assert out["shapes"] == {
            "qkv": (tc.dim, tc.qkv_dim // 2), "proj": (tc.dim // 2, tc.dim),
            "fc1": (tc.dim, tc.ff_dim // 2), "fc2": (tc.ff_dim // 2, tc.dim),
            "lm_head": (tc.dim, tc.vocab_size // 2), "dim": tc.dim // 2,
            "heads": (tc.n_heads // 2, tc.n_kv_heads // 2)}
        np.testing.assert_array_equal(out["qkv_w"], qkv[:, qkv_columns(tc, 2, r).numpy()])
        assert out["shared_wte"]


def test_shard_cut_refuses_quantized_like_jax(mesh_world):
    """int4 and int8 text blocks raise ValueError on a mesh, as placing
    them with the JAX package's shardings does."""
    assert all(len(out["quantized"]) == 2 for out in mesh_world[2])
    assert "must be dense" in mesh_world[2][0]["quantized"][0]
    jcfg, tree, _, _ = _pair({})
    mesh = jax_parallel.create_mesh({"dp": 1, "tp": 2})
    for quant in (jax_text.quantize_text_params, jax_text.quantize_text_params_int8):
        with pytest.raises(ValueError):
            jax_parallel.ShardedTextEngine(quant(tree["text"]), jcfg.text, mesh)


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_launch_kills_every_rank_and_raises(how):
    """A rank that fails, or a world that outlives the timeout, ends the
    launch: every rank is killed and RuntimeError names the cause."""
    match = "rank 1 raised" if how == "raise" else "timed out"
    with pytest.raises(RuntimeError, match=match):
        comm.launch(2, ranks.fail_rank, how, timeout_s=5, device="cpu")


@pytest.mark.parametrize("fails", [(1,), (0,), (0, 1)], ids=["follower", "leader", "both"])
def test_follower_outcome_must_match_rank_0(fails):
    """A mirrored call that raises on some ranks only ends the launch at
    once (the rank whose outcome differs raises), instead of leaving its
    state to depart from rank 0's until a collective hangs; one that
    raises everywhere is passed over. Reads (`free_slots`) run on rank 0
    alone."""
    t0 = time.monotonic()
    if fails == (0, 1):
        outs = comm.launch(2, ranks.outcome_rank, fails, timeout_s=TIMEOUT_S, device="cpu")
        assert outs == [{"reads": 1}, {"calls": 1, "reads": 0}]
        return
    want = ("rank 1's step fails" if fails == (1,) else
            "rank 0's engine.step raised where this rank's returned")
    with pytest.raises(RuntimeError, match="rank 1 raised") as err:
        comm.launch(2, ranks.outcome_rank, fails, timeout_s=TIMEOUT_S, device="cpu")
    assert want in str(err.value)
    assert time.monotonic() - t0 < 30  # rank 0 sleeps 60 s after the call


def test_launch_defaults_to_the_card(monkeypatch):
    """Without device=, the ranks are nccl ranks on the card: with no card
    the launch raises before any rank starts, never falling back to
    gloo on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comm.launch(2, ranks.fail_rank, "raise", timeout_s=5)
