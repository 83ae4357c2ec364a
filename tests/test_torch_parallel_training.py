"""The port's dp x tp and dp x sp training (finetune.trainer.make_train_step
on a rank's parallel.mesh.shard_text_model and shard_batch, the
differentiable collectives of parallel.grad) and its whole-model cut
(parallel.mesh.shard_params), on gloo ranks on the CPU in fp32.

One `comm.launch` per mesh shape (at most 4 ranks, one torch thread each,
a hard timeout) trains two steps of each of its cases; the parent holds
every rank's result against two oracles (tests/torch_training_oracles.py):
the port's own unsharded step, at the JAX package's own tolerances (loss
rtol 1e-5; gradients rtol 2e-4, atol 2e-5, tests/test_pipeline_parallel.py;
updated weights atol 1e-5, tests/test_parallel.py), and the JAX package's
single-device value_and_grad and make_train_step (loss 1e-5 relative;
every gradient, the RoPE table's included, within 1e-4 of its largest
element; the update moved alike, tests/test_torch_finetune.py). A tp rank's
tensors are compared through the cut (`mesh.cut_text_tensor`: qkv by
heads, the rest by contiguous shares); the masks are uneven (> 0.3 drawn),
so a per-rank normaliser would show."""

import re

import numpy as np
import pytest
import torch

import jax

import torch_training_oracles as O
import torch_training_ranks as ranks
from moondream_tpu import parallel as jax_parallel
from moondream_tpu.config import tiny_test_config as jax_tiny_config
from moondream_tpu_torch.parallel import comm
from moondream_tpu_torch.parallel.mesh import (
    batch_shardings, param_shardings, qkv_columns, text_param_shardings)

SEED, SEED2 = 0, 1

# launch -> (mesh axes, text kind, sequence axis, extra checks)
WORLDS = {
    "dp2_tp2": ({"dp": 2, "tp": 2}, "mha", None, {"ckpt": True, "whole": True}),
    "gqa_tp2": ({"dp": 1, "tp": 2}, "gqa", None, {}),
    "dp1_sp4": ({"dp": 1, "sp": 4}, "mha", "sp", {}),
    "dp2_sp2": ({"dp": 2, "sp": 2}, "mha", "sp", {"bad": True}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The oracles' tiny ops gain nothing from intra-op threads, which
    contend under the parallel test workers: run this module on one (the
    ranks run on one each)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every launch of WORLDS and its two oracles, once per module."""
    out = {}
    for name, (axes, kind, seq_axis, extra) in WORLDS.items():
        ckpt = str(tmp_path_factory.mktemp("ckpt") / "step.pt") if extra.get("ckpt") else None
        whole = (O.port_config(), O.whole_state()) if extra.get("whole") else None
        case = {"cfg": O.configs(kind)[1], "state": O.port_state(kind), "batch": O.batch(SEED),
                "batch2": O.batch(SEED2), "seq_axis": seq_axis}
        n = int(np.prod(list(axes.values())))
        outs = comm.launch(n, ranks.train_rank, axes, [case], ckpt, whole,
                           seq_axis if extra.get("bad") else None, timeout_s=O.TIMEOUT_S,
                           device="cpu")
        out[name] = {"name": name, "axes": axes, "kind": kind, "outs": outs, "ckpt": ckpt,
                     "a": O.port_oracle(kind, SEED, SEED2),
                     "b": {**O.jax_oracle(kind, SEED), **O.jax_step(kind, SEED)}}
    return out


@pytest.fixture(params=sorted(WORLDS))
def world(request, worlds):
    return worlds[request.param]


def _tp(world):
    return world["axes"].get("tp", 1)


def _rank_views(world):
    """(rank, its tp rank, its first case) per rank."""
    tp = _tp(world)
    return [(r, r % tp, out["cases"][0]) for r, out in enumerate(world["outs"])]


def test_loss_matches_both_oracles(world):
    for _, _, got in _rank_views(world):
        assert abs(got["loss"] - world["a"]["loss"]) <= 1e-5 * abs(world["a"]["loss"])
        assert abs(got["loss"] - world["b"]["loss"]) <= 1e-5 * abs(world["b"]["loss"])
        # the second step, from the first's update, as the unsharded one
        assert abs(got["loss2"] - world["a"]["loss2"]) <= 1e-5 * abs(world["a"]["loss2"])
        assert got["step"] == 1


def test_every_gradient_matches_both_oracles(world):
    """Each rank's summed gradients (what its optimizer got) through the cut;
    `wte` has none (zeros) and still decays; the RoPE table's is whole."""
    kind, tp = world["kind"], _tp(world)
    assert np.max(np.abs(world["b"]["grads"]["freqs_cis"])) > 0
    for _, t, got in _rank_views(world):
        assert set(got["grads"]) == set(world["a"]["grads"])
        assert not got["grads"]["wte"].any()
        for name, g in got["grads"].items():
            want_a = O.cut(world["a"]["grads"][name], name, kind, tp, t)
            np.testing.assert_allclose(g, want_a, rtol=2e-4, atol=2e-5, err_msg=name)
            if name != "wte":
                assert O.max_rel(g, O.cut(world["b"]["grads"][name], name, kind, tp, t)) < 1e-4, name


def test_update_matches_both_oracles(world):
    kind, tp = world["kind"], _tp(world)
    for _, t, got in _rank_views(world):
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, O.cut(world["a"]["params"][name], name, kind, tp, t),
                                       rtol=0, atol=1e-5, err_msg=name)
            c = lambda a: O.cut(a, name, kind, tp, t)
            O.assert_moved_alike(p, c(world["b"]["params"][name]), c(world["b"]["start"][name]),
                                 name)


def test_ranks_of_one_tp_index_agree(world):
    """dp replicas (and sp ranks) hold equal leaves after the step."""
    tp = _tp(world)
    views = _rank_views(world)
    for r, t, got in views[tp:]:
        first = views[t][2]
        for name, p in got["params"].items():
            np.testing.assert_array_equal(p, first["params"][name], err_msg=f"rank {r} {name}")


def test_sharded_checkpoint_round_trip_and_loads_on_one_device(worlds):
    """dp 2 x tp 2: rank 0 writes the unsharded file from the gathered tp
    shards; each rank's fresh shard loads its cut back equal (step 1), and a
    whole model loads it equal to the unsharded step's weights."""
    world = worlds["dp2_tp2"]
    from moondream_tpu_torch.finetune import trainer
    from moondream_tpu_torch.finetune.optim import named_leaves

    for out in world["outs"]:
        assert out["ckpt"] == {"step": 1, "equal": True}
    model = ranks.text_model(O.configs(world["kind"])[1], O.port_state(world["kind"]))
    opt = trainer.make_optimizer(lr=ranks.LR)
    restored = trainer.load_checkpoint(world["ckpt"], trainer.init_train_state(model, opt), opt)
    assert restored.step == 1
    saved = torch.load(world["ckpt"], weights_only=True)["params"]
    assert list(saved) == [n for n, _ in named_leaves(model)]
    for name, t in named_leaves(model):
        np.testing.assert_allclose(t.numpy(), world["a"]["params"][name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_shard_params_is_jax_placement(worlds):
    """Each rank's cut of the whole model (vision, text, region) equals the
    shard jax.device_put(params, param_shardings(mesh, cfg)) places on the
    device at the same mesh coordinates; the text qkv is compared through
    the head cut and `wte` whole (the port's two deviations). A ViT MLP
    width that does not split over tp raises ValueError first (dp 2 x tp 2)."""
    world = worlds["dp2_tp2"]
    axes, tp = world["axes"], world["axes"]["tp"]
    mesh = jax_parallel.create_mesh(axes)
    tree = jax.tree.map(np.asarray, O.whole_tree())
    placed = jax.device_put(tree, jax_parallel.param_shardings(mesh, jax_tiny_config()))
    nodes = {part: O.named_nodes(placed[part]) for part in placed}
    whole = {part: O.port_named(tree[part]) for part in tree}
    tcfg = O.configs("mha")[1]
    for r, out in enumerate(world["outs"]):
        dev = mesh.devices[r // tp, r % tp]
        got = out["shard_params"]
        assert set(got) == {f"{part}.{name}" for part in nodes for name in nodes[part]}
        for key, piece in got.items():
            part, name = key.split(".", 1)
            if part == "text" and ".qkv." in name:
                want = np.take(whole[part][name], qkv_columns(tcfg, tp, r % tp).numpy(), axis=-1)
            elif part == "text" and name == "wte":
                want = whole[part][name]
            else:
                arr, layer = nodes[part][name]
                want = np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))
                want = want if layer is None else want[layer]
            np.testing.assert_array_equal(piece, want, err_msg=key)
        assert out["indivisible"].startswith("vision.blocks.0.mlp.fc1.w: dim 1 of (32, 63) "
                                             "not divisible by tp=2")


def test_tables_follow_jax():
    """The port's per-name tables are the JAX package's PartitionSpecs
    without the stacked layer axis (`wte` whole, the deviation), and the
    batch's split is JAX's."""
    mesh = jax_parallel.create_mesh({"dp": 1, "tp": 2})
    jax_specs = jax_parallel.param_shardings(mesh, jax_tiny_config())
    port = param_shardings()
    assert port["text"] == text_param_shardings() and port["region"] == {}
    pad = lambda spec: tuple(spec) + (None,) * (3 - len(spec))
    for part in ("vision", "text", "region"):
        for name, (node, layer) in O.named_nodes(jax_specs[part], n_layers=1).items():
            spec = tuple(node.spec)[1:] if layer is not None else tuple(node.spec)
            rule = re.sub(r"^blocks\.\d+\.", "blocks.*.", name)
            if (part, name) == ("text", "wte"):
                assert spec == (None, "tp") and port[part][name] == (None, None)
            else:
                assert pad(port[part].get(rule, ())) == pad(spec), (part, name)
    jb = jax_parallel.batch_shardings(jax_parallel.create_mesh({"dp": 1, "sp": 2}), seq_axis="sp")
    for key, spec in batch_shardings(seq_axis="sp").items():
        assert pad(jb[key].spec) == pad(spec), key


def test_shard_batch_refuses_uneven_splits(worlds):
    assert worlds["dp2_sp2"]["outs"][0]["bad"] == ["batch of 7 rows does not split over dp=2",
                                       "sequence of 15 positions does not split over sp=2"]
