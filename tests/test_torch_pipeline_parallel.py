"""The port's GPipe pp x dp training (moondream_tpu_torch/parallel/pipeline.py)
on gloo ranks on the CPU in fp32, against the port's own unsharded step and
the JAX package (tests/torch_training_oracles.py), as
tests/test_pipeline_parallel.py holds the JAX pipeline against its
single-device step.

One `comm.launch` per mesh shape runs all of that shape's checks: pp 2 x
dp 1 (M 1, and M 2 with an all-zero mask on one microbatch; the
ValueErrors), pp 2 x dp 2 (M 2; GQA 8 heads over 2 KV heads; two train
steps; a checkpoint round trip) and pp 4 x dp 1 (M 4). Tolerances: against
the port's unsharded step, the JAX package's own (loss rtol 1e-5,
gradients and updated weights rtol 2e-4, atol 2e-5); against the JAX
package's single-device value_and_grad and make_train_step, loss 1e-5
relative, every gradient (the RoPE table's included) within 1e-4 of its
largest element and the update moved alike; and at pp 2 x dp 1, M 1,
against the JAX package's own make_pp_loss_and_grads on the 8-device CPU
mesh. Each stage's leaves are compared at their global layer."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import torch_training_oracles as O
import torch_training_ranks as ranks
from moondream_tpu.parallel import create_mesh as jax_create_mesh
from moondream_tpu.parallel import pipeline as jax_pipeline
from moondream_tpu_torch.parallel import comm

SEED, SEED2 = 0, 1
ZERO_MB = (4, 8)  # the second microbatch's rows: all-zero label_mask

# case -> (launch, text kind, M, rows whose mask is all 0)
CASES = {
    "pp2_dp1_m1": ("pp2_dp1", "mha", 1, None),
    "pp2_dp1_m2_zero_mask": ("pp2_dp1", "mha", 2, ZERO_MB),
    "pp2_dp2_m2": ("pp2_dp2", "mha", 2, None),
    "pp2_dp2_gqa": ("pp2_dp2", "gqa", 2, None),
    "pp4_dp1_m4": ("pp4_dp1", "mha", 4, None),
}
LAUNCHES = {"pp2_dp1": {"pp": 2, "dp": 1}, "pp2_dp2": {"pp": 2, "dp": 2},
            "pp4_dp1": {"pp": 4, "dp": 1}}
TRAIN_M = 2  # the train step's and the checkpoint's microbatches (pp 2 x dp 2)


def _case(name):
    _, kind, m, zero = CASES[name]
    return {"cfg": O.configs(kind)[1], "state": O.port_state(kind), "M": m,
            "batch": O.batch(SEED, slice(*zero) if zero else None)}


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
def launches(tmp_path_factory):
    """Every launch's ranks' results, once per module."""
    out = {}
    for launch, axes in LAUNCHES.items():
        names = [n for n, c in CASES.items() if c[0] == launch]
        train = ckpt = errors = None
        if launch == "pp2_dp2":
            train = {**_case("pp2_dp2_m2"), "M": TRAIN_M, "batch2": O.batch(SEED2)}
            ckpt = str(tmp_path_factory.mktemp("ckpt") / "pp.pt")
        if launch == "pp2_dp1":
            errors = {**_case("pp2_dp1_m1"), "M": 3,
                      "cfg3": dataclasses.replace(O.configs("mha")[1], n_layers=3)}
        n = int(np.prod(list(axes.values())))
        outs = comm.launch(n, ranks.pp_rank, axes, [_case(c) for c in names], train, ckpt,
                           errors, timeout_s=O.TIMEOUT_S, device="cpu")
        out[launch] = {"axes": axes, "names": names, "outs": outs, "ckpt": ckpt}
    return out


def _results(launches, name):
    """Every rank's result of case `name`, with the rank's first layer."""
    launch = launches[CASES[name][0]]
    i = launch["names"].index(name)
    return [out["cases"][i] for out in launch["outs"]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_loss_and_grads_match_both_oracles(launches, name):
    _, kind, _, zero = CASES[name]
    a = O.port_oracle(kind, SEED, SEED2, zero)
    b = O.jax_oracle(kind, SEED, zero)
    assert np.max(np.abs(b["grads"]["freqs_cis"])) > 0
    for got in _results(launches, name):
        assert abs(got["loss"] - a["loss"]) <= 1e-5 * abs(a["loss"])
        assert abs(got["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert not got["grads"]["wte"].any()
        for local, g in got["grads"].items():
            name_ = O.global_name(local, got["first_layer"])
            np.testing.assert_allclose(g, a["grads"][name_], rtol=2e-4, atol=2e-5, err_msg=name_)
            if local != "wte":
                assert O.max_rel(g, b["grads"][name_]) < 1e-4, name_


def test_pp_stages_hold_their_slabs(launches):
    """Stage s of S holds layers [s L/S, (s+1) L/S) and the replicated
    leaves; together the stages cover every leaf once."""
    for launch in launches.values():
        pp = launch["axes"]["pp"]
        got = [out["cases"][0] for out in launch["outs"]]
        names = set()
        for r, res in enumerate(got):
            stage = r // launch["axes"]["dp"]
            assert res["first_layer"] == stage * (4 // pp)
            names |= {O.global_name(n, res["first_layer"]) for n in res["grads"]}
        assert names == set(O.port_oracle("mha", SEED, SEED2)["grads"])


def test_pp_matches_the_jax_pipeline(launches):
    """pp 2 x dp 1, M 1: the JAX package's own make_pp_loss_and_grads on the
    8-device CPU mesh, from the same tree."""
    tree = jax.tree.map(np.asarray, O.tree("mha"))
    b = O.batch(SEED)
    mesh = jax_create_mesh({"pp": 2, "dp": 1})
    # jitted, as make_pp_train_step calls it (eager, the shard_map takes ~20 s)
    fn = jax.jit(jax_pipeline.make_pp_loss_and_grads(O.configs("mha")[0], mesh, 1))
    loss, grads = fn(jax_pipeline.shard_params_pp(tree, mesh), b)
    want = O.port_named(grads)
    for got in _results(launches, "pp2_dp1_m1"):
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for local, g in got["grads"].items():
            name = O.global_name(local, got["first_layer"])
            if local != "wte":
                assert O.max_rel(g, want[name]) < 1e-4, name


def test_pp_train_step_matches_both_oracles(launches):
    """make_pp_train_step at pp 2 x dp 2, M 2: the loss, the gradients the
    optimizer got, the updated slab and replicated leaves, step 1; a second
    step runs and gives the unsharded second step's loss."""
    a = O.port_oracle("mha", SEED, SEED2)
    b = O.jax_step("mha", SEED)
    for out in launches["pp2_dp2"]["outs"]:
        got = out["train"]
        f = out["cases"][0]["first_layer"]
        assert got["step"] == 1 and got["step2"] == 2
        assert abs(got["loss"] - a["loss"]) <= 1e-5 * abs(a["loss"])
        assert abs(got["loss2"] - a["loss2"]) <= 1e-5 * abs(a["loss2"])
        for local, p in got["params"].items():
            name = O.global_name(local, f)
            np.testing.assert_allclose(got["grads"][local], a["grads"][name], rtol=2e-4,
                                       atol=2e-5, err_msg=name)
            np.testing.assert_allclose(p, a["params"][name], rtol=2e-4, atol=2e-5, err_msg=name)
            O.assert_moved_alike(p, b["params"][name], b["start"][name], name)


def test_pp_checkpoint_round_trip(launches):
    """The pp 2 x dp 2 state after one step, saved from the gathered slabs
    by rank 0: every rank's fresh stage loads its slab back equal at step 1
    and trains on; the file is the unsharded one, which a whole model
    loads equal to the stages' leaves."""
    from moondream_tpu_torch.finetune import trainer
    from moondream_tpu_torch.finetune.optim import named_leaves

    outs = launches["pp2_dp2"]["outs"]
    for out in outs:
        ck = out["train"]["ckpt"]
        assert ck["step"] == 1 and ck["equal"] and np.isfinite(ck["loss_after"])
        assert ck["loss_after"] == out["train"]["loss2"]
    model = ranks.text_model(O.configs("mha")[1], O.port_state("mha"))
    opt = trainer.make_optimizer(lr=ranks.LR)
    restored = trainer.load_checkpoint(launches["pp2_dp2"]["ckpt"],
                                       trainer.init_train_state(model, opt), opt)
    assert restored.step == 1
    leaves = dict(named_leaves(model))
    saved = torch.load(launches["pp2_dp2"]["ckpt"], weights_only=True)["params"]
    assert list(saved) == list(leaves)
    for out in outs:
        f = out["cases"][0]["first_layer"]
        for local, p in out["train"]["params"].items():
            np.testing.assert_array_equal(leaves[O.global_name(local, f)].numpy(), p)


def test_pp_rejects_bad_divisibility(launches):
    """n_layers 3 over pp 2 and a dp-local batch of 8 over M 3 raise the
    JAX package's ValueErrors."""
    for out in launches["pp2_dp1"]["outs"]:
        assert out["errors"] == ["n_layers=3 not divisible by pp=2",
                                 "dp-local batch 8 not divisible by M=3"]
    with pytest.raises(ValueError, match="n_layers=3 not divisible by pp=2"):
        jax_pipeline.make_pp_loss_and_grads(
            dataclasses.replace(O.configs("mha")[0], n_layers=3),
            jax_create_mesh({"pp": 2, "dp": 1}), 2)
