"""The port's finetuning (moondream_tpu_torch/finetune/, the cache-free
forward of models/text.py, ops/layers.sdpa) against moondream_tpu.finetune
on the CPU at tiny_test_config, fp32 unless named, with the same weights
and inputs (seeded numpy). T 768 and the CLI's 896-position examples run
past the 730 prefix, so the causal part of the prefix mask is exercised.

Tolerances, each relative to the JAX side's largest magnitude:
  * losses and hidden states: 1e-5;
  * gradients, leaf by leaf: 1e-4 (sums over 768 positions in another
    order); leaves the loss does not read are exactly 0 in JAX and None
    here;
  * optimizer, fp32: each weight's movement within 1e-5 of the largest
    movement; bf16: at most 2x as far from the fp32 run as JAX's own bf16
    run is (per leaf);
  * the whole CLI loop in fp32: each leaf's movement within 1e-3 of JAX's
    in L2 and 1e-1 of its largest element (Adam divides by sqrt(v) + 1e-6,
    which magnifies the gradients' last bits where they are small);
  * schedule, size bins, labels, masks, indices and saved files: equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from moondream_tpu.config import tiny_test_config
from moondream_tpu.finetune import finetune_region as jfr
from moondream_tpu.finetune import finetune_text as jft
from moondream_tpu.finetune import trainer as jtrainer
from moondream_tpu.models import region as jregion
from moondream_tpu.models import text as jtext
from moondream_tpu.models import vision as jvision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.ops import layers as jlayers
from moondream_tpu.tokenizer import ByteTokenizer as JaxByteTokenizer
from moondream_tpu.weights import load_params as jax_load_params
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.finetune import finetune_region as pfr
from moondream_tpu_torch.finetune import finetune_text as pft
from moondream_tpu_torch.finetune import trainer
from moondream_tpu_torch.finetune.optim import named_leaves, trainable
from moondream_tpu_torch.models import text as ptext
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.ops.layers import sdpa
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import load_params, params_from_jax, params_to_jax

CFG = tiny_test_config()
PCFG = port_tiny_config()
T = 768
F32 = jnp.float32
_JITS = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops gain nothing from intra-op threads, which contend under the
    parallel test workers: run this module on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jit(name, build):
    if name not in _JITS:
        _JITS[name] = build()
    return _JITS[name]


@pytest.fixture(scope="module")
def tree():
    """JAX fp32 parameters with every leaf but the RoPE table moved off its
    init (biases and norms nonzero), so that every gradient is exercised."""
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    t = {"vision": jvision.init_vision_params(CFG.vision, kv, F32),
         "text": jtext.init_text_params(CFG.text, kt, F32),
         "region": jregion.init_region_params(CFG.region, kr, F32)}
    rng = np.random.default_rng(1)

    def nudge(path, x):
        x = np.asarray(x)
        if path[-1].key == "freqs_cis":
            return x
        return (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(nudge, t)


def port_params(tree):
    return params_from_jax(tree, PCFG, device="cpu", dtype=torch.float32)


def max_rel(ours, want) -> float:
    ours, want = np.asarray(ours, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(ours - want)) / max(np.max(np.abs(want)), 1e-30))


def flat(tree_) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree_)[0]:
        out[".".join(p.key for p in path)] = np.asarray(leaf)
    return out


def grads_as_jax(params, part: str) -> dict:
    """The gradients of params[part]'s named leaves in JAX's tree layout
    (None as zeros): a copy of the modules holding the gradients, carried
    back by params_to_jax."""
    g = copy.deepcopy(params)
    with torch.no_grad():
        for (_, dst), (_, src) in zip(named_leaves(g[part]), named_leaves(params[part])):
            dst.copy_(src.grad if src.grad is not None else torch.zeros_like(src))
    return params_to_jax(g)[part]


def text_batch(seed=2, t=T):
    rng = np.random.default_rng(seed)
    embeds = (0.5 * rng.standard_normal((1, t, CFG.text.dim))).astype(np.float32)
    labels = np.zeros((1, t), np.int32)
    mask = np.zeros((1, t), np.float32)
    labels[0, 700:760] = rng.integers(0, CFG.text.vocab_size, 60)  # across the prefix end
    mask[0, 700:760] = 1.0
    mask[0, 745:750] = 0.0
    return embeds, labels, mask


# ------------------------------------------------------------- the forward


def test_sdpa_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, 40, 32)).astype(np.float32) for _ in range(3))
    mask = np.asarray(jtext.prefix_attn_mask(40, 25))
    want = np.asarray(jlayers.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(mask)))
    got = sdpa(*(torch.from_numpy(a) for a in (q, k, v)), torch.tensor(mask))
    assert max_rel(got, want) < 1e-5
    # bf16 inputs: within 2x JAX's own bf16 error against the fp32 result
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jlayers.sdpa(*(x.astype(F32) for x in (qb, kb, vb)), jnp.asarray(mask)))
    jax_bf16 = np.asarray(jlayers.sdpa(qb, kb, vb, jnp.asarray(mask)).astype(F32))
    ours = sdpa(*(torch.tensor(np.asarray(x.astype(F32))).bfloat16() for x in (qb, kb, vb)),
                torch.tensor(mask))
    assert ours.dtype == torch.bfloat16
    assert max_rel(ours.float(), ref) <= 2 * max_rel(jax_bf16, ref)


@pytest.mark.parametrize("q_len,prefix", [(768, 730), (40, 25), (16, 0), (16, 16)])
def test_prefix_attn_mask_matches_jax(q_len, prefix):
    want = np.asarray(jtext.prefix_attn_mask(q_len, prefix))
    assert np.array_equal(ptext.prefix_attn_mask(q_len, prefix).numpy(), want)


def test_produce_hidden_and_layers_match_jax(tree):
    params = port_params(tree)
    embeds, _, _ = text_batch()
    hid = _jit("hidden", lambda: jax.jit(
        lambda p, e: jtext.produce_hidden(e, p, CFG.text)))(tree["text"], embeds)
    layers = _jit("layers", lambda: jax.jit(
        lambda p, e: jtext.produce_hidden_layers(e, p, CFG.text)))(tree["text"], embeds)
    x = torch.from_numpy(embeds)
    assert max_rel(ptext.produce_hidden(x, params["text"]), hid) < 1e-5
    got = ptext.produce_hidden_layers(x, params["text"])
    assert got.shape == layers.shape and max_rel(got, layers) < 1e-5
    logits = jtext.lm_head_full(jnp.asarray(hid), tree["text"])
    assert max_rel(ptext.lm_head_full(torch.tensor(np.asarray(hid)), params["text"]),
                   logits) < 1e-5


# ----------------------------------------------------- losses and gradients


def test_named_leaves_are_jax_tree_leaves(tree):
    params = port_params(tree)
    for part in ("text", "region"):
        names = list(flat(params_to_jax(params)[part]))
        assert names == list(flat(tree[part]))
        size = sum(t.numel() for _, t in named_leaves(params[part]))
        assert size == sum(a.size for a in flat(tree[part]).values())
    assert named_leaves(params["text"])[-1][1] is params["text"].freqs_cis
    assert params["text"].freqs_cis.dtype == torch.float32


def test_text_loss_and_every_gradient_match_jax(tree):
    params = port_params(tree)
    embeds, labels, mask = text_batch()
    vg = _jit("text_vg", lambda: jax.jit(jax.value_and_grad(
        lambda p, e, l, m: jtrainer.text_loss(p, e, l, m, CFG.text))))
    want, jgrads = vg(tree["text"], embeds, labels, mask)
    leaves = named_leaves(params["text"])
    with trainable(leaves):
        loss = trainer.text_loss(params["text"], torch.from_numpy(embeds),
                                 torch.from_numpy(labels), torch.from_numpy(mask))
        loss.backward()
    assert not any(t.requires_grad for _, t in leaves)
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    ours, theirs = flat(grads_as_jax(params, "text")), flat(jgrads)
    assert params["text"].wte.grad is None and not np.any(theirs["wte"])
    assert np.max(np.abs(theirs["freqs_cis"])) > 0  # the RoPE table is trained
    for name, g in theirs.items():
        if name != "wte":
            assert max_rel(ours[name], g) < 1e-4, name


def test_region_loss_and_every_gradient_match_jax(tree):
    params = port_params(tree)
    embeds, _, _ = text_batch(seed=4)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 1024, 12).astype(np.int32)  # 3 boxes
    c_idx = np.array([740, 741, 743, 744, 746, 747], np.int32)
    s_idx = np.array([742, 745, 748], np.int32)
    hid = _jit("hidden", lambda: jax.jit(
        lambda p, e: jtext.produce_hidden(e, p, CFG.text)))(tree["text"], embeds)
    want, jgrads = _jit("region_vg", lambda: jax.jit(jax.value_and_grad(jtrainer.region_loss)))(
        tree["region"], hid, labels, c_idx, s_idx)
    with torch.no_grad():
        hidden = ptext.produce_hidden(torch.from_numpy(embeds), params["text"])
    leaves = named_leaves(params["region"])
    with trainable(leaves):
        loss = trainer.region_loss(params["region"], hidden, torch.from_numpy(labels),
                                   torch.from_numpy(c_idx), torch.from_numpy(s_idx))
        loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    ours, theirs = flat(grads_as_jax(params, "region")), flat(jgrads)
    for name, g in theirs.items():
        if name.startswith(("coord_decoder", "size_decoder")):
            assert max_rel(ours[name], g) < 1e-4, name
        else:  # read only by the examples, which are data
            assert not np.any(g) and not np.any(ours[name]), name
    coord = jnp.asarray(rng.standard_normal((5, 1024)), F32)
    bins = rng.integers(0, 1024, 5).astype(np.int32)
    assert abs(float(trainer.region_coord_loss(torch.tensor(np.asarray(coord)),
                                               torch.from_numpy(bins)))
               - float(jtrainer.region_coord_loss(coord, bins))) < 1e-5


# --------------------------------------------------------------- optimizer


OPT_SHAPES = {"w": (24, 16), "b": (16,), "wte": (12, 8), "rope": (6, 4, 2)}
OPT_STEPS = 6


def _opt_case(kind):
    """(optax transformation, port AdamW): the CLIs' MultiSteps(k=2) adamw on
    the schedule with weight decay 1e-4; make_optimizer at a constant LR;
    make_optimizer on the schedule."""
    if kind == "cli":
        sched = jtrainer.lr_schedule(1e-2)
        jopt = optax.MultiSteps(optax.adamw(lambda s: sched(s, 3), b1=0.9, b2=0.95, eps=1e-6),
                                every_k_schedule=2)
        return jopt, trainer.cli_optimizer(1e-2, 3, 2)
    max_steps = 4 if kind == "make_schedule" else None
    return (jtrainer.make_optimizer(2e-2, weight_decay=1e-3, max_steps=max_steps),
            trainer.make_optimizer(2e-2, weight_decay=1e-3, max_steps=max_steps))


def _run_optax(jopt, params, grads):
    update = jax.jit(jopt.update)
    state, out = jopt.init(params), []
    for g in grads:
        u, state = update(g, state, params)
        params = optax.apply_updates(params, u)
        out.append(params)
    return out


def _run_port(opt, params, grads):
    leaves = [(k, torch.tensor(np.asarray(v.astype(F32))).to(
        torch.float32 if v.dtype == F32 else torch.bfloat16)) for k, v in params.items()]
    state, out, emitted = opt.init(leaves), [], []
    for g in grads:
        for k, t in leaves:
            t.grad = None if k == "wte" else torch.tensor(
                np.asarray(g[k].astype(F32))).to(t.dtype)
        emitted.append(opt.update(state, leaves))
        out.append({k: t.float().numpy().copy() for k, t in leaves})
    return out, emitted


@pytest.mark.parametrize("kind", ["cli", "make_constant", "make_schedule"])
def test_adamw_matches_optax_fp32(kind):
    rng = np.random.default_rng(6)
    params = {k: jnp.asarray(rng.standard_normal(s), F32) for k, s in OPT_SHAPES.items()}
    grads = [{k: jnp.asarray(0.0 if k == "wte" else rng.standard_normal(s), F32)
              * jnp.ones(s, F32) for k, s in OPT_SHAPES.items()} for _ in range(OPT_STEPS)]
    jopt, popt = _opt_case(kind)
    want = _run_optax(jopt, params, grads)
    got, emitted = _run_port(popt, params, grads)
    every = 2 if kind == "cli" else 1
    assert emitted == [(i + 1) % every == 0 for i in range(OPT_STEPS)]
    for i in range(OPT_STEPS):
        for k in OPT_SHAPES:
            start = np.asarray(params[k])
            moved = np.max(np.abs(np.asarray(want[i][k]) - start))
            err = np.max(np.abs(got[i][k] - np.asarray(want[i][k])))
            assert err <= 1e-5 * moved + 1e-7, (kind, i, k, err, moved)
            if not emitted[i]:  # between boundaries nothing moves
                prev = got[i - 1][k] if i else start
                assert np.array_equal(got[i][k], prev)
    # wte moves by weight decay alone
    assert not np.array_equal(got[-1]["wte"], np.asarray(params["wte"]))


def test_adamw_matches_optax_bf16():
    """bf16 weights (the RoPE-like leaf stays fp32, as freqs_cis does in a
    bf16 text tree): the port's bf16 run is at most 2x as far from the
    fp32 run as JAX's bf16 run is."""
    rng = np.random.default_rng(7)
    dt = {k: (F32 if k == "rope" else jnp.bfloat16) for k in OPT_SHAPES}
    params = {k: jnp.asarray(rng.standard_normal(s), dt[k]) for k, s in OPT_SHAPES.items()}
    grads = [{k: (jnp.zeros(s) if k == "wte" else jnp.asarray(rng.standard_normal(s)))
              .astype(dt[k]) for k, s in OPT_SHAPES.items()} for _ in range(OPT_STEPS)]
    jopt, popt = _opt_case("cli")
    ref = _run_optax(jopt, {k: v.astype(F32) for k, v in params.items()},
                     [{k: v.astype(F32) for k, v in g.items()} for g in grads])
    jax_bf16 = _run_optax(jopt, params, grads)
    got, _ = _run_port(popt, params, grads)
    for k in OPT_SHAPES:
        r = np.asarray(ref[-1][k])
        ours = np.max(np.abs(got[-1][k] - r))
        theirs = np.max(np.abs(np.asarray(jax_bf16[-1][k].astype(F32)) - r))
        assert ours <= 2 * theirs + (1e-7 if k == "rope" else 0), (k, ours, theirs)


# ----------------------------------------------------------------- helpers


def test_lr_schedule_matches_jax():
    for lr in (3e-6, 5e-5):
        jsched, psched = jtrainer.lr_schedule(lr), trainer.lr_schedule(lr)
        for max_steps in (1, 7, 100):
            for step in range(max_steps + 1):
                want = np.float32(jsched(jnp.int32(step), max_steps))
                got = psched(step, max_steps)
                assert got.dtype == torch.float32
                assert abs(float(got) - float(want)) <= 1e-6 * float(want), (lr, step)


def test_size_to_bin_matches_jax():
    sizes = np.concatenate([np.geomspace(1e-5, 2.0, 300), [0.0, 1 / 1024, 1.0, 0.5]])
    sizes = sizes.astype(np.float32)
    want = np.asarray(jtrainer.size_to_bin(jnp.asarray(sizes)))
    got = trainer.size_to_bin(torch.from_numpy(sizes))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------- examples


@pytest.fixture(scope="module")
def models(tree):
    ref = JaxModel(CFG, params=tree, tokenizer=JaxByteTokenizer(), dtype=F32)
    ours = MoondreamModel(PCFG, params=port_params(tree), tokenizer=ByteTokenizer(),
                          dtype=torch.float32, device="cpu")
    return ref, ours


def test_build_example_matches_jax(models, monkeypatch):
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")  # JAX's host crop path
    ref, ours = models
    img = pft.synthetic_dataset(1)[0]["image"]
    answer = f"synthetic sample number 0{pft.ANSWER_EOS}"
    want = jft.build_example(ref, Image.fromarray(img), pft.QUESTION, answer)
    got = pft.build_example(ours, img, pft.QUESTION, answer)
    assert got["inputs_embeds"].shape == want["inputs_embeds"].shape
    assert got["inputs_embeds"].shape[1] % pft.SEQ_BUCKET == 0
    assert max_rel(got["inputs_embeds"], want["inputs_embeds"]) < 1e-5
    assert np.array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert np.array_equal(got["label_mask"].numpy(), np.asarray(want["label_mask"]))


def test_build_class_example_matches_jax(models):
    ref, ours = models
    img_emb = np.random.default_rng(8).standard_normal((729, CFG.text.dim)).astype(np.float32)
    boxes = [[0.41, 0.5, 0.3, 0.4], [0.0, 1.0, 1e-4, 1.0], [0.5, 0.25, 0.5, 0.0625]]
    want = jfr.build_class_example(ref, jnp.asarray(img_emb), "widget", boxes)
    got = pfr.build_class_example(ours, torch.from_numpy(img_emb), "widget", boxes)
    assert max_rel(got["inputs_embeds"], want["inputs_embeds"]) < 1e-5
    for key in ("labels", "c_idx", "s_idx"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


# --------------------------------------------------------- the CLI's loops


def assert_moved_alike(got, want, start, name):
    """A weight's movement over a loop: within 1e-3 of JAX's in L2, and no
    element off by more than 1e-1 of the largest movement. Adam's first
    update is g / (|g| + 1e-6) per element, so where |g| is near 1e-6 the
    gradients' last bits (the ViT and attention summed in another order)
    move it by a few percent of the LR."""
    d_want, d_got = want - start, got - start
    assert np.linalg.norm(d_got - d_want) <= 1e-3 * np.linalg.norm(d_want), name
    assert np.max(np.abs(d_got - d_want)) <= 1e-1 * np.max(np.abs(d_want)), name


def _jax_text_loop(ref, dataset, epochs, lr, grad_accum):
    """The JAX CLI's loop (moondream_tpu/finetune/finetune_text.py main)."""
    total = epochs * len(dataset) // grad_accum
    sched = jtrainer.lr_schedule(lr)
    opt = optax.MultiSteps(optax.adamw(lambda s: sched(s, max(total, 1)), b1=0.9, b2=0.95,
                                       eps=1e-6), every_k_schedule=grad_accum)
    params = ref.params["text"]
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s, batch):
        loss, g = jax.value_and_grad(lambda q: jtrainer.text_loss(
            q, batch["inputs_embeds"], batch["labels"], batch["label_mask"], CFG.text))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    losses = []
    for _ in range(epochs):
        for sample in dataset:
            batch = jft.build_example(ref, Image.fromarray(sample["image"]), pft.QUESTION,
                                      f"{sample['description']}{pft.ANSWER_EOS}")
            params, opt_state, loss = step(params, opt_state, batch)
            ref.params["text"] = params
            losses.append(float(loss))
    return losses


def test_text_finetune_loop_matches_jax(tree, monkeypatch):
    """Two synthetic samples, two epochs, grad-accum 2: two updates, the
    second example's image embedding read after the first update's wte."""
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
    ref = JaxModel(CFG, params=copy.deepcopy(tree), tokenizer=JaxByteTokenizer(), dtype=F32)
    ours = MoondreamModel(PCFG, params=port_params(tree), tokenizer=ByteTokenizer(),
                          dtype=torch.float32, device="cpu")
    dataset = pft.synthetic_dataset(2)
    want_losses = _jax_text_loop(ref, dataset, 2, 1e-3, 2)
    losses = []
    state = pft.train(ours, dataset, 2, 1e-3, 2, log=lambda s, l: losses.append(float(l)))
    assert state.step == 4 and state.opt_state.count == 2
    assert np.allclose(losses, want_losses[1::2], rtol=1e-5)
    got = flat(params_to_jax(ours.params)["text"])
    start = flat(tree["text"])
    for name, want in flat(ref.params["text"]).items():
        assert np.max(np.abs(want - start[name])) > 0, name  # every leaf trains or decays
        assert_moved_alike(got[name], want, start[name], name)
    assert not any(t.requires_grad for _, t in named_leaves(ours.text))


def test_region_finetune_loop_matches_jax(tree, monkeypatch):
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
    ref = JaxModel(CFG, params=copy.deepcopy(tree), tokenizer=JaxByteTokenizer(), dtype=F32)
    ours = MoondreamModel(PCFG, params=port_params(tree), tokenizer=ByteTokenizer(),
                          dtype=torch.float32, device="cpu")
    dataset = pfr.synthetic_dataset(2)
    sched = jtrainer.lr_schedule(1e-3)
    opt = optax.MultiSteps(optax.adamw(lambda s: sched(s, 1), b1=0.9, b2=0.95, eps=1e-6),
                           every_k_schedule=2)
    rp, opt_state = ref.params["region"], opt.init(ref.params["region"])

    @jax.jit
    def step(rp, tp, s, batch):
        def loss_fn(q):
            hidden = jtext.produce_hidden(batch["inputs_embeds"], tp, CFG.text)
            return jtrainer.region_loss(q, hidden, batch["labels"], batch["c_idx"],
                                        batch["s_idx"])
        loss, g = jax.value_and_grad(loss_fn)(rp)
        u, s = opt.update(g, s, rp)
        return optax.apply_updates(rp, u), s, loss

    for sample in dataset:
        img_emb = ref._run_vision_encoder(Image.fromarray(sample["image"]))
        batch = jfr.build_class_example(ref, img_emb, "widget", sample["boxes"])
        rp, opt_state, want_loss = step(rp, ref.params["text"], opt_state, batch)
        ref.params["region"] = rp
    before = flat(params_to_jax(ours.params))
    losses = []
    pfr.train(ours, dataset, 1, 1e-3, 2, log=lambda s, l: losses.append(float(l)))
    assert abs(losses[-1] - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    after = flat(params_to_jax(ours.params))
    got, start = flat(params_to_jax(ours.params)["region"]), flat(tree["region"])
    for name, want in flat(rp).items():
        assert_moved_alike(got[name], want, start[name], name)
    # only the region tree moved
    for name, a in before.items():
        if not name.startswith("region."):
            assert np.array_equal(after[name], a), name


# -------------------------------------------------------- saving, refusals


def test_save_params_matches_jax_and_both_loaders_read_it(tree, models, tmp_path):
    from safetensors.numpy import load_file

    ref, ours = models
    jpath, ppath = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jft.save_params(jpath, ref)
    pft.save_params(ppath, ours)
    want, got = load_file(jpath), load_file(ppath)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    back = flat(jax_load_params(ppath, CFG, dtype=F32))
    for name, a in flat(tree).items():
        if name != "text.freqs_cis":
            assert np.array_equal(back[name], a), name
    pt = str(tmp_path / "port.pt")
    pft.save_params(pt, ours)
    for path in (ppath, pt):
        loaded = load_params(path, PCFG, dtype=torch.float32, device="cpu")
        for (name, a), (_, b) in zip(loaded.named_parameters(), ours.params.named_parameters()):
            assert torch.equal(a, b), (path, name)


def test_checkpoint_round_trip(tree, tmp_path):
    params = port_params(tree)
    opt = trainer.make_optimizer(1e-2)
    state = trainer.init_train_state(params["text"], opt)
    embeds, labels, mask = (torch.from_numpy(a) for a in text_batch())
    state, _ = trainer.make_train_step(opt)(state, {
        "inputs_embeds": embeds, "labels": labels, "label_mask": mask})
    path = str(tmp_path / "step.pt")
    trainer.save_checkpoint(path, state)
    fresh = port_params(tree)
    restored = trainer.load_checkpoint(path, trainer.init_train_state(fresh["text"], opt), opt)
    assert restored.step == 1 and restored.opt_state.count == 0
    for (name, a), (_, b) in zip(named_leaves(fresh["text"]), named_leaves(params["text"])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_quantized_params_refused_like_jax(tree, fmt):
    params = port_params(tree)
    quant = {"int4": (ptext.quantize_text_params, jtext.quantize_text_params),
             "int8": (ptext.quantize_text_params_int8, jtext.quantize_text_params_int8)}[fmt]
    quant[0](params["text"])
    embeds = text_batch()[0][:, :32]
    with pytest.raises(ValueError) as want:
        jtext.produce_hidden(jnp.asarray(embeds), quant[1](tree["text"]), CFG.text)
    for fn in (ptext.produce_hidden, ptext.produce_hidden_layers):
        with pytest.raises(ValueError) as got:
            fn(torch.from_numpy(embeds), params["text"])
        assert str(got.value).split(" is not", 1)[1] == str(want.value).split(" is not", 1)[1]


def test_lora_rank_trains_an_adapter_that_serves(tmp_path):
    """--lora-rank on the CPU: two updates, a checkpoint of the adapter at
    each, and a variant file whose adapter changes a caption's first
    logits when served through settings["variant"]."""
    out, ckpt = str(tmp_path / "adapter.pt"), str(tmp_path / "ckpt")
    pft.main(["--config", "tiny", "--synthetic", "2", "--device", "cpu", "--lora-rank", "2",
              "--grad-accum", "1", "--epochs", "1", "--save-every", "1", "--lr", "1e-2",
              "--ckpt-dir", ckpt, "--save", out])
    saved = torch.load(f"{ckpt}/step_2.pt", weights_only=True)
    assert saved["step"] == 2 and sorted(saved["params"]) == sorted(
        f"{g}.{s}.{f}" for g, s in ptext.LORA_SITES for f in ("A", "B"))
    model = MoondreamModel(PCFG, dtype=torch.float32, seed=0, device="cpu")
    prompt = list(PCFG.tokenizer.templates["caption"]["normal"])
    img = np.random.default_rng(0).integers(0, 255, (64, 80, 3), np.uint8)

    def first_logits(settings):
        enc = model.encode_image(img, settings=settings)
        kv = model.load_encoded_image(enc)
        return model._prefill_prompt(kv, prompt, enc.pos, 0.0, 0.0,
                                     lora=model._variant(settings))[0]

    lora = model._variant({"variant": out})
    assert lora["mlp"]["fc1"]["A"].shape == (PCFG.text.n_layers, 2, PCFG.text.dim)
    assert lora["attn"]["qkv"]["B"].any()
    assert not torch.equal(first_logits({"variant": out}), first_logits(None))


def test_cli_needs_the_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (pft.main, pfr.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", "tiny", "--synthetic", "1"])


@pytest.mark.parametrize("cli,save", [(pft, "t.safetensors"), (pfr, "r.pt")])
def test_cli_runs_on_the_cpu(cli, save, tmp_path):
    out = str(tmp_path / save)
    extra = ["--save-every", "1", "--ckpt-dir", str(tmp_path / "ckpt")] if cli is pft else []
    cli.main(["--config", "tiny", "--synthetic", "2", "--device", "cpu", "--grad-accum", "1",
              "--epochs", "1", "--save", out, *extra])
    loaded = load_params(out, PCFG, device="cpu")
    assert "region" in loaded
    assert all(torch.isfinite(p).all() for p in loaded.parameters())
    if cli is pft:  # a checkpoint of the text tree per update; the last one resumes
        saved = [t.clone() for _, t in named_leaves(loaded["text"])]
        opt = trainer.make_optimizer()
        state = trainer.init_train_state(loaded["text"], opt)
        state = trainer.load_checkpoint(str(tmp_path / "ckpt" / "step_2.pt"), state, opt)
        assert state.step == 2 and (tmp_path / "ckpt" / "step_1.pt").exists()
        for (name, t), old in zip(named_leaves(loaded["text"]), saved):
            # save_params drops the trained RoPE table; the checkpoint keeps it
            assert torch.equal(t, old) != (name == "freqs_cis"), name
