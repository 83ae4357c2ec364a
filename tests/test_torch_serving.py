"""The port's ContinuousBatchingEngine against moondream_tpu's, on the CPU at
tiny_test_config in fp32 with the same parameters (`params_from_jax`).

Each scenario runs, call for call, on a pool of each package (the two
engines share their API), and the result strings must be equal. With
IdTokenizer every id renders as `<id>`, so equal strings mean equal token
ids. The cases follow tests/test_serving.py and tests/test_prefix_share.py:
staggered admission, slot reuse, budgets, streaming, cancel, pipelining,
prepare/admit, prefix-shared pools (bf16-layout and int8 KV) and a sampled
row beside greedy ones. The JAX pool is the reference rather than batch-1
captions: a pool's matrix products reduce in another order than batch 1's.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.models.serve import ContinuousBatchingEngine as JaxEngine
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def _with_kv8(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_int8=True))


def _pair(kv_int8: bool):
    """(JAX side, port side), each {"model", "encs"}: the same weights and
    the three images encoded once (requests reuse the EncodedImages, so
    prefix-shared pools share entries by identity)."""
    cfg = tiny_test_config()
    kv, kt = jax.random.split(jax.random.PRNGKey(0))
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
    }
    port_cfg = port_tiny_config()
    if kv_int8:
        cfg, port_cfg = _with_kv8(cfg), _with_kv8(port_cfg)
    ref = JaxModel(cfg, params=dict(tree, region=None), tokenizer=IdTokenizer(),
                   dtype=jnp.float32)
    ours = MoondreamModel(port_cfg, params=params_from_jax(tree, port_cfg),
                          tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (80 + 16 * i, 100, 3), np.uint8) for i in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        # the JAX model's host crop path (its device path is bit-identical)
        mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
        ref_encs = [ref.encode_image(Image.fromarray(im)) for im in images]
    return (
        {"model": ref, "encs": ref_encs, "engine": JaxEngine, "jits": {}},
        {"model": ours, "encs": [ours.encode_image(im) for im in images],
         "engine": ContinuousBatchingEngine},
    )


@pytest.fixture(scope="module")
def sides():
    return _pair(kv_int8=False)


@pytest.fixture(scope="module")
def sides_kv8():
    return _pair(kv_int8=True)


def _both(sides, scenario, **kw):
    """Run `scenario(side, **kw)` on the JAX side and on the port's; return
    both results."""
    ref, ours = sides
    return scenario(ref, **kw), scenario(ours, **kw)


def _engine(side, **kw):
    eng = side["engine"](side["model"], slot_len=1024, **kw)
    if "jits" in side:
        # JAX pools of one kind share their compiled chunk functions (keyed
        # by chunk size): every pool here has slot_len 1024 and the
        # tokenizer's EOS, so only prefix sharing changes what is compiled
        eng._jits = side["jits"].setdefault(kw.get("prefix_share", False), {})
    return eng


# --------------------------------------------------------------- scenarios
def _single(side):
    eng = _engine(side, n_slots=2, chunk=4)
    rid = eng.submit(side["encs"][0], max_tokens=12)
    out = eng.drain()[rid]
    budget = _engine(side, n_slots=2, chunk=8)
    rid5 = budget.submit(side["encs"][0], max_tokens=5)
    budget.drain()
    return out, budget.results[rid5], budget.token_counts[rid5]


def _staggered(side, pipeline_depth=1):
    eng = _engine(side, n_slots=3, chunk=3, pipeline_depth=pipeline_depth)
    stream = []
    encs = side["encs"]
    r0 = eng.submit(encs[0], max_tokens=10, on_text=lambda rid, ch: stream.append(ch))
    eng.step()  # r0 alone for one chunk (dispatch only at depth 2)
    r1 = eng.submit(encs[1], question="what?", max_tokens=10)
    eng.step()
    r2 = eng.submit(encs[2], max_tokens=10)
    out = eng.drain()
    assert not eng._inflight
    return [out[r0], out[r1], out[r2]], "".join(stream)


def _slot_reuse(side):
    eng = _engine(side, n_slots=1, chunk=4)
    encs = side["encs"]
    r0 = eng.submit(encs[0], max_tokens=6)
    with pytest.raises(RuntimeError):
        eng.submit(encs[1], max_tokens=6)
    eng.drain()
    r1 = eng.submit(encs[1], max_tokens=6)  # the slot is free again
    out = eng.drain()
    return [out[r0], out[r1]]


def _cancel(side):
    eng = _engine(side, n_slots=2, chunk=4)
    encs = side["encs"]
    r1 = eng.submit(encs[0], max_tokens=64)
    r2 = eng.submit(encs[1], max_tokens=8)
    eng.step()
    partial = len(eng.slots[[s.req_id for s in eng.slots].index(r1)].tokens)
    assert eng.cancel(r1) is True
    assert eng.cancel(r1) is False  # already finished
    assert eng.cancel(999) is False
    assert len(eng.free_slots()) == 1  # reusable at once
    r3 = eng.submit(encs[0], max_tokens=6)
    out = eng.drain()
    assert set(out) == {r1, r2, r3}
    assert partial == 4  # one chunk
    return [out[r1], out[r2], out[r3]]


def _prepare_admit(side):
    eng = _engine(side, n_slots=2, chunk=4)
    encs = side["encs"]
    other = eng.submit(encs[1], max_tokens=12)
    eng.step()
    prep = eng.prepare(encs[0])
    eng.step()  # stepping between prepare and admit must not disturb it
    rid = eng.admit_prepared(prep, max_tokens=10)
    out = eng.drain()

    one = _engine(side, n_slots=1, chunk=4)
    prep = one.prepare(encs[0])
    one.release_prepared(prep)
    one.release_prepared(prep)  # idempotent
    with pytest.raises(ValueError):
        one.admit_prepared(prep)  # already released
    r0 = one.submit(encs[1], max_tokens=4)
    prep2 = one.prepare(encs[0])
    with pytest.raises(RuntimeError):
        one.admit_prepared(prep2)  # no free slot: prep2 stays valid
    one.drain()
    r2 = one.admit_prepared(prep2, max_tokens=6)
    out1 = one.drain()
    return [out[other], out[rid], out1[r0], out1[r2]]


def _prefix_pools(side):
    """Two requests on one encode and one on another, through a plain and
    a prefix-shared pool."""
    encs = side["encs"]

    def run(prefix_share):
        eng = _engine(side, n_slots=4, chunk=4, prefix_share=prefix_share)
        rids = [
            eng.submit(encs[0], max_tokens=10),
            eng.submit(encs[1], max_tokens=10),
            eng.submit(encs[0], max_tokens=10, question="what?"),
        ]
        if prefix_share:
            refs = sorted(eng._pref_refs, reverse=True)
            assert refs[:3] == [2, 1, 0]  # one entry held by two requests
        out = eng.drain()
        if prefix_share:
            assert eng._pref_refs.count(0) == len(eng._pref_refs)  # released
            assert len(eng._pref_pid_of) == 2  # still mapped for re-hits
        return [out[r] for r in rids]

    return run(False), run(True)


def _mixed_sampling(side):
    eng = _engine(side, n_slots=3, chunk=4)
    encs = side["encs"]
    g0 = eng.submit(encs[0], max_tokens=10)
    s1 = eng.submit(encs[1], max_tokens=10, temperature=1.0, top_p=0.9)
    g2 = eng.submit(encs[2], max_tokens=10)
    out = eng.drain()
    assert isinstance(out[s1], str)
    return [out[g0], out[g2]]


# ------------------------------------------------------------------- tests
def test_single_request_and_budget(sides):
    (want, want5, n5), (got, got5, m5) = _both(sides, _single)
    assert got == want and got.count("<") == 12
    assert got5 == want5 and m5 == n5 <= 5


def test_staggered_caption_query_caption(sides):
    (want, _), (got, stream) = _both(sides, _staggered)
    assert got == want
    assert stream == got[0]  # the streaming callback adds up to the result


def test_pipeline_depth_2_equals_depth_1(sides):
    (want, _), (got, stream) = _both(sides, _staggered, pipeline_depth=2)
    assert got == want
    assert stream == got[0]


def test_slot_reuse_and_backpressure(sides):
    want, got = _both(sides, _slot_reuse)
    assert got == want


def test_cancel(sides):
    want, got = _both(sides, _cancel)
    assert got == want


def test_prepare_admit_release(sides):
    want, got = _both(sides, _prepare_admit)
    assert got == want


def test_prefix_shared_pool(sides):
    (_, want), (plain, shared) = _both(sides, _prefix_pools)
    assert shared == plain == want


def test_int8_kv_prefix_shared_pool(sides_kv8):
    (_, want), (plain, shared) = _both(sides_kv8, _prefix_pools)
    assert shared == plain == want


def test_greedy_rows_exact_beside_a_sampled_row(sides):
    want, got = _both(sides, _mixed_sampling)
    assert got == want


def test_prefix_pool_exhaustion_and_wrong_span(sides):
    _, ours = sides
    encs = ours["encs"]
    eng = _engine(ours, n_slots=3, chunk=4, prefix_share=True, prefix_entries=1)
    assert tuple(eng.kv.k.shape[3:]) == (384, 32)  # ceil128(1024 - 730)
    assert tuple(eng.kv_pref.k.shape[1:4]) == (1, 2, 768)
    eng.submit(encs[0], max_tokens=4)
    eng.submit(encs[0], max_tokens=4)  # the same entry
    with pytest.raises(RuntimeError, match="prefix pool exhausted"):
        eng.submit(encs[1], max_tokens=4)
    eng.drain()
    rid = eng.submit(encs[1], max_tokens=4)  # the entry freed up
    assert rid in eng.drain()
    bad = dataclasses.replace(encs[0], pos=encs[0].pos - 1)
    with pytest.raises(ValueError, match="shared prefix"):
        eng.submit(bad, max_tokens=4)


def test_unported_options_raise(sides):
    _, ours = sides
    # speculative serving and LoRA variants are ported now
    # (tests/test_torch_serving_spec.py, tests/test_torch_multi_lora.py): a
    # variant tree without its sites, and a variant the pool does not hold,
    # raise KeyError
    assert _engine(ours, speculative=3).spec_k == 3
    with pytest.raises(KeyError):
        _engine(ours, variants={"a": {}})
    eng = _engine(ours, n_slots=1)
    with pytest.raises(KeyError, match="unknown variant"):
        eng.submit(ours["encs"][0], variant="a")
    assert eng.free_slots() == [0]
