"""Detect, point and gaze requests in the port's serving pool (the mixed
chunks) against moondream_tpu's pool and the port's single-request paths,
on the CPU at tiny_test_config in fp32 with the same parameters, as
tests/test_serving_structured.py holds JAX's pool (its sharded case
excepted).

Exactness needs decisive argmaxes: the region decoders' fc2 biases get
seeded normals x 50 (the peaked oracle of tests/test_serving_structured.py),
so a pooled box equals the single-request box whatever order a pool's
products sum in. The port's pooled boxes must equal its single `detect` /
`point` / `detect_gaze` exactly and JAX's pool within 1e-6 (sizes pass
through exp2, which the two libraries may round an ulp apart); text rows
beside them must give the ids of the port's plain pool and of JAX's mixed
pool. Also: cancel keeps the objects found so far, structured rows compose
with speculation (the greedy mixed spec chunk, also with no text row at
all), a sampled speculative pool falls back to the plain mixed chunk, int8
KV and prefix-shared pools, and a request asking for more objects than the
pool holds is refused."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu.models.serve import ContinuousBatchingEngine as JaxEngine
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import serving
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

ATOL = 1e-6
MAX_OBJECTS = 4  # every pool's; requests ask for at most this many
S = {"max_objects": MAX_OBJECTS}
EYE = (0.4, 0.3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's ops are too small to gain from intra-op threads, and
    under parallel test workers those threads contend for the cores: run
    this module on one, and give the worker its setting back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


# JAX's chunks take the parameters as arguments: pools of one config (and
# prefix mode) share their compiles across trees
_JITS = {}


def _pair(kv_int8: bool, scale: float = 50.0, lm_offsets=None):
    """(JAX side, port side) on one tree, the three images encoded once on
    each: region decoders' fc2 biases + seeded normals x `scale`, lm_head
    bias + `lm_offsets` by id."""
    cfg, port_cfg = tiny_test_config(), port_tiny_config()
    if kv_int8:
        kv8 = lambda c: dataclasses.replace(c, text=dataclasses.replace(c.text, kv_int8=True))
        cfg, port_cfg = kv8(cfg), kv8(port_cfg)
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
        "region": jax_region.init_region_params(cfg.region, kr, jnp.float32),
    }
    tree = copy.deepcopy(tree)
    rng = np.random.default_rng(3)
    for site in ("coord_decoder", "size_decoder"):
        b = np.asarray(tree["region"][site]["fc2"]["b"])
        tree["region"][site]["fc2"]["b"] = jnp.asarray(
            b + rng.standard_normal(b.shape).astype(np.float32) * scale)
    lb = np.array(tree["text"]["lm_head"]["b"])
    for i, off in (lm_offsets or {}).items():
        lb[i] += off
    tree["text"]["lm_head"]["b"] = jnp.asarray(lb)
    ref = JaxModel(cfg, params=tree, tokenizer=IdTokenizer(), dtype=jnp.float32)
    ours = MoondreamModel(port_cfg, params=params_from_jax(tree, port_cfg),
                          tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (90 + 25 * i, 120, 3), np.uint8) for i in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")  # JAX's host crop path
        ref_encs = [ref.encode_image(Image.fromarray(im)) for im in images]
    return (
        {"model": ref, "encs": ref_encs, "engine": JaxEngine,
         "jits": _JITS.setdefault(kv_int8, {})},
        {"model": ours, "encs": [ours.encode_image(im) for im in images],
         "engine": ContinuousBatchingEngine},
    )


@pytest.fixture(scope="module")
def sides():
    return _pair(kv_int8=False)


@pytest.fixture(scope="module")
def sides_kv8():
    return _pair(kv_int8=True)


def _engine(side, **kw):
    eng = side["engine"](side["model"], slot_len=1024, max_objects=MAX_OBJECTS, **kw)
    if "jits" in side:  # JAX pools of one prefix mode share their compiled chunks
        eng._jits = side["jits"].setdefault(kw.get("prefix_share", False), {})
    return eng


def _both(sides, scenario, **kw):
    ref, ours = sides
    return scenario(ref, **kw), scenario(ours, **kw)


def _close(a, b) -> bool:
    """Equal nested results, floats within ATOL."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= ATOL
    return a == b


@pytest.fixture(scope="module")
def singles(sides):
    """The port's single-request results: detect of image 0, point of image
    1, gaze on image 0, and the plain pool's caption of each image."""
    _, ours = sides
    m, encs = ours["model"], ours["encs"]
    caps = {}
    for n in (8, 12):
        eng = _engine(ours, n_slots=3, chunk=3)
        rids = [eng.submit(e, max_tokens=n) for e in encs]
        out = eng.drain()
        caps[n] = [out[r] for r in rids]
    return {"detect": m.detect(encs[0], "object", settings=S),
            "point": m.point(encs[1], "thing", settings=S),
            "gaze": m.detect_gaze(encs[0], eye=EYE), "captions": caps}


def test_peaked_oracle_is_decisive(singles):
    assert len(singles["detect"]["objects"]) == MAX_OBJECTS
    assert len(singles["point"]["points"]) == MAX_OBJECTS
    assert singles["gaze"]["gaze"] is not None


# --------------------------------------------------------------- scenarios
def _detect_point(side):
    eng = _engine(side, n_slots=3, chunk=3)
    r_det = eng.submit_detect(side["encs"][0], "object")
    r_pts = eng.submit_point(side["encs"][1], "thing", max_objects=MAX_OBJECTS)
    out = eng.drain()
    assert eng.token_counts[r_det] == 0
    return out[r_det], out[r_pts]


def test_pooled_detect_point_match_single_and_jax(sides, singles):
    (want_d, want_p), (got_d, got_p) = _both(sides, _detect_point)
    assert got_d == singles["detect"] and got_p == singles["point"]
    assert _close(got_d, want_d) and _close(got_p, want_p)


def _gaze(side):
    eng = _engine(side, n_slots=2, chunk=3)
    rid = eng.submit_gaze(side["encs"][0], EYE)
    forced = eng.submit_gaze(side["encs"][0], EYE, force_detect=True)
    out = eng.drain()
    mix = _engine(side, n_slots=3, chunk=3)
    r_g = mix.submit_gaze(side["encs"][0], EYE)
    r_d = mix.submit_detect(side["encs"][1], "object")
    r_c = mix.submit(side["encs"][2], max_tokens=8)
    res = mix.drain()
    return out[rid], out[forced], res[r_g], res[r_d], res[r_c]


def test_pooled_gaze_matches_single_and_jax(sides, singles):
    want, got = _both(sides, _gaze)
    assert got[0] == got[2] == singles["gaze"]
    assert got[1] == {"gaze": None}  # force_detect's token 0 is EOS here
    assert got[4] == singles["captions"][8][2]
    assert got[3] == sides[1]["model"].detect(sides[1]["encs"][1], "object", settings=S)
    assert _close(got, want)


def _mixed(side, spec=0):
    """A caption, a detect, then (a chunk later) a point and a gaze in one
    pool; then a caption in a slot a structured request left."""
    eng = _engine(side, n_slots=4, chunk=3, speculative=spec)
    encs = side["encs"]
    r_cap = eng.submit(encs[2], max_tokens=12)
    r_det = eng.submit_detect(encs[0], "object")
    eng.step()  # text and structured rows advance together
    r_pts = eng.submit_point(encs[1], "thing")
    r_gaze = eng.submit_gaze(encs[0], EYE)
    out = eng.drain()
    r_again = eng.submit(encs[0], max_tokens=8)
    again = eng.drain()[r_again]
    return out[r_cap], out[r_det], out[r_pts], out[r_gaze], again


@pytest.mark.parametrize("spec", [0, 3], ids=["mixed", "mixed-spec"])
def test_mixed_text_and_structured_pool(sides, singles, spec):
    want, got = _both(sides, _mixed, spec=spec)
    assert got[0] == singles["captions"][12][2]
    assert got[1] == singles["detect"]
    assert got[2] == sides[1]["model"].point(sides[1]["encs"][1], "thing", settings=S)
    assert got[3] == singles["gaze"]
    assert got[4] == singles["captions"][8][0]  # the mode was reset for text
    assert _close(got, want)


def _cancel(side):
    eng = _engine(side, n_slots=2, chunk=2)
    rid = eng.submit_detect(side["encs"][0], "object")
    eng.step()
    eng.step()  # 4 forwards: the first object is recorded at its 3rd
    assert eng.cancel(rid) is True and eng.cancel(rid) is False
    partial = eng.results[rid]
    r2 = eng.submit_point(side["encs"][1], "thing")
    out = eng.drain()
    with pytest.raises(ValueError, match="max_objects"):
        eng.submit_detect(side["encs"][0], "object", max_objects=MAX_OBJECTS + 1)
    return partial, out[r2]


def test_cancel_keeps_the_objects_found_so_far(sides, singles):
    (want, want_pts), (got, got_pts) = _both(sides, _cancel)
    assert got["objects"] == singles["detect"]["objects"][:len(got["objects"])]
    assert len(got["objects"]) == 1
    assert got_pts == singles["point"]
    assert _close(got, want) and _close(got_pts, want_pts)


def _short_slot_gaze(side):
    """A slot that holds the image but not the gaze prompt (17 rows, its
    prefill padded to 24): admission refuses it with a ValueError, the
    padded prefill running past the slot notwithstanding."""
    enc = side["encs"][0]
    eng = side["engine"](side["model"], slot_len=enc.pos + 16, max_objects=MAX_OBJECTS)
    with pytest.raises(ValueError, match="no room to generate"):
        eng.submit_gaze(enc, EYE)
    return eng.free_slots()


def test_gaze_past_a_short_slot_is_refused(sides):
    want, got = _both(sides, _short_slot_gaze)
    assert got == want == list(range(len(got)))


def _structured_only_spec(side):
    eng = _engine(side, n_slots=2, chunk=3, speculative=3)
    r_det = eng.submit_detect(side["encs"][0], "object")
    r_pts = eng.submit_point(side["encs"][1], "thing")
    out = eng.drain()
    return out[r_det], out[r_pts]


def test_spec_pool_of_structured_rows_only(sides, singles, monkeypatch):
    want = _structured_only_spec(sides[0])
    calls = []
    spec_chunk = serving.serve_chunk_mixed_spec
    monkeypatch.setattr(serving, "serve_chunk_mixed_spec",
                        lambda *a, **k: calls.append(1) or spec_chunk(*a, **k))
    got = _structured_only_spec(sides[1])
    assert calls  # every chunk took the mixed spec path
    assert got == (singles["detect"], singles["point"]) and _close(got, want)


def _sampled_spec(side):
    eng = _engine(side, n_slots=2, chunk=3, speculative=3)
    r_txt = eng.submit(side["encs"][2], max_tokens=8, temperature=0.7, top_p=0.9)
    r_det = eng.submit_detect(side["encs"][0], "object")
    out = eng.drain()
    return out[r_det], out[r_txt]


def test_sampled_spec_pool_falls_back_to_the_plain_mixed_chunk(sides, singles, monkeypatch):
    (want, _), _ = _both(sides, _sampled_spec)
    calls = []
    mixed = serving.serve_chunk_mixed
    monkeypatch.setattr(serving, "serve_chunk_mixed",
                        lambda *a, **k: calls.append(1) or mixed(*a, **k))
    monkeypatch.setattr(serving, "serve_chunk_mixed_spec", None)  # must not be taken
    got, text = _sampled_spec(sides[1])
    assert calls and got == singles["detect"] and _close(got, want)
    assert isinstance(text, str) and text.count("<") <= 8


def _int8(side):
    eng = _engine(side, n_slots=2, chunk=3)
    r_det = eng.submit_detect(side["encs"][0], "object")
    r_cap = eng.submit(side["encs"][1], max_tokens=8)
    out = eng.drain()
    return out[r_det], out[r_cap]


def test_structured_pool_with_int8_kv(sides_kv8):
    want, got = _both(sides_kv8, _int8)
    m, encs = sides_kv8[1]["model"], sides_kv8[1]["encs"]
    assert got[0] == m.detect(encs[0], "object", settings=S)
    assert _close(got, want)


def _prefix(side):
    eng = _engine(side, n_slots=3, chunk=3, prefix_share=True)
    r_det = eng.submit_detect(side["encs"][0], "object")
    r_cap = eng.submit(side["encs"][0], max_tokens=8)
    r_gaze = eng.submit_gaze(side["encs"][0], EYE)
    assert sorted(eng._pref_refs, reverse=True)[:2] == [3, 0]  # one entry, three holders
    out = eng.drain()
    assert eng._pref_refs.count(0) == len(eng._pref_refs)
    return out[r_det], out[r_cap], out[r_gaze]


def test_structured_prefix_shared_pool(sides, singles):
    want, got = _both(sides, _prefix)
    assert got == (singles["detect"], singles["captions"][8][0], singles["gaze"])
    assert _close(got, want)


# ------------------------------------------- boxes that read the hidden state
# (region decoder bias scale, lm_head bias offsets by id), as
# tests/test_torch_structured.py: at x1 an argmax is decisive in fp32 but
# moves with the hidden state the row holds; the EOS offset stops a detect
# before max_objects, through the mixed chunks' EOS check
MILD = {"mild": (1.0, {}), "mild-eos": (1.0, {0: 4.0})}  # EOS after one box


@pytest.fixture(scope="module")
def mild_sides():
    built = {}

    def get(case):
        if case not in built:
            scale, lm = MILD[case]
            built[case] = _pair(kv_int8=False, scale=scale, lm_offsets=lm)
        return built[case]

    return get


@pytest.mark.parametrize("scenario", ["mixed", "mixed-spec", "structured-spec"])
@pytest.mark.parametrize("case", sorted(MILD))
def test_hidden_dependent_boxes_in_mixed_pools(mild_sides, case, scenario):
    """Under x1 biases a pooled box is right only if the chunk feeds each
    structured row its own hidden state, embedding and positions; under the
    EOS offset only if it stops each row where the single call does."""
    sides = mild_sides(case)
    m, encs = sides[1]["model"], sides[1]["encs"]
    single = (m.detect(encs[0], "object", settings=S), m.point(encs[1], "thing", settings=S))
    points = [tuple(p.values()) for p in single[1]["points"]]
    assert len(set(points)) > 1  # they follow the hidden state, not the bias
    n_boxes = len(single[0]["objects"])
    assert n_boxes == MAX_OBJECTS if case == "mild" else 0 < n_boxes < MAX_OBJECTS
    if scenario == "structured-spec":
        want, got = _both(sides, _structured_only_spec)
        assert got == single and _close(got, want)
        return
    want, got = _both(sides, _mixed, spec=3 if scenario == "mixed-spec" else 0)
    assert got[1:4] == (*single, m.detect_gaze(encs[0], eye=EYE))
    plain = _engine(sides[1], n_slots=2, chunk=3)
    caps = [plain.submit(encs[2], max_tokens=12), plain.submit(encs[0], max_tokens=8)]
    out = plain.drain()
    assert (got[0], got[4]) == (out[caps[0]], out[caps[1]])
    assert _close(got, want)
