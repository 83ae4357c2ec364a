"""The port's region-head paths against moondream_tpu.MoondreamModel on the
CPU, at tiny_test_config, fp32, with the same parameters: detect, point,
detect_gaze (eye mode and accuracy mode), detect_batch / point_batch,
query with reasoning and with spatial refs, and the answer loop's EOS
handling and host reads.

Coordinates come from a 1024-bin argmax, so an exact box check needs
decisive argmaxes: the region decoders' fc2 biases get seeded normals
times a scale (tests/test_batched.py's peaked oracle): 50 makes every
argmax the bias's own ("peaked"); 1 keeps it decisive in fp32 yet
dependent on the hidden state ("mild"). lm_head bias offsets steer the
greedy tokens: EOS (id 0) after some objects or at once, and for reasoning
the coord (5), start-ground (7), end-ground (9) and answer (3) ids.
Boxes and points must equal JAX's within 1e-6 (sizes pass through exp2,
which the two libraries round differently by an ulp); ids and reasoning
text exactly. IdTokenizer renders every id as `<id>`."""

import copy
import math
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from moondream_tpu.config import tiny_test_config
from moondream_tpu.engine import generate as jax_generate
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.engine import generate as port_generate
from moondream_tpu_torch.engine.batched import batched_steps
from moondream_tpu_torch.models import text as port_text
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

ATOL = 1e-6
MAX_OBJECTS = 8
# (region decoder bias scale, lm_head bias offsets by id)
CASES = {
    "peaked": (50.0, {}),
    "mild": (1.0, {}),
    "mild-eos": (1.0, {0: 3.5}),  # EOS after five boxes
    "first-eos": (1.0, {0: 4.5}),  # EOS as the prompt's own token
    # reasoning: coordinates then end-ground tokens; coordinates inside
    # text split by start-ground tokens; four coordinates, then the answer
    "reason-ground": (1.0, {5: 3.8, 7: 2.5, 9: 2.8, 3: 2.5}),
    "reason-chunks": (1.0, {5: 3.2, 7: 2.5, 9: 2.8, 3: 2.5}),
    "reason-answer": (1.0, {5: 3.8, 7: 2.5, 9: 2.8, 3: 2.9}),
}
# (detect, point) boxes found per case at MAX_OBJECTS
FOUND = {"peaked": (8, 8), "mild": (8, 8), "mild-eos": (5, 8), "first-eos": (0, 0)}


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


@pytest.fixture(scope="module")
def base_tree():
    cfg = tiny_test_config()
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    return {
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
        "region": jax_region.init_region_params(cfg.region, kr, jnp.float32),
    }


@pytest.fixture(scope="module")
def make(base_tree):
    """make(case) -> (JAX model, port model) on one tree, built once."""
    built = {}

    def build(case):
        if case not in built:
            scale, lm = CASES[case]
            tree = copy.deepcopy(base_tree)
            rng = np.random.default_rng(3)
            for site in ("coord_decoder", "size_decoder"):
                b = np.asarray(tree["region"][site]["fc2"]["b"])
                tree["region"][site]["fc2"]["b"] = jnp.asarray(
                    b + rng.standard_normal(b.shape).astype(np.float32) * scale)
            lb = np.array(tree["text"]["lm_head"]["b"])
            for i, off in lm.items():
                lb[i] += off
            tree["text"]["lm_head"]["b"] = jnp.asarray(lb)
            ref = JaxModel(tiny_test_config(), params=tree, tokenizer=IdTokenizer(),
                           dtype=jnp.float32)
            ours = MoondreamModel(port_tiny_config(), params=params_from_jax(tree, port_tiny_config()),
                                  tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
            built[case] = ref, ours
        return built[case]

    return build


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 255, shape, dtype=np.uint8)
            for shape in ((378, 504, 3), (378, 378, 3), (600, 500, 3))]


@pytest.fixture(autouse=True)
def host_crops(monkeypatch):
    # the JAX model's host crop path (its device path is bit-identical)
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")


def _boxes(out):
    rows = out["objects"] if "objects" in out else out["points"]
    width = 4 if "objects" in out else 2
    return np.asarray([list(r.values()) for r in rows], dtype=np.float64).reshape(-1, width)


def _assert_reads_bounded(loop):
    c = port_generate.LOOP_COUNTS[loop]
    assert c["calls"] == 1
    assert c["reads"] <= math.ceil(c["steps"] / port_generate.DONE_CHECK_EVERY) + 1, c
    return c


@pytest.mark.parametrize("case", sorted(FOUND))
@pytest.mark.parametrize("task", ["detect", "point"])
def test_detect_and_point_match_jax(make, images, case, task):
    ref, ours = make(case)
    s = {"max_objects": MAX_OBJECTS}
    want = getattr(ref, task)(Image.fromarray(images[0]), "object", settings=s)
    port_generate.reset_loop_counts()
    got = getattr(ours, task)(images[0], "object", settings=s)
    c = _assert_reads_bounded("generate_points")
    np.testing.assert_allclose(_boxes(got), _boxes(want), atol=ATOL, rtol=0)
    found = FOUND[case][task == "point"]
    assert len(_boxes(got)) == found
    spo = 3 if task == "detect" else 2
    # the loop stops at the first flag read after EOS, or at the last box
    if found < MAX_OBJECTS:
        assert c["steps"] == batched_steps(found * spo, MAX_OBJECTS * spo)
    else:
        assert c["steps"] == MAX_OBJECTS * spo
    if case == "mild" and task == "detect":
        assert len({tuple(b) for b in _boxes(got)}) > 1  # the hidden state matters


@pytest.mark.parametrize("case", ["peaked", "mild"])
@pytest.mark.parametrize("force_detect", [False, True], ids=["plain", "force-detect"])
def test_detect_gaze_eye_mode_matches_jax(make, images, case, force_detect):
    ref, ours = make(case)
    s = {"force_detect": force_detect}
    want = ref.detect_gaze(Image.fromarray(images[1]), eye=(0.4, 0.3), unstable_settings=s)
    got = ours.detect_gaze(images[1], eye=(0.4, 0.3), unstable_settings=s)
    assert (got["gaze"] is None) == (want["gaze"] is None)
    # eos_id is 0 in this config: force_detect's token 0 always stops
    assert (got["gaze"] is None) == force_detect
    if want["gaze"] is not None:
        for k in ("x", "y"):
            assert abs(got["gaze"][k] - want["gaze"][k]) <= ATOL


@pytest.mark.parametrize("case", ["peaked", "mild"])
def test_detect_gaze_accuracy_mode_matches_jax(make, images, case):
    """20 eye positions drawn from Python's `random` in the same order, over
    the image and its mirror, in one lockstep batch; the port flips the
    array, JAX the PIL image."""
    ref, ours = make(case)
    face = {"x_min": 0.3, "x_max": 0.6, "y_min": 0.2, "y_max": 0.45}
    s = {"prioritize_accuracy": True}
    random.seed(7)
    want = ref.detect_gaze(Image.fromarray(images[1]), face=face, unstable_settings=s)
    random.seed(7)
    got = ours.detect_gaze(images[1], face=face, unstable_settings=s)
    assert want["gaze"] is not None and got["gaze"] is not None
    for k in ("x", "y"):
        assert abs(got["gaze"][k] - want["gaze"][k]) <= ATOL
    random.seed(7)
    again = ours.detect_gaze(images[1], face=face, unstable_settings={
        **s, "flip_enc_img": ours.encode_image(np.ascontiguousarray(images[1][:, ::-1]))})
    assert again == got


def test_detect_gaze_argument_errors(make, images):
    _, ours = make("mild")
    with pytest.raises(ValueError, match="eye"):
        ours.detect_gaze(images[0])
    with pytest.raises(ValueError, match="face"):
        ours.detect_gaze(images[0], unstable_settings={"prioritize_accuracy": True})
    with pytest.raises(ValueError, match="flip_enc_img"):
        ours.detect_gaze(ours.encode_image(images[0]), face={"x_min": 0, "x_max": 1,
                         "y_min": 0, "y_max": 1}, unstable_settings={"prioritize_accuracy": True})


@pytest.mark.parametrize("case", ["peaked", "mild", "mild-eos"])
def test_detect_batch_and_point_batch_match_jax_and_single(make, images, case):
    ref, ours = make(case)
    s = {"max_objects": MAX_OBJECTS}
    pil = [Image.fromarray(im) for im in images]
    got = {}
    for task in ("detect", "point"):
        port_generate.reset_loop_counts()
        got[task] = getattr(ours, f"{task}_batch")(images, "object", settings=s)
        _assert_reads_bounded("generate_points_batched")
        want = getattr(ref, f"{task}_batch")(pil, "object", settings=s)
        assert len(got[task]) == len(want) == len(images)
        for g, w, im in zip(got[task], want, images):
            np.testing.assert_allclose(_boxes(g), _boxes(w), atol=ATOL, rtol=0)
            assert g == getattr(ours, task)(im, "object", settings=s)
    encs = ours.encode_images(images[:2])
    assert ours.detect_batch(encs, "object", settings=s) == got["detect"][:2]


@pytest.mark.parametrize("case", ["reason-ground", "reason-chunks", "reason-answer"])
def test_query_reasoning_matches_jax(make, images, case):
    ref, ours = make(case)
    s = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 16}
    want = ref.query(Image.fromarray(images[0]), "What?", reasoning=True, settings=s)
    port_generate.reset_loop_counts()
    got = ours.query(images[0], "What?", reasoning=True, settings=s)
    _assert_reads_bounded("generate_reasoning")
    _assert_reads_bounded("generate_text")
    assert got == want
    assert "<5>" in got["reasoning"]["text"]  # the coordinate branch ran
    if case != "reason-chunks":
        assert got["reasoning"]["grounding"]
    streamed = ours.query(images[0], "What?", reasoning=True, stream=True, settings=s)
    assert streamed["reasoning"] == got["reasoning"]
    assert "".join(streamed["answer"]) == got["answer"]


@pytest.mark.parametrize("reasoning", [False, True], ids=["answer", "reasoning"])
def test_query_spatial_refs_matches_jax(make, images, reasoning):
    ref, ours = make("mild")
    s = {"temperature": 0.0, "top_p": 0.0, "max_tokens": 12}
    refs = [(0.3, 0.6), (0.1, 0.2, 0.5, 0.7)]
    want = ref.query(Image.fromarray(images[0]), "Is it?", reasoning=reasoning,
                     spatial_refs=refs, settings=s)
    got = ours.query(images[0], "Is it?", reasoning=reasoning, spatial_refs=refs, settings=s)
    assert got == want and got["answer"]
    plain = ours.query(images[0], "Is it?", reasoning=reasoning, settings=s)
    # the refs' embeddings, not the coord / size ids' own, reach the model
    enc = ours.encode_image(images[0])
    tok = ours.config.tokenizer
    prompt = [1, 14, 2, tok.coord_id, tok.coord_id, tok.coord_id, tok.coord_id, tok.size_id]
    logits = [ours._prefill_prompt(ours.load_encoded_image(enc), prompt, enc.pos, 0.0, 0.0,
                                   r)[0] for r in (refs, None)]
    assert not torch.equal(*logits)
    assert isinstance(plain["answer"], str)


# EOS at emitted token k of a free greedy run whose 12 ids are distinct,
# or no EOS and the limit (max_tokens)
EOS_AT = [0, 1, 7, 8, 9, "limit8", "limit10"]


@pytest.mark.parametrize("at", EOS_AT, ids=[str(a) for a in EOS_AT])
def test_generate_text_eos_count_pos_and_reads_match_jax(make, at):
    """Both packages prefill the same 12 random embeddings (bidirectional
    over 8), then decode greedily from token 300 at position 12 with the
    answer id suppressed."""
    ref, ours = make("mild")
    cfg = ref.config.text
    x = np.random.default_rng(35).standard_normal((1, 12, cfg.dim)).astype(np.float32)
    max_tokens = int(at[5:]) if isinstance(at, str) else 12

    def run_jax(eos):
        kv = jax_text.KVCache.create(cfg, batch=1, dtype=jnp.float32)
        _, kv = jax_text.text_decoder(jnp.asarray(x), ref.params["text"], kv,
                                      jnp.int32(0), jnp.int32(8), cfg)
        res = jax_generate.generate_text(
            ref.params["text"], kv, jnp.int32(300), jnp.int32(12), jax.random.PRNGKey(0),
            jnp.float32(0.0), jnp.float32(0.0), jnp.int32(max_tokens), cfg, eos, (3,), 64)
        return np.asarray(res.tokens)[:int(res.count)].tolist(), int(res.count), int(res.pos)

    free, _, _ = run_jax(-1)
    assert len(set(free)) == len(free) == max_tokens
    eos = free[at] if isinstance(at, int) else -1
    want_tokens, want_count, want_pos = run_jax(eos)
    assert want_count == (at if isinstance(at, int) else max_tokens)

    kv = port_text.KVCache.create(ours.config.text, 1, torch.float32, "cpu")
    port_text.text_decoder(torch.from_numpy(x), ours.text, kv, 0, 8)
    port_generate.reset_loop_counts()
    res = port_generate.generate_text(ours.text, kv, torch.tensor(300), 12, None, 0.0, 0.0,
                                      max_tokens, eos, (3,))
    assert (res.tokens, res.count, res.pos) == (want_tokens, want_count, want_pos)
    c = _assert_reads_bounded("generate_text")
    assert c["steps"] == batched_steps(want_count, max_tokens)
    assert c["reads"] == c["steps"] // port_generate.DONE_CHECK_EVERY + 1 + (
        c["steps"] % port_generate.DONE_CHECK_EVERY > 0)
