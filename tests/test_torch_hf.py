"""The port's HF wrapper (moondream_tpu_torch/hf_moondream.py) against the
JAX package's (moondream_tpu/hf_moondream.py), on the CPU at
tiny_test_config in fp32 with the same parameters (`params_from_jax`) and
IdTokenizer (equal text is equal ids).

The legacy API and the pass-throughs follow tests/test_eval_orchestration.py's
HF-shim cases, with both models decoding 4 greedy tokens; the embedding
accessors, a swapped table of the same shape and one of another vocabulary
must drive generation alike in both packages; `config` is JAX's dict
without the fields the port does not read, and JAX's `from_dict` of it
gives JAX's config back."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from moondream_tpu import config as jax_config
from moondream_tpu.hf_moondream import HfMoondream as JaxHf
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch import config as port_config
from moondream_tpu_torch.engine import graphs
from moondream_tpu_torch.hf_moondream import HfConfig, HfMoondream
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    """(JAX wrapper, port wrapper) on one fp32 tree (peaked region
    decoders), both decoding 4 greedy tokens whatever the settings say,
    as tests/test_eval_orchestration.py's model does."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")  # JAX's host crops
    cfg, port_cfg = jax_config.tiny_test_config(), port_config.tiny_test_config()
    kv, kt, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = copy.deepcopy({
        "vision": jax_vision.init_vision_params(cfg.vision, kv, jnp.float32),
        "text": jax_text.init_text_params(cfg.text, kt, jnp.float32),
        "region": jax_region.init_region_params(cfg.region, kr, jnp.float32),
    })
    rng = np.random.default_rng(3)
    for site in ("coord_decoder", "size_decoder"):
        b = np.asarray(tree["region"][site]["fc2"]["b"])
        tree["region"][site]["fc2"]["b"] = jnp.asarray(
            b + rng.standard_normal(b.shape).astype(np.float32) * 50.0)
    ref = JaxModel(cfg, params=tree, tokenizer=IdTokenizer(), dtype=jnp.float32)
    ours = MoondreamModel(port_cfg, params=params_from_jax(tree, port_cfg),
                          tokenizer=IdTokenizer(), dtype=torch.float32, device="cpu")
    for m in (ref, ours):
        m._settings = lambda s: (4, 0.0, 0.0)
    yield JaxHf(ref), HfMoondream(ours)
    mp.undo()


def _img(seed, size=(64, 80)):
    return np.random.default_rng(seed).integers(0, 255, (size[0], size[1], 3), np.uint8)


def _both(pair, call):
    """call(wrapper, image_of) on the JAX wrapper (PIL images) and the
    port's (arrays)."""
    theirs, ours = pair
    return (call(theirs, lambda s: Image.fromarray(_img(s))), call(ours, _img))


def test_legacy_api_matches_jax(pair):
    def legacy(hf, img):
        return {
            "answer": hf.answer_question(hf.encode_image(img(3)), "what is this?"),
            "batch": hf.batch_answer([img(3), img(4)], ["a?", "b?"]),
            "generate": hf.generate(img(3), "hello"),
            "generate_enc": hf.generate(hf.encode_image(img(4)), "hi", max_new_tokens=3),
        }

    want, got = _both(pair, legacy)
    assert got == want
    assert isinstance(got["answer"], str) and len(got["batch"]) == 2
    assert isinstance(got["generate"], list) and len(got["generate"]) == 1


def test_pass_throughs_match_jax(pair):
    def calls(hf, img):
        return {
            "caption": hf.caption(img(3))["caption"],
            "query": hf.query(img(3), "why?")["answer"],
            "detect": hf.detect(img(3), "thing")["objects"],
            "point": hf.point(img(3), "thing")["points"],
            "gaze": hf.detect_gaze(img(3), (0.5, 0.5))["gaze"],
        }

    want, got = _both(pair, calls)
    assert got["caption"] == want["caption"] and got["query"] == want["query"]
    assert got["detect"], "the peaked decoders find objects"
    for key in ("detect", "point"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(list(a.values()), list(b.values()), atol=1e-6)
    np.testing.assert_allclose(list(got["gaze"].values()), list(want["gaze"].values()),
                               atol=1e-6)


def test_input_embeds(pair):
    theirs, ours = pair
    wte = ours.get_input_embeddings()
    assert wte is ours.model.text.wte and tuple(wte.shape) == (512, 64)
    emb = ours.input_embeds([1, 2, 3])
    assert emb.shape == (1, 3, 64)
    torch.testing.assert_close(emb[0], wte[[1, 2, 3]], rtol=0, atol=0)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(theirs.input_embeds([1, 2, 3])))
    batch = ours.input_embeds(np.array([[4, 5], [6, 7]]))
    np.testing.assert_array_equal(batch.numpy(),
                                  np.asarray(theirs.input_embeds(np.array([[4, 5], [6, 7]]))))


def test_config_to_dict(pair):
    theirs, ours = pair
    got, want = ours.config, theirs.config
    assert want["text"].pop("group_size") is None  # the one text field the port drops
    assert got == want
    assert jax_config.MoondreamConfig.from_dict(got) == theirs.model.config
    assert port_config.MoondreamConfig.from_dict(got) == ours.model.config
    for name in ("MOONDREAM_2B", "MOONDREAM_05B"):
        mine = getattr(port_config, name)
        kv8 = dataclasses.replace(mine, text=dataclasses.replace(mine.text, kv_int8=True))
        assert kv8.to_dict() == mine.to_dict()  # a runtime switch, not schema
        assert jax_config.MoondreamConfig.from_dict(mine.to_dict()) == getattr(jax_config, name)
    assert HfConfig().model_type == "moondream1"


def test_swapped_tables_drive_generation(pair):
    """A table of the same shape is written into the one the graphs read; a
    table of another vocabulary replaces it and drops the model's graphs.
    Either drives generation as it does in the JAX package."""
    theirs, ours = pair
    wte0 = ours.get_input_embeddings().detach().clone()
    ptr = ours.get_input_embeddings().data_ptr()

    def answer(hf, img):
        return hf.answer_question(hf.encode_image(img(5)), "what?")

    before = _both(pair, answer)
    assert before[0] == before[1]
    rng = np.random.default_rng(0)
    same = rng.standard_normal(tuple(wte0.shape)).astype(np.float32) * 0.02
    for hf in pair:
        hf.set_input_embeddings(same)
    assert ours.get_input_embeddings().data_ptr() == ptr
    np.testing.assert_array_equal(ours.get_input_embeddings().numpy(), same)
    after = _both(pair, answer)
    assert after[0] == after[1] and after[1] != before[1]

    graphs.cache_of(ours.model.text).entries["stale"] = graphs.Entry(None)
    wider = rng.standard_normal((wte0.shape[0] + 64, wte0.shape[1])).astype(np.float32) * 0.02
    theirs.set_input_embeddings(wider)
    ours.set_input_embeddings(torch.nn.Embedding.from_pretrained(torch.from_numpy(wider)))
    assert tuple(ours.get_input_embeddings().shape) == wider.shape
    assert not graphs.cache_of(ours.model.text).entries  # graphs of the old table dropped
    wide = _both(pair, answer)
    assert wide[0] == wide[1] and wide[1] != after[1]
    np.testing.assert_array_equal(ours.input_embeds([520, 570]).numpy()[0], wider[[520, 570]])

    with pytest.raises(ValueError):
        ours.set_input_embeddings(np.zeros((4, 4), np.float32))
    for hf in pair:
        hf.set_input_embeddings(wte0.numpy())
    assert _both(pair, answer) == before
