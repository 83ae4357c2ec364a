"""The video recipes (`recipes/`) on the port's model
(moondream_tpu_torch/recipes.py) against the same recipes on the JAX
package's, on the CPU at tiny_test_config in fp32 with the models of
tests/test_torch_eval.py (one tree, peaked region decoders).

`recipes.common.pipeline.detect_frames`, whole frames and tiles, and each
recipe's process_video on a synthetic mp4 give the same detections (boxes
within 1e-6) and the same gaze points through both models. Every one of
them must take the batched route: `detect_frames` falls back to one detect
per frame on any exception with only a print, so the tests hold the port's
LOOP_COUNTS (one "generate_points_batched" call per chunk, no single
"generate_points") and the absence of that print. `recipes.load_model` and
`recipes.main` build the port's model with device="cpu"."""

import json
import sys

import numpy as np
import pytest
import torch

from moondream_tpu_torch import config as port_config
from moondream_tpu_torch import recipes
from moondream_tpu_torch.engine import generate
from moondream_tpu_torch.finetune.finetune_text import save_params
from test_torch_eval import models, small_budgets

FALLBACK = "falling back per-frame"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    small_budgets(mp)
    yield models()
    mp.undo()


def _frames(n=6, size=(96, 128)):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 255, (*size, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 6-frame mp4 (mp4v) of seeded noise."""
    import cv2

    path = str(tmp_path_factory.mktemp("video") / "in.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (128, 96))
    for f in _frames():
        w.write(f)
    w.release()
    return path


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=1e-6)


def _batched(run, capsys, chunks, gazes=0):
    """run() on the port, asserting that it took the batched route: `chunks`
    lockstep structured loops, no fallback print, and no single structured
    loop but the `gazes` eye-mode gaze points."""
    generate.reset_loop_counts()
    out = run()
    assert FALLBACK not in capsys.readouterr().out
    assert generate.LOOP_COUNTS["generate_points_batched"]["calls"] == chunks
    assert generate.LOOP_COUNTS.get("generate_points", {"calls": 0})["calls"] == gazes
    return out


@pytest.mark.parametrize("grid", [(1, 1), (1, 2)])
def test_detect_frames_matches_jax_batched(pair, capsys, grid):
    from recipes.common.pipeline import detect_frames

    ref, ours = pair
    frames = _frames(3)
    want = detect_frames(ref, frames, "thing", grid=grid, encode_batch=3)
    assert FALLBACK not in capsys.readouterr().out
    got = _batched(lambda: detect_frames(ours, frames, "thing", grid=grid, encode_batch=3),
                   capsys, grid[1])
    assert [len(b) for b in got] == [len(b) for b in want] and any(want)
    for a, b in zip(got, want):
        _close(a, b)


def _strip(stats):
    return {k: v for k, v in stats.items() if k not in ("inference_s", "model_fps", "output")}


@pytest.mark.parametrize("name", ["promptable_video_redaction", "promptable_content_moderation"])
def test_redaction_and_moderation_match_jax(pair, video, tmp_path, capsys, name):
    module = recipes.recipe(name)
    ref, ours = pair
    dets = {}
    for side, model in (("jax", ref), ("port", ours)):
        dets[side] = str(tmp_path / f"{side}.json")
        run = lambda: module.process_video(model, video, str(tmp_path / f"{side}.mp4"), "thing",
                                           every_n=2, encode_batch=3,
                                           save_detections=dets[side])
        stats = run() if side == "jax" else _batched(run, capsys, 1)
        assert stats["frames"] == 6 and stats["sampled"] == 3
        dets[side] = (json.load(open(dets[side]))["detections"], _strip(stats))
    (got, got_stats), (want, want_stats) = dets["port"], dets["jax"]
    assert got_stats == want_stats and got.keys() == want.keys()
    assert any(want.values())
    for k in want:
        _close(got[k], want[k])
    assert FALLBACK not in capsys.readouterr().out


def test_gaze_recipe_matches_jax(pair, video, tmp_path, capsys, monkeypatch):
    """Faces through one detect_batch per chunk, then one eye-mode gaze per
    face on the shared encodings; the drawn (face box, gaze) pairs agree."""
    module = recipes.recipe("gaze_detection_video")
    ref, ours = pair
    drawn, faces = {}, 0
    for side, model in (("jax", ref), ("port", ours)):
        calls = drawn.setdefault(side, [])

        def record(frame, box, gaze, color, trail=None, calls=calls):
            calls.append((*box, *gaze))
            return frame

        monkeypatch.setattr(module, "draw_gaze", record)
        run = lambda: module.process_video(model, video, str(tmp_path / f"{side}.mp4"),
                                           every_n=2, encode_batch=3)
        capsys.readouterr()
        if side == "jax":
            stats = run()
            faces = sum(int(line.split(": ")[1].split()[0])
                        for line in capsys.readouterr().out.splitlines()
                        if line.startswith("  frame "))
        else:
            stats = _batched(run, capsys, 1, gazes=faces)
        assert stats["frames"] == 6 and stats["sampled"] == 3
    assert faces and len(drawn["port"]) == len(drawn["jax"])
    _close(drawn["port"], drawn["jax"])


def test_load_model_and_main_on_the_cpu(pair, video, tmp_path, monkeypatch, capsys):
    """load_model with a checkpoint and without (random weights), then a
    recipe CLI through main, the 2B config swapped for the tiny one."""
    monkeypatch.setattr(port_config, "MOONDREAM_2B", port_config.tiny_test_config())
    monkeypatch.chdir(tmp_path)  # no ./tokenizer.json: the byte tokenizer
    ckpt = str(tmp_path / "m.safetensors")
    save_params(ckpt, pair[1])
    model = recipes.load_model(ckpt, "2b", device="cpu")
    assert model.device.type == "cpu" and model.dtype == torch.bfloat16
    want = pair[1].params.state_dict()
    for k, v in model.params.state_dict().items():
        assert torch.equal(v, want[k].to(torch.bfloat16)), k
    assert recipes.load_model("", "2b", device="cpu").config == port_config.tiny_test_config()

    module = recipes.recipe("promptable_video_redaction")
    loader, argv = module.load_model, list(sys.argv)
    dets = str(tmp_path / "d.json")
    recipes.main(["promptable_video_redaction", "--input", video, "--detect", "thing",
                  "--every-n", "3", "--device", "cpu", "--save-detections", dets])
    assert module.load_model is loader and sys.argv == argv
    assert sorted(json.load(open(dets))["detections"]) == ["0", "3"]
    out = capsys.readouterr().out
    assert "random weights" in out and FALLBACK not in out
    with pytest.raises(SystemExit):
        recipes.main(["no_such_recipe"])
