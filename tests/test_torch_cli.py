"""The port's CLI (moondream_tpu_torch/cli.py) against the JAX package's
(moondream_tpu/cli.py), on the CPU at tiny_test_config.

Both `main()`s read their arguments from sys.argv (`--demo --config tiny
--max-tokens 4`, and `--device cpu` for the port) and print every
capability's answer. The two packages draw random weights differently, so
both models are built on one fp32 tree here (the region decoders peaked,
as tests/test_torch_serve_http.py does) with IdTokenizer, and the printed
answers must be equal line for line; the device line differs by design.
`_benchmark` prints its two blocks."""

import copy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moondream_tpu import cli as jax_cli
from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import moondream as jax_moondream
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu_torch import cli
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models import moondream as port_moondream
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
def tree():
    cfg = tiny_test_config()
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
    return tree


def _on_tree(monkeypatch, module, tree, to_params, dtype):
    """Make `module.MoondreamModel` build fp32 models on `tree` (where the
    CLI passes no parameters) with IdTokenizer."""
    base = module.MoondreamModel

    class OnTree(base):
        def __init__(self, config, params=None, tokenizer=None, **kw):
            kw["dtype"] = dtype
            super().__init__(config, params=to_params(tree, config) if params is None else params,
                             tokenizer=IdTokenizer(), **kw)

    monkeypatch.setattr(module, "MoondreamModel", OnTree)


def _run(main, argv, monkeypatch, capsys) -> list:
    monkeypatch.setattr(sys, "argv", argv)
    main()
    return capsys.readouterr().out.splitlines()


def test_demo_matches_jax(tree, monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)  # both write detect.jpg and point.jpg here
    monkeypatch.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")  # JAX's host crops
    _on_tree(monkeypatch, jax_moondream, tree, lambda t, c: t, jnp.float32)
    _on_tree(monkeypatch, port_moondream, tree, params_from_jax, torch.float32)
    args = ["--demo", "--config", "tiny", "--max-tokens", "4"]
    want = _run(jax_cli.main, ["moondream_tpu.cli", *args], monkeypatch, capsys)
    got = _run(cli.main, ["moondream_tpu_torch.cli", *args, "--device", "cpu"],
               monkeypatch, capsys)
    assert want[0].startswith("Devices:") and got[0] == "Device: cpu (cpu)"
    assert got[1:] == want[1:]
    assert any(line.startswith("Found ") for line in got)
    assert (tmp_path / "detect.jpg").exists() and (tmp_path / "point.jpg").exists()


def test_benchmark_prints_both_blocks(capsys):
    model = port_moondream.MoondreamModel(port_tiny_config(), dtype=torch.float32, seed=1,
                                          device="cpu")
    res = cli._benchmark(model, cli.demo_image(), "What?", {"max_tokens": 4,
                                                             "temperature": 0.0})
    out = capsys.readouterr().out
    assert "Benchmark Results (10 runs):" in out and "Image Encoding Time (ms):" in out
    assert "Query Speed (tokens/sec; streamed chunks):" in out
    assert all(len(res[k]) == 10 for k in ("encode_ms", "query_s", "chunks", "chunks_per_s"))
    assert all(t > 0 for t in res["encode_ms"])


def test_main_defaults_to_the_card(monkeypatch):
    """Without --device cpu and without a card, main raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["cli", "--demo", "--config", "tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main()
