"""The port's hf_release (moondream_tpu_torch/hf_release.py) against the JAX
package's: both `main()`s run under the same sys.argv with
`huggingface_hub` stubbed in sys.modules by a recording HfApi, and must
make the same calls in the same order and print the same line. Nothing
touches the network."""

import sys
import types

import pytest

from moondream_tpu import hf_release as jax_release
from moondream_tpu_torch import hf_release as port_release

ARGV = ["hf_release", "--model", "ckpt.safetensors", "--repo", "someone/moondream"]


def _hub(calls: list) -> types.ModuleType:
    """A stand-in huggingface_hub whose HfApi records every call."""
    hub = types.ModuleType("huggingface_hub")

    class HfApi:
        def __init__(self, *args, **kwargs):
            calls.append(("HfApi", args, kwargs))

        def create_repo(self, *args, **kwargs):
            calls.append(("create_repo", args, kwargs))

        def upload_file(self, *args, **kwargs):
            calls.append(("upload_file", args, kwargs))

    hub.HfApi = HfApi
    return hub


def _run(main, argv, monkeypatch, capsys):
    calls = []
    monkeypatch.setitem(sys.modules, "huggingface_hub", _hub(calls))
    monkeypatch.setattr(sys, "argv", argv)
    main()
    return calls, capsys.readouterr().out


@pytest.mark.parametrize("config", [None, "config.json"], ids=["model", "model+config"])
def test_port_makes_the_jax_calls(config, monkeypatch, capsys):
    argv = ARGV + (["--config", config] if config else [])
    want = _run(jax_release.main, argv, monkeypatch, capsys)
    got = _run(port_release.main, argv, monkeypatch, capsys)
    assert got == want
    assert [c[0] for c in got[0]] == (["HfApi", "create_repo", "upload_file"]
                                      + (["upload_file"] if config else []))
    assert got[1] == "pushed ckpt.safetensors to someone/moondream\n"


def test_missing_repo_exits_like_jax(monkeypatch, capsys):
    codes = []
    for main in (jax_release.main, port_release.main):
        calls = []
        monkeypatch.setitem(sys.modules, "huggingface_hub", _hub(calls))
        monkeypatch.setattr(sys, "argv", ARGV[:3])
        with pytest.raises(SystemExit) as err:
            main()
        codes.append((err.value.code, calls))
    assert codes == [(2, []), (2, [])]
