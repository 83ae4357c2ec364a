"""CPU tests of the harness's own arithmetic: the open-loop schedule, the
statistics of the end-to-end metrics, the work counts, and the check that
no JAX module is loaded."""

import ast
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import common, work  # noqa: E402
from gpubench.drivers import batch_pipeline, serve_open_loop  # noqa: E402

CELL = common.load_json("workloads", "md2b-serve-caption")
# the driver's query requests (no cell of the benchmark sends them yet)
QUERY = {**CELL, "request": "query", "rate_per_s": 4.0, "output_tokens": [1, 16],
         "question_tokens": [4, 16]}


def _sched(seed, cell=CELL, seconds=30.0):
    return serve_open_loop.schedule(cell, np.random.default_rng([seed, 1]), seconds)


# ------------------------------------------------------------ the schedule

def test_schedule_repeats_exactly_for_one_seed():
    assert _sched(2 ** 31 + 7) == _sched(2 ** 31 + 7)


def test_schedule_differs_across_seeds():
    a, b = _sched(11), _sched(12)
    assert [q["due"] for q in a] != [q["due"] for q in b]
    assert [q["tokens"] for q in a] != [q["tokens"] for q in b]


@pytest.mark.parametrize("cell", [CELL, QUERY], ids=["caption", "query"])
def test_every_seed_gets_the_same_work_in_another_order(cell):
    """The same gaps, shapes and lengths, so seeds change the order only."""
    runs = [_sched(s, cell) for s in (1, 2, 3)]
    for key in ("tokens", "qlen", "shape"):
        assert all(sorted(q[key] for q in r) == sorted(q[key] for q in runs[0]) for r in runs)
    win = [[q for q in r if q["window"]] for r in runs]
    assert len({len(w) for w in win}) == 1
    assert len(win[0]) == round(cell["rate_per_s"] * 30.0)
    for w in win:
        assert w[0]["due"] == 0.0 and w[-1]["due"] < 30.0
        gaps = sorted(np.diff([q["due"] for q in w]).round(9))
        first = sorted(np.diff([q["due"] for q in win[0]]).round(9))
        assert len(gaps) == len(first)


def test_schedule_shares_and_ranges():
    win = [q for q in _sched(5) if q["window"]]
    n = len(win)
    big = sum(q["shape"] == (756, 1008) for q in win)
    assert abs(big - n / 2) <= 1
    toks = [q["tokens"] for q in win]
    assert min(toks) >= 48 and max(toks) <= 256
    qlen = [q["qlen"] for q in _sched(5, QUERY)]
    assert min(qlen) >= 4 and max(qlen) <= 16


def test_exponential_gaps_sum_to_the_span():
    g = serve_open_loop.exp_gaps(9.0, 270, 30.0)
    assert g.sum() == pytest.approx(30.0)
    assert np.mean(g) == pytest.approx(1 / 9.0, rel=1e-6)
    assert np.median(g) < np.mean(g)  # skewed like an exponential


def test_batch_stream_keeps_the_shares():
    cell = common.load_json("workloads", "md05b-batch-caption")
    s = batch_pipeline.stream(cell, np.random.default_rng(3), 400)
    assert sum(shape == (756, 1008) for shape, _ in s) == 200
    assert s == batch_pipeline.stream(cell, np.random.default_rng(3), 400)


# ---------------------------------------------------------- the statistics

def _req(due, first, last, n, ok=True, tokens=None):
    return {"due": due, "first": first, "last": last, "n_tokens": n, "ok": ok,
            "tokens": n if tokens is None else tokens}


def test_latencies_run_from_the_due_time():
    lat = common.request_latencies([_req(1.0, 1.25, 2.0, 4)])
    assert lat["ttft"] == [pytest.approx(0.25)]
    assert lat["latency"] == [pytest.approx(1.0)]
    assert lat["tpot"] == [pytest.approx(0.25)]


def test_a_failure_counts_as_a_miss():
    reqs = [_req(0.0, 0.1, 0.2, 3) for _ in range(19)] + [
        {"due": 0.0, "ok": False, "first": None, "n_tokens": 0, "tokens": 5}]
    lat = common.request_latencies(reqs)
    assert len(lat["ttft"]) == 20 and math.isinf(max(lat["ttft"]))
    assert math.isinf(common.percentile(lat["ttft"], 100))
    assert len(lat["tpot"]) == 20 and math.isinf(max(lat["tpot"]))


def test_tail_is_over_all_requests():
    """95th percentile of 100 requests, one slow one per 20: not a median of
    per-chunk or per-client figures."""
    ttft = [0.1] * 94 + [1.0] * 6
    reqs = [_req(0.0, t, t + 0.5, 2) for t in ttft]
    lat = common.request_latencies(reqs)
    assert common.percentile(lat["ttft"], 95) == pytest.approx(1.0)
    assert common.percentile(lat["ttft"], 50) == pytest.approx(0.1)


def test_failures_at_the_tail_make_it_infinite():
    reqs = [_req(0.0, 0.1, 0.2, 3) for _ in range(90)] + [
        {"due": 0.0, "ok": False, "first": None, "n_tokens": 0, "tokens": 3}] * 10
    p95 = common.percentile(common.request_latencies(reqs)["latency"], 95)
    assert math.isinf(p95)
    line = common.result_line(True, 100, 10, {"latency_p95_ms": (p95 * 1e3, "ms")},
                              {"platform": "gpu"}, [])
    assert '"value":1000000000000.0' in line


def test_mean_tpot_is_all_decode_time_over_all_tokens():
    """(3 s + 1 s) over (4 + 4) token steps: 0.5 s, not the mean of the
    requests' own 0.75 and 0.25 s; a request of one token adds nothing."""
    reqs = [_req(0.0, 1.0, 4.0, 5), _req(0.0, 1.0, 2.0, 5), _req(0.0, 1.0, 1.0, 1)]
    assert common.mean_tpot(reqs) == pytest.approx(0.5)


def test_mean_tpot_counts_a_failure_as_a_miss():
    reqs = [_req(0.0, 1.0, 4.0, 5), {"due": 0.0, "ok": False, "first": None,
                                      "n_tokens": 0, "tokens": 5}]
    assert math.isinf(common.mean_tpot(reqs))


def test_every_request_gets_an_image_of_its_own():
    reqs = [q for q in _sched(3, seconds=6.0)]
    serve_open_loop.make_images(reqs, np.random.default_rng([3, 2]))
    again = [dict(q) for q in _sched(3, seconds=6.0)]
    serve_open_loop.make_images(again, np.random.default_rng([3, 2]))
    digests = {q["image"].tobytes() for q in reqs}
    assert len(digests) == len(reqs)
    assert all(q["image"].shape[:2] == q["shape"] for q in reqs)
    assert all(np.array_equal(q["image"], p["image"]) for q, p in zip(reqs, again))


def test_images_per_s_is_total_work_over_the_whole_window():
    """Two batches of 8 done in a 10 s window: 1.6 images/s, not a median of
    the batches' own rates; completions outside the window count nothing."""
    done = [(0.5, 8), (9.5, 8), (10.5, 8), (-0.1, 8)]
    assert common.throughput(done, 0.0, 10.0) == pytest.approx(1.6)


def test_spread_uses_statistics_quantiles():
    vals = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = __import__("statistics").quantiles(vals, n=4)
    assert common.spread(vals) == pytest.approx((q3 - q1) / med)


def test_result_line_ends_with_the_checks():
    line = common.result_line(True, 5, 0, {"setup_s": (1.5, "s")},
                              {"platform": "gpu", "kind": "x", "count": 1,
                               "memory_peak_bytes": 1}, [("gap", 0.1, 0.5)])
    assert line.rstrip("}").endswith('"limit":0.5')
    assert list(__import__("json").loads(line))[-1] == "checks"
    assert len(line) < 1500


# -------------------------------------------------------------- work counts

@pytest.mark.parametrize("shape, want_us", [
    # PERF.md's kernel table, "Bound" column: (b, h, tq, tk, d, attended)
    ((13, 16, 768, 768, 72, 13 * work.mask_pairs(768, 768, 0, 729)), 33.96),
    ((1, 32, 730, 768, 64, work.mask_pairs(730, 768, 0, 730)), 4.41),
    ((1, 32, 1, 736, 64, work.mask_pairs(1, 736, 735, 730)), 1.80),
    ((8, 32, 1, 801, 64, 8 * work.mask_pairs(1, 801, 800, 730)), 15.69),
    ((8, 32, 738, 768, 64, 8 * work.mask_pairs(738, 768, 0, 730)), 35.70),
], ids=["vit", "image_prefill", "kernel_b_tq1", "kernel_b_b8", "fused_prefill_b8"])
def test_attention_bounds_match_the_kernel_table(shape, want_us):
    assert work.least_seconds(*work.attn_call(*shape)) * 1e6 == pytest.approx(want_us, abs=0.006)


def test_pool_bound_matches_the_kernel_table():
    pos = [735, 736, 800, 1000, 0, 760, 900, 1022]
    assert work.least_seconds(*work.ragged_call(32, 64, 1, pos, 8)) * 1e6 == pytest.approx(
        14.60, abs=0.006)


def test_crop_bound_matches_the_kernel_table():
    cfg = common.load_json("configs", "moondream-2b")["model"]
    nbytes, ops = work.lanczos_work(cfg, 756, 1008)
    assert nbytes == 7858620
    assert work.least_seconds(nbytes, ops, work.PEAK_INT8_OP_S) * 1e6 == pytest.approx(2.35, abs=0.006)


@pytest.mark.parametrize("config", ["moondream-2b", "moondream-0.5b"])
def test_model_flops_per_unit(config):
    cfg = common.load_json("configs", config)["model"]
    t, v = cfg["text"], cfg["vision"]
    # a decode row: 2 FLOPs per weight of the blocks' linears and the head
    d, ff, layers = t["dim"], t["ff_dim"], t["n_layers"]
    weights = layers * (3 * d * d + d * d + 2 * d * ff) + d * t["vocab_size"]
    assert work.decode_row_flops(cfg, 800) == 2 * weights + 4 * layers * d * 801
    assert work.image_crops(cfg, 756, 1008) == 13
    assert work.image_crops(cfg, 600, 800) == 9
    assert work.image_crops(cfg, 378, 378) == 2
    crop = work.vit_crop_flops(cfg)
    e = v["enc_dim"]
    assert crop > 2 * 729 * v["enc_n_layers"] * (4 * e * e + 2 * e * v["enc_ff_dim"])
    caption = work.caption_flops(cfg, 756, 1008, 5, 64)
    assert caption == work.prepare_flops(cfg, 756, 1008, 5) + sum(
        work.decode_row_flops(cfg, 735 + j) for j in range(63))
    if config == "moondream-2b":
        # over the cells' mix of 13, 9 and 2 crops, 7-9 TFLOP per image
        mix = (0.5 * caption + 0.25 * work.caption_flops(cfg, 600, 800, 5, 64)
               + 0.25 * work.caption_flops(cfg, 378, 378, 5, 64))
        assert 7e12 < mix < 9e12


# ----------------------------------------------------- loaded module check

def test_forbidden_modules_compare_whole_top_level_names():
    names = ["moondream_tpu_torch", "moondream_tpu_torch.models.text", "jaxtyping",
             "moondream_tpu_extra", "torch"]
    assert common.forbidden_loaded(names) == []
    assert common.forbidden_loaded(names + ["moondream_tpu.ops"]) == ["moondream_tpu.ops"]
    assert common.forbidden_loaded(["jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client"]


def test_a_run_of_the_harness_loads_no_jax():
    """Importing the harness, its drivers, readers and the program's modules
    the cells drive leaves no JAX module behind."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gpubench import common, harness, readers\n"
            "from gpubench.reference import plain\n"
            "common.load_module('drivers', 'serve_open_loop')\n"
            "common.load_module('drivers', 'batch_pipeline')\n"
            "import moondream_tpu_torch.serve_http, moondream_tpu_torch.engine.pipeline\n"
            "print(common.forbidden_loaded())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("moondream_tpu_torch", "moondream_tpu", "jax",
                                               "jaxlib", "gpubench"), (path.name, n)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gpubench.reference.plain\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('moondream')))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """No card (or too few): a non-zero exit and no result line."""
    out = subprocess.run([sys.executable, str(ROOT / "gpubench" / "run.py"), "--workload",
                          "md2b-serve-caption", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "correct" not in out.stdout
