"""The port's HTTP server (moondream_tpu_torch/serve_http.py) against the
JAX package's (moondream_tpu/serve_http.py), on the CPU at tiny_test_config
in fp32 with the same parameters (`params_from_jax`).

Both servers run over real HTTP on 127.0.0.1 and get the same requests in
the same order; their JSON bodies must be equal, timing fields aside
(`id` / `created` of a chat completion; uptime, rates and latencies in
/metrics). Text comes through IdTokenizer, which renders every id as
`<id>`, so equal text means equal ids. Boxes and points are made decisive
by the peaked oracle (the region decoders' fc2 biases + seeded normals x
50) and compared within 1e-6 (sizes pass through exp2, which the two
libraries may round an ulp apart). The cases follow the unmarked tests of
tests/test_serve_http.py; the port's own add a variants endpoint and the
multi-GPU options' refusals.

Every JAX frontend here has 4 slots and a chunk of 4, and shares its pool's
compiled chunks (`_JITS`) with the others of its prefix mode, so that JAX
compiles each chunk once for the module."""

import base64
import copy
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from moondream_tpu import lora as jax_lora
from moondream_tpu import serve_http as jax_http
from moondream_tpu.config import tiny_test_config
from moondream_tpu.models import region as jax_region
from moondream_tpu.models import text as jax_text
from moondream_tpu.models import vision as jax_vision
from moondream_tpu.models.moondream import MoondreamModel as JaxModel
from moondream_tpu_torch import lora as port_lora
from moondream_tpu_torch import serve_http
from moondream_tpu_torch.config import tiny_test_config as port_tiny_config
from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import params_from_jax

ATOL = 1e-6
SLOTS, CHUNK = 4, 4
# timing fields of the bodies, left out of every comparison
TIMING = ("id", "created", "uptime_s", "tokens_per_sec_lifetime", "p50", "p95", "max")
# JAX frontends' compiled pool chunks, shared per prefix mode
_JITS = {}


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's ops are too small to gain from intra-op threads, and
    under parallel test workers those threads contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) on one fp32 tree with peaked region
    decoders; the JAX model crops on the host (its device path is
    bit-identical)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MOONDREAM_DEVICE_PREPROCESS", "0")
    cfg, port_cfg = tiny_test_config(), port_tiny_config()
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
    yield ref, ours
    mp.undo()


class _Server:
    """One package's server over real HTTP."""

    def __init__(self, module, model, **kw):
        self.server, self.frontend = module.make_server(
            model, "127.0.0.1", 0, n_slots=SLOTS, chunk=CHUNK, **kw)
        if module is jax_http:
            self.frontend.engine._jits = _JITS.setdefault(kw.get("prefix_share", False), {})
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.frontend.shutdown()
        self.thread.join(timeout=30)

    def post(self, path, payload):
        """(status, body) of a POST; an error status gives its JSON body."""
        req = urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return json.loads(r.read())

    def sse(self, path, payload):
        """The `data:` events of a streamed response (the last is [DONE])."""
        req = urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            assert r.headers.get("Content-Type") == "text/event-stream"
            raw = r.read().decode()
        return [line[len("data: "):] for line in raw.split("\n") if line.startswith("data: ")]


class _Pair:
    """The JAX server and the port's, built alike."""

    def __init__(self, models, **kw):
        self.jax = _Server(jax_http, models[0], **kw)
        self.port = _Server(serve_http, models[1], **kw)

    def close(self):
        self.jax.close()
        self.port.close()

    def post(self, path, payload, code=200, compare=True):
        """POST to both; both must answer `code` with equal bodies (with
        `compare`). Returns the port's body, or both."""
        (cj, bj), (cp, bp) = self.jax.post(path, payload), self.port.post(path, payload)
        assert (cp, cj) == (code, code), (path, bp, bj)
        if not compare:
            return bp, bj
        _same(bp, bj)
        return bp

    def get(self, path):
        bj, bp = self.jax.get(path), self.port.get(path)
        _same(bp, bj)
        return bp


def _same(a, b, where="body"):
    """Equal JSON values: floats within ATOL, timing fields skipped."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, a, b)
        for k in a:
            if k not in TIMING:
                _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= ATOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.fixture(scope="module")
def pair(models):
    p = _Pair(models)
    yield p
    p.close()


def _image_b64(seed=0, size=(120, 160)):
    rng = np.random.default_rng(seed)
    im = Image.fromarray(rng.integers(0, 255, size=(size[0], size[1], 3), dtype=np.uint8))
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_healthz(pair):
    body = pair.get("/healthz")
    assert body["ok"] is True and body["slots"] == SLOTS


def test_caption_and_query(pair):
    body = pair.post("/v1/caption", {"image_b64": _image_b64(), "max_tokens": 8})
    assert isinstance(body["caption"], str) and body["caption"]
    body = pair.post("/v1/query", {"image_b64": _image_b64(1), "question": "What?",
                                   "max_tokens": 8})
    assert body["answer"]


def test_concurrent_captions_share_pool(pair):
    """Concurrent requests all complete in each server's pool, and each
    equals the sequential caption of its image on both servers."""
    imgs = [(i, _image_b64(seed=i)) for i in range(3)]
    results = {}

    def run(srv, i, b64):
        results[srv, i] = srv.post("/v1/caption", {"image_b64": b64, "max_tokens": 8})

    threads = [threading.Thread(target=run, args=(srv, i, b64))
               for srv in (pair.jax, pair.port) for i, b64 in imgs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    for i, b64 in imgs:
        want = pair.post("/v1/caption", {"image_b64": b64, "max_tokens": 8})
        assert results[pair.port, i] == results[pair.jax, i] == (200, want)


def test_detect_and_point(pair):
    body = pair.post("/v1/detect", {"image_b64": _image_b64(), "object": "x"})
    assert body["objects"]
    body = pair.post("/v1/point", {"image_b64": _image_b64(), "object": "x"})
    assert "points" in body


def test_error_codes(pair):
    pair.post("/v1/caption", {}, code=400)
    pair.post("/v1/nope", {"image_b64": _image_b64()}, code=404)
    # PIL's message names the buffer's address, so only its start compares
    bodies = pair.post("/v1/caption", {"image_b64": base64.b64encode(b"no image").decode()},
                       code=400, compare=False)
    assert all(b["error"].startswith("could not decode image: ") for b in bodies)


def test_get_unknown_path(pair):
    for srv in (pair.jax, pair.port):
        with pytest.raises(urllib.error.HTTPError) as e:
            srv.get("/nope")
        assert e.value.code == 404


def _occupied_frontend(module, model, image):
    """A frontend whose stepper is stopped and whose every slot is taken,
    so that no slot frees while a request waits."""
    frontend = module.ServingFrontend(model, n_slots=SLOTS, chunk=CHUNK)
    if module is jax_http:
        frontend.engine._jits = _JITS.setdefault(False, {})
    frontend._stop = True
    frontend._wake.set()
    frontend._stepper.join(timeout=30)
    with frontend._lock:
        for _ in range(SLOTS):
            frontend.engine.submit(image, max_tokens=16)
    return frontend


def test_slot_timeout_releases_prepared(models):
    """When no slot frees before the deadline, the prepared request's KV
    buffer goes back to the model's pool and the engine keeps serving."""
    rng = np.random.default_rng(7)
    im = rng.integers(0, 255, size=(120, 160, 3), dtype=np.uint8)
    outs = []
    for module, model, image in ((jax_http, models[0], Image.fromarray(im)),
                                 (serve_http, models[1], im)):
        frontend = _occupied_frontend(module, model, image)
        try:
            pool_before = sum(len(p) for p in model._kv_pool.values())
            with pytest.raises(TimeoutError):
                frontend.text_request(image, None, "normal", 8, timeout_s=0.05)
            assert sum(len(p) for p in model._kv_pool.values()) >= pool_before
            out = frontend.engine.drain()
            assert len(out) == SLOTS
            outs.append(sorted(out.values()))
        finally:
            frontend.shutdown()
    assert outs[0] == outs[1]


def test_metrics_endpoint(pair):
    """/metrics after the same traffic on both servers: the same request,
    error and token counts, latency reservoirs of the same sizes."""
    pair.post("/v1/caption", {"image_b64": _image_b64(9), "max_tokens": 6})
    m = pair.get("/metrics")
    assert m["requests"].get("caption", 0) >= 1
    assert m["generated_tokens"] >= 1
    assert m["latency_ms"]["caption"]["n"] >= 1
    assert m["slots"] == SLOTS and "structured_coalesced" in m


def test_streaming_caption_matches_nonstream(pair):
    """SSE: the same chunks on both servers, which join to the non-streamed
    result; no slot is left taken."""
    b64 = _image_b64(31)
    plain = pair.post("/v1/caption", {"image_b64": b64, "max_tokens": 10})
    payload = {"image_b64": b64, "max_tokens": 10, "stream": True}
    ev_j, ev_p = pair.jax.sse("/v1/caption", payload), pair.port.sse("/v1/caption", payload)
    assert ev_p == ev_j and ev_p[-1] == "[DONE]"
    assert "".join(json.loads(e)["chunk"] for e in ev_p[:-1]) == plain["caption"]

    payload = {"image_b64": b64, "question": "What?", "max_tokens": 8, "stream": True}
    ev_j, ev_p = pair.jax.sse("/v1/query", payload), pair.port.sse("/v1/query", payload)
    assert ev_p == ev_j
    plainq = pair.post("/v1/query", {"image_b64": b64, "question": "What?", "max_tokens": 8})
    assert "".join(json.loads(e)["chunk"] for e in ev_p[:-1]) == plainq["answer"]
    h = pair.get("/healthz")
    assert h["free"] == h["slots"]


def test_encode_cache(models):
    """A repeated image serves from the cached EncodedImage (hits advance,
    the result is the same); the LRU holds 2; both servers alike."""
    p = _Pair(models, encode_cache=2)
    try:
        b64 = _image_b64(50)
        first = p.post("/v1/caption", {"image_b64": b64, "max_tokens": 8})
        assert p.port.frontend.encode_cache_hits == p.jax.frontend.encode_cache_hits == 0
        assert p.post("/v1/caption", {"image_b64": b64, "max_tokens": 8}) == first
        assert p.port.frontend.encode_cache_hits == 1
        p.post("/v1/detect", {"image_b64": b64, "object": "x"})  # shares the cache
        assert p.port.frontend.encode_cache_hits == p.jax.frontend.encode_cache_hits == 2
        p.post("/v1/caption", {"image_b64": _image_b64(51), "max_tokens": 4})
        p.post("/v1/caption", {"image_b64": _image_b64(52), "max_tokens": 4})
        assert len(p.port.frontend._enc_cache) == 2
        m = p.get("/metrics")
        assert m["encode_cache_hits"] == 2 and m["encode_cache_entries"] == 2
    finally:
        p.close()


def test_gaze_endpoint(pair):
    body = pair.post("/v1/gaze", {"image_b64": _image_b64(70), "eye": {"x": 0.4, "y": 0.3}})
    g = body["gaze"]
    assert g is None or (0.0 <= g["x"] <= 1.0 and 0.0 <= g["y"] <= 1.0)
    pair.post("/v1/gaze", {"image_b64": _image_b64(70)}, code=400)  # no eye


def test_warmup(models):
    """warmup() runs the serving path and leaves a clean pool (all slots
    free, encode cache empty), as JAX's does."""
    for module, model in ((jax_http, models[0]), (serve_http, models[1])):
        frontend = module.ServingFrontend(model, n_slots=SLOTS, chunk=CHUNK, encode_cache=2)
        if module is jax_http:
            frontend.engine._jits = _JITS.setdefault(False, {})
        try:
            frontend.warmup()
            assert len(frontend.engine.free_slots()) == SLOTS
            assert len(frontend._enc_cache) == 0
            assert frontend.metrics.snapshot()["requests"] == {"caption": 1}
        finally:
            frontend.shutdown()


def _chat_msg(b64, text="What is this?"):
    return [{"role": "user", "content": [
        {"type": "text", "text": text},
        {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}},
    ]}]


def test_chat_completions(pair):
    """Image + text through the pool (the native query's answer), text
    only through the no-image query, the stream's deltas joining to the
    plain content, remote URLs refused: equal on both servers."""
    b64 = _image_b64(80)
    msg = _chat_msg(b64)
    body = pair.post("/v1/chat/completions", {"messages": msg, "max_tokens": 8})
    assert body["object"] == "chat.completion"
    content = body["choices"][0]["message"]["content"]
    native = pair.post("/v1/query", {"image_b64": b64, "question": "What is this?",
                                     "max_tokens": 8})
    assert content == native["answer"]

    body = pair.post("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Say something."}], "max_tokens": 6})
    assert isinstance(body["choices"][0]["message"]["content"], str)

    payload = {"messages": msg, "max_tokens": 8, "stream": True}
    ev_j = pair.jax.sse("/v1/chat/completions", payload)
    ev_p = pair.port.sse("/v1/chat/completions", payload)
    assert ev_p[-1] == ev_j[-1] == "[DONE]"
    events = [json.loads(e) for e in ev_p[:-1]]
    _same(events, [json.loads(e) for e in ev_j[:-1]])
    assert events[0]["choices"][0]["delta"].get("role") == "assistant"
    assert events[-1]["choices"][0]["finish_reason"] == "stop"
    assert "".join(e["choices"][0]["delta"].get("content", "") for e in events) == content

    pair.post("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "x"},
        {"type": "image_url", "image_url": {"url": "https://example.com/x.png"}},
    ]}]}, code=400)


def test_query_reasoning_and_spatial_refs(pair):
    """/v1/query with reasoning gives the grounded reasoning dict,
    spatial_refs reach the prompt, malformed refs are 400s."""
    b64 = _image_b64(90)
    body = pair.post("/v1/query", {"image_b64": b64, "question": "Why?",
                                   "reasoning": True, "max_tokens": 8})
    assert isinstance(body["reasoning"]["text"], str) and "answer" in body
    pair.post("/v1/query", {"image_b64": b64, "question": "What is here?",
                            "spatial_refs": [[0.5, 0.5], [0.1, 0.1, 0.6, 0.6]],
                            "max_tokens": 8})
    pair.post("/v1/query", {"image_b64": b64, "question": "x", "spatial_refs": [[0.5]]},
              code=400)


def test_chat_multi_turn_keeps_image(pair):
    """A follow-up without an image answers about the image sent earlier;
    stream + reasoning and a malformed data URI are 400s."""
    b64 = _image_b64(80)
    history = _chat_msg(b64) + [
        {"role": "assistant", "content": "something"},
        {"role": "user", "content": "What color is it?"},
    ]
    body = pair.post("/v1/chat/completions", {"messages": history, "max_tokens": 8})
    direct = pair.post("/v1/query", {"image_b64": b64, "question": "What color is it?",
                                     "max_tokens": 8})
    assert body["choices"][0]["message"]["content"] == direct["answer"]
    pair.post("/v1/query", {"image_b64": b64, "question": "x", "reasoning": True,
                            "stream": True}, code=400)
    bodies = pair.post("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "x"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64"}},
    ]}]}, code=400, compare=False)
    assert all(b["error"].startswith("could not decode image: ") for b in bodies)


def test_struct_pool_server(models):
    """--struct-pool: detect and point ride the pool beside a caption,
    concurrently; each answer equals the JAX server's, and every slot
    frees."""
    p = _Pair(models, struct_pool=True)
    try:
        requests = {
            "d0": ("/v1/detect", {"image_b64": _image_b64(40), "object": "cat"}),
            "d1": ("/v1/detect", {"image_b64": _image_b64(41), "object": "dog"}),
            "p0": ("/v1/point", {"image_b64": _image_b64(42), "object": "dog"}),
            "c0": ("/v1/caption", {"image_b64": _image_b64(44), "max_tokens": 8}),
        }
        got = {}

        def run(name):
            got[name] = p.port.post(*requests[name])

        threads = [threading.Thread(target=run, args=(n,)) for n in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        for name, req in requests.items():
            code, want = p.jax.post(*req)
            assert got[name][0] == code == 200
            _same(got[name][1], want, name)
        assert got["d0"][1]["objects"] and "points" in got["p0"][1]
        h = p.get("/healthz")
        assert h["free"] == h["slots"]
    finally:
        p.close()


def test_prefix_share_with_encode_cache(models):
    """--prefix-share: an encode-cache hit hands the pool the same
    EncodedImage, so same-image requests share ONE prefix entry; the
    answers are the plain server's."""
    plain, shared = _Pair(models), _Pair(models, encode_cache=2, prefix_share=True)
    try:
        b64 = _image_b64(60)
        for path, payload in (("/v1/caption", {"image_b64": b64, "max_tokens": 8}),
                              ("/v1/query", {"image_b64": b64, "question": "What?",
                                             "max_tokens": 8})):
            assert shared.post(path, payload) == plain.post(path, payload)
        eng = shared.port.frontend.engine
        assert len(eng._pref_pid_of) == 1
        assert eng.kv.k.shape[3] < eng.kv_pref.k.shape[3]
    finally:
        plain.close()
        shared.close()


def _adapter_file(path, b_scale: float, seed: int) -> str:
    """A seeded rank-4 adapter at the tiny widths, in the legacy names."""
    cfg = tiny_test_config().text
    rng = np.random.default_rng(seed)
    d, ff = cfg.dim, cfg.ff_dim
    shapes = {"mixer.Wqkv": (d, cfg.qkv_dim), "mixer.out_proj": (d, d),
              "mlp.fc1": (d, ff), "mlp.fc2": (ff, d)}
    state = {}
    for i in range(cfg.n_layers):
        for site, (fin, fout) in shapes.items():
            a = rng.standard_normal((4, fin)).astype(np.float32) * 0.1
            b = rng.standard_normal((fout, 4)).astype(np.float32) * b_scale
            state[f"text_model.transformer.h.{i}.{site}.A"] = torch.from_numpy(a)
            state[f"text_model.transformer.h.{i}.{site}.B"] = torch.from_numpy(b)
    torch.save(state, str(path))
    return str(path)


def test_variants_endpoint(models, tmp_path):
    """Multi-tenant LoRA over HTTP, both servers alike: a zero-B adapter
    answers as the base weights, a real one differently, unknown names are
    400s, /healthz lists the variants, and a variant detect without the
    struct pool is refused."""
    files = {"zero": _adapter_file(tmp_path / "zero.pt", 0.0, 0),
             "tuned": _adapter_file(tmp_path / "tuned.pt", 0.5, 1)}
    n_layers = models[0].config.text.n_layers
    jax_variants = {name: jax_lora.variant_state_dict(path, n_layers=n_layers,
                                                      dtype_str="float32")
                    for name, path in files.items()}
    port_variants = {name: port_lora.variant_state_dict(path, n_layers, torch.float32, "cpu")
                     for name, path in files.items()}
    p = _Pair.__new__(_Pair)
    p.jax = _Server(jax_http, models[0], variants=jax_variants)
    p.port = _Server(serve_http, models[1], variants=port_variants)
    try:
        payload = {"image_b64": _image_b64(seed=11), "question": "what?", "max_tokens": 8}
        base = p.post("/v1/query", payload)
        zero = p.post("/v1/query", {**payload, "variant": "zero"})
        tuned = p.post("/v1/query", {**payload, "variant": "tuned"})
        assert zero == base and tuned != base
        err = p.post("/v1/query", {**payload, "variant": "nope"}, code=400)
        assert "unknown variant" in err["error"]
        p.post("/v1/detect", {"image_b64": payload["image_b64"], "object": "x",
                              "variant": "tuned"}, code=400)
        assert p.get("/healthz")["variants"] == ["tuned", "zero"]
    finally:
        p.close()


def test_multi_gpu_options_refused(models):
    """What multi-GPU serving refuses, as the JAX package does: a
    prefix-shared pool under mesh= (ValueError, before the mesh is read),
    and --tp over quantized text weights (each rank's shard cut raises; the
    launcher reports it). Serving over a mesh itself is
    tests/test_torch_parallel_serving.py's."""
    with pytest.raises(ValueError, match="prefix_share is single-chip"):
        serve_http.make_server(models[1], "127.0.0.1", 0, mesh=object(), prefix_share=True)
    with pytest.raises(RuntimeError, match="must be dense"):
        serve_http.main(["--tp", "2", "--device", "cpu", "--config", "tiny", "--int4",
                         "--no-warmup", "--port", "0"])


def test_main_defaults_to_the_card(monkeypatch):
    """Without a card, the entry point raises instead of serving from the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main(["--config", "tiny", "--no-warmup"])
