"""What the ranks of tests/test_torch_parallel.py and
tests/test_torch_parallel_serving.py run (`parallel.comm.launch` pickles
these functions by name, so they live in a module that imports neither jax
nor the JAX package: the ranks never load them).

Every rank rebuilds the same fp32 port model on the CPU from `state`, the
parent's parameters (`weights.params_from_jax` of the JAX package's tree,
as numpy arrays), runs its part and returns plain data."""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from moondream_tpu_torch.models.moondream import MoondreamModel
from moondream_tpu_torch.tokenizer import ByteTokenizer
from moondream_tpu_torch.weights import build_params


class IdTokenizer(ByteTokenizer):
    """Renders every id as `<id>`: equal strings are equal ids."""

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def state_of(params) -> Dict[str, np.ndarray]:
    """A port ModuleDict's tensors as numpy arrays (what the ranks get)."""
    return {k: v.detach().cpu().numpy() for k, v in params.state_dict().items()}


def port_model(cfg, state: Dict[str, np.ndarray]) -> MoondreamModel:
    params = build_params(cfg, "cpu", torch.float32, region="region.coord_features" in state)
    params.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=False)
    return MoondreamModel(cfg, params=params, tokenizer=IdTokenizer(), dtype=torch.float32,
                          device="cpu")


def _tree(arrays: Optional[dict]) -> Optional[dict]:
    if arrays is None:
        return None
    return {g: {s: {f: torch.from_numpy(a) for f, a in pair.items()} for s, pair in sites.items()}
            for g, sites in arrays.items()}


# ------------------------------------------------------------- text engine


def text_engine_rank(rank: int, axes: dict, cfg, state, embeds: np.ndarray, steps: int) -> dict:
    """ShardedTextEngine over `axes`: prefill the batch `embeds`, then
    `steps` greedy tokens; this rank's view of the results and its cache."""
    from moondream_tpu_torch.parallel.inference import ShardedTextEngine, kv_cache_sharding
    from moondream_tpu_torch.parallel.mesh import create_mesh

    model = port_model(cfg, state)
    mesh = create_mesh(axes)
    eng = ShardedTextEngine(model.text, cfg.text, mesh)
    n = embeds.shape[1]
    logits, hidden, kv = eng.prefill(torch.from_numpy(embeds), pos=0, length=n, prefix_len=0)
    res = eng.generate(kv, logits.argmax(-1), n, max_tokens=steps, eos_id=-1, buffer=64)
    return {"logits": logits.numpy(), "hidden_shape": tuple(hidden.shape),
            "tokens": res.tokens.numpy(), "counts": res.counts.numpy(), "pos": res.pos,
            "cache": {f: tuple(getattr(kv, f).shape) for f in ("k", "v", "ks", "vs")
                      if getattr(kv, f) is not None},
            "spec": kv_cache_sharding(mesh, cfg.text).k}


def mesh_rank(rank: int, cfg, state) -> dict:
    """A 2-rank world: the mesh's axes and groups, an oversize mesh, the
    shard cut's shapes and the refusal of quantized text blocks."""
    from moondream_tpu_torch.models.text import quantize_text_params, quantize_text_params_int8
    from moondream_tpu_torch.parallel.mesh import (
        axis_rank, axis_size, create_mesh, shard_text_model)

    out = {}
    try:
        create_mesh({"dp": 2, "tp": 2})
    except ValueError as e:
        out["oversize"] = str(e)
    mesh = create_mesh({"dp": 1, "tp": 2})
    out["axes"] = {a: (axis_size(mesh, a), axis_rank(mesh, a)) for a in ("dp", "tp", "pp")}
    model = port_model(cfg, state)
    local = shard_text_model(model.text, mesh)
    blk = local.blocks[0]
    out["shapes"] = {"qkv": tuple(blk.qkv.w.shape), "proj": tuple(blk.proj.w.shape),
                     "fc1": tuple(blk.mlp.fc1.w.shape), "fc2": tuple(blk.mlp.fc2.w.shape),
                     "lm_head": tuple(local.lm_head.w.shape), "dim": local.config.dim,
                     "heads": (local.config.n_heads, local.config.n_kv_heads)}
    out["qkv_w"] = blk.qkv.w.numpy()
    out["shared_wte"] = local.wte is model.text.wte
    for quant in (quantize_text_params, quantize_text_params_int8):
        q = port_model(cfg, state)
        quant(q.text)
        try:
            shard_text_model(q.text, mesh)
        except ValueError as e:
            out.setdefault("quantized", []).append(str(e))
    return out


def fail_rank(rank: int, how: str) -> None:
    if rank == 1 and how == "raise":
        raise ValueError("rank 1 fails on purpose")
    if rank == 1 and how == "hang":
        time.sleep(600)
    dist.barrier()


class _Engine:
    """A pool stand-in whose `step` raises on the ranks named by `fails`;
    `free_slots`, a read, is not mirrored."""

    def __init__(self, rank: int, fails):
        self.rank, self.fails, self.reads = rank, fails, 0

    def step(self, launch_lock=None):
        if self.rank in self.fails:
            raise RuntimeError(f"rank {self.rank}'s step fails")
        return []

    def free_slots(self):
        self.reads += 1
        return [0]


def outcome_rank(rank: int, fails) -> Optional[dict]:
    """Rank 0 drives one read and one step of `_Engine` through a
    Controller, the other ranks follow. Where only some ranks' step raises,
    rank 0 goes on serving (sleeps) after it; the launch must end at the
    follower's error, long before rank 0 wakes."""
    from moondream_tpu_torch.parallel import comm

    group = comm.control_group()
    eng = _Engine(rank, fails)
    if rank != 0:
        return {"calls": comm.follow(group, {"engine": eng}), "reads": eng.reads}
    ctl = comm.Controller(group, {"engine": eng})
    proxy = ctl.proxy("engine")
    proxy.free_slots()
    try:
        proxy.step(None)
    except RuntimeError:
        pass
    if set(fails) not in (set(), {0, 1}):
        time.sleep(60)
    ctl.close()
    return {"reads": eng.reads}


# ---------------------------------------------------------------- serving


def _images(shapes) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (h, w, 3), np.uint8) for h, w in shapes]


def _run(eng, scenario: dict, images: list) -> list:
    """A pool scenario's requests, in order; every result in request order."""
    ids = []
    for req in scenario["requests"]:
        kind, i = req[0], req[1]
        if kind == "text":
            ids.append(eng.submit(images[i], max_tokens=scenario["max_tokens"], **req[2]))
        else:
            ids.append(eng.submit_detect(images[i], req[2], max_objects=3))
    out = eng.drain()
    return [out[i] for i in ids]


def pool_rank(rank: int, axes: dict, cfg, state, scenarios: List[dict], shapes,
              variants: Optional[dict]) -> dict:
    """Each scenario's sharded pool (`make_sharded_serving_engine` with its
    kwargs; "controlled": rank 0 drives it through comm.Controller and the
    others follow), this rank's results, and the crop-parallel ViT's
    features beside the unsharded encoder's."""
    from moondream_tpu_torch.parallel import comm
    from moondream_tpu_torch.parallel.mesh import create_mesh
    from moondream_tpu_torch.parallel.serving import make_sharded_serving_engine

    model = port_model(cfg, state)
    mesh = create_mesh(axes)
    images = _images(shapes)
    group = comm.control_group()
    out = {"results": [], "kv": []}
    for sc in scenarios:
        kw = dict(sc["engine"])
        if sc.get("variants"):
            kw["variants"] = {"v": _tree(variants)}
        eng = make_sharded_serving_engine(model, mesh, shard_vision=sc.get("shard_vision", False),
                                          **kw)
        out["kv"].append(tuple(eng.kv.k.shape))
        if sc.get("controlled"):
            if rank == 0:
                ctl = comm.Controller(group, {"engine": eng})
                res = _run(ctl.proxy("engine"), sc, images)
                ctl.close()
            else:
                comm.follow(group, {"engine": eng})
                res = [eng.results[i] for i in sorted(eng.results)]
        else:
            res = _run(eng, sc, images)
        out["results"].append(res)
        if sc.get("shard_vision"):
            crops = torch.from_numpy(np.random.default_rng(7).integers(
                0, 255, (5, 378, 378, 3), np.uint8))
            out["vit"] = (eng.model._vision_features(crops).numpy(),
                          model._vision_features(crops).numpy())
    return out


def validation_rank(rank: int, cfg, gqa_cfg, state, gqa_state) -> List[str]:
    """The sharded pool's refusals on a dp 2 world and a tp 2 one."""
    from moondream_tpu_torch.models.text import quantize_text_params
    from moondream_tpu_torch.parallel.mesh import create_mesh
    from moondream_tpu_torch.parallel.serving import make_sharded_serving_engine

    model = port_model(cfg, state)
    errors = []

    def refused(fn):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
        else:
            errors.append("")

    dp_mesh = create_mesh({"dp": 2})
    refused(lambda: make_sharded_serving_engine(model, dp_mesh, n_slots=3))
    refused(lambda: make_sharded_serving_engine(model, dp_mesh, n_slots=4, prefix_share=True))
    tp_mesh = create_mesh({"tp": 2})
    refused(lambda: make_sharded_serving_engine(port_model(gqa_cfg, gqa_state), tp_mesh))
    quantize_text_params(model.text)
    refused(lambda: make_sharded_serving_engine(model, tp_mesh, n_slots=4))
    return errors


def http_rank(rank: int, axes: dict, cfg, state, shape, max_tokens: int):
    """One caption over HTTP from make_server(mesh=...): rank 0 serves, the
    others follow until it shuts down."""
    from PIL import Image

    from moondream_tpu_torch import serve_http
    from moondream_tpu_torch.parallel.mesh import create_mesh

    model = port_model(cfg, state)
    srv, frontend = serve_http.make_server(model, "127.0.0.1", 0, n_slots=4, chunk=4,
                                           mesh=create_mesh(axes))
    if srv is None:
        return "followed"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        buf = io.BytesIO()
        Image.fromarray(_images([shape])[0]).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/caption", method="POST",
            data=json.dumps({"image_b64": base64.b64encode(buf.getvalue()).decode(),
                             "max_tokens": max_tokens}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())["caption"]
    finally:
        srv.shutdown()
        srv.server_close()
        frontend.shutdown()
