"""The port runs where neither jax nor the JAX package can be imported: in a
fresh interpreter with `sys.modules["jax"]` and `sys.modules["moondream_tpu"]`
set to None, import every module of moondream_tpu_torch and run a tiny
greedy caption on the CPU, dense and with int4 text blocks and an int8 KV
cache, encode an image on the device crop route (the plain Lanczos passes)
and on the host route with equal snapshots, serve two requests on one image through a prefix-shared pool, caption
two images in one lockstep batch, caption with a GQA text config, run
the region-head paths: detect, point, both gaze modes, query with reasoning
and spatial refs, detect_batch and point_batch, the speculative paths:
a speculative caption, a drafting call, and a speculative pool serving a
caption beside a detect, the multi-image paths: BatchPipeline plain and
speculative, PooledPipeline and the pool's submit_many, a greedy
caption with int8 text blocks and a statically calibrated int8 ViT,
finetuning: one text training step and one region training step, and
steering and adapter training: hidden states collected for two prompts, a
control vector trained from them steering a caption, and one LoRA
adapter training step, and the front ends (the HTTP server, the CLI, the
HF wrapper and the native BPE tokenizer are imported with the rest):
one caption served over HTTP, and the eval harness and the recipes: an
eval loop on a stand-in `datasets`, caption agreement against an int8
ViT twin, and the recipes' batched detect_frames, and the multi-GPU
modules: a world of one gloo rank running the sharded text engine and the
sharded pool with the crop-parallel ViT, and multi-GPU training on that
world (hf_release is imported with the rest): one GPipe step at M 2, one
dp x tp step on a rank's shard and one sequence-parallel step."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["moondream_tpu"] = None  # and so does the JAX package
import importlib, pkgutil
import numpy as np
import torch
torch.set_num_threads(1)  # one core, as the port's other test modules: the suite runs workers side by side
import moondream_tpu_torch
for m in pkgutil.walk_packages(moondream_tpu_torch.__path__, "moondream_tpu_torch."):
    importlib.import_module(m.name)
from moondream_tpu_torch.config import tiny_test_config
from moondream_tpu_torch.models.moondream import MoondreamModel
model = MoondreamModel(tiny_test_config(), dtype=torch.float32, seed=1, device="cpu")
img = np.random.default_rng(0).integers(0, 255, (300, 500, 3), dtype=np.uint8)
out = model.caption(img, settings={"temperature": 0, "max_tokens": 4})
assert isinstance(out["caption"], str)
import os
from moondream_tpu_torch.ops import device_preprocess as devpre
os.environ.pop("MOONDREAM_DEVICE_PREPROCESS", None)
devpre.reset_route_counts()
on_device = model.encode_image(img)
os.environ["MOONDREAM_DEVICE_PREPROCESS"] = "0"
on_host = model.encode_image(img)
del os.environ["MOONDREAM_DEVICE_PREPROCESS"]
assert devpre.ROUTES == {"device": 1, "host": 1}
assert torch.equal(on_device.k, on_host.k) and torch.equal(on_device.v, on_host.v)
from moondream_tpu_torch.models.serve import ContinuousBatchingEngine
eng = ContinuousBatchingEngine(model, n_slots=2, slot_len=1024, chunk=4, prefix_share=True)
enc = model.encode_image(img)
rids = [eng.submit(enc, max_tokens=4), eng.submit(enc, question="what?", max_tokens=4)]
served = eng.drain()
assert sorted(served) == rids and eng._pref_refs == [0, 0] and len(eng._pref_pid_of) == 1
import dataclasses
from moondream_tpu_torch.models.text import quantize_text_params
from moondream_tpu_torch.weights import init_params
cfg = tiny_test_config()
cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, kv_int8=True))
params = init_params(cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
quantize_text_params(params["text"])
qmodel = MoondreamModel(cfg, params=params, dtype=torch.float32, device="cpu")
enc = qmodel.encode_image(img)
assert enc.k.dtype == torch.int8 and enc.ks is not None
qout = qmodel.caption(enc, settings={"temperature": 0, "max_tokens": 4})
assert isinstance(qout["caption"], str)
batch = model.caption_batch([img, img[:200]], settings={"temperature": 0, "max_tokens": 4})
assert len(batch) == 2 and all(isinstance(t, str) for t in batch)
gcfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, n_kv_heads=1))
gmodel = MoondreamModel(gcfg, dtype=torch.float32, seed=1, device="cpu")
assert gmodel.encode_image(img).k.shape[2] == 1
assert isinstance(gmodel.caption(img, settings={"temperature": 0, "max_tokens": 4})["caption"], str)
greedy = {"temperature": 0, "max_tokens": 4}
assert len(model.detect(img, "cat", settings={"max_objects": 3})["objects"]) <= 3
assert len(model.point(img, "cat", settings={"max_objects": 3})["points"]) <= 3
assert "gaze" in model.detect_gaze(img, eye=(0.5, 0.5))
face = {"x_min": 0.3, "x_max": 0.6, "y_min": 0.2, "y_max": 0.5}
assert "gaze" in model.detect_gaze(img, face=face, unstable_settings={"prioritize_accuracy": True})
assert "reasoning" in model.query(img, "why?", reasoning=True, settings=greedy)
assert isinstance(model.query(img, "why?", spatial_refs=[(0.2, 0.3)], settings=greedy)["answer"], str)
assert len(model.detect_batch([img, img[:200]], "cat", settings={"max_objects": 2})) == 2
assert len(model.point_batch([img, img[:200]], "cat", settings={"max_objects": 2})) == 2
spec = model.caption(img, settings={**greedy, "speculative": 4})["caption"]
assert spec == model.caption(img, settings=greedy)["caption"]
from moondream_tpu_torch.engine.drafting import ngram_draft_rows
draft, hit = ngram_draft_rows(torch.tensor([[5, 6, 7, 5, 6]]), torch.tensor([5]),
                              torch.tensor([6]), 3)
assert draft.tolist() == [[7, 5]] and bool(hit)
seng = ContinuousBatchingEngine(model, n_slots=2, slot_len=1024, chunk=2, speculative=3,
                                max_objects=2)
rids = [seng.submit(img, max_tokens=4), seng.submit_detect(img, "cat")]
served = seng.drain()
assert isinstance(served[rids[0]], str) and len(served[rids[1]]["objects"]) <= 2
from moondream_tpu_torch.engine.pipeline import BatchPipeline, PooledPipeline
for spec in (0, 3):
    texts = BatchPipeline(model, batch_size=2, speculative=spec).caption(
        [img, img[:200], img], settings=greedy)
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
assert len(PooledPipeline(model, n_slots=2, chunk=4).caption([img, img[:200]], settings=greedy)) == 2
beng = ContinuousBatchingEngine(model, n_slots=2, chunk=4)
rids = beng.submit_many([img, img[:200]], max_tokens=4)
assert sorted(beng.drain()) == rids
from moondream_tpu_torch.models.text import quantize_text_params_int8
from moondream_tpu_torch.models.vision import collect_vision_act_stats, quantize_vision_params
p8 = init_params(tiny_test_config(), torch.Generator().manual_seed(1), "cpu", torch.float32)
quantize_text_params_int8(p8["text"])
calib = torch.rand(2, 378, 378, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
quantize_vision_params(p8["vision"], collect_vision_act_stats(calib, p8["vision"]))
m8 = MoondreamModel(tiny_test_config(), params=p8, dtype=torch.float32, device="cpu")
assert m8.vision.blocks[0].qkv.inv_a is not None and m8.text.blocks[0].qkv.inv_a is None
c8 = m8.caption(img, settings=greedy)["caption"]
assert isinstance(c8, str) and c8 == m8.caption(img, settings=greedy)["caption"]
from moondream_tpu_torch.finetune import finetune_region, finetune_text, trainer
ftm = MoondreamModel(tiny_test_config(), dtype=torch.float32, seed=2, device="cpu")
opt = trainer.cli_optimizer(1e-3, 1, 1)
state = trainer.init_train_state(ftm.text, opt)
example = finetune_text.build_example(ftm, img, finetune_text.QUESTION, "a cat")
w0 = ftm.text.blocks[0].qkv.w.clone()
state, loss = trainer.make_train_step(opt)(state, example)
assert torch.isfinite(loss) and state.opt_state.count == 1
assert not torch.equal(ftm.text.blocks[0].qkv.w, w0)  # updated in place
ropt = trainer.cli_optimizer(1e-3, 1, 1)
rstate = trainer.init_train_state(ftm.region, ropt)
emb = ftm._run_vision_encoder(img)
rex = finetune_region.build_class_example(ftm, emb, "cat", [[0.5, 0.5, 0.2, 0.3]])
rstate, rloss = finetune_region.make_train_step(ropt, ftm.text)(rstate, rex)
assert torch.isfinite(rloss) and rstate.opt_state.count == 1
from moondream_tpu_torch import repeng
reps = repeng.HiddenStateCollector(model)
kw = dict(samples_per_image=1, max_tokens=3, temperature=0.0)
cv = repeng.train_control_vectors(reps.collect([img], "yes", **kw), reps.collect([img], "no", **kw))
assert isinstance(model.caption(img, settings={**greedy, "steer": cv})["caption"], str)
from moondream_tpu_torch.finetune import lora as ft_lora
adapter = ft_lora.init_lora_params(ftm.config.text, 2, torch.Generator().manual_seed(0),
                                   device="cpu")
lopt = trainer.cli_optimizer(1e-3, 1, 1)
lstate, lloss = ft_lora.make_lora_train_step(lopt, ftm.config.text)(
    trainer.init_train_state(adapter, lopt), ftm.text, example)
assert torch.isfinite(lloss) and bool(adapter["mlp"]["fc2"]["B"].any())
import base64, io, json, threading, urllib.request
from PIL import Image
from moondream_tpu_torch.serve_http import make_server
srv, frontend = make_server(model, "127.0.0.1", 0, n_slots=2, chunk=4)
threading.Thread(target=srv.serve_forever, daemon=True).start()
buf = io.BytesIO()
Image.fromarray(img).save(buf, format="PNG")
req = urllib.request.Request(
    f"http://127.0.0.1:{srv.server_address[1]}/v1/caption", method="POST",
    data=json.dumps({"image_b64": base64.b64encode(buf.getvalue()).decode(),
                     "max_tokens": 4}).encode(), headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req, timeout=120) as r:
    assert isinstance(json.loads(r.read())["caption"], str)
srv.shutdown()
srv.server_close()
frontend.shutdown()
import types
from moondream_tpu_torch.eval import countbenchqa, quant_drift
from moondream_tpu_torch import recipes
stand_in = types.ModuleType("datasets")
stand_in.load_dataset = lambda path, split=None: [{"image": Image.fromarray(img),
                                                   "question": "how many?", "number": 2}]
sys.modules["datasets"] = stand_in
model._settings = lambda settings: (4, 0.0, 0.0)
assert countbenchqa.eval_countbenchqa(model)["total_count"] == 1
del model._settings
twin = quant_drift.quantized_twin(model, vit8=True)
assert quant_drift.caption_agreement(model, twin, images=[img], max_tokens=3)["n_images"] == 1
recipes.recipe("gaze_detection_video")
from recipes.common.pipeline import detect_frames
from moondream_tpu_torch.models import moondream as port_moondream
port_moondream.DEFAULT_MAX_OBJECTS = 2
assert len(detect_frames(model, [img, img[:200]], "cat")) == 2
from moondream_tpu_torch import parallel
assert all(getattr(parallel, name) is not None for name in parallel.__all__)
from moondream_tpu_torch.parallel.mesh import create_mesh
mesh = create_mesh({"dp": 1, "tp": 1}, device="cpu")  # a world of one gloo rank
seng = parallel.ShardedTextEngine(model.text, model.config.text, mesh)
lg, _, skv = seng.prefill(torch.zeros(1, 8, model.config.text.dim), pos=0, length=8,
                          prefix_len=0)
assert seng.generate(skv, lg.argmax(-1), 8, max_tokens=3, eos_id=-1, buffer=3).tokens.shape == (1, 3)
peng = parallel.make_sharded_serving_engine(model, mesh, shard_vision=True, n_slots=2, chunk=4)
rid = peng.submit(img, max_tokens=4)
assert isinstance(peng.drain()[rid], str)
from moondream_tpu_torch.parallel.pipeline import make_pp_train_step
g = torch.Generator().manual_seed(4)
tb = {"inputs_embeds": torch.randn(2, 8, cfg.text.dim, generator=g) * 0.1,
      "labels": torch.randint(0, cfg.text.vocab_size, (2, 8), generator=g),
      "label_mask": (torch.rand(2, 8, generator=g) > 0.3).float()}
import copy
base_text = MoondreamModel(tiny_test_config(), dtype=torch.float32, seed=3, device="cpu").text
def fresh_text():
    return copy.deepcopy(base_text)
def one_step(step, params, batch):
    opt = trainer.make_optimizer(lr=1e-3)
    state, loss = step(opt)(trainer.init_train_state(params, opt), batch)
    assert torch.isfinite(loss) and state.step == 1 and state.opt_state.count == 1
    return float(loss)
pmesh = create_mesh({"pp": 1, "dp": 1}, device="cpu")
losses = [one_step(lambda o: make_pp_train_step(o, tiny_test_config().text, pmesh, 2),
                   parallel.shard_params_pp(fresh_text(), pmesh), tb),
          one_step(trainer.make_train_step, parallel.shard_text_model(fresh_text(), mesh),
                   parallel.shard_batch(tb, mesh)),
          one_step(trainer.make_train_step, fresh_text(),
                   parallel.shard_batch(tb, create_mesh({"dp": 1, "sp": 1}, device="cpu"),
                                        seq_axis="sp"))]
assert max(losses) - min(losses) <= 1e-5 * max(losses), losses
torch.distributed.destroy_process_group()
assert sys.modules["jax"] is None and sys.modules["moondream_tpu"] is None
loaded = [n for n, m in sys.modules.items()
          if m is not None and n.startswith(("jax", "moondream_tpu"))
          and not n.startswith("moondream_tpu_torch")]
assert not loaded, loaded
print("OK", out["caption"])
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
