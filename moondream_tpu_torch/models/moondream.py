"""MoondreamModel: caption, query (with reasoning and spatial refs),
detect, point, detect_gaze, the lockstep batched paths and what the
serving pool needs of the model (a subset of
moondream_tpu/models/moondream.py).

encode_image: overlap crops -> ViT over a bucketed crop batch -> stitch +
projection -> [BOS, image] prefill -> KV snapshot. The crops are made on
the card from the raw image by default (`ops.device_preprocess`, the
Lanczos kernel of csrc/lanczos_resize.cu; equal to the host crops byte for
byte), and on the host under MOONDREAM_DEVICE_PREPROCESS=0 or past
`exact_path_supported`; the encode launches nothing that syncs the host.
caption and query: the template prompt prefill over the restored snapshot
(query also without an image), then greedy or top-p decode, plain or
streamed; query with reasoning first runs the reasoning loop with inline
grounding, and spatial refs replace the prompt's coordinate and size token
embeddings.
detect / point: the prompt prefill, then the structured coordinate loop
through the region heads. detect_gaze: an embedding-space prompt around an
eye position, then one point (eye mode), or 20 sampled eye positions over
the image and its mirror in one lockstep batch (accuracy mode).
encode_images: one ViT call per (crop count, tiling) group of images, one
stitch + projection per group and one batched [BOS, image] prefill;
caption_batch / query_batch / detect_batch / point_batch: one shared
prompt over many images, decoded in lockstep.
`models.serve.ContinuousBatchingEngine` prefills its requests through
load_encoded_image (on recycled buffers) and _prefill_prompt.
On the card the decode loops (caption and query, plain, speculative and
with reasoning; detect, point, detect_gaze; the lockstep batches) replay
CUDA graphs of their runs (engine/graphs.py); `compile()` builds the
kernels and captures them ahead of the first request. A stream replays a
graph of one decode step per token, or of one verify span per span under
settings["speculative"], on MHA and GQA models and at every k alike.
LoRA variants: settings["variant"] (a local adapter file,
`lora.variant_state_dict`) or settings["variant_tree"] (an adapter
already loaded) puts the adapter in every text forward of a request, the
[BOS, image] prefill included; settings["variant_label"] names it. An
EncodedImage records the label it was encoded under, and a request under
another label refuses it (moondream_tpu/models/moondream.py:79-90,
:755-784, :840-855). detect_gaze runs no adapter, as the JAX package's
runs none, and refuses these settings.
Steering: settings["steer"] (a `repeng.ControlVector`, or an (n_layers,
dim) array) times settings["steer_scale"] adds its row l to block l's
output in caption and query, in the answer's prompt prefill and every
step of its decode loop (fused, speculative, streamed and graphed), as the
JAX package steers them (moondream_tpu/models/moondream.py:907-918,
:1231, :1308). Every other entry point, which the JAX package lets drop
the vector without a word, refuses it.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Literal, Optional, Tuple

import numpy as np
import torch

from ..config import MoondreamConfig, TextConfig, TextShardConfig
from ..engine import batched as batched_engine
from ..engine import generate as engine
from ..engine.sampling import sample_token
from ..ops import device_preprocess as devpre
from ..ops.image_crops import overlap_crop_image, reconstruct_from_crops
from ..tokenizer import TokenizerBase, load_tokenizer
from ..utils.points import remove_outlier_points
from ..utils.streaming import TokenStreamer, stream_text
from ..weights import checked_device, init_params
from . import region as region_ops
from .text import KVCache, text_encoder
from .vision import normalize_crops, vision_encoder, vision_projection

DEFAULT_MAX_TOKENS = 768
DEFAULT_TEMPERATURE = 0.5
DEFAULT_TOP_P = 0.3
DEFAULT_MAX_OBJECTS = 50

# Crop-count buckets for the ViT batch (1 global + up to 12 local crops).
CROP_BUCKETS = (2, 5, 9, 13)
# Prompt prefills pad to multiples of this.
PROMPT_PAD = 8
# Speculative decoding seeds its draft history with the prompt's last
# tokens, left-padded with -1 to this width (moondream_tpu/models/
# moondream.py:276).
SPEC_SEED_LEN = 64
# The JAX package's LoRA-variant settings (moondream_tpu/models/
# moondream.py:79-90, :840-855), applied by every entry point but
# detect_gaze and PooledPipeline's. The serving pool takes `variant=`
# names of its own adapters instead (models/serve.py).
VARIANT_SETTINGS = ("variant", "variant_tree", "variant_label")
# Its steering settings (:907-918), applied by caption and query only (and
# compile, which warms them); the JAX package's other entry points drop them.
STEER_SETTINGS = ("steer", "steer_scale")


def _refuse_dropped(settings: Optional[Dict[str, Any]], entry: str,
                    variants: bool = False) -> None:
    """Raise NotImplementedError when `settings` sets a steering vector, or
    with `variants` a LoRA variant (detect_gaze and PooledPipeline, whose
    JAX counterparts run no adapter), in an entry point whose JAX
    counterpart drops it without a word: answering as the base model would
    hide that the setting did nothing. A deliberate deviation from the JAX
    package, which ignores them there."""
    for key in STEER_SETTINGS + (VARIANT_SETTINGS if variants else ()):
        if (settings or {}).get(key) is not None:
            what, where = (("steering", "the JAX package steers caption and query only")
                           if key in STEER_SETTINGS else
                           ("a LoRA variant", "the JAX package runs no adapter there"))
            raise NotImplementedError(
                f"settings[{key!r}]: {entry} does not apply {what} ({where}, and its "
                f"{entry} drops the setting without a word); leave it out here"
            )


def _unsteered(settings: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """`settings` without the steering keys: what caption and query hand to
    the entry points that steer nothing (encode_image; compile's detect,
    point and gaze warm-ups)."""
    if not settings or not any(settings.get(k) is not None for k in STEER_SETTINGS):
        return settings
    return {k: v for k, v in settings.items() if k not in STEER_SETTINGS}


def _variant_label(settings: Optional[Dict[str, Any]]) -> Optional[str]:
    """The variant a request asks for, by name: settings["variant_label"],
    else settings["variant"] when it is a string, else None (the base
    weights) (moondream_tpu/models/moondream.py:79-90)."""
    if not settings:
        return None
    label = settings.get("variant_label")
    if label is not None:
        return label
    v = settings.get("variant")
    return v if isinstance(v, str) else None


@dataclass(frozen=True)
class EncodedImage:
    """KV snapshot after prefilling [BOS, image]: k/v (L, 1, H_kv, pos, Dh).
    With config.text.kv_int8, k/v hold int8 codes and ks/vs the fp32
    scales (L, 1, H_kv/g, pos) (models.text.KVCache). `variant`: the label
    of the LoRA variant the prefill ran under (None: the base weights); a
    request under another label refuses the snapshot."""

    pos: int
    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None
    variant: Optional[str] = None

    def as_cache(self) -> KVCache:
        return KVCache(k=self.k, v=self.v, ks=self.ks, vs=self.vs)


def _snap_enc(kv: KVCache, pos: int, b: Optional[int] = None,
              variant: Optional[str] = None) -> EncodedImage:
    """The snapshot [0, pos) of batch row b of a cache (of its only row when
    b is None), labelled with `variant`."""
    rows = slice(None) if b is None else slice(b, b + 1)
    cut = lambda a: None if a is None else a[:, rows, :, :pos].clone()
    return EncodedImage(pos=pos, k=cut(kv.k), v=cut(kv.v), ks=cut(kv.ks), vs=cut(kv.vs),
                        variant=variant)


def _concat_enc_kv(encs: List[EncodedImage]) -> KVCache:
    """Per-image snapshots stacked on the batch axis
    (moondream_tpu/models/moondream.py:106-114)."""
    cat = lambda xs: None if xs[0] is None else torch.cat(xs, dim=1)
    return KVCache(
        k=cat([e.k for e in encs]), v=cat([e.v for e in encs]),
        ks=cat([e.ks for e in encs]), vs=cat([e.vs for e in encs]),
    )


def _box(b) -> Dict[str, float]:
    return {"x_min": float(b[0]), "y_min": float(b[1]),
            "x_max": float(b[2]), "y_max": float(b[3])}


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _prompt_pad(length: int) -> int:
    """The rows a prompt prefill of `length` tokens writes: the length
    rounded up to PROMPT_PAD, at least PROMPT_PAD."""
    return max(_ceil_to(length, PROMPT_PAD), PROMPT_PAD)


def _rgb_array(image) -> np.ndarray:
    """A PIL image (converted to RGB) or a uint8 (H, W, 3) array, as a uint8
    (H, W, 3) array."""
    arr = image if isinstance(image, np.ndarray) else np.asarray(image.convert("RGB"))
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("image must be uint8 (H, W, 3)")
    return arr


def _n_crops(item: np.ndarray, tiling) -> int:
    """Crops of a `_prep_crop_groups` item: a host stack's rows, or a raw
    image's tiles plus its global crop."""
    return item.shape[0] if item.ndim == 4 else tiling[0] * tiling[1] + 1


def _bucket(n: int, buckets=CROP_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class MoondreamModel:
    def __init__(
        self,
        config: MoondreamConfig,
        params: Optional[torch.nn.ModuleDict] = None,
        tokenizer: Optional[TokenizerBase] = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device="cuda",
        graphed: bool = True,
    ):
        """`params`: from `weights.params_from_jax`, `weights.load_params`
        or `weights.init_params`; None draws random weights on `device`
        from `seed`. Runtime weight formats, applied to the parameters
        before they come here: int4 text blocks (`load_params(...,
        runtime_int4=True)`, or `models.text.quantize_text_params` on dense
        ones); int8 w8a8 text blocks (`load_params(..., runtime_int8=True)`
        or `models.text.quantize_text_params_int8`); int8 ViT blocks,
        dynamic or statically calibrated
        (`models.vision.quantize_vision_params`, with the statistics of
        `collect_vision_act_stats` on normalized crops for static). Every
        path, the CUDA graphs and the serving pool included, takes these
        blocks as they are: the int8 linears launch one fused kernel each,
        which allocates only its output and never syncs. An int8 KV cache
        comes from config.text.kv_int8. `device` is the card
        unless the caller asks for the CPU (device="cpu", the plain
        versions); without a card the default raises. On a CUDA device the
        kernels take bf16 activations only. `graphed`: on the card the
        decode loops (answer, speculative, reasoning, structured, the
        lockstep batches, the accuracy-mode gaze step and the streams)
        replay CUDA graphs of their runs (engine/graphs.py); False runs the
        same steps eagerly, for comparison."""
        self.config = config
        self.dtype = dtype
        self.device = checked_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.graphed = graphed
        if params is None:
            params = init_params(config, self.generator, self.device, dtype)
        self.params = params
        self.tokenizer = tokenizer if tokenizer is not None else load_tokenizer()
        # Recycled KV buffers, by (batch, slot count) (the JAX package's
        # pool, moondream_tpu/models/moondream.py:151-159): the serving pool
        # returns each prefilled request's buffer once its slot write is
        # done, so the next load_encoded_image costs only the snapshot
        # copy. Stale slots past a snapshot are overwritten before they are
        # attended. Servers and pipelines recycle from other threads (hence
        # the lock) and streams: each buffer keeps an event recorded on the
        # stream that returned it, which the stream taking it waits on.
        self._kv_pool: Dict[Tuple[int, int], List[Tuple[KVCache, Any]]] = {}
        self._kv_pool_lock = threading.Lock()

    @property
    def vision(self):
        return self.params["vision"]

    @property
    def text(self):
        return self.params["text"]

    @property
    def cache_config(self) -> TextConfig:
        """The config the model's KV caches are made from: its text config,
        or a tensor-parallel rank's own (`config.TextShardConfig`: the
        rank's heads, one int8 scale per head and token)."""
        tc = self.text.config
        return tc if isinstance(tc, TextShardConfig) else self.config.text

    @property
    def region(self):
        if "region" not in self.params:
            raise ValueError("these parameters have no region heads")
        return self.params["region"]

    def _encode_text(self, text: str) -> List[int]:
        return self.tokenizer.encode(text)

    def _decode_tokens(self, ids) -> str:
        return self.tokenizer.decode([int(i) for i in ids])

    # ------------------------------------------------------------- bounds
    def _kv_bound(self, end_pos: int) -> Optional[int]:
        """KV-read bound for a prefill ending at end_pos: rounded up to 256;
        None (the whole cache) past 3/4 of the context."""
        max_ctx = self.config.text.max_context
        bound = _ceil_to(max(end_pos, 1), 256)
        return bound if bound <= (3 * max_ctx) // 4 else None

    def _decode_bound(self, end_pos: int) -> Optional[int]:
        """KV-read bound for a decode session ending by end_pos: rounded up
        to 256; None when within 256 of the context end."""
        max_ctx = self.config.text.max_context
        bound = _ceil_to(min(end_pos, max_ctx), 256)
        return None if bound >= max_ctx else bound

    # ------------------------------------------------------------- vision
    def _crops(self, image) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Host overlap crops (n, 378, 378, 3) uint8 and the tiling of a PIL
        image or a uint8 (H, W, 3) array."""
        cfg = self.config.vision
        out = overlap_crop_image(
            _rgb_array(image), overlap_margin=cfg.overlap_margin, max_crops=cfg.max_crops
        )
        return out["crops"], tuple(out["tiling"])

    def _prep_crop_groups(self, images) -> List[Tuple[np.ndarray, Tuple[int, int]]]:
        """Per image: (its raw uint8 (H, W, 3) array, its tiling) where it
        crops on the card (`device_preprocess.device_route`: the default),
        else (its host crop stack (n, 378, 378, 3), its tiling)
        (moondream_tpu/models/moondream.py:610-638)."""
        cfg = self.config.vision
        out = []
        for im in images:
            arr = _rgb_array(im)
            if devpre.device_route(*arr.shape[:2], cfg.crop_size):
                out.append((arr, devpre.preprocess_tiling(
                    *arr.shape[:2], cfg.crop_size, cfg.enc_patch_size, cfg.overlap_margin,
                    cfg.max_crops)))
            else:
                out.append(self._crops(arr))
        return out

    def _stage(self, arrays: List[np.ndarray]) -> torch.Tensor:
        """uint8 arrays of one shape, stacked, on the model's device: on a
        card copied into pinned memory and sent with a non_blocking copy on
        the current stream (no host sync)."""
        pin = self.device.type == "cuda"
        host = torch.empty((len(arrays), *arrays[0].shape), dtype=torch.uint8, pin_memory=pin)
        view = host.numpy()
        for i, a in enumerate(arrays):
            view[i] = a
        return host.to(self.device, non_blocking=True) if pin else host

    def _build_crop_segments(self, items: List[np.ndarray]) -> List[Tuple[str, torch.Tensor]]:
        """Producer half of a tiling group's crops (moondream_tpu/models/
        moondream.py:640-675): consecutive raw images of one shape make one
        segment ("raw", (count, H, W, 3)), cropped later by one batched
        kernel call; a host crop stack makes a segment ("crops", (n, 378,
        378, 3)). Each is copied to the device here, on the current stream;
        no kernel is launched."""
        segs: List[Tuple[str, torch.Tensor]] = []
        run: List[np.ndarray] = []
        for it in items + [None]:
            if run and (it is None or it.ndim == 4 or it.shape != run[0].shape):
                segs.append(("raw", self._stage(run)))
                run = []
            if it is not None and it.ndim == 3:
                run.append(it)
            elif it is not None:
                segs.append(("crops", self._stage([it])[0]))
        return segs

    def _materialize_crop_segments(self, segs, tiling, pad_to: int = 0) -> torch.Tensor:
        """Consumer half (moondream_tpu/models/moondream.py:677-691): the
        group's image-major crop stack on the device, at least `pad_to` rows
        (the rest zero): the crop kernel writes each raw segment's crops in
        place, and each host stack is copied in. Launches on the current
        stream, right before the ViT."""
        cfg = self.config.vision
        per_image = tiling[0] * tiling[1] + 1
        rows = [t.shape[0] * (per_image if kind == "raw" else 1) for kind, t in segs]
        total = sum(rows)
        out = torch.empty((max(total, pad_to), cfg.crop_size, cfg.crop_size, 3),
                          dtype=torch.uint8, device=self.device)
        out[total:].zero_()
        off = 0
        for (kind, t), n in zip(segs, rows):
            if kind == "raw":
                devpre.device_overlap_crops_batched(
                    t, tiling, cfg.crop_size, cfg.enc_patch_size, cfg.overlap_margin,
                    out=out[off:off + n])
            else:
                out[off:off + n].copy_(t)
            off += n
        return out

    def _crops_device(self, items: List[np.ndarray], tiling, pad_to: int = 0) -> torch.Tensor:
        """A tiling group's crops (raw images and / or host stacks) as one
        image-major stack on the device (both halves in this thread)."""
        return self._materialize_crop_segments(self._build_crop_segments(items), tiling, pad_to)

    def _vision_features(self, crops: torch.Tensor) -> torch.Tensor:
        """(N, 378, 378, 3) uint8 crops -> (N, 729, enc_dim). Crops on the
        host are copied to the device first; crops already there (the
        pipeline's, copied on its side stream) are used where they are."""
        return vision_encoder(normalize_crops(crops.to(self.device), self.dtype), self.vision)

    def _stitch_project(self, feats: torch.Tensor, tiling) -> torch.Tensor:
        """(..., n, 729, enc_dim) features of each image's global crop and n - 1
        local crops -> (..., 729, text_dim) image embeddings."""
        cfg = self.config.vision
        g = cfg.grid_size
        local = feats[..., 1:, :, :].reshape(*feats.shape[:-3], -1, g, g, cfg.enc_dim)
        recon = reconstruct_from_crops(
            local, tiling, overlap_margin=cfg.overlap_margin, patch_size=1
        )
        return vision_projection(feats[..., 0, :, :], recon, self.vision)

    def _embed_group(self, crops: torch.Tensor, n: int, tiling) -> torch.Tensor:
        """(G, 729, text_dim) embeddings of G images with n crops each and
        one tiling, from their crops (G * n, 378, 378, 3) in image order:
        ONE ViT call for the group."""
        feats = self._vision_features(crops)
        return self._stitch_project(feats.reshape(-1, n, *feats.shape[1:]), tiling)

    def _run_vision_encoder(self, image) -> torch.Tensor:
        """PIL image or uint8 (H, W, 3) array -> (729, text_dim) image
        embedding: the crops (on the card by default, from the raw image;
        from the host where `_prep_crop_groups` says so), padded with zero
        crops on the device to a crop-count bucket, through the ViT
        (moondream_tpu/models/moondream.py:702-753)."""
        ((item, tiling),) = self._prep_crop_groups([image])
        n = _n_crops(item, tiling)
        crops = self._crops_device([item], tiling, pad_to=_bucket(n))
        return self._stitch_project(self._vision_features(crops)[:n], tiling)

    def encode_image(self, image, settings: Optional[Dict[str, Any]] = None) -> EncodedImage:
        """Encode an image and prefill [BOS, image] through the text model,
        under the settings' LoRA variant. An EncodedImage is returned as it
        is when it was encoded under the request's variant label; under
        another label it raises ValueError (the adapter changes the image
        prefill too)."""
        _refuse_dropped(settings, "encode_image")
        want = _variant_label(settings)
        if isinstance(image, EncodedImage):
            if image.variant != want:
                raise ValueError(
                    f"EncodedImage was encoded under variant {image.variant!r} but this "
                    f"request uses {want!r}; the adapter applies to the image prefill, so "
                    "re-encode the image under the request's variant"
                )
            return image
        lora = self._variant(settings)
        img_emb = self._run_vision_encoder(image)
        bos = self.config.tokenizer.bos_id
        bos_emb = self.text.wte[bos:bos + 1][None]  # text_encoder's lookup, no host tensor
        embeds = torch.cat([bos_emb, img_emb[None]], dim=1).to(self.dtype)
        seq = embeds.shape[1]
        kv = KVCache.create(self.cache_config, 1, self.dtype, self.device)
        engine.prefill(
            self.text, kv, embeds, 0, seq, seq, kv_bound=self._kv_bound(seq), lora=lora
        )
        return _snap_enc(kv, seq, variant=want)

    def _variant(self, settings: Optional[Dict[str, Any]]) -> Optional[dict]:
        """The stacked LoRA adapter of a request (moondream_tpu/models/
        moondream.py:840-855): settings["variant_tree"] as given (on the
        model's device), else settings["variant"] loaded from its local
        file in the model's dtype on its device (`lora.variant_state_dict`,
        cached), else None. A tensor-parallel rank cuts it to its shard
        (`parallel.mesh.shard_adapter`; a tree cut already stays)."""
        if not settings:
            return None
        tree = settings.get("variant_tree")
        if tree is not None:
            kinds = {pair[f].device.type for sites in tree.values() for pair in sites.values()
                     for f in ("A", "B")}
            if kinds != {self.device.type}:
                raise ValueError(f"settings['variant_tree'] lies on {sorted(kinds)}, the model "
                                 f"on {self.device}: the adapter runs where the model runs")
        elif settings.get("variant") is None:
            return None
        else:
            from ..lora import variant_state_dict

            tree = variant_state_dict(settings["variant"], self.config.text.n_layers,
                                      self.dtype, self.device)
        if isinstance(self.text.config, TextShardConfig):
            from ..parallel.mesh import shard_adapter

            tree = shard_adapter(tree, self.text)
        return tree

    def _steer_vectors(self, settings: Optional[Dict[str, Any]]) -> Optional[torch.Tensor]:
        """The request's steering vector, pre-scaled, fp32 (n_layers, dim) on
        the model's device (moondream_tpu/models/moondream.py:907-918):
        settings["steer"].scaled(settings["steer_scale"]) for a
        ControlVector (its default scale when the scale is absent), an
        array or tensor times the scale (1.0 when absent); None without a
        vector (a scale alone steers nothing). Raises ValueError for another
        shape."""
        steer = (settings or {}).get("steer")
        if steer is None:
            return None
        scale = settings.get("steer_scale")
        if hasattr(steer, "scaled"):  # repeng.ControlVector
            vec = steer.scaled(scale, device=self.device)
        else:
            vec = torch.as_tensor(steer).to(self.device, torch.float32)
            vec = vec * (1.0 if scale is None else scale)
        want = (self.config.text.n_layers, self.config.text.dim)
        if tuple(vec.shape) != want:
            raise ValueError(f"settings['steer'] must be (n_layers, dim) = {want}, got "
                             f"{tuple(vec.shape)}")
        return vec

    def compile(self, settings: Optional[Dict[str, Any]] = None) -> "MoondreamModel":
        """Warm the hot paths (moondream_tpu/models/moondream.py:787-821):
        one dummy request through encode, caption, query, query with
        reasoning, detect, point and detect_gaze, greedy, with the JAX
        package's defaults (max_tokens 768, max_objects 50, temperature 0,
        top_p 0) where `settings` leaves them out. Returns self.

        On the card it first builds every kernel (one compiler per source,
        all at once), and the requests capture the CUDA graphs of their
        loops (engine/graphs.py: the answer loop, or the speculative one
        when settings["speculative"] is set; the reasoning loop; the
        structured loop of detect and point; the eye-mode gaze point) for
        the kv_bound bucket that max_tokens and max_objects give: warm with
        the settings real requests use, as the JAX package's jit keys say.
        No request streams, so the plain and the speculative stream capture
        their graphs at the first streamed request of each key (kv_bound
        bucket, sampling mode, adapter, cache). A graph is captured at its
        loop's first full run of 8 steps, so a
        dummy request that stops inside its first run leaves it to the
        first real one, as does a sampled request; the serving pool
        captures its chunks' graphs at their first chunk, and the lockstep
        batches and the accuracy-mode gaze step theirs at the first batch,
        as JAX compiles at its first batch. On the CPU it only runs the
        requests. The dummy image is encoded under `settings` too, so that a
        variant's graphs are the ones warmed (the JAX package encodes it
        without settings, and its caption then refuses the snapshot of
        another variant); detect_gaze, which runs no adapter, warms on a
        base encoding. A steering vector in `settings` warms the steered
        caption and query graphs (one per loop key, whatever the vector
        and scale); detect and point warm without it, as the JAX package's
        drop it."""
        s = dict(settings or {})
        s.setdefault("max_tokens", DEFAULT_MAX_TOKENS)
        s.setdefault("max_objects", DEFAULT_MAX_OBJECTS)
        s.setdefault("temperature", 0.0)
        s.setdefault("top_p", 0.0)
        if self.device.type == "cuda":
            from ..kernels import attention as attn_kernels
            from ..kernels import preprocess as crop_kernels
            from ..kernels import quant as quant_kernels
            from ..kernels.build import build_parallel

            build_parallel([*attn_kernels.LOADERS, *quant_kernels.LOADERS,
                            *crop_kernels.LOADERS])
        side = self.config.vision.crop_size
        dummy = np.zeros((side, side, 3), dtype=np.uint8)
        plain = _unsteered(s)
        enc = self.encode_image(dummy, settings=plain)
        self.caption(enc, "normal", settings=s)
        self.query(image=enc, question="?", settings=s)
        self.query(image=enc, question="?", reasoning=True, settings=s)
        self.detect(enc, "x", settings=plain)
        self.point(enc, "x", settings=plain)
        base = any(s.get(k) is not None for k in VARIANT_SETTINGS)
        self.detect_gaze(self.encode_image(dummy) if base else enc, eye=(0.5, 0.5))
        return self

    def _take_kv_buffer(self, batch: int = 1, slots: Optional[int] = None) -> KVCache:
        """A (batch, slots) cache buffer, recycled when the pool has one;
        its contents are stale. The current stream waits until the stream
        that recycled it is done with it."""
        slots = slots or self.config.text.max_context
        with self._kv_pool_lock:
            pool = self._kv_pool.get((batch, slots))
            entry = pool.pop() if pool else None
        if entry is None:
            return KVCache.create(self.cache_config, batch, self.dtype, self.device, slots)
        kv, freed = entry
        if freed is not None:
            torch.cuda.current_stream(kv.k.device).wait_event(freed)
        return kv

    def _recycle_kv(self, kv: Optional[KVCache]) -> None:
        """Return a buffer to the pool (at most two kept per batch and
        size); the caller must not use it afterwards."""
        if kv is None:
            return
        freed = None
        if kv.k.is_cuda:
            freed = torch.cuda.Event()
            freed.record(torch.cuda.current_stream(kv.k.device))
        with self._kv_pool_lock:
            pool = self._kv_pool.setdefault((int(kv.k.shape[1]), int(kv.k.shape[3])), [])
            if len(pool) < 2:
                pool.append((kv, freed))

    def _load_snapshot(self, snap: KVCache, slots: Optional[int]) -> KVCache:
        """A working cache holding `snap` (its batch rows) from column 0, on
        a recycled buffer when the pool has one."""
        kv = self._take_kv_buffer(int(snap.k.shape[1]), slots)
        n = snap.k.shape[3]  # the whole snapshot, as the JAX package writes it
        kv.k[:, :, :, :n] = snap.k
        kv.v[:, :, :, :n] = snap.v
        if kv.ks is not None:
            kv.ks[..., :n] = snap.ks
            kv.vs[..., :n] = snap.vs
        return kv

    def load_encoded_image(
        self, encoded: EncodedImage, slots: Optional[int] = None
    ) -> KVCache:
        """A working cache holding the snapshot, on a recycled buffer when
        the pool has one. `slots` bounds its token capacity (default
        max_context): serving pools pass their slot_len."""
        return self._load_snapshot(encoded.as_cache(), slots)

    # ------------------------------------------------------------ prefill
    def _prefill_prompt(
        self, kv: KVCache, prompt_tokens: List[int], pos: int,
        temperature: float, top_p: float, spatial_refs=None,
        prefix_len: Optional[int] = None, lora: Optional[dict] = None,
        steer: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int, KVCache]:
        """Embed and prefill a prompt into `kv` (in place), under the
        adapter `lora` and the steering vector `steer` when given, and
        sample the first token.
        `spatial_refs` (points and boxes) replace the embeddings at the
        prompt's coord_id and size_id tokens, in order. Returns (logits,
        hidden, next_token (0-d device tensor), new_pos, kv), as the JAX
        package does."""
        tok_cfg = self.config.tokenizer
        ids = list(prompt_tokens)
        length = len(ids)
        pad = _prompt_pad(length)
        ids_t = torch.tensor([ids + [0] * (pad - length)], device=self.device)
        emb = text_encoder(ids_t, self.text).to(self.dtype)
        if spatial_refs:
            encoded = region_ops.encode_spatial_refs(spatial_refs, self.region)
            at = lambda tid: [i for i, t in enumerate(ids) if t == tid]
            emb[0, at(tok_cfg.coord_id)] = encoded["coords"].to(self.dtype)
            if encoded["sizes"] is not None:
                emb[0, at(tok_cfg.size_id)] = encoded["sizes"].to(self.dtype)
        if prefix_len is None:
            prefix_len = self.config.text.prefix_attn
        logits, hidden = engine.prefill(
            self.text, kv, emb, pos, length, prefix_len,
            kv_bound=self._kv_bound(pos + pad), lora=lora, steer=steer,
        )
        next_token = sample_token(logits, self.generator, temperature, top_p)
        return logits, hidden, next_token, pos + length, kv

    # --------------------------------------------------------- generation
    def _settings(self, settings) -> Tuple[int, float, float]:
        s = settings or {}
        return (
            s.get("max_tokens", DEFAULT_MAX_TOKENS),
            s.get("temperature", DEFAULT_TEMPERATURE),
            s.get("top_p", DEFAULT_TOP_P),
        )

    @staticmethod
    def _spec_k(settings) -> int:
        """settings["speculative"]: True is k 8, a number k is max(2, k),
        anything false is 0 (no speculation)."""
        spec = (settings or {}).get("speculative")
        if not spec:
            return 0
        return 8 if spec is True else max(2, int(spec))

    def _spec_seed(self, prompt_tokens) -> Optional[torch.Tensor]:
        """The draft seed of a prompt: its last SPEC_SEED_LEN tokens,
        left-padded with -1 to that width, on the device (None without a
        prompt)."""
        if not prompt_tokens:
            return None
        tail = list(prompt_tokens)[-SPEC_SEED_LEN:]
        return torch.tensor([-1] * (SPEC_SEED_LEN - len(tail)) + tail, device=self.device)

    def _generate_answer_tokens(
        self, kv, next_token, pos, settings, eos_id=None, prompt_tokens=None, lora=None,
        steer=None,
    ) -> List[int]:
        """The answer's ids. With settings["speculative"] (k 8 for True):
        n-gram drafts, seeded by the prompt's tail, verified k rows at a
        time; greedy ids equal the plain loop's, and at temperature > 0 the
        drafts pass the rejection test against the target nucleus
        (moondream_tpu/models/moondream.py:929-982). `steer`: a steering
        vector added in every step or span."""
        max_tokens, temperature, top_p = self._settings(settings)
        eos = eos_id if eos_id is not None else self.config.tokenizer.eos_id
        suppress = (self.config.tokenizer.answer_id,)
        spec_k = self._spec_k(settings)
        if not spec_k:
            return engine.generate_text(
                self.text, kv, next_token, pos, self.generator, temperature, top_p,
                max_tokens, eos, suppress, kv_bound=self._decode_bound(pos + max_tokens + 1),
                graphed=self.graphed, lora=lora, steer=steer,
            ).tokens
        bound = self._decode_bound(pos + max_tokens + spec_k + 1)
        seed = self._spec_seed(prompt_tokens)
        if temperature == 0:
            return engine.generate_text_spec(
                self.text, kv, next_token, pos, max_tokens, eos, suppress, spec_k,
                bound, seed, graphed=self.graphed, lora=lora, steer=steer,
            ).tokens
        return engine.generate_text_spec_sampled(
            self.text, kv, next_token, pos, self.generator, temperature, top_p,
            max_tokens, eos, suppress, spec_k, bound, seed, graphed=self.graphed, lora=lora,
            steer=steer,
        ).tokens

    def _stream_answer(
        self, kv, next_token, pos, settings, eos_id=None, prompt_tokens=None, lora=None,
        steer=None,
    ) -> Iterator[str]:
        """Incremental streaming, text flushed on word boundaries: one decode
        step and one host sync per token (engine.stream_tokens, one CUDA
        graph replay each on the card), or with settings["speculative"] the
        fused loop's verify spans (engine.spec_spans, one replay each), one
        sync per 1..k tokens."""
        max_tokens, temperature, top_p = self._settings(settings)
        eos = eos_id if eos_id is not None else self.config.tokenizer.eos_id
        suppress = (self.config.tokenizer.answer_id,)
        spec_k = self._spec_k(settings)
        if spec_k:
            tokens = (t for span in engine.spec_spans(
                self.text, kv, next_token, pos, max_tokens, eos, suppress, spec_k,
                self._decode_bound(pos + max_tokens + spec_k + 1),
                self._spec_seed(prompt_tokens), self.generator, temperature, top_p,
                graphed=self.graphed, lora=lora, steer=steer,
            ) for t in span)
        else:
            tokens = self._step_tokens(kv, next_token, pos, max_tokens, eos, suppress,
                                       temperature, top_p, lora, steer)
        streamer = TokenStreamer(self._decode_tokens)
        for tok in tokens:
            chunk = streamer.feed(tok)
            if chunk:
                yield chunk
        tail = streamer.finish()
        if tail:
            yield tail

    def _step_tokens(self, kv, next_token, pos, max_tokens, eos, suppress, temperature,
                     top_p, lora=None, steer=None) -> Iterator[int]:
        """The answer's ids one decode step and one host sync at a time."""
        return engine.stream_tokens(
            self.text, kv, next_token, pos, self.generator, temperature, top_p, max_tokens,
            eos, suppress, self._decode_bound(pos + max_tokens + 1), lora=lora, steer=steer,
            graphed=self.graphed)

    # -------------------------------------------------------------- query
    def query(
        self,
        image=None,
        question: Optional[str] = None,
        reasoning: bool = False,
        spatial_refs=None,
        stream: bool = False,
        settings: Optional[Dict[str, Any]] = None,
    ):
        """Visual question answering, plain or streamed, with or without an
        image (moondream_tpu/models/moondream.py:1156-1250). Without an
        image the prompt starts with BOS at position 0 and is causal
        throughout. `reasoning`: a reasoning phase after the prompt and
        the thinking token (the reasoning loop, its text and grounding
        returned under "reasoning"), then the answer. `spatial_refs`
        ((x, y) points and (x_min, y_min, x_max, y_max) boxes, with an
        image only) go into the prompt as coordinate and size embeddings.
        A settings variant applies in every text forward; a steering vector
        in the answer's prompt prefill and decode loop, not in the image
        prefill or the reasoning phase, as the JAX package's."""
        templates = self.config.tokenizer.templates["query"]
        if templates is None:
            raise NotImplementedError("Model does not support querying.")
        if question is None:
            raise ValueError("question must be provided.")
        if spatial_refs and image is None:
            raise ValueError("spatial_refs can only be used with an image.")
        tok_cfg = self.config.tokenizer
        lora = self._variant(settings)
        steer = self._steer_vectors(settings)
        if image is not None:
            enc = self.encode_image(image, _unsteered(settings))
            kv, pos = self.load_encoded_image(enc), enc.pos
            prompt = list(templates["prefix"])
            prefix_len = self.config.text.prefix_attn
        else:
            kv, pos = self._take_kv_buffer(1), 0
            prompt = [tok_cfg.bos_id] + list(templates["prefix"])
            prefix_len = 0
        for ref in spatial_refs or []:
            prompt += [tok_cfg.coord_id, tok_cfg.coord_id] + [tok_cfg.size_id] * (len(ref) == 4)
        prompt += self._encode_text(question)
        max_tokens, temperature, top_p = self._settings(settings)

        reasoning_dict = {}
        if reasoning:
            r_prompt = prompt + list(templates["suffix"]) + [tok_cfg.thinking_id]
            _, hidden, next_token, pos, kv = self._prefill_prompt(
                kv, r_prompt, pos, temperature, top_p, spatial_refs,
                prefix_len=prefix_len, lora=lora,
            )
            res = engine.generate_reasoning(
                self.text, self.region, kv, next_token, hidden, pos, self.generator,
                temperature, top_p, max_tokens, tok_cfg.answer_id, tok_cfg.coord_id,
                (tok_cfg.eos_id, tok_cfg.size_id),
                kv_bound=self._decode_bound(pos + max_tokens + 1), graphed=self.graphed,
                lora=lora,
            )
            pos = res.pos
            reasoning_dict = {"reasoning": self._assemble_reasoning(
                res.tokens, res.is_coord, res.coord_vals)}
            answer_prompt = list(templates["suffix"])
        else:
            answer_prompt = prompt + list(templates["suffix"])

        _, _, next_token, pos, kv = self._prefill_prompt(
            kv, answer_prompt, pos, temperature, top_p,
            None if reasoning else spatial_refs, prefix_len=prefix_len, lora=lora, steer=steer,
        )
        if stream:
            return {**reasoning_dict, "answer": self._stream_answer(
                kv, next_token, pos, settings, prompt_tokens=answer_prompt, lora=lora,
                steer=steer)}
        tokens = self._generate_answer_tokens(kv, next_token, pos, settings,
                                              prompt_tokens=answer_prompt, lora=lora,
                                              steer=steer)
        self._recycle_kv(kv)  # the next request decodes on it (and its graphs)
        return {**reasoning_dict,
                "answer": "".join(stream_text(tokens, self._decode_tokens))}

    def _assemble_reasoning(self, tokens, is_coord, coord_vals) -> dict:
        """The reasoning tokens as text and grounding spans
        (moondream_tpu/models/moondream.py:1252-1286): the text splits into
        chunks at each start-ground-points and end-ground token; a chunk
        with two or more coordinates grounds its text span with their
        (x, y) pairs."""
        tok_cfg = self.config.tokenizer
        text_chunks: List[List[int]] = [[]]
        ground_chunks: List[List[float]] = [[]]
        for t, c, v in zip(tokens, is_coord, coord_vals):
            t = int(t)
            if t in (tok_cfg.start_ground_points_id, tok_cfg.end_ground_id):
                text_chunks.append([])
                ground_chunks.append([])
            text_chunks[-1].append(t)
            if c:
                ground_chunks[-1].append(float(v))

        decoded = [self._decode_tokens(chunk) for chunk in text_chunks]
        grounding = []
        start_idx = 0
        for chunk_text, gchunk in zip(decoded, ground_chunks):
            if len(gchunk) > 1:
                pts = [(gchunk[i], gchunk[i + 1])
                       for i in range(0, len(gchunk) - (len(gchunk) % 2), 2)]
                grounding.append({"start_idx": start_idx,
                                  "end_idx": start_idx + len(chunk_text), "points": pts})
            start_idx += len(chunk_text)
        return {"text": "".join(decoded), "grounding": grounding}

    # ------------------------------------------------------------ caption
    def caption(
        self,
        image,
        length: Literal["normal", "short", "long"] = "normal",
        stream: bool = False,
        settings: Optional[Dict[str, Any]] = None,
    ):
        """A caption of the image, plain or streamed, under the settings'
        variant and steering vector (the latter in the prompt prefill and
        the decode loop, not in the image prefill)."""
        templates = self.config.tokenizer.templates["caption"]
        if templates is None:
            raise NotImplementedError("Model does not support captioning.")
        if length not in templates:
            raise ValueError(f"Model does not support caption length '{length}'.")

        lora = self._variant(settings)
        steer = self._steer_vectors(settings)
        enc = self.encode_image(image, _unsteered(settings))
        _, temperature, top_p = self._settings(settings)
        kv = self.load_encoded_image(enc)
        prompt = list(templates[length])
        _, _, next_token, pos, kv = self._prefill_prompt(
            kv, prompt, enc.pos, temperature, top_p, lora=lora, steer=steer
        )
        if not stream:
            tokens = self._generate_answer_tokens(kv, next_token, pos, settings,
                                                  prompt_tokens=prompt, lora=lora, steer=steer)
            self._recycle_kv(kv)  # the next request decodes on it (and its graphs)
            return {"caption": "".join(stream_text(tokens, self._decode_tokens))}
        return {"caption": self._stream_answer(kv, next_token, pos, settings,
                                               prompt_tokens=prompt, lora=lora, steer=steer)}

    # ------------------------------------------------------ detect / point
    def _max_objects(self, settings) -> int:
        return (settings or {}).get("max_objects", DEFAULT_MAX_OBJECTS)

    def _structured_prompt(self, template_key: str, object: str) -> List[int]:
        templates = self.config.tokenizer.templates[template_key]
        if templates is None:
            raise NotImplementedError(f"Model does not support {template_key}.")
        return (list(templates["prefix"]) + self._encode_text(" " + object)
                + list(templates["suffix"]))

    def _structured_decode(
        self, image, object: str, template_key: str, include_size: bool, settings
    ) -> np.ndarray:
        """The prompt prefill, then the greedy structured loop
        (moondream_tpu/models/moondream.py:1326-1360). Returns the boxes
        (count, 4) as float64."""
        prompt = self._structured_prompt(template_key, object)
        lora = self._variant(settings)
        enc = self.encode_image(image, settings)
        kv = self.load_encoded_image(enc)
        _, hidden, next_token, pos, kv = self._prefill_prompt(kv, prompt, enc.pos, 0.0, 0.0,
                                                              lora=lora)
        max_objects = self._max_objects(settings)
        steps_per_object = 3 if include_size else 2
        boxes = engine.generate_points(
            self.text, self.region, kv, hidden, next_token, pos,
            self.config.tokenizer.eos_id, include_size, max_objects,
            kv_bound=self._decode_bound(pos + steps_per_object * max_objects + 2),
            graphed=self.graphed, lora=lora,
        )
        self._recycle_kv(kv)
        return boxes

    def detect(self, image, object: str, settings=None):
        """Bounding boxes of `object`, normalised to [0, 1]; settings may set
        max_objects (default 50)."""
        _refuse_dropped(settings, "detect")
        boxes = self._structured_decode(image, object, "detect", True, settings)
        return {"objects": [_box(b) for b in boxes]}

    def point(self, image, object: str, settings=None):
        """Centre points of `object`, normalised to [0, 1]."""
        _refuse_dropped(settings, "point")
        pts = self._structured_decode(image, object, "point", False, settings)
        return {"points": [{"x": float(p[0]), "y": float(p[1])} for p in pts]}

    # ------------------------------------------------------------ batching
    def encode_images(self, images, settings=None) -> List[EncodedImage]:
        """Batched encode (moondream_tpu/models/moondream.py:1401-1452): host
        crops per image, ONE ViT call per (crop count, tiling) group over the
        group's concatenated crops, one stitch + projection per group, and
        ONE batched [BOS, image] prefill for all images, under the settings'
        variant (each snapshot labelled with it)."""
        _refuse_dropped(settings, "encode_images")
        lora = self._variant(settings)
        prepped = self._prep_crop_groups(images)
        groups: Dict[Tuple[int, Tuple[int, int]], List[int]] = {}
        for i, (item, tiling) in enumerate(prepped):
            groups.setdefault((_n_crops(item, tiling), tiling), []).append(i)
        img_embs: List[Optional[torch.Tensor]] = [None] * len(images)
        for (n, tiling), idxs in groups.items():
            crops = self._crops_device([prepped[i][0] for i in idxs], tiling)
            for i, emb in zip(idxs, self._embed_group(crops, n, tiling)):
                img_embs[i] = emb

        bos = self.config.tokenizer.bos_id
        bos_emb = self.text.wte[bos:bos + 1]
        embeds = torch.stack([torch.cat([bos_emb, e]) for e in img_embs]).to(self.dtype)
        bsz, seq, _ = embeds.shape
        bound = self._kv_bound(seq)
        kv = self._take_kv_buffer(bsz, bound)
        batched_engine.prefill_batched(self.text, kv, embeds, 0, seq, seq, kv_bound=bound,
                                       lora=lora)
        want = _variant_label(settings)
        encs = [_snap_enc(kv, seq, b, variant=want) for b in range(bsz)]
        self._recycle_kv(kv)
        return encs

    def caption_batch(
        self,
        images,
        length: Literal["normal", "short", "long"] = "normal",
        settings: Optional[Dict[str, Any]] = None,
    ) -> List[str]:
        """Lockstep batched captioning: one prompt for every image, a shared
        position, per-row EOS."""
        _refuse_dropped(settings, "caption_batch")
        return self._symmetric_batch_generate(
            images, list(self.config.tokenizer.templates["caption"][length]),
            settings,
        )

    def query_batch(
        self, images, question: str, settings: Optional[Dict[str, Any]] = None
    ) -> List[str]:
        """Batched VQA: ONE question over every image, decoded in lockstep."""
        _refuse_dropped(settings, "query_batch")
        templates = self.config.tokenizer.templates["query"]
        prompt = (
            list(templates["prefix"])
            + self._encode_text(question)
            + list(templates["suffix"])
        )
        return self._symmetric_batch_generate(images, prompt, settings)

    def _structured_decode_batch(
        self, images, object: str, template_key: str, include_size: bool, settings
    ) -> List[np.ndarray]:
        """Lockstep detect / point of one object over the images
        (moondream_tpu/models/moondream.py:1569-1608): one batched prefill
        and one structured loop with per-row counts and EOS. Returns each
        image's boxes (count, 4) as float64."""
        ids = self._structured_prompt(template_key, object)
        max_objects = self._max_objects(settings)
        steps_per_object = 3 if include_size else 2
        # the single path's bound (pos + length is the position after the
        # prompt), so that both read the same columns
        logits, hidden, kv, pos, length, bound = self._batched_prompt_prefill(
            images, ids, settings,
            lambda pos, length, pad: pos + length + steps_per_object * max_objects + 2,
        )
        res = batched_engine.generate_points_batched(
            self.text, self.region, kv, hidden, torch.argmax(logits, dim=-1),
            pos + length, self.config.tokenizer.eos_id, include_size, max_objects,
            kv_bound=bound, graphed=self.graphed, lora=self._variant(settings),
        )
        self._recycle_kv(kv)
        return [res.boxes[b, :n] for b, n in enumerate(res.counts)]

    def detect_batch(self, images, object: str, settings=None) -> List[dict]:
        """`detect` of one object over many images, in lockstep."""
        _refuse_dropped(settings, "detect_batch")
        return [{"objects": [_box(b) for b in boxes]} for boxes in
                self._structured_decode_batch(images, object, "detect", True, settings)]

    def point_batch(self, images, object: str, settings=None) -> List[dict]:
        """`point` of one object over many images, in lockstep."""
        _refuse_dropped(settings, "point_batch")
        return [{"points": [{"x": float(p[0]), "y": float(p[1])} for p in pts]} for pts in
                self._structured_decode_batch(images, object, "point", False, settings)]

    def _batched_prompt_prefill(self, images, ids, settings, session_end):
        """The symmetric batched paths' scaffold
        (moondream_tpu/models/moondream.py:1480-1515): images to
        EncodedImages (one encode_images for the fresh ones), the batched
        cache loaded to the session's bound (`session_end(pos, length, pad)`
        is the last position the session can write), the shared prompt
        broadcast to every row, and ONE batched prefill, all under the
        settings' variant (an EncodedImage of another variant label raises
        ValueError). Returns (logits, hidden, kv, pos, length, bound)."""
        encs = [im if isinstance(im, EncodedImage) else None for im in images]
        for e in encs:
            if e is not None:
                self.encode_image(e, settings)  # the variant label's check
        to_encode = [im for im, e in zip(images, encs) if e is None]
        if to_encode:
            fresh = iter(self.encode_images(to_encode, settings))
            encs = [e if e is not None else next(fresh) for e in encs]

        pos, length = encs[0].pos, len(ids)
        pad = _prompt_pad(length)
        bound = self._decode_bound(session_end(pos, length, pad))
        kv = self._load_snapshot(_concat_enc_kv(encs), bound)
        ids_t = torch.tensor([list(ids) + [0] * (pad - length)], device=self.device)
        emb = text_encoder(ids_t, self.text).to(self.dtype).repeat(len(encs), 1, 1)
        logits, hidden = batched_engine.prefill_batched(
            self.text, kv, emb, pos, length, self.config.text.prefix_attn,
            kv_bound=self._kv_bound(pos + pad), lora=self._variant(settings),
        )
        return logits, hidden, kv, pos, length, bound

    def _symmetric_batch_generate(self, images, prompt_tokens, settings) -> List[str]:
        max_tokens, temperature, top_p = self._settings(settings)
        logits, _, kv, pos, length, bound = self._batched_prompt_prefill(
            images, prompt_tokens, settings,
            lambda pos, length, pad: pos + pad + max_tokens + 1,
        )
        first = batched_engine.sample_tokens_batched(
            logits, self.generator, temperature, top_p
        )
        res = batched_engine.generate_text_batched(
            self.text, kv, first, pos + length, self.generator, temperature,
            top_p, max_tokens, self.config.tokenizer.eos_id,
            (self.config.tokenizer.answer_id,), kv_bound=bound, graphed=self.graphed,
            lora=self._variant(settings),
        )
        rows = torch.cat([res.counts[:, None], res.tokens], dim=1).tolist()  # one read
        self._recycle_kv(kv)
        return ["".join(stream_text(r[1:1 + r[0]], self._decode_tokens)) for r in rows]

    # ---------------------------------------------------------------- gaze
    def _gaze_embeds(self, sources: List[Tuple[float, float]]) -> Tuple[torch.Tensor, int]:
        """The embedding-space gaze prompt of each eye position: "\\n\\nPoint:",
        enc(x), enc(y), " gaze\\n\\n" (moondream_tpu/models/moondream.py:1644-1673),
        (B, pad, D) right-padded with zeros, and its length."""
        bsz = len(sources)
        ids = lambda text: torch.tensor([self._encode_text(text)], device=self.device)
        before = text_encoder(ids("\n\nPoint:"), self.text).expand(bsz, -1, -1)
        after = text_encoder(ids(" gaze\n\n"), self.text).expand(bsz, -1, -1)
        xy = torch.tensor(sources, dtype=torch.float64).to(self.dtype).to(self.device)
        x_emb = region_ops.encode_coordinate(xy[:, 0, None, None], self.region)
        y_emb = region_ops.encode_coordinate(xy[:, 1, None, None], self.region)
        embeds = torch.cat([before, x_emb, y_emb, after], dim=1).to(self.dtype)
        length = embeds.shape[1]
        pad = _prompt_pad(length)
        return torch.nn.functional.pad(embeds, (0, 0, 0, pad - length)), length

    def _gaze_prefill(self, kv: KVCache, pos: int, embeds: torch.Tensor, length: int,
                      lora: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Prefill one eye position's gaze prompt (`_gaze_embeds`, (1, pad,
        D) of `length` rows) onto `kv` at pos, under the adapter `lora` when
        given (moondream_tpu/models/moondream.py:1644-1674). Returns (the
        last hidden state (D,), its greedy token (0-d), the position after
        it)."""
        logits, hidden = engine.prefill(
            self.text, kv, embeds, pos, length, self.config.text.prefix_attn,
            kv_bound=self._kv_bound(pos + embeds.shape[1]), lora=lora,
        )
        return hidden, torch.argmax(logits, dim=-1), pos + length

    def _detect_gaze(
        self, encoded: EncodedImage, source: Tuple[float, float], force_detect=False
    ) -> Optional[Dict[str, float]]:
        """Eye mode (moondream_tpu/models/moondream.py:1676-1697): the gaze
        prompt prefilled over the image, then one point. `force_detect`
        replaces the prompt's greedy token with 0 before the EOS check."""
        kv = self.load_encoded_image(encoded)
        hidden, next_token, pos = self._gaze_prefill(kv, encoded.pos, *self._gaze_embeds([source]))
        if force_detect:
            next_token = torch.zeros_like(next_token)
        if int(next_token) == self.config.tokenizer.eos_id:
            self._recycle_kv(kv)
            return None
        pts = engine.generate_points(
            self.text, self.region, kv, hidden, next_token, pos,
            self.config.tokenizer.eos_id, False, 1, kv_bound=self._decode_bound(pos + 4),
            graphed=self.graphed,
        )
        self._recycle_kv(kv)
        return {"x": float(pts[0][0]), "y": float(pts[0][1])} if len(pts) else None

    def _detect_gaze_batch(
        self, encs: List[EncodedImage], sources: List[Tuple[float, float]],
        force_detect: bool = False,
    ) -> List[Optional[Dict[str, float]]]:
        """Every (image, eye position) row at once
        (moondream_tpu/models/moondream.py:1699-1782): one batched prefill
        of the gaze prompts, then `engine.gaze_points_batched`: x from its
        last hidden states, one lockstep step on enc(x) for y (a CUDA graph
        on the card), and one read of (token, x, y) per row; the row math
        is `_detect_gaze`'s. A row whose greedy token (0 under
        `force_detect`) is EOS gives None."""
        embeds, length = self._gaze_embeds(sources)
        pos = encs[0].pos
        bound = self._kv_bound(pos + embeds.shape[1] + 4)
        kv = self._load_snapshot(_concat_enc_kv(encs), bound)
        logits, hidden = batched_engine.prefill_batched(
            self.text, kv, embeds, pos, length, self.config.text.prefix_attn, kv_bound=bound)
        toks = torch.argmax(logits, dim=-1)
        if force_detect:
            toks = torch.zeros_like(toks)
        rows = engine.gaze_points_batched(self.text, self.region, kv, hidden, toks,
                                          pos + length, bound, graphed=self.graphed)
        self._recycle_kv(kv)
        eos = self.config.tokenizer.eos_id
        return [None if int(t) == eos else {"x": xv, "y": yv} for t, xv, yv in rows]

    def detect_gaze(
        self,
        image,
        eye: Optional[Tuple[float, float]] = None,
        face: Optional[Dict[str, float]] = None,
        unstable_settings: Optional[Dict[str, Any]] = None,
    ):
        """Where a person looks (moondream_tpu/models/moondream.py:1784-1854).
        Eye mode: one gaze point from `eye`. Accuracy mode
        (unstable_settings["prioritize_accuracy"]): 10 eye positions drawn
        uniformly inside `face` (Python's module-level `random`) over the
        image and 10 over its mirror image ("flip_enc_img", or the image
        flipped left to right), all in one lockstep batch; fewer than 10
        detections give {"gaze": None}, else the mean of the detections
        that survive the outlier filter. It runs no LoRA adapter, as the JAX
        package's detect_gaze runs none, and refuses the variant settings
        rather than drop them."""
        _refuse_dropped(unstable_settings, "detect_gaze", variants=True)
        unstable_settings = unstable_settings or {}
        force_detect = unstable_settings.get("force_detect", False)
        if not unstable_settings.get("prioritize_accuracy", False):
            if eye is None:
                raise ValueError("eye must be provided when prioritize_accuracy=False")
            enc = self.encode_image(image)
            return {"gaze": self._detect_gaze(enc, eye, force_detect=force_detect)}

        if face is None:
            raise ValueError("face must be provided when prioritize_accuracy=True")
        if isinstance(image, EncodedImage) and "flip_enc_img" not in unstable_settings:
            raise ValueError(
                "image must be a PIL Image or an array when prioritize_accuracy=True, "
                "or flip_enc_img must be provided"
            )
        enc = self.encode_image(image)
        if "flip_enc_img" in unstable_settings:
            enc_flipped = unstable_settings["flip_enc_img"]
        elif isinstance(image, np.ndarray):
            enc_flipped = self.encode_image(np.ascontiguousarray(image[:, ::-1]))
        else:
            from PIL import Image as PILImage

            enc_flipped = self.encode_image(
                image.transpose(method=PILImage.Transpose.FLIP_LEFT_RIGHT))

        n = 10
        draw = lambda lo, hi: random.uniform(face[lo], face[hi])
        sources = [(draw("x_min", "x_max"), draw("y_min", "y_max")) for _ in range(n)]
        sources += [(1 - draw("x_min", "x_max"), draw("y_min", "y_max")) for _ in range(n)]
        rows = self._detect_gaze_batch([enc] * n + [enc_flipped] * n, sources,
                                       force_detect=force_detect)
        detections = ([(g["x"], g["y"]) for g in rows[:n] if g is not None]
                      + [(1 - g["x"], g["y"]) for g in rows[n:] if g is not None])
        if len(detections) < n:
            return {"gaze": None}
        detections = remove_outlier_points(detections)
        mean_x = sum(d[0] for d in detections) / len(detections)
        mean_y = sum(d[1] for d in detections) / len(detections)
        return {"gaze": {"x": mean_x, "y": mean_y}}
