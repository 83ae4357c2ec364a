"""moondream_tpu_torch: the PyTorch + CUDA port of moondream_tpu for one
NVIDIA H100, beside the JAX package it is tested against.

It runs caption, query (with reasoning and spatial refs), detect, point,
detect_gaze, the lockstep batches and the continuous-batching pool: host
overlap crops, the ViT, stitch and projection, the [BOS, image] prefill,
the prompt prefill, the decode loops, the region heads and streaming
detokenisation; and its front ends: the HTTP server (`serve_http`), the
CLI (`cli`), the HF wrapper (`hf_moondream`) and the native byte-level BPE
(`native_bpe`). Attention and the int4 linears run in hand-written CUDA
kernels (`csrc/`) on the card and in their plain PyTorch versions on the
CPU. The package never imports jax.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # keep `import moondream_tpu_torch` light; the model pulls in torch
    if name in ("MoondreamModel", "EncodedImage"):
        from .models import moondream

        return getattr(moondream, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
