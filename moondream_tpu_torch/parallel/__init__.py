"""Multi-GPU serving of the port (moondream_tpu/parallel/): one process per
GPU over torch.distributed (`comm`), the dp x tp mesh and the shard cut
(`mesh`), the sharded lockstep text engine (`inference`) and the sharded
serving pool with the crop-parallel ViT (`serving`). Training's half of
the JAX package's `parallel/` (GPipe, the sharded train step, sequence
parallelism) is not ported yet.

The names are imported on first use: the model's modules import `comm`
from here, and `mesh`, `inference` and `serving` import the models.
"""

_EXPORTS = {
    "ShardedTextEngine": "inference",
    "kv_cache_sharding": "inference",
    "make_sharded_serving_engine": "serving",
    "shard_vision_encoder": "serving",
    "ShardedBatchingEngine": "serving",
    "create_mesh": "mesh",
    "default_mesh_axes": "mesh",
    "text_param_shardings": "mesh",
    "shard_text_model": "mesh",
    "launch": "comm",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
