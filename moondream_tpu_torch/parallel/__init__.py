"""Multi-GPU serving and training of the port (moondream_tpu/parallel/):
one process per GPU over torch.distributed (`comm`), the mesh, the shard
cuts of the text model, of a training batch (sequence parallelism
included) and of the whole model (`mesh`), the collectives that carry a
gradient and the gradient sums (`grad`), the sharded lockstep text engine
(`inference`), the sharded serving pool with the crop-parallel ViT
(`serving`) and GPipe pp x dp training (`pipeline`). The dp x tp and
dp x sp training step is `finetune.trainer.make_train_step` on a rank's
shard.

The names are imported on first use: the model's modules import `comm`
and `grad` from here, and `mesh`, `inference`, `serving` and `pipeline`
import the models.
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
    "batch_shardings": "mesh",
    "shard_batch": "mesh",
    "param_shardings": "mesh",
    "shard_params": "mesh",
    "make_pp_loss_and_grads": "pipeline",
    "make_pp_train_step": "pipeline",
    "shard_params_pp": "pipeline",
    "launch": "comm",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
