"""The eval harness on the port's model (moondream_tpu/eval/): the
per-benchmark loops, eval_all and the quantized configs' accuracy gates
(quant_drift)."""

from . import metrics  # noqa: F401
