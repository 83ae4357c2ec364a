"""HuggingFace-compatible wrapper and legacy API shim over the port's model
(moondream_tpu/hf_moondream.py).

`HfMoondream` exposes the legacy method surface (`answer_question`,
`batch_answer`, `generate`, the embedding accessors) and passes the modern
entry points through, so that consumers written against the reference's
HF distribution can switch with one import. `HfConfig` mirrors the hub's
config class. `from_pretrained` reads a local checkpoint only (the port
never reaches the network), on the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .config import MoondreamConfig
from .engine import graphs
from .models.moondream import MoondreamModel

try:  # transformers is optional for this shim
    from transformers import PretrainedConfig

    class HfConfig(PretrainedConfig):
        model_type = "moondream1"

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.config = {}

except ImportError:

    class HfConfig:  # type: ignore[no-redef]
        model_type = "moondream1"

        def __init__(self, **kwargs):
            self.config = {}


class HfMoondream:
    """Legacy-API adapter over MoondreamModel."""

    def __init__(self, model: MoondreamModel):
        self.model = model

    @classmethod
    def from_pretrained(cls, path: str, config_json: Optional[str] = None, tokenizer=None,
                        device="cuda") -> "HfMoondream":
        """A local checkpoint (`weights.load_params`) under `config_json`
        (default: the 2B config) with `tokenizer.load_tokenizer(tokenizer)`."""
        from .tokenizer import load_tokenizer
        from .weights import load_params

        config = MoondreamConfig.from_json(config_json) if config_json else MoondreamConfig()
        params = load_params(path, config, device=device)
        return cls(MoondreamModel(config, params=params, tokenizer=load_tokenizer(tokenizer),
                                  device=device))

    # -------------------------------------------------- modern pass-throughs
    def encode_image(self, image, settings=None):
        return self.model.encode_image(image, settings)

    def caption(self, *a, **k):
        return self.model.caption(*a, **k)

    def query(self, *a, **k):
        return self.model.query(*a, **k)

    def detect(self, *a, **k):
        return self.model.detect(*a, **k)

    def point(self, *a, **k):
        return self.model.point(*a, **k)

    def detect_gaze(self, *a, **k):
        return self.model.detect_gaze(*a, **k)

    # ------------------------------------------------------------ legacy API
    def answer_question(self, image_embeds, question: str, tokenizer=None,
                        chat_history: str = "", result_queue=None,
                        max_new_tokens: int = 256, **kwargs) -> str:
        """The answer to `question` with the model's default sampling,
        stripped; also put on `result_queue` when one is given."""
        answer = self.model.query(
            image=image_embeds, question=question, settings={"max_tokens": max_new_tokens},
        )["answer"].strip()
        if result_queue is not None:
            result_queue.put(answer)
        return answer

    def batch_answer(self, images, prompts, tokenizer=None, **kwargs) -> List[str]:
        """One answer per (image, prompt) pair, in order."""
        answers = []
        for image, prompt in zip(images, prompts):
            enc = self.model.encode_image(image)
            answers.append(self.model.query(enc, prompt)["answer"].strip())
        return answers

    def generate(self, image_embeds, prompt: str, tokenizer=None,
                 max_new_tokens: int = 128, **kwargs) -> List[str]:
        """Greedy continuation of a raw text prompt after the image (no
        template)."""
        model = self.model
        prompt_ids = model._encode_text(prompt)
        enc = image_embeds if hasattr(image_embeds, "pos") else model.encode_image(image_embeds)
        kv = model.load_encoded_image(enc)
        _, _, next_token, pos, kv = model._prefill_prompt(
            kv, prompt_ids, enc.pos, temperature=0.0, top_p=0.0
        )
        tokens = model._generate_answer_tokens(
            kv, next_token, pos, {"max_tokens": max_new_tokens, "temperature": 0.0}
        )
        model._recycle_kv(kv)
        return [model._decode_tokens(tokens)]

    # ------------------------------------------------------------ embeddings
    def get_input_embeddings(self) -> torch.Tensor:
        """The (vocab, dim) embedding table itself: lookups are `wte[ids]`."""
        return self.model.text.wte

    def set_input_embeddings(self, value) -> None:
        """Replace the embedding table with a (vocab, dim) array, tensor or
        anything with a `.weight` (an nn.Embedding), in the model's dtype on
        its device. A table of the current shape is copied into the one the
        CUDA graphs read; a table of another vocabulary size becomes a new
        parameter, and the model's graphs, which read the old table's
        address, are dropped (recaptured at their next use)."""
        model = self.model
        w = getattr(value, "weight", value)
        if isinstance(w, torch.Tensor):
            w = w.detach()
        else:
            w = torch.from_numpy(np.array(w, dtype=np.float32))
        w = w.to(device=model.device, dtype=model.dtype)
        dim = model.config.text.dim
        if w.ndim != 2 or w.shape[1] != dim:
            raise ValueError(f"embedding table must be (vocab, {dim}); got {tuple(w.shape)}")
        text = model.text
        with graphs.lock():
            if w.shape == text.wte.shape:
                with torch.no_grad():
                    text.wte.copy_(w)
                return
            text.wte = torch.nn.Parameter(w.clone(), requires_grad=False)
            graphs.cache_of(text).entries.clear()

    def input_embeds(self, input_ids) -> torch.Tensor:
        """Token ids -> embeddings (1, n, dim) for a 1-d list, else
        (batch, n, dim)."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.model.device)
        if ids.ndim == 1:
            ids = ids[None]
        return self.model.text.wte[ids]

    @property
    def config(self) -> Dict[str, Any]:
        return self.model.config.to_dict()
