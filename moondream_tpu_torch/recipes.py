"""The video recipes (`recipes/`) on the port's model.

`load_model` is the counterpart of `recipes.gaze_detection_video.load_model`
(the loader all three recipe CLIs call); `main` runs one recipe's CLI with
it in place of the recipe's own loader, so that every model call of the
recipe (encode_images, detect_batch, detect, detect_gaze) runs on the
port. The recipes themselves are unchanged and import nothing of the JAX
package when they are imported.

    python -m moondream_tpu_torch.recipes gaze_detection_video --input in.mp4 \
        [--model ckpt.safetensors] [--device cpu] [the recipe's own options]

The model runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from pathlib import Path

RECIPES = ("gaze_detection_video", "promptable_video_redaction",
           "promptable_content_moderation")
_ROOT = str(Path(__file__).resolve().parents[1])


def load_model(model_path: str, config_name: str = "2b", device="cuda"):
    """A MoondreamModel from a checkpoint (tokenizer from
    MOONDREAM_TOKENIZER, else ./tokenizer.json when present), or random
    weights for a dry run when no checkpoint is given, on `device`."""
    from .config import MOONDREAM_05B, MOONDREAM_2B
    from .models.moondream import MoondreamModel

    config = MOONDREAM_2B if config_name == "2b" else MOONDREAM_05B
    if model_path:
        from .tokenizer import load_tokenizer
        from .weights import load_params

        params = load_params(model_path, config, device=device)
        tok_path = os.environ.get("MOONDREAM_TOKENIZER", "tokenizer.json")
        tokenizer = load_tokenizer(tok_path) if os.path.exists(tok_path) else None
        return MoondreamModel(config, params=params, tokenizer=tokenizer, device=device)
    print("WARNING: no --model given; using random weights (smoke test only)")
    return MoondreamModel(config, seed=0, device=device)


def recipe(name: str):
    """The recipe module `recipes.<name>` (the repository root is put on
    sys.path, as the recipes do themselves)."""
    if name not in RECIPES:
        raise ValueError(f"unknown recipe {name!r}; one of {RECIPES}")
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    return importlib.import_module(f"recipes.{name}")


def main(argv=None):
    """Run a recipe's CLI with the port's `load_model` on --device; every
    other argument goes to the recipe's own parser."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("recipe", choices=RECIPES)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    args, rest = parser.parse_known_args(argv)
    module = recipe(args.recipe)
    saved = module.load_model, sys.argv
    module.load_model = lambda path, config_name="2b": load_model(path, config_name,
                                                                  args.device)
    sys.argv = [f"recipes.{args.recipe}", *rest]
    try:
        return module.main()
    finally:
        module.load_model, sys.argv = saved


if __name__ == "__main__":
    main()
