"""Model configuration of the port: the fields of `moondream_tpu.config`
that the port reads, with the same names, defaults and published sizes
(tests/test_torch_host.py holds the two side by side).

The port keeps its own copy so that neither it nor `chip_smoke.py` imports
anything of the JAX package. The text config's `group_size` and the TPU's
runtime switches (`xla_attn`) are not ported; `kv_int8` and the region
heads are.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class TextConfig:
    dim: int = 2048
    ff_dim: int = 8192
    n_layers: int = 24
    vocab_size: int = 51200
    max_context: int = 2048
    n_heads: int = 32
    n_kv_heads: int = 32
    prefix_attn: int = 730
    # int8 KV cache: codes plus fp32 per-token scales (models/text.py)
    kv_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def qkv_dim(self) -> int:
        return int(self.dim * (1 + 2 * self.n_kv_heads / self.n_heads))

    @property
    def rope_dim(self) -> int:
        # partial rotary: the first rope_dim channels of each head rotate
        return self.dim // (2 * self.n_heads)


@dataclass(frozen=True)
class TextShardConfig(TextConfig):
    """One tensor-parallel rank's text config (`parallel.mesh.
    shard_text_model`): `n_heads`, `n_kv_heads` and `ff_dim` are the
    rank's shares over the tp ranks, and `dim` its attention width before
    proj, (n_heads / tp) * head_dim, so that head_dim, rope_dim and
    qkv_dim are the rank's too. `model_dim` is the residual stream's
    width, which every rank holds whole. The rank's int8 KV cache keeps
    one scale per head and token (`models.text.kv_scale_group`), as the
    JAX package's does under a mesh."""

    model_dim: int = 2048


@dataclass(frozen=True)
class VisionConfig:
    enc_dim: int = 1152
    enc_patch_size: int = 14
    enc_n_layers: int = 27
    enc_ff_dim: int = 4304
    enc_n_heads: int = 16
    proj_out_dim: int = 2048
    crop_size: int = 378
    in_channels: int = 3
    max_crops: int = 12
    overlap_margin: int = 4
    proj_inner_dim: int = 8192

    @property
    def grid_size(self) -> int:
        return self.crop_size // self.enc_patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def patch_dim(self) -> int:
        return self.enc_patch_size * self.enc_patch_size * self.in_channels


@dataclass(frozen=True)
class RegionConfig:
    dim: int = 2048
    coord_feat_dim: int = 256
    coord_out_dim: int = 1024
    size_feat_dim: int = 512
    size_out_dim: int = 2048
    inner_dim: int = 8192
    group_size: Optional[int] = None


def _default_templates() -> Dict[str, Optional[Dict[str, List[int]]]]:
    # prompt templates in token-id space ("starmie-v1" tokenizer scheme)
    return {
        "caption": {
            "short": [1, 32708, 2, 12492, 3],
            "normal": [1, 32708, 2, 6382, 3],
            "long": [1, 32708, 2, 4059, 3],
        },
        "query": {"prefix": [1, 15381, 2], "suffix": [3]},
        "detect": {"prefix": [1, 7235, 476, 2], "suffix": [3]},
        "point": {"prefix": [1, 2581, 2], "suffix": [3]},
    }


@dataclass(frozen=True)
class TokenizerConfig:
    bos_id: int = 0
    eos_id: int = 0
    answer_id: int = 3
    thinking_id: int = 4
    coord_id: int = 5
    size_id: int = 6
    start_ground_points_id: int = 7
    end_ground_id: int = 9
    # every task's template, as the JAX package keeps them
    templates: Dict[str, Optional[Dict[str, List[int]]]] = field(
        default_factory=_default_templates
    )


# Text fields of the JAX package's config that the port does not read.
_UNPORTED_TEXT_FIELDS = ("group_size", "xla_attn")


@dataclass(frozen=True)
class MoondreamConfig:
    text: TextConfig = field(default_factory=TextConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    region: RegionConfig = field(default_factory=RegionConfig)
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)

    @classmethod
    def from_dict(cls, config_dict: dict) -> "MoondreamConfig":
        """moondream_tpu.config.MoondreamConfig.from_dict; the text fields
        the port does not read (`group_size`, `xla_attn`) are dropped, any
        other unknown field raises TypeError."""
        text = {k: v for k, v in config_dict.get("text", {}).items()
                if k not in _UNPORTED_TEXT_FIELDS}
        return cls(
            text=TextConfig(**text),
            vision=VisionConfig(**config_dict.get("vision", {})),
            region=RegionConfig(**config_dict.get("region", {})),
            tokenizer=TokenizerConfig(**config_dict.get("tokenizer", {})),
        )

    @classmethod
    def from_json(cls, path: str) -> "MoondreamConfig":
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))

    # Runtime switches, not model schema (moondream_tpu/config.py:169-185):
    # left out of to_dict so that exported configs stay the reference's.
    _RUNTIME_TEXT_FIELDS = ("kv_int8",)

    def to_dict(self) -> dict:
        """moondream_tpu.config.MoondreamConfig.to_dict without the text
        fields the port does not read (`group_size`, `xla_attn`); the JAX
        package's from_dict of it gives its own config back (those fields at
        their defaults)."""
        text = dict(self.text.__dict__)
        for f in self._RUNTIME_TEXT_FIELDS:
            text.pop(f, None)
        return {
            "text": text,
            "vision": dict(self.vision.__dict__),
            "region": dict(self.region.__dict__),
            "tokenizer": dict(self.tokenizer.__dict__),
        }


# Published model sizes, as in moondream_tpu.config.
MOONDREAM_2B = MoondreamConfig()
MOONDREAM_05B = MoondreamConfig(
    text=TextConfig(dim=1024, ff_dim=4096, n_heads=16, n_kv_heads=16),
    vision=VisionConfig(enc_dim=720, enc_ff_dim=2690, enc_n_heads=10, proj_out_dim=1024),
    region=RegionConfig(dim=1024),
)


def tiny_test_config(vocab_size: int = 512) -> MoondreamConfig:
    """The JAX package's miniature CPU test config: a 729-token image grid,
    the 730 prefix and partial RoPE at tiny widths. Template word ids stay
    below 256 so the ByteTokenizer's byte ids (256+) fit a 512 vocab."""
    tiny_templates = {
        "caption": {
            "short": [1, 10, 2, 11, 3],
            "normal": [1, 10, 2, 12, 3],
            "long": [1, 10, 2, 13, 3],
        },
        "query": {"prefix": [1, 14, 2], "suffix": [3]},
        "detect": {"prefix": [1, 15, 16, 2], "suffix": [3]},
        "point": {"prefix": [1, 17, 2], "suffix": [3]},
    }
    return MoondreamConfig(
        tokenizer=TokenizerConfig(templates=tiny_templates),
        text=TextConfig(
            dim=64, ff_dim=128, n_layers=2, vocab_size=vocab_size,
            max_context=1024, n_heads=2, n_kv_heads=2,
        ),
        vision=VisionConfig(
            enc_dim=32, enc_n_layers=2, enc_ff_dim=64, enc_n_heads=2,
            proj_out_dim=64, proj_inner_dim=64,
        ),
        region=RegionConfig(dim=64, coord_feat_dim=16, size_feat_dim=32, inner_dim=64),
    )
