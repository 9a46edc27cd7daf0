"""Config registry: the architectures the port can run.

Counterpart of the JAX package's ``repro/configs/__init__.py``.  Registered:
the attention decoders gemma-2b, qwen1.5-4b, chatglm3-6b and h2o-danube-3-4b
(sliding window) with dense MLPs, deepseek-moe-16b and qwen3-moe-30b-a3b
with mixture-of-experts MLPs, and the recurrent families rwkv6-7b
(attention-free) and recurrentgemma-9b (RG-LRU with local attention), the
encoder-decoder whisper-medium (``src_embeds``: stub audio frames) and
internvl2-26b (``prefix_embeds``: stub image patches before the tokens).
"""
from __future__ import annotations

from typing import Dict, List

from .base import ModelConfig, MoECfg, ShapeConfig, SHAPES, smoke_config  # noqa: F401

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} is not an architecture the port runs yet "
                       f"(have {sorted(_REGISTRY)}; ROADMAP A10)")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from . import (  # noqa: F401
        chatglm3_6b,
        deepseek_moe_16b,
        gemma_2b,
        h2o_danube3_4b,
        internvl2_26b,
        qwen3_moe_30b_a3b,
        qwen15_4b,
        recurrentgemma_9b,
        rwkv6_7b,
        whisper_medium,
    )
