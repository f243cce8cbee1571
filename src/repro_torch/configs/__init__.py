"""Architecture config registry of the port (the dense and MoE decoders,
the VLM, the encoder-decoder, the SSM and the hybrid it serves: every
family of the JAX package's registry).

``get_config(name)`` returns the full published config; ``reduced(name)``
the CPU-test variant of the same structure.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    AquaConfig, AttentionConfig, CacheSpec, FrontendConfig, ModelConfig,
    MoEConfig, QuantSpec, RGLRUConfig, ServingConfig, SparsitySpec,
    SSMConfig, TrainConfig, reduce_config,
    resolve_cache_specs, resolve_eviction, resolve_sparsity_spec,
)

_MODULES: Dict[str, str] = {
    "qwen3-0.6b": "qwen3_0_6b",
    "llama3.1-8b": "llama31_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen1.5-4b": "qwen15_4b",
    "minitron-4b": "minitron_4b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "pixtral-12b": "pixtral_12b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}
ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    cfg: ModelConfig = importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG
    cfg.validate()
    return cfg


def reduced(name: str, **kw) -> ModelConfig:
    return reduce_config(get_config(name), **kw)
