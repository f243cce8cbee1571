"""Model factory (the port serves every family of the JAX package: dense,
MoE, VLM, encoder-decoder, SSM and hybrid)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import LM, DecodeState  # noqa: F401


def build_model(cfg: ModelConfig, device=None) -> LM:
    """``device`` None means the CUDA card (raises without one); pass
    ``device="cpu"`` for the plain CPU path."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg, device)
    if cfg.family == "encdec":
        from repro_torch.models.transformer import EncDecLM
        return EncDecLM(cfg, device)
    if cfg.family == "ssm":
        from repro_torch.models.mamba2 import Mamba2LM
        return Mamba2LM(cfg, device)
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import HybridLM
        return HybridLM(cfg, device)
    raise ValueError(f"unknown family {cfg.family!r}")
