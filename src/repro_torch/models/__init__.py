"""Model factory (the port serves the dense, MoE, VLM and encoder-decoder
families)."""
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
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
