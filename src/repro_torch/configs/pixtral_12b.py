"""pixtral-12b — VLM: mistral-nemo backbone, pixtral-ViT frontend (stub).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
The vision frontend supplies precomputed patch embeddings (256 of width
1024), which ``patch_proj`` projects and splices over the first prompt
positions. [hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.configs.base import (AttentionConfig, FrontendConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131072,
    attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                              rope_theta=1000000.0),
    frontend=FrontendConfig(kind="vision_patches", num_embeds=256,
                            embed_dim=1024),
    skip_long_context=True,
)
