"""qwen3-0.6b — dense GQA with per-head q/k RMSNorm. [hf:Qwen/Qwen3 family]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, explicit head_dim=128.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    d_ff=3072,
    vocab_size=151936,
    attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=128,
                              qk_norm=True, rope_theta=1000000.0),
    tie_embeddings=True,
    skip_long_context=True,
)
