"""llama-3.1-8b — the paper's primary evaluation model (§8.1).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, head_dim=128.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                              rope_theta=500000.0),
    skip_long_context=True,
)
