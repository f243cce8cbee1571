"""minitron-4b — width-pruned nemotron. [arXiv:2407.14679]

32L d_model=3072 24H (GQA kv=8) head_dim=128 d_ff=9216 vocab=256000
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    d_ff=9216,
    vocab_size=256000,
    attention=AttentionConfig(num_heads=24, num_kv_heads=8, head_dim=128,
                              rope_theta=10000.0),
    act="silu",
    skip_long_context=True,
)
