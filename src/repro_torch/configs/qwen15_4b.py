"""qwen1.5-4b — dense with QKV bias. [hf:Qwen/Qwen1.5 family]

40L d_model=2560 20H (GQA kv=20 == MHA) head_dim=128 d_ff=6912
vocab=151936
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    d_ff=6912,
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=20, num_kv_heads=20, head_dim=128,
        qkv_bias=True, rope_theta=1000000.0),
    skip_long_context=True,  # pure full attention
)
