"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1:2. [arXiv:2402.19427]

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 vocab=256000,
block pattern (recurrent, recurrent, attention), local window 2048.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    d_ff=12288,
    vocab_size=256000,
    attention=AttentionConfig(num_heads=16, num_kv_heads=1, head_dim=256,
                              kind="local", window=2048, rope_theta=10000.0),
    rglru=RGLRUConfig(lru_width=0, conv_width=4,
                      block_pattern=("recurrent", "recurrent", "attention")),
    act="gelu",
)
