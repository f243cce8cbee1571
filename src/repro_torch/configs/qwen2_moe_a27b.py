"""qwen2-moe-a2.7b — MoE with shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B]

24L d_model=2048 16H (kv=16, MHA) expert_ff=1408, 60 routed top-4 +
4-shared-expert-equivalent shared path, vocab=151936.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    d_ff=1408,
    vocab_size=151936,
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                              qkv_bias=True, rope_theta=1000000.0),
    moe=MoEConfig(num_experts=60, top_k=4, expert_ff=1408, num_shared=4),
    skip_long_context=True,
)
