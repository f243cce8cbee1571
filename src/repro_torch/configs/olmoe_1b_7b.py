"""olmoe-1b-7b — MoE, 64 experts top-8, MHA. [arXiv:2409.02060]

The paper's own second evaluation model (OLMoE-1B-7B-Instruct).

16L d_model=2048 16H (kv=16, MHA) expert_ff=1024 vocab=50304.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    d_ff=1024,
    vocab_size=50304,
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                              qk_norm=True, rope_theta=10000.0),
    moe=MoEConfig(num_experts=64, top_k=8, expert_ff=1024),
    skip_long_context=True,
)
