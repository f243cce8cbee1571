"""h2o-danube-1.8b — dense GQA decoder with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) head_dim=80 d_ff=6912 vocab=32000, window
4096, untied embeddings  [arXiv:2401.16818]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    d_ff=6912,
    vocab_size=32000,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=8, head_dim=80,
        kind="swa", window=4096, rope_theta=10000.0),
    tie_embeddings=False,
)
