"""mamba2-370m — attention-free SSD (state-space duality). [arXiv:2405.21060]

48L d_model=1024, ssm_state=128, head_dim=64, expand=2.

AQUA is inapplicable (no query-key dot product): served without it, as in
the JAX package.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
)
