"""whisper-tiny — encoder-decoder, conv audio frontend (stub).
[arXiv:2212.04356]

4L enc + 4L dec, d_model=384 6H (MHA) d_ff=1536 vocab=51865, gelu, no
RoPE (sinusoidal encoder positions, a learned decoder position table).
The conv frontend is stubbed: a request carries precomputed frame
embeddings (batch, 1500, d_model) fed straight to the encoder.
"""
from repro_torch.configs.base import (AttentionConfig, FrontendConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    num_encoder_layers=4,
    d_model=384,
    d_ff=1536,
    vocab_size=51865,
    attention=AttentionConfig(num_heads=6, num_kv_heads=6, head_dim=64,
                              use_rope=False),
    frontend=FrontendConfig(kind="audio_frames", num_embeds=1500,
                            embed_dim=384),
    act="gelu",
    skip_long_context=True,
)
