"""Checkpoints of the port: the manager (the JAX package's on-disk
format), HF checkpoint ingestion (the safetensors codec, the HF -> port
param mapping) and the synthetic-checkpoint writer."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
