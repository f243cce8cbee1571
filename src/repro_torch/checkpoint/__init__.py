"""HF checkpoint ingestion of the port: the safetensors codec, the HF ->
port param mapping and the synthetic-checkpoint writer."""
