"""Synthetic HF-checkpoint writer (no network): the port's counterpart of
the JAX package's ``checkpoint/fixtures.py``.

Writes a random qwen3-geometry checkpoint in genuine HF layout —
``config.json`` plus safetensors file(s) with transformers tensor names
and HF-side shapes (``q_proj.weight`` as ``(H*D, hidden)`` etc.) — through
the port's own codec. The names and shapes below are written against the
HF llama/qwen3 state-dict format directly, not from ``hf.mapping_specs``,
so a mapping bug cannot hide behind a fixture made from the same table.
Values come from a ``torch.Generator`` seeded with ``seed`` (not the JAX
writer's numpy stream: tests compare loaders on one set of files).

Variants: ``variant="single"`` (one ``model.safetensors``) or
``"sharded"`` (two shard files plus ``model.safetensors.index.json``);
``tied`` (``tie_word_embeddings``, no ``lm_head.weight``); ``bias``
(``attention_bias``: q/k/v biases); ``dtype`` "float32" or "bfloat16"
(stored dtype); ``extra_tensors`` (a ``rotary_emb.inv_freq`` entry that
ingestion ignores); ``config_overrides`` (e.g. a published geometry).
The values are drawn on ``device``: the CUDA card unless the caller asks
for the CPU (a CPU and a CUDA generator give different streams, so one
seed names one checkpoint per device).

CLI (``--device cpu`` where there is no card)::

    PYTHONPATH=src python -m repro_torch.checkpoint.fixtures OUT \\
        --variant sharded --seed 0
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import torch

from repro_torch.checkpoint.safetensors import save_file
from repro_torch.runtime import DeviceLike, resolve_device

# Tiny qwen3 geometry (the JAX writer's): GQA (kv < heads), qk-norm.
# head_dim 16 admits block_dims 8; vocab 256 fits the byte-level corpus.
QWEN3_TINY: Dict[str, object] = {
    "model_type": "qwen3",
    "hidden_size": 64,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "head_dim": 16,
    "intermediate_size": 128,
    "vocab_size": 256,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "float32",
}
_STORED = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def fixture_state_dict(config: Dict[str, object], *, seed: int = 0,
                       device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random float32 tensors under HF transformers names and shapes, on
    ``device`` (default the card; raises without one): weights normal with
    std 1/sqrt(in_features) (biases 0.02), norms ones."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    hidden = int(config["hidden_size"])
    layers = int(config["num_hidden_layers"])
    heads = int(config["num_attention_heads"])
    kv = int(config.get("num_key_value_heads", heads))
    d = int(config.get("head_dim", hidden // heads))
    ff = int(config["intermediate_size"])
    vocab = int(config["vocab_size"])
    qk_norm = config.get("model_type") == "qwen3"
    bias = bool(config.get("attention_bias", False))
    tied = bool(config.get("tie_word_embeddings", False))

    def w(*shape: int) -> torch.Tensor:
        scale = shape[-1] ** -0.5 if len(shape) > 1 else 0.02
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, device=device)

    sd = {"model.embed_tokens.weight": w(vocab, hidden),
          "model.norm.weight": ones(hidden)}
    if not tied:
        sd["lm_head.weight"] = w(vocab, hidden)
    for i in range(layers):
        pre = f"model.layers.{i}."
        attn = pre + "self_attn."
        sd[pre + "input_layernorm.weight"] = ones(hidden)
        sd[pre + "post_attention_layernorm.weight"] = ones(hidden)
        sd[attn + "q_proj.weight"] = w(heads * d, hidden)
        sd[attn + "k_proj.weight"] = w(kv * d, hidden)
        sd[attn + "v_proj.weight"] = w(kv * d, hidden)
        sd[attn + "o_proj.weight"] = w(hidden, heads * d)
        if qk_norm:
            sd[attn + "q_norm.weight"] = ones(d)
            sd[attn + "k_norm.weight"] = ones(d)
        if bias:
            sd[attn + "q_proj.bias"] = w(heads * d)
            sd[attn + "k_proj.bias"] = w(kv * d)
            sd[attn + "v_proj.bias"] = w(kv * d)
        sd[pre + "mlp.gate_proj.weight"] = w(ff, hidden)
        sd[pre + "mlp.up_proj.weight"] = w(ff, hidden)
        sd[pre + "mlp.down_proj.weight"] = w(hidden, ff)
    return sd


def write_hf_fixture(outdir: str, *, seed: int = 0, variant: str = "single",
                     tied: bool = False, bias: bool = False,
                     dtype: str = "float32",
                     config_overrides: Optional[Dict[str, object]] = None,
                     extra_tensors: bool = False,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Write a synthetic HF checkpoint to ``outdir``; returns the float32
    HF-layout state dict the files were written from (on ``device``,
    where the values are drawn: default the card, raising without one)."""
    if dtype not in _STORED:
        raise ValueError(f"unsupported fixture dtype {dtype!r}")
    if variant not in ("single", "sharded"):
        raise ValueError(f"unknown fixture variant {variant!r}")
    config = dict(QWEN3_TINY)
    config["tie_word_embeddings"] = tied
    if bias:
        config["attention_bias"] = True
    config["torch_dtype"] = dtype
    if config_overrides:
        config.update(config_overrides)
    sd = fixture_state_dict(config, seed=seed, device=device)

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    stored = {k: v.to(_STORED[dtype]) for k, v in sd.items()}
    if extra_tensors:
        stored["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(
            int(config["head_dim"]) // 2)

    if variant == "single":
        save_file(stored, os.path.join(outdir, "model.safetensors"))
        return sd
    names = sorted(stored)
    half = len(names) // 2
    shards = {"model-00001-of-00002.safetensors": names[:half],
              "model-00002-of-00002.safetensors": names[half:]}
    weight_map = {}
    for fname, keys in shards.items():
        save_file({k: stored[k] for k in keys}, os.path.join(outdir, fname))
        weight_map.update({k: fname for k in keys})
    total = sum(t.numel() * t.element_size() for t in stored.values())
    with open(os.path.join(outdir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return sd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", default="single",
                    choices=("single", "sharded"))
    ap.add_argument("--tied", action="store_true")
    ap.add_argument("--bias", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="draw the values on the CUDA card (default; exits "
                         "non-zero without one) or on the CPU")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[fixtures] {e} (--device cpu)") from None
    sd = write_hf_fixture(args.outdir, seed=args.seed, variant=args.variant,
                          tied=args.tied, bias=args.bias, dtype=args.dtype,
                          device=device)
    print(f"[fixtures] wrote {len(sd)} tensors ({args.variant}, "
          f"{args.dtype}, drawn on {device}) to {args.outdir}")


if __name__ == "__main__":
    main()
