"""HF-format safetensors ingestion: a real checkpoint -> the port's params.

The port's counterpart of the JAX package's ``checkpoint/hf.py``, with the
same explicit per-tensor mapping (:func:`mapping_specs`): every leaf of
the port's param tree names the HF tensor it comes from, the transform
that reshapes it and the exact shape it must produce. The files are read
by the port's own codec (``checkpoint/safetensors.py``).

Layout differences handled here:

* HF ``nn.Linear`` stores ``(out_features, in_features)``; the model's
  projections contract ``(in, out)`` — every projection transposes.
* GQA head packing: HF ``q_proj`` rows are ``[head0 | head1 | ...]`` with
  query head ``h`` reading KV head ``h // group_size`` (the ``repeat_kv``
  convention). The port's ``(d_model, KV, G, D)`` is exactly that
  grouping, so a reshape after the transpose is the whole transform.
* ``o_proj`` ``(d_model, H*D)`` transposes, then reshapes to
  ``(KV, G, D, d_model)``.
* RMSNorm placement: ``input_layernorm`` -> ``ln1`` (pre-attention),
  ``post_attention_layernorm`` -> ``ln2`` (pre-MLP); qwen3's per-head
  ``q_norm``/``k_norm`` land inside the attention params.
* Gated MLP: ``gate_proj`` -> ``w1``, ``up_proj`` -> ``w3``,
  ``down_proj`` -> ``w2``.
* Tied embeddings (``tie_word_embeddings``) have no ``lm_head.weight``;
  the tree then has no ``unembed`` entry.
* Biases (qwen2, ``attention_bias``): ``q_proj.bias`` -> ``bq``
  ``(KV, G, D)``, ``k_proj.bias`` / ``v_proj.bias`` -> ``bk`` / ``bv``
  ``(KV, D)``.
* Sharded checkpoints resolve through ``model.safetensors.index.json``;
  tensors are read one at a time, file by file.
* ``rope_scaling`` in ``config.json`` is ignored, as the reference
  ignores it; RoPE has no parameters, and non-parameter extras such as
  ``rotary_emb.inv_freq`` are ignored.

Per-layer tensors land in one preallocated ``(num_layers, ...)`` tensor
per leaf on the target device, layer by layer, so the loaded params are
the layout ``bridge.params_from_numpy`` gives and no stacked copy is ever
built beside them.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.safetensors import SafetensorsFile
from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.runtime import resolve_device, torch_dtype

INDEX_NAME = "model.safetensors.index.json"
SINGLE_NAME = "model.safetensors"


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One leaf of the port's tree: where it comes from and how it gets
    there."""

    hf_name: str
    # path inside the param tree, e.g. ("layers", "attn", "wq"); per-layer
    # specs carry their layer index separately and stack
    path: Tuple[str, ...]
    transform: str
    # the shape this spec must produce (per layer, without the stacked
    # leading L axis)
    shape: Tuple[int, ...]
    layer: Optional[int] = None


def _reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(shape)``; a size mismatch is a geometry mismatch
    (``ValueError``, as numpy raises in the reference)."""
    try:
        return t.reshape(shape)
    except RuntimeError as e:
        raise ValueError(f"cannot reshape tensor of shape {tuple(t.shape)} "
                         f"into shape {shape}: {e}") from None


def _t_identity(t: torch.Tensor, acfg: AttentionConfig, d_model: int):
    return t


def _t_linear(t: torch.Tensor, acfg: AttentionConfig, d_model: int):
    """HF Linear (out, in) -> (in, out)."""
    return t.T


def _t_q_proj(t: torch.Tensor, acfg: AttentionConfig, d_model: int):
    """(H*D, d_model) -> (d_model, KV, G, D)."""
    kv, g, d = acfg.num_kv_heads, acfg.group_size, acfg.head_dim
    return _reshape(t.T, d_model, kv, g, d)


def _t_kv_proj(t: torch.Tensor, acfg: AttentionConfig, d_model: int):
    """(KV*D, d_model) -> (d_model, KV, D)."""
    return _reshape(t.T, d_model, acfg.num_kv_heads, acfg.head_dim)


def _t_o_proj(t: torch.Tensor, acfg: AttentionConfig, d_model: int):
    """(d_model, H*D) -> (KV, G, D, d_model)."""
    kv, g, d = acfg.num_kv_heads, acfg.group_size, acfg.head_dim
    return _reshape(t.T, kv, g, d, d_model)


def _t_q_bias(t: torch.Tensor, acfg: AttentionConfig, d_model: int):
    """(H*D,) -> (KV, G, D)."""
    kv, g, d = acfg.num_kv_heads, acfg.group_size, acfg.head_dim
    return _reshape(t, kv, g, d)


def _t_kv_bias(t: torch.Tensor, acfg: AttentionConfig, d_model: int):
    """(KV*D,) -> (KV, D)."""
    return _reshape(t, acfg.num_kv_heads, acfg.head_dim)


TRANSFORMS: Dict[str, Callable[..., torch.Tensor]] = {
    "identity": _t_identity,
    "linear_t": _t_linear,
    "q_proj": _t_q_proj,
    "kv_proj": _t_kv_proj,
    "o_proj": _t_o_proj,
    "q_bias": _t_q_bias,
    "kv_bias": _t_kv_bias,
}


def mapping_specs(cfg: ModelConfig) -> List[TensorSpec]:
    """The full, explicit tensor mapping for ``cfg`` (dense llama/qwen
    geometry). Every leaf of the param tree appears exactly once."""
    acfg = cfg.attention
    assert acfg is not None, "HF ingestion covers attention models"
    m, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kv, g, d = acfg.num_kv_heads, acfg.group_size, acfg.head_dim
    specs = [TensorSpec("model.embed_tokens.weight", ("embed", "table"),
                        "identity", (v, m)),
             TensorSpec("model.norm.weight", ("ln_f",), "identity", (m,))]
    if not cfg.tie_embeddings:
        specs.append(TensorSpec("lm_head.weight", ("unembed", "table"),
                                "identity", (v, m)))
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        attn = pre + "self_attn."
        layer = [
            TensorSpec(pre + "input_layernorm.weight", ("layers", "ln1"),
                       "identity", (m,)),
            TensorSpec(pre + "post_attention_layernorm.weight",
                       ("layers", "ln2"), "identity", (m,)),
            TensorSpec(attn + "q_proj.weight", ("layers", "attn", "wq"),
                       "q_proj", (m, kv, g, d)),
            TensorSpec(attn + "k_proj.weight", ("layers", "attn", "wk"),
                       "kv_proj", (m, kv, d)),
            TensorSpec(attn + "v_proj.weight", ("layers", "attn", "wv"),
                       "kv_proj", (m, kv, d)),
            TensorSpec(attn + "o_proj.weight", ("layers", "attn", "wo"),
                       "o_proj", (kv, g, d, m)),
            TensorSpec(pre + "mlp.gate_proj.weight", ("layers", "ffn", "w1"),
                       "linear_t", (m, f)),
            TensorSpec(pre + "mlp.up_proj.weight", ("layers", "ffn", "w3"),
                       "linear_t", (m, f)),
            TensorSpec(pre + "mlp.down_proj.weight", ("layers", "ffn", "w2"),
                       "linear_t", (f, m)),
        ]
        if acfg.qk_norm:
            layer += [
                TensorSpec(attn + "q_norm.weight",
                           ("layers", "attn", "q_norm"), "identity", (d,)),
                TensorSpec(attn + "k_norm.weight",
                           ("layers", "attn", "k_norm"), "identity", (d,)),
            ]
        if acfg.qkv_bias:
            layer += [
                TensorSpec(attn + "q_proj.bias", ("layers", "attn", "bq"),
                           "q_bias", (kv, g, d)),
                TensorSpec(attn + "k_proj.bias", ("layers", "attn", "bk"),
                           "kv_bias", (kv, d)),
                TensorSpec(attn + "v_proj.bias", ("layers", "attn", "bv"),
                           "kv_bias", (kv, d)),
            ]
        specs.extend(dataclasses.replace(s, layer=i) for s in layer)
    return specs


# ---------------------------------------------------------------------------
# File resolution + tensor fetch
# ---------------------------------------------------------------------------


def resolve_tensor_files(path: str) -> Dict[str, str]:
    """{tensor name: safetensors file} for a checkpoint at ``path`` — a
    directory in HF layout (single ``model.safetensors`` or a sharded
    ``model.safetensors.index.json``) or a direct ``.safetensors`` file."""

    def names_in(fname: str) -> Dict[str, str]:
        with SafetensorsFile(fname) as f:
            return {name: fname for name in f.keys()}

    if os.path.isfile(path):
        return names_in(path)
    index = os.path.join(path, INDEX_NAME)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return {name: os.path.join(path, shard)
                for name, shard in weight_map.items()}
    single = os.path.join(path, SINGLE_NAME)
    if os.path.exists(single):
        return names_in(single)
    cands = (sorted(n for n in os.listdir(path) if n.endswith(".safetensors"))
             if os.path.isdir(path) else [])
    if len(cands) == 1:
        return names_in(os.path.join(path, cands[0]))
    raise FileNotFoundError(
        f"no HF safetensors checkpoint at {path!r} (expected {SINGLE_NAME}, "
        f"{INDEX_NAME}, or a single .safetensors file)")


def _leaf_name(spec: TensorSpec) -> str:
    return "/".join(spec.path) + (f"[{spec.layer}]" if spec.layer is not None
                                  else "")


def load_hf_checkpoint(path: str, cfg: ModelConfig, *, dtype=None,
                       device=None) -> dict:
    """Load an HF safetensors checkpoint into the port's param tree.

    ``dtype`` (a config dtype name or a torch dtype) defaults to
    ``cfg.param_dtype``; stored bf16 tensors are cast on load (the
    bf16 -> float32 widening is exact). ``device`` None is the CUDA card
    (raises without one); pass ``device="cpu"`` for the CPU. A missing
    tensor raises ``KeyError`` naming the tensor and the leaf it was meant
    to fill; a tensor whose transform gives the wrong shape raises
    ``ValueError`` (the checkpoint's geometry does not match ``cfg``).
    Returns the nested dicts ``model.init`` gives, every ``layers/...``
    leaf stacked over a leading layer axis.
    """
    acfg = cfg.attention
    dev = resolve_device(device)
    out_dtype = (dtype if isinstance(dtype, torch.dtype)
                 else torch_dtype(dtype or cfg.param_dtype))
    locations = resolve_tensor_files(path)
    specs = mapping_specs(cfg)
    by_file: Dict[str, List[TensorSpec]] = {}
    for spec in specs:
        fname = locations.get(spec.hf_name)
        if fname is None:
            raise KeyError(
                f"HF checkpoint at {path!r} is missing tensor "
                f"{spec.hf_name!r} (needed for port leaf "
                f"{_leaf_name(spec)!r}; {len(locations)} tensors present)")
        by_file.setdefault(fname, []).append(spec)

    tree: Dict[str, Any] = {}

    def node_of(tpath: Tuple[str, ...]) -> dict:
        node = tree
        for key in tpath[:-1]:
            node = node.setdefault(key, {})
        return node

    for fname, file_specs in sorted(by_file.items()):
        with SafetensorsFile(fname) as f:
            for spec in file_specs:
                t = TRANSFORMS[spec.transform](f.get_tensor(spec.hf_name),
                                               acfg, cfg.d_model)
                if tuple(t.shape) != tuple(spec.shape):
                    raise ValueError(
                        f"tensor {spec.hf_name!r} maps to shape "
                        f"{tuple(t.shape)}, expected {tuple(spec.shape)} for "
                        f"port leaf {'/'.join(spec.path)!r} — checkpoint "
                        f"geometry does not match config {cfg.name!r}")
                node, key = node_of(spec.path), spec.path[-1]
                if spec.layer is None:
                    node[key] = t.to(device=dev, dtype=out_dtype,
                                     copy=True).contiguous()
                    continue
                if key not in node:
                    node[key] = torch.empty((cfg.num_layers, *spec.shape),
                                            dtype=out_dtype, device=dev)
                node[key][spec.layer].copy_(t)
    return tree


# ---------------------------------------------------------------------------
# HF config.json -> ModelConfig
# ---------------------------------------------------------------------------

# model_type values this ingestion path understands (all dense
# llama-geometry decoders)
SUPPORTED_MODEL_TYPES = ("llama", "qwen2", "qwen3")


def config_from_hf(path: str, *, name: Optional[str] = None) -> ModelConfig:
    """A ``ModelConfig`` from an HF ``config.json`` (``path``: the file or
    its directory).

    Serving defaults, as in the reference: float32 params and activations.
    ``rope_scaling`` is ignored, as the reference ignores it.
    """
    cfg_path = (path if os.path.isfile(path)
                else os.path.join(path, "config.json"))
    with open(cfg_path) as f:
        hf = json.load(f)
    model_type = hf.get("model_type", "llama")
    if model_type not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"unsupported model_type {model_type!r} in {cfg_path!r} "
            f"(supported: {SUPPORTED_MODEL_TYPES})")
    heads = int(hf["num_attention_heads"])
    hidden = int(hf["hidden_size"])
    attention = AttentionConfig(
        num_heads=heads,
        num_kv_heads=int(hf.get("num_key_value_heads", heads)),
        head_dim=int(hf.get("head_dim", hidden // heads)),
        qk_norm=model_type == "qwen3",
        qkv_bias=bool(hf.get("attention_bias", model_type == "qwen2")),
        rope_theta=float(hf.get("rope_theta", 10000.0)))
    return ModelConfig(
        name=name or hf.get("_name_or_path", model_type),
        family="dense",
        num_layers=int(hf["num_hidden_layers"]),
        d_model=hidden,
        d_ff=int(hf["intermediate_size"]),
        vocab_size=int(hf["vocab_size"]),
        attention=attention,
        norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        dtype="float32",
        param_dtype="float32")
