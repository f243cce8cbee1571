"""Carry weights and projections from the JAX package into the port.

``params_from_numpy`` takes the JAX package's param tree with numpy leaves
(``jax.tree.map(np.asarray, params)``) and returns the port's params: the
same nested dicts and layouts (``wq (M, KV, G, D)``, ``wk/wv (M, KV, D)``,
``wo (KV, G, D, M)``, layers stacked on a leading axis) as tensors on
``device``. ``load_projections`` reads the ``aqua_projections.npz`` format
both packages write. An MoE layer's ``ffn`` carries ``router`` (d, E),
``w1``/``w3`` (E, d, f), ``w2`` (E, f, d) and, with shared experts,
``shared`` (a gated MLP) and ``shared_gate`` (d, 1); stacked (L, ...).
A VLM's tree adds ``patch_proj`` (``w`` (embed_dim, d)); an
encoder-decoder's is ``embed``, ``pos`` (max_positions, d), ``enc_layers``
(dense blocks), ``enc_ln``, ``dec_layers`` (blocks with ``xattn`` and its
norm ``ln_x``, an ungated MLP) and ``ln_f``, as JAX's ``EncDecLM`` makes it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.calibration import load_projections  # noqa: F401
from repro_torch.runtime import resolve_device


#: params that stay float32 whatever the param dtype (JAX draws the MoE
#: router in float32 and routes in float32)
FLOAT32_PARAMS = ("router",)


def params_from_numpy(tree, device=None, dtype=None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (None = the CUDA card), cast to ``dtype`` if given (the
    ``FLOAT32_PARAMS`` to float32)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(
                    v, dev, torch.float32 if dtype is not None
                    and k in FLOAT32_PARAMS else dtype)
                for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True)).to(dev)
    return t if dtype is None else t.to(dtype)
