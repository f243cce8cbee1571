"""Carry weights and projections from the JAX package into the port.

``params_from_numpy`` takes the JAX package's param tree with numpy leaves
(``jax.tree.map(np.asarray, params)``) and returns the port's params: the
same nested dicts and layouts (``wq (M, KV, G, D)``, ``wk/wv (M, KV, D)``,
``wo (KV, G, D, M)``, layers stacked on a leading axis) as tensors on
``device``. ``load_projections`` reads the ``aqua_projections.npz`` format
both packages write.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.calibration import load_projections  # noqa: F401
from repro_torch.runtime import resolve_device


def params_from_numpy(tree, device=None, dtype=None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (None = the CUDA card), cast to ``dtype`` if given."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True)).to(dev)
    return t if dtype is None else t.to(dtype)
