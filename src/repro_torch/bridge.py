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
A Mamba-2's ``layers`` are stacked SSD blocks; a hybrid's are a list of
per-layer dicts (recurrent and attention blocks), as in JAX.

On a serving mesh ``params_from_numpy(..., mesh=)`` places this rank's
blocks (``distributed.sharding.param_pspec``): each array (or host
tensor) is cut on the host before it is copied, so a whole sharded
tensor never lands on the device. It is the one way weights reach a
mesh's ranks: the serving engine on a mesh takes the rank's blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.calibration import load_projections  # noqa: F401
from repro_torch.runtime import resolve_device


#: params that stay float32 whatever the param dtype, as JAX draws them:
#: the MoE router (it routes in float32), the RG-LRU's gates ``wr``, ``wi``
#: and ``lam``, and Mamba-2's ``a_log``, ``dt_bias`` and ``d_skip``
FLOAT32_PARAMS = ("router", "wr", "wi", "lam", "a_log", "dt_bias", "d_skip")


def params_from_numpy(tree, device=None, dtype=None, mesh=None):
    """Nested dicts (and lists: a hybrid's per-layer params) of numpy
    arrays or host tensors -> the same dicts and lists of tensors on
    ``device`` (None = the CUDA card), cast to ``dtype`` if given (the
    ``FLOAT32_PARAMS`` to float32). ``mesh``: this rank's blocks only, by
    ``param_pspec`` of each leaf's path and (global) shape, cut on the
    host."""
    return _to_tensors(tree, resolve_device(device), dtype, mesh, ())


def _to_tensors(tree, dev, dtype, mesh, path):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, dev, torch.float32 if dtype is not None
                               and k in FLOAT32_PARAMS else dtype, mesh,
                               path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, dev, dtype, mesh, path + (str(i),))
                for i, v in enumerate(tree)]
    arr = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    if mesh is not None:
        from repro_torch.distributed import sharding as dsh
        arr = dsh.shard(arr, dsh.param_pspec(path, tuple(arr.shape), mesh),
                        mesh)
    if isinstance(arr, torch.Tensor):
        t = arr.to(dev, copy=True)
    else:
        t = torch.from_numpy(np.array(arr, copy=True)).to(dev)
    return t if dtype is None else t.to(dtype)
