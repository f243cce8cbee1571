"""Offline AQUA calibration (paper §6.1) in the port.

Run the model over a calibration corpus, capture post-RoPE query and key
activations per layer and GQA group, and compute the per-group SVD
projections P: ``AquaProjections.p`` (num_layers, num_kv_heads, D, D).
The Gram matrices accumulate in float64 on the host and the
eigendecomposition is numpy's, exactly as in the JAX package, so the same
captured activations give bit-identical projections in both packages.
Saved and loaded as ``.npz`` (key ``p``), the JAX package's format.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import resolve_device


@dataclass
class AquaProjections:
    """p: (num_layers, num_kv_heads, d_head, d_head) float32 tensor."""

    p: torch.Tensor


def identity_projections(num_layers: int, num_kv: int, d: int,
                         device=None) -> AquaProjections:
    eye = torch.eye(d, device=resolve_device(device))
    return AquaProjections(p=eye.expand(num_layers, num_kv, d, d).clone())


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


def capture_forward(model) -> Callable:
    """The ``forward_with_capture`` of a port model for numpy batches:
    every array of the batch (the tokens and a frontend's inputs) onto the
    model's device, then ``model.forward(..., capture=True)``'s aux (an
    encoder-decoder's: its decoder's self-attention q/k)."""
    def fwd(params, batch):
        inputs = {k: torch.from_numpy(np.asarray(v)).to(model.device)
                  for k, v in batch.items()}
        return model.forward(params, inputs, capture=True)[1]
    return fwd


def calibrate(forward_with_capture: Callable, params, batches: Iterable,
              cfg: ModelConfig, max_vectors: int = 16384,
              device=None) -> AquaProjections:
    """Compute projections from captured activations.

    ``forward_with_capture(params, batch) -> aux`` returns ``aux["qk"]``: a
    list over the attention layers of (q (B, S, KV, G, D), k (B, S, KV,
    D)) — tensors or arrays; a hybrid captures only its
    ``num_attn_layers`` attention layers, so its projections are per
    attention layer, as in JAX. Returns the projections on ``device``
    (None = the CUDA card).
    """
    acfg = cfg.attention
    assert acfg is not None, "calibration needs an attention model"
    d, kvh = acfg.head_dim, acfg.num_kv_heads
    grams = None
    seen = 0
    for batch in batches:
        if seen >= max_vectors:
            break
        qks = forward_with_capture(params, batch)["qk"]
        if grams is None:
            grams = np.zeros((len(qks), kvh, d, d), np.float64)
        for li, (q, k) in enumerate(qks):
            b, s = q.shape[0], q.shape[1]
            qm = _f64(q).reshape(b * s, kvh, -1, d)
            km = _f64(k).reshape(b * s, kvh, d)
            for h in range(kvh):
                dmat = np.concatenate([qm[:, h].reshape(-1, d), km[:, h]],
                                      axis=0)
                grams[li, h] += dmat.T @ dmat
            seen_batch = b * s
        seen += seen_batch
    assert grams is not None, "no calibration batches supplied"
    p = np.zeros(grams.shape, np.float32)
    for li in range(grams.shape[0]):
        for h in range(kvh):
            _, eigvec = np.linalg.eigh(grams[li, h])
            p[li, h] = eigvec[:, ::-1]  # descending variance
    return AquaProjections(p=torch.from_numpy(p).to(resolve_device(device)))


def save_projections(path: str, proj: AquaProjections) -> None:
    with open(path, "wb") as f:
        np.savez(f, p=proj.p.detach().cpu().numpy())


def load_projections(path: str, device=None) -> AquaProjections:
    """Load an ``aqua_projections.npz`` written by either package."""
    with np.load(path) as f:
        return AquaProjections(
            p=torch.from_numpy(np.asarray(f["p"], np.float32)).to(
                resolve_device(device)))
