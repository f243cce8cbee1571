"""AQUA core primitives (paper §4, §6, §7) in PyTorch.

* offline SVD projection (per GQA group), via eigh of the Gram matrix;
* dynamic magnitude-based dim-block selection (per query, or per query
  chunk for the prefill kernel).

Tie-break: ``jax.lax.top_k`` keeps the lower index among equal values and
``torch.topk`` promises no order, so selection here is a *stable*
descending sort truncated to k — equal magnitudes resolve to the lower
index exactly as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch


def compute_projection(d_calib: torch.Tensor) -> torch.Tensor:
    """SVD of the calibration matrix; returns P = V (d_head × d_head).

    ``d_calib``: (M, d_head) stacked query+key activations for one layer /
    GQA group. Right singular vectors via eigh of the Gram matrix, columns
    in descending-variance order. Columns are defined up to sign.
    """
    d_calib = d_calib.float()
    gram = d_calib.T @ d_calib
    eigval, eigvec = torch.linalg.eigh(gram)
    order = torch.argsort(eigval, descending=True, stable=True)
    return eigvec[:, order]


def ceil_to(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n``."""
    return -(-n // m) * m


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, lower index
    first among ties (``jax.lax.top_k`` order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def magnitude_mask(q_hat: torch.Tensor, k_dims: int, *,
                   block_dims: int = 1) -> torch.Tensor:
    """0/1 mask over the last axis keeping the top-``k_dims`` dims by |q̂|,
    quantized to whole blocks of ``block_dims`` dims when > 1."""
    d = q_hat.shape[-1]
    if k_dims >= d:
        return torch.ones_like(q_hat)
    mag = q_hat.float().abs()
    if block_dims == 1:
        idx = topk_indices(mag, k_dims)
        return torch.zeros_like(mag).scatter_(-1, idx, 1.0).to(q_hat.dtype)
    assert d % block_dims == 0 and k_dims % block_dims == 0, \
        (d, k_dims, block_dims)
    nb, kb = d // block_dims, k_dims // block_dims
    bmag = mag.reshape(*mag.shape[:-1], nb, block_dims).sum(-1)
    bmask = torch.zeros_like(bmag).scatter_(-1, topk_indices(bmag, kb), 1.0)
    return bmask.repeat_interleave(block_dims, dim=-1).to(q_hat.dtype)


def topk_block_indices(q_hat: torch.Tensor, k_dims: int,
                       block_dims: int) -> torch.Tensor:
    """Selected dim-block indices (sorted ascending, int32); the last
    axis of the result has ``k_dims // block_dims`` entries."""
    d = q_hat.shape[-1]
    assert d % block_dims == 0 and k_dims % block_dims == 0
    nb, kb = d // block_dims, k_dims // block_dims
    mag = q_hat.float().abs()
    bmag = mag.reshape(*mag.shape[:-1], nb, block_dims).sum(-1)
    return torch.sort(topk_indices(bmag, kb), dim=-1)[0].to(torch.int32)


def chunk_topk_block_indices(q_hat: torch.Tensor, k_dims: int,
                             block_dims: int, q_chunk: int,
                             lengths: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Per-query-*chunk* dim-block selection for the prefill kernel: |q̂|
    block magnitudes are summed over each ``q_chunk`` queries before the
    top-k, rows at or past ``lengths`` excluded.

    q_hat: (B, H, S, D) with S a multiple of ``q_chunk``;
    returns (B, H, S // q_chunk, k_dims // block_dims) int32, sorted.
    """
    b, h, s, d = q_hat.shape
    assert s % q_chunk == 0, (s, q_chunk)
    assert d % block_dims == 0 and k_dims % block_dims == 0, \
        (d, k_dims, block_dims)
    nb, kb = d // block_dims, k_dims // block_dims
    mag = q_hat.float().abs()
    if lengths is not None:
        valid = (torch.arange(s, device=q_hat.device)[None, :]
                 < lengths.to(q_hat.device)[:, None])
        mag = mag * valid[:, None, :, None]
    bmag = mag.reshape(b, h, s // q_chunk, q_chunk, nb, block_dims
                       ).sum(dim=(3, 5))
    return torch.sort(topk_indices(bmag, kb), dim=-1)[0].to(torch.int32)


def stored_dims(aqua, head_dim: int) -> int:
    """Width of the stored (cached) K̂ and of q̂ under AQUA: the kept dims
    (``aqua.kept_dims``), padded with zero columns up to a multiple of 8
    where the selection is by whole dim-blocks of them — the bf16 kernels
    copy 16-byte pieces, and a zero column adds exactly 0 to every score.
    Other kept widths (per-dim selection, or blocks that do not tile the
    kept dims) run the masked-dense paths and stay unpadded."""
    kept = aqua.kept_dims(head_dim)
    if aqua.block_dims > 1 and kept % aqua.block_dims == 0:
        return ceil_to(kept, 8)
    return kept


def stored_projection(p: torch.Tensor, aqua, head_dim: int) -> torch.Tensor:
    """A projection (…, D, D) cut to its kept columns and padded with zero
    columns to :func:`stored_dims`: (…, D, width). Projected once with it,
    q̂ and K̂ come out in stored form with exact zeros in the padding."""
    kept, width = aqua.kept_dims(head_dim), stored_dims(aqua, head_dim)
    return torch.nn.functional.pad(p[..., :kept], (0, width - kept))


def project(x: torch.Tensor, p: Optional[torch.Tensor]) -> torch.Tensor:
    """q̂ = q P (runtime path, used when RoPE prevents folding)."""
    if p is None:
        return x
    return x @ p.to(x.dtype)
