"""Masked-dense oracles for the AQUA kernels (port of ``kernels/ref.py``).

They take the block selection as given and compute in float32 with the
selected q̂ dims kept and the others zeroed (masked-q identity: zeroing
unselected q̂ dims equals not reading the matching K̂ dim-blocks).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _block_mask(block_idx: torch.Tensor, nb: int, block_dims: int
                ) -> torch.Tensor:
    """(..., NB_sel) selected block ids -> (..., NB*bd) 0/1 float mask."""
    sel = torch.zeros(*block_idx.shape[:-1], nb, device=block_idx.device)
    sel.scatter_(-1, block_idx.long(), 1.0)
    return sel.repeat_interleave(block_dims, dim=-1)


def aqua_decode_ref(q_hat: torch.Tensor, khat: torch.Tensor, v: torch.Tensor,
                    block_idx: torch.Tensor, lengths: torch.Tensor,
                    block_dims: int, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q_hat: (B, H, D); khat: (B, KV, S, D) seq-major; v: (B, KV, S, Dv);
    block_idx: (B, H, NB_sel); lengths: (B,). Returns (B, H, Dv) in v's
    dtype. ``scale`` defaults to 1/sqrt(D)."""
    b, h, d = q_hat.shape
    kvh, s = khat.shape[1], khat.shape[2]
    g = h // kvh
    if scale is None:
        scale = 1.0 / d ** 0.5
    mask = _block_mask(block_idx, d // block_dims, block_dims)
    qm = (q_hat.float() * mask).reshape(b, kvh, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qm, khat.float()) * scale
    valid = (torch.arange(s, device=khat.device)[None, :]
             < lengths.to(khat.device)[:, None])
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, v.float())
    return out.reshape(b, h, -1).to(v.dtype)


def aqua_prefill_ref(q_hat: torch.Tensor, khat: torch.Tensor, v: torch.Tensor,
                     block_idx: torch.Tensor, lengths: torch.Tensor,
                     block_dims: int, q_chunk: int, *, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q_hat: (B, H, S, D); khat: (B, KV, S, D); v: (B, KV, S, Dv);
    block_idx: (B, H, ceil(S / q_chunk), NB_sel); lengths: (B,). Every
    query of a chunk shares the chunk's block set. Returns (B, H, S, Dv)."""
    b, h, s, d = q_hat.shape
    kvh = khat.shape[1]
    g = h // kvh
    if scale is None:
        scale = 1.0 / d ** 0.5
    mask = _block_mask(block_idx, d // block_dims, block_dims)  # B,H,NQC,D
    mask = mask.repeat_interleave(q_chunk, dim=2)[:, :, :s]
    qm = (q_hat.float() * mask).reshape(b, kvh, g, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qm, khat.float()) * scale
    pos = torch.arange(s, device=khat.device)
    m = (pos[None, :] < lengths.to(khat.device)[:, None])[:, None, :]
    if causal:
        m = m & (pos[:, None] >= pos[None, :])[None]
    scores = torch.where(m[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return out.reshape(b, h, s, -1).to(v.dtype)
