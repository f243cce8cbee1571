"""Dense oracles for the kernels (port of ``kernels/ref.py``).

Both compute in float32. :func:`aqua_prefill_ref` takes the block selection
as given and keeps the selected q̂ dims, zeroing the others (masked-q
identity: zeroing unselected q̂ dims equals not reading the matching K̂
dim-blocks); :func:`flash_attention_ref` is dense causal / windowed GQA
attention. The decode kernel's oracle is its plain version,
``aqua_decode.aqua_decode_plain``, which also reads pages, int8 scales
and participation tables.
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D). Returns (B, H, S, D) in v's
    dtype: dense GQA attention in float32, scale 1/sqrt(D), the causal
    mask and optionally a sliding window ``kpos > qpos - window``."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qr = q.reshape(b, kvh, g, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qr, k.float()) / d ** 0.5
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return out.reshape(b, h, s, d).to(v.dtype)
