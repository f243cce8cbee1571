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


def _block_mask(block_idx: torch.Tensor, d: int, block_dims: int
                ) -> torch.Tensor:
    """(..., NB_sel) selected block ids -> (..., d) 0/1 float mask over the
    d dims (a tail narrower than a block is never selected)."""
    nb = d // block_dims
    sel = torch.zeros(*block_idx.shape[:-1], nb, device=block_idx.device)
    sel.scatter_(-1, block_idx.long(), 1.0)
    mask = sel.repeat_interleave(block_dims, dim=-1)
    return torch.nn.functional.pad(mask, (0, d - nb * block_dims))


def aqua_prefill_ref(q_hat: torch.Tensor, khat: torch.Tensor, v: torch.Tensor,
                     block_idx: torch.Tensor, lengths: torch.Tensor,
                     block_dims: int, q_chunk: int, *, causal: bool = True,
                     scale: Optional[float] = None, q_offset: int = 0,
                     kc_part: Optional[torch.Tensor] = None,
                     k_blk: int = 128,
                     window: Optional[int] = None) -> torch.Tensor:
    """q_hat: (B, H, T, D) queries at sequence rows [q_offset, q_offset +
    T); khat: (B, KV, S, D); v: (B, KV, S, Dv); block_idx: (B, H,
    ceil(T / q_chunk), NB_sel); lengths: (B,). Every query of a
    (chunk-local) q_chunk tile shares the tile's block set. kc_part (B,
    ceil(T / q_chunk), KT): a key attends only when its ``k_blk`` chunk is
    in its query tile's list. ``window``: only keys ``kpos > qpos -
    window`` (causal or not). Returns (B, H, T, Dv)."""
    b, h, t, d = q_hat.shape
    kvh, s = khat.shape[1], khat.shape[2]
    g = h // kvh
    dev = khat.device
    if scale is None:
        scale = 1.0 / d ** 0.5
    mask = _block_mask(block_idx, d, block_dims)             # B,H,NQC,D
    mask = mask.repeat_interleave(q_chunk, dim=2)[:, :, :t]
    qm = (q_hat.float() * mask).reshape(b, kvh, g, t, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qm, khat.float()) * scale
    qpos = q_offset + torch.arange(t, device=dev)
    kpos = torch.arange(s, device=dev)
    m = (kpos[None, :] < lengths.to(dev)[:, None])[:, None, :]   # (B, 1, S)
    if causal:
        m = m & (qpos[:, None] >= kpos[None, :])[None]
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)[None]
    if kc_part is not None:
        nkc = -(-s // k_blk)
        part = torch.zeros(b, kc_part.shape[1], nkc + 1, dtype=torch.bool,
                           device=dev)                  # column nkc: -1 pads
        cols = torch.where(kc_part >= 0, kc_part.long(),
                           torch.full_like(kc_part.long(), nkc))
        part.scatter_(-1, cols.to(dev), True)
        rows = part[:, torch.arange(t, device=dev) // q_chunk]   # (B,T,NKC+1)
        m = m & rows[:, :, kpos // k_blk]
    scores = torch.where(m[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return out.reshape(b, h, t, -1).to(v.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None,
                        lengths: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D). Returns (B, H, S, D) in v's
    dtype: dense GQA attention in float32, scale 1/sqrt(D), the causal
    mask, optionally a sliding window ``kpos > qpos - window`` and keys
    ``kpos < lengths[b]`` only (rows at or past a length see every valid
    key, as JAX's dense reference with lengths)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qr = q.reshape(b, kvh, g, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qr, k.float()) / d ** 0.5
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones(1, s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if lengths is not None:
        mask = mask & (kpos < lengths.to(q.device)[:, None, None])
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return out.reshape(b, h, s, d).to(v.dtype)
