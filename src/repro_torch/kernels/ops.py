"""Public AQUA attention ops: selection plus the kernel wrappers.

``flash_attention`` (and its oracle ``flash_attention_ref``) is re-exported
here as in the JAX package. ``aqua_decode`` / ``aqua_paged_decode`` /
``aqua_prefill`` take the model-layout tensors (seq-major K̂ cache, as the
JAX package's ops do), choose the dim-blocks by |q̂| and call the kernel
wrappers, which launch the CUDA kernels for CUDA tensors and run the plain
versions for CPU tensors. Unlike the JAX ops they never build the dim-major view of the
cache: the CUDA kernels read the selected blocks of the seq-major cache
directly (:func:`to_dim_major_blocks` is kept for tests and byte
accounting). The selection helpers :func:`decode_blocks` and
:func:`prefill_blocks` are shared with the attention backends, including
the reference backend that runs the plain versions on the card.

``kept`` (the selection helpers and ops): the real width of q̂ when the
stored K̂ is padded with zero columns past it (AQUA-Memory kept widths that
are not a multiple of 8, which the bf16 kernels need). The count of
selected dims is ``round_k_dims(kept, ...)`` and only the ``kept //
block_dims`` real blocks are ranked, so a padded block is never selected,
not even on a tie; the kernels then read padded q̂ and K̂ with the same
block indices. None means the whole width is real.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import aqua as aqua_lib
from repro_torch.kernels.aqua_decode import (aqua_decode_attention,
                                             aqua_paged_decode_attention)
from repro_torch.kernels.aqua_prefill import aqua_prefill_attention
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.ref import flash_attention_ref  # noqa: F401


def to_dim_major_blocks(khat: torch.Tensor, block_dims: int) -> torch.Tensor:
    """(B, KV, S, D) seq-major -> (B, KV, NB, bd, S) dim-major blocks."""
    b, kvh, s, d = khat.shape
    assert d % block_dims == 0, (d, block_dims)
    return khat.transpose(2, 3).reshape(b, kvh, d // block_dims, block_dims, s)


def round_k_dims(d: int, k_ratio: float, block_dims: int) -> int:
    """Kept-dim count for a k_ratio: rounded to the nearest dim count, then
    up to whole dim-blocks, clamped to [block_dims, d]."""
    k_dims = max(block_dims, int(round(k_ratio * d)))
    k_dims = ((k_dims + block_dims - 1) // block_dims) * block_dims
    return min(k_dims, d)


def block_counts(d: int, k_ratio: float, block_dims: int) -> tuple:
    """(NB_total, NB_sel) dim-block accounting for head dim ``d``."""
    return d // block_dims, round_k_dims(d, k_ratio, block_dims) // block_dims


def _i32(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def _real(q_hat: torch.Tensor, kept: Optional[int]) -> torch.Tensor:
    """The real (unpadded) dims of q̂: a view of its first ``kept``."""
    return q_hat if kept is None else q_hat[..., :kept]


def decode_blocks(q_hat: torch.Tensor, k_ratio: float, block_dims: int,
                  kept: Optional[int] = None) -> torch.Tensor:
    """Decode selection: (B, H, NB_sel) int32 dim-blocks by |q̂| among
    the real blocks."""
    q = _real(q_hat, kept)
    return aqua_lib.topk_block_indices(
        q, round_k_dims(q.shape[-1], k_ratio, block_dims),
        block_dims).contiguous()


def prefill_blocks(q_hat: torch.Tensor, lengths: Optional[torch.Tensor],
                   k_ratio: float, block_dims: int, q_blk: int,
                   kept: Optional[int] = None) -> tuple:
    """Prefill selection: queries are taken in chunks of ``q_blk``
    (clamped to the sequence, rounded up to 8); each chunk shares the
    dim-blocks selected from its summed |q̂| over valid rows, among the
    real blocks.

    Returns (block_idx (B, H, NQC, NB_sel) int32, lengths (B,) int32 —
    all full when None —, the chunk size used)."""
    q_hat = _real(q_hat, kept)
    b, h, s, d = q_hat.shape
    dev = q_hat.device
    lengths = (torch.full((b,), s, dtype=torch.int32, device=dev)
               if lengths is None else _i32(lengths, dev))
    q_blk = min(q_blk, aqua_lib.ceil_to(s, 8))
    pad = aqua_lib.ceil_to(s, q_blk) - s
    qsel = F.pad(q_hat, (0, 0, 0, pad)) if pad else q_hat
    block_idx = aqua_lib.chunk_topk_block_indices(
        qsel, round_k_dims(d, k_ratio, block_dims), block_dims, q_blk,
        lengths).contiguous()
    return block_idx, lengths, q_blk


def aqua_decode(q_hat: torch.Tensor, khat: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, *, k_ratio: float = 0.75,
                block_dims: int = 8, scale: Optional[float] = None,
                kept: Optional[int] = None) -> torch.Tensor:
    """AQUA decode attention over a contiguous cache (selection + kernel).

    q_hat (B, H, D); khat (B, KV, S, D) seq-major; v (B, KV, S, Dv);
    lengths (B,). Returns (B, H, Dv)."""
    return aqua_decode_attention(
        q_hat.contiguous(), khat, v,
        decode_blocks(q_hat, k_ratio, block_dims, kept),
        _i32(lengths, q_hat.device), block_dims=block_dims, scale=scale)


def aqua_paged_decode(q_hat: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, page_table: torch.Tensor,
                      lengths: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      part_idx: Optional[torch.Tensor] = None,
                      block_idx: Optional[torch.Tensor] = None, *,
                      k_ratio: float = 0.75, block_dims: int = 8,
                      scale: Optional[float] = None,
                      kept: Optional[int] = None) -> torch.Tensor:
    """AQUA decode attention over a page pool.

    q_hat (B, H, D); k_pool (P, KV, ps, D); v_pool (P, KV, ps, Dv);
    page_table (B, NP) int32 (-1 unmapped); lengths (B,). k_scale /
    v_scale (P, SH) float32 for int8 pools (output float32). part_idx
    (B, KP): hierarchical AQUA's participating logical pages per lane, or
    None for all pages. block_idx: a precomputed (B, H, NB_sel) dim-block
    selection, or None to select here from |q̂|."""
    dev = q_hat.device
    if block_idx is None:
        block_idx = decode_blocks(q_hat, k_ratio, block_dims, kept)

    def f32(x):
        return None if x is None else x.to(device=dev,
                                           dtype=torch.float32).contiguous()
    return aqua_paged_decode_attention(
        q_hat.contiguous(), k_pool, v_pool, _i32(block_idx, dev),
        _i32(page_table, dev), _i32(lengths, dev), block_dims=block_dims,
        scale=scale, k_scale=f32(k_scale), v_scale=f32(v_scale),
        part_idx=None if part_idx is None else _i32(part_idx, dev))


def aqua_prefill(q_hat: torch.Tensor, khat: torch.Tensor, v: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None, *,
                 k_ratio: float = 0.75, block_dims: int = 8,
                 q_blk: int = 128, causal: bool = True,
                 window: Optional[int] = None,
                 scale: Optional[float] = None,
                 kept: Optional[int] = None,
                 prefill_fn=aqua_prefill_attention) -> torch.Tensor:
    """AQUA block-sparse prefill attention (selection: :func:`prefill_blocks`)
    through ``prefill_fn`` (the kernel wrapper, or its plain version).

    q_hat (B, H, S, D); khat (B, KV, S, D); v (B, KV, S, Dv) — views of any
    strides with a contiguous last axis; lengths (B,) (None = all full);
    ``window``: keys ``kpos > qpos - window`` only (sliding-window models).
    Returns (B, H, S, Dv); rows at or past a row's length attend every
    valid key, as the Pallas kernel's (an MoE routes them).
    """
    block_idx, lengths, q_blk = prefill_blocks(q_hat, lengths, k_ratio,
                                               block_dims, q_blk, kept)
    return prefill_fn(q_hat, khat, v, block_idx, lengths,
                      block_dims=block_dims, q_blk=q_blk, causal=causal,
                      scale=scale, window=window)


def aqua_prefill_chunk(q_hat: torch.Tensor, khat: torch.Tensor,
                       v: torch.Tensor, lengths: torch.Tensor, *,
                       q_offset: int,
                       mag_state: Optional[torch.Tensor] = None,
                       k_ratio: float = 0.75, block_dims: int = 8,
                       q_blk: int = 128, causal: bool = True,
                       scale: Optional[float] = None,
                       kept: Optional[int] = None,
                       prefill_fn=aqua_prefill_attention) -> tuple:
    """Chunk-resumable AQUA prefill: attention of query rows [q_offset,
    q_offset + T) against the key stripe [0, S), through ``prefill_fn``
    (the kernel wrapper, or its plain version for the plain backend).

    Selection tiles anchor at the chunk's first row, so when every chunk
    boundary is a ``q_blk`` multiple the chunks select the monolithic
    call's dim-blocks and walk its key tiles. A chunk ending mid-tile
    returns that tile's |q̂| aggregate as ``carry``; passed to the next
    chunk as ``mag_state`` it is added to that chunk's first tile.

    q_hat (B, H, T, D) this chunk's queries; khat (B, KV, S, D) and v (B,
    KV, S, Dv) covering at least rows [0, q_offset + T); lengths (B,)
    valid *sequence* lengths (global positions: the key mask and the |q̂|
    aggregation use them); mag_state (B, H, NB_total) float32 or None.
    Returns (out (B, H, T, Dv), carry (B, H, NB_total) float32: the
    trailing tile's aggregate when T % q_blk != 0, else zeros)."""
    b, h, t, _ = q_hat.shape
    assert 0 <= q_offset and q_offset + t <= khat.shape[2], \
        (q_offset, t, khat.shape)
    d = q_hat.shape[-1] if kept is None else kept
    dev = q_hat.device
    lengths = _i32(lengths, dev)
    q_blk = min(q_blk, aqua_lib.ceil_to(t, 8))
    tpad = aqua_lib.ceil_to(t, q_blk)
    nqc, nb = tpad // q_blk, d // block_dims
    kb = round_k_dims(d, k_ratio, block_dims) // block_dims
    # the same aggregation as chunk_topk_block_indices over the real
    # blocks, masked by global positions and carrying the previous
    # chunk's partial leading tile
    mag = F.pad(_real(q_hat, kept).float().abs(), (0, 0, 0, tpad - t))
    row = torch.arange(tpad, device=dev)
    valid = (row[None, :] < t) & (q_offset + row[None, :] < lengths[:, None])
    mag = mag * valid[:, None, :, None]
    bmag = mag.reshape(b, h, nqc, q_blk, nb, block_dims).sum(dim=(3, 5))
    if mag_state is not None:
        bmag[:, :, 0] += mag_state.to(dev, torch.float32)
    carry = (bmag[:, :, -1].clone() if t % q_blk
             else torch.zeros(b, h, nb, device=dev))
    block_idx = torch.sort(aqua_lib.topk_indices(bmag, kb), dim=-1)[0]
    out = prefill_fn(q_hat, khat, v, _i32(block_idx, dev), lengths,
                     block_dims=block_dims, q_blk=q_blk, causal=causal,
                     scale=scale, q_offset=q_offset)
    return out, carry
