"""Two-stage hierarchical selection (port of ``core/selection.py``).

Stage 1 (token sparsity, page-granular) ranks a lane's pages by the H2O
accumulated attention mass of the paged pool (``PagedAttnCache.acc_pool``)
and keeps the top ``kept_pages`` as *participants*; stage 2 is AQUA's
per-query |q̂| dim-block top-k (``core.aqua``), applied within them. The
decode kernel walks only the participating pages, so dropped pages cost no
bytes.

Ranking semantics (shared with the JAX package and its numpy oracle):

* page mass = per-lane sum of the page's ``acc_pool`` scores, gathered
  through the lane's own page table; unmapped entries score 0;
* the trailing ``pin_recent_pages`` pages up to the one holding position
  ``count - 1`` rank ``+inf`` (recency pin);
* logical pages beyond that tail rank ``-inf``;
* ties resolve to the lowest page index (``jax.lax.top_k`` order). The
  serving path keeps no H2O statistics, so every score is 0 there and the
  ranking is the attention sink (earliest pages) plus the pinned tail —
  ties decide everything. ``torch.topk`` promises no order among ties, so
  the ranking is a stable descending sort;
* the participating set is sorted ascending, so a full keep is the
  identity.

:func:`chunk_participating_tiles` is the prefill twin: per q-tile
participating key chunks for the prefill kernel's ``kc_part`` walk, with
the diagonal pinned and the same tie rule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import aqua as aqua_lib


@dataclass
class SelectionPlan:
    """One decode step's resolved two-stage selection: ``block_idx``
    (B, H, NB_sel) int32 stage-2 dim-blocks, and ``pages`` (B, KP) int32
    stage-1 participating logical pages (sorted), or None when every page
    participates."""

    block_idx: torch.Tensor
    pages: Optional[torch.Tensor] = None


def page_scores(acc_pool: torch.Tensor, page_table: torch.Tensor,
                tp=None) -> torch.Tensor:
    """Per-lane page mass: (P, KV, ps) pool x (B, NP) table -> (B, NP).
    ``tp`` (``distributed.layout.MeshLayout``): on a mesh whose ``model``
    axis shards the KV heads, the mass over every head."""
    score = acc_pool[page_table.long().clamp(min=0)].sum(dim=(2, 3))
    if tp is not None:
        score = tp.sum_heads(score)
    return torch.where(page_table >= 0, score, torch.zeros_like(score))


def participating_pages(acc_pool: torch.Tensor, page_table: torch.Tensor,
                        count: torch.Tensor, *, page_size: int,
                        kept_pages: int, pin_recent_pages: int,
                        tp=None) -> torch.Tensor:
    """Stage-1 selection: (B, kept_pages) int32 logical page indices,
    sorted ascending (see the module docstring). ``count`` (B,) is the
    lane's token count: the page holding ``count - 1`` anchors the pin.
    ``tp``: as :func:`page_scores`'."""
    npl = page_table.shape[1]
    score = page_scores(acc_pool, page_table, tp)             # (B, NP)
    pidx = torch.arange(npl, device=score.device)[None, :]
    tail = ((count.long()[:, None] - 1) // page_size).clamp(min=0)
    pinned = (pidx > tail - pin_recent_pages) & (pidx <= tail)
    score = torch.where(pinned, torch.full_like(score, float("inf")), score)
    score = torch.where(pidx > tail, torch.full_like(score, -float("inf")),
                        score)
    top = torch.sort(score, dim=-1, descending=True, stable=True)[1]
    return torch.sort(top[:, :kept_pages], dim=-1)[0].to(torch.int32)


def reference_participating_pages(acc_pool, page_table, count, *,
                                  page_size: int, kept_pages: int,
                                  pin_recent_pages: int) -> np.ndarray:
    """Numpy twin of :func:`participating_pages` (the page-ranking
    oracle): the same ranking, pin, tie and sort rules, host-side."""
    acc = np.asarray(acc_pool)
    table = np.asarray(page_table)
    cnt = np.asarray(count)
    b, npl = table.shape
    out = np.zeros((b, kept_pages), np.int32)
    pidx = np.arange(npl)
    for i in range(b):
        score = acc[np.maximum(table[i], 0)].sum(axis=(1, 2),
                                                 dtype=np.float32)
        score[table[i] < 0] = 0.0
        tail = max((int(cnt[i]) - 1) // page_size, 0)
        score[(pidx > tail - pin_recent_pages) & (pidx <= tail)] = np.inf
        score[pidx > tail] = -np.inf
        out[i] = np.sort(np.argsort(-score, kind="stable")[:kept_pages])
    return out


def build_decode_plan(q_hat: torch.Tensor, cache, *, topk_dims: int,
                      block_dims: int, kept_pages: Optional[int] = None,
                      pin_recent_pages: int = 2,
                      kept: Optional[int] = None, tp=None) -> SelectionPlan:
    """One decode step's :class:`SelectionPlan`. q_hat (B, H, Dk)
    projected queries; ``cache`` a single-layer ``PagedAttnCache``.
    ``topk_dims`` selected dims (``AquaConfig.topk_dims``) among the first
    ``kept`` dims of q̂ (None: all of them; the rest is zero padding, never
    selected). ``kept_pages`` None (or the full page count) disables
    stage 1. ``tp``: as :func:`page_scores`'."""
    real = q_hat if kept is None else q_hat[..., :kept]
    block_idx = aqua_lib.topk_block_indices(real, topk_dims, block_dims)
    pages = None
    if kept_pages is not None and kept_pages < cache.pages_per_lane:
        pages = participating_pages(
            cache.acc_pool, cache.page_table, cache.count,
            page_size=cache.page_size, kept_pages=kept_pages,
            pin_recent_pages=pin_recent_pages, tp=tp)
    return SelectionPlan(block_idx=block_idx, pages=pages)


def participation_slot_mask(pages: torch.Tensor, *, page_size: int,
                            num_slots: int) -> torch.Tensor:
    """(B, KP) participating pages -> (B, S_log) bool slot mask: the
    masked-dense reference's view of stage 1."""
    npl = num_slots // page_size
    hit = (torch.arange(npl, device=pages.device)[None, :, None]
           == pages[:, None, :]).any(-1)                       # (B, NP)
    return hit.repeat_interleave(page_size, dim=1)


def chunk_participating_tiles(scores: torch.Tensor, *, nqc: int, q_blk: int,
                              k_blk: int, kept_tiles: int,
                              pin_tiles: int = 1,
                              q_offset: int = 0) -> torch.Tensor:
    """The q-tile analogue of :func:`participating_pages`, for the prefill
    kernel's participating walk (``kc_part``).

    ``scores`` (B, NKC): per-key-chunk mass (zeros degrade to the sink
    plus the diagonal). For each of the ``nqc`` q-tiles (rows [q_offset +
    i·q_blk, q_offset + (i+1)·q_blk)) the ``pin_tiles`` key chunks up to
    the one holding the tile's last row rank ``+inf`` and chunks past it
    ``-inf`` (the kernel's causal skip drops them anyway). Ranking is a
    stable descending sort, lower index first among ties, as
    ``jax.lax.top_k``. Returns (B, nqc, kept_tiles) int32, sorted
    ascending per q-tile."""
    b, nkc = scores.shape
    dev = scores.device
    diag = (q_offset + (torch.arange(nqc, device=dev) + 1) * q_blk - 1
            ) // k_blk
    tidx = torch.arange(nkc, device=dev)[None, None, :]
    d = diag[None, :, None]
    s = scores.float()[:, None, :].expand(b, nqc, nkc)
    s = torch.where((tidx > d - pin_tiles) & (tidx <= d),
                    torch.full_like(s, float("inf")), s)
    s = torch.where(tidx > d, torch.full_like(s, -float("inf")), s)
    top = aqua_lib.topk_indices(s, kept_tiles)
    return torch.sort(top, dim=-1)[0].to(torch.int32)
