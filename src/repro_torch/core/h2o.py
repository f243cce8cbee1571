"""H2O heavy-hitter token eviction (Zhang et al., 2023) and its AQUA
coupling (paper §8.3) — port of the JAX package's ``core/h2o.py``.

The slot mechanics live in :mod:`repro_torch.core.kvcache`
(``select_slot`` / ``paged_select_slot`` / ``accumulate_h2o``); this
module holds the policy-level API: the budget, the victim decision of one
step, and the numpy oracles the tests hold the online policy against.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import AquaConfig
from repro_torch.core import kvcache as kv


def h2o_budget(aqua: Optional[AquaConfig], max_seq: int) -> Optional[int]:
    """H2O cache budget in slots, or None when eviction is off."""
    if aqua is None or not aqua.enabled or aqua.h2o_ratio >= 1.0:
        return None
    return max(8, int(aqua.h2o_ratio * max_seq))


def recent_len(aqua: AquaConfig, num_slots: int) -> int:
    """Slots of the budget reserved for the most recent tokens."""
    return max(1, int(aqua.h2o_recent_frac * num_slots))


def reference_keep_set(weights: np.ndarray, budget: int,
                       recent_frac: float) -> np.ndarray:
    """Oracle H2O keep-set from a full (S_q, S_k) attention-weight matrix
    (one head): the ``recent`` last positions plus the heaviest of the
    rest by accumulated column mass (lower index first among ties, as
    ``jax.lax.top_k``). Returns the sorted kept indices, ``budget`` many."""
    w = np.asarray(weights, np.float32)
    s = w.shape[-1]
    recent = max(1, int(recent_frac * budget))
    acc = w.sum(axis=0)
    acc[s - recent:] = np.inf
    order = np.argsort(-acc, kind="stable")
    return np.sort(order[:budget])


def eviction_step(cache: kv.AttnCache, aqua: AquaConfig) -> torch.Tensor:
    """The victim-slot decision of the next insert (B,), for inspection."""
    return kv.select_slot(cache, window=None, h2o=True,
                          recent_len=recent_len(aqua, cache.num_slots))


def reference_victim_page(positions, acc_score, count, *, page_size: int,
                          recent_len: int, window=None) -> int:
    """NumPy oracle of the paged H2O victim-page decision (one lane).

    positions (S,) logical-slot positions (-1 empty); acc_score (KV, S);
    count: position of the incoming token. Returns the logical page that
    ``kvcache.paged_select_slot`` must evict, or -1 when an empty slot
    exists (no eviction)."""
    pos = np.asarray(positions)
    acc = np.asarray(acc_score, np.float32)
    npl = pos.shape[0] // page_size
    if (pos < 0).any():
        return -1
    protected = pos > (count - recent_len)
    page_prot = protected.reshape(npl, page_size).any(axis=-1)
    score = acc.sum(axis=0).reshape(npl, page_size).sum(axis=-1)
    score = np.where(page_prot, np.inf, score)
    if window is not None:
        stale = (pos >= 0) & (pos <= count - window)
        page_stale = stale.reshape(npl, page_size).all(axis=-1)
        score = np.where(page_stale & ~page_prot, -np.inf, score)
    return int(np.argmin(score))
