"""Decode-time KV caches in PyTorch.

Port of the JAX package's ``core/kvcache.py``: one slot-based cache for
every policy the serving path uses —

* full cache (slots = max_seq, slot s holds position s);
* sliding window (slots = window, a ring: position p lives in slot
  p % slots);
* H2O heavy hitters (slots = budget; once full, the incoming token
  evicts the slot with the least accumulated attention mass outside the
  recent window);
* both at once (window + H2O: slots whose position slid out of the window
  are evicted first).

Keys are stored *projected and sliced* when AQUA is on, seq-major; the
CUDA decode kernel reads the selected dim-blocks of that layout directly.
Slots carry explicit ``positions`` (-1 empty), so masking and recency
protection are uniform across policies.

Two layouts with the same logical slot space:

* :class:`AttnCache` — one contiguous slot stripe per lane;
* :class:`PagedAttnCache` — a global page pool plus per-lane page tables
  (logical slot ``s`` of lane ``b`` lives at
  ``(page_table[b, s // page_size], s % page_size)``), optionally with
  int8 pools and float32 per-page scales (``QuantSpec``), and over int8
  pools optionally with mixed-precision hot residents: a few pages kept
  in full precision beside their ints, which the reference lane views
  read instead. Full-cache and ring policies are slot-for-slot those of
  the contiguous cache; H2O evicts whole pages.

Unlike the JAX package, which returns new pytrees, the write functions
here update the cache tensors **in place** (an insert touches one slot per
lane instead of copying the cache). A cache's tensors may carry a leading
layer axis; ``layer(i)`` then returns views of layer ``i`` that write
through to the stacked tensors. The H2O statistic is the paged pool's
``acc_pool`` (hierarchical selection ranks pages by it too) and the
contiguous cache's ``acc_score``, which exists only under H2O: nothing
else reads it there.

The per-step writes (``insert``, ``paged_insert`` on full-precision
pools, ``accumulate_h2o``, ``paged_accumulate_h2o``) take their write
masks as tensors and never read them on the host: no boolean-mask
indexing, no ``nonzero``. A row that must not write repeats the write of
a row that does (same address, same value) or rewrites what its address
holds — the JAX package's out-of-bounds dropped scatter, for an in-place
scatter that has no drop mode. The int8 insert, which requantizes whole
pages, repeats a writing row's page requantization too. So one decode step
can be captured in a CUDA graph (``serving/step_graph.py``), and a step
that no row writes leaves the cache as it was, bit for bit. The lane
surgery (``paged_graft``, ``paged_write_tail``, ``paged_reset_lane``,
``install_table_row``, and ``paged_copy_page``, prefix sharing's
copy-on-write) takes its lane or page as a Python int or a device tensor
and reads nothing on the host either, by the same stand-in addressing:
an admission is captured too (``serving/admit_graph.py``).
:func:`reset_cache` empties a cache in place, keeping its tensors.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _tensors(cache) -> list:
    """The cache's fields in order (``dataclasses.astuple`` would copy)."""
    return [getattr(cache, f.name) for f in dataclasses.fields(cache)]


def _layer(cache, i: int):
    """Views of layer ``i`` of a cache with a leading layer axis (None
    fields stay None)."""
    return type(cache)(*(None if t is None else t[i]
                         for t in _tensors(cache)))


@dataclass
class AttnCache:
    """k (…, B, KV, S, Dk); v (…, B, KV, S, Dv); positions (…, B, S) int32
    with -1 empty; count (…, B) int32 = tokens processed (next position);
    acc_score (…, B, KV, S) float32 H2O accumulated attention mass, or
    None when the policy does not evict by score. The optional leading
    axis is the layer."""

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor
    count: torch.Tensor
    acc_score: Optional[torch.Tensor] = None

    @property
    def num_slots(self) -> int:
        return self.k.shape[-2]

    def layer(self, i: int) -> "AttnCache":
        return _layer(self, i)


def init_attn_cache(batch: int, num_kv: int, slots: int, dk: int, dv: int,
                    dtype=torch.bfloat16, device=None,
                    num_layers: Optional[int] = None,
                    h2o: bool = False) -> AttnCache:
    """Empty lanes; ``h2o`` allocates the ``acc_score`` statistic."""
    lead = () if num_layers is None else (num_layers,)
    return AttnCache(
        k=torch.zeros(*lead, batch, num_kv, slots, dk, dtype=dtype,
                      device=device),
        v=torch.zeros(*lead, batch, num_kv, slots, dv, dtype=dtype,
                      device=device),
        positions=torch.full((*lead, batch, slots), -1, dtype=torch.int32,
                             device=device),
        count=torch.zeros(*lead, batch, dtype=torch.int32, device=device),
        acc_score=(torch.zeros(*lead, batch, num_kv, slots,
                               dtype=torch.float32, device=device)
                   if h2o else None))


def cache_slots(max_seq: int, window: Optional[int] = None,
                h2o_budget: Optional[int] = None) -> int:
    """Slots per lane: ``max_seq``, cut to the window and to the H2O
    budget where set."""
    s = max_seq
    if window is not None:
        s = min(s, window)
    if h2o_budget is not None:
        s = min(s, h2o_budget)
    return max(s, 1)


def select_slot(cache: AttnCache, *, window: Optional[int] = None,
                h2o: bool = False, recent_len: int = 0,
                tp=None) -> torch.Tensor:
    """Slot (B,) for the incoming token: the ring (window only), the
    full-cache slot, or under H2O a free slot while one is left, else the
    victim — the least summed ``acc_score`` among slots outside the
    ``recent_len`` newest positions, slots out of the window first when a
    window is set too (first index among ties, as ``jnp.argmin``). On a
    mesh whose ``model`` axis shards the KV heads, ``tp``
    (``distributed.layout.MeshLayout``) sums the score over every head."""
    s = cache.num_slots
    count = cache.count
    if window is not None and not h2o:
        return count % s
    if not h2o:
        return torch.clamp(count, max=s - 1)
    pos, cur = cache.positions, count[:, None]
    # empties are never victims by score (the free slot takes them)
    protected = (pos > cur - recent_len) | (pos < 0)
    score = cache.acc_score.sum(dim=1)                  # (B, S)
    if tp is not None:
        score = tp.sum_heads(score)
    score = torch.where(protected, torch.full_like(score, float("inf")),
                        score)
    if window is not None:
        stale = (pos >= 0) & (pos <= cur - window)
        score = torch.where(stale & ~protected,
                            torch.full_like(score, -float("inf")), score)
    victim = torch.argmin(score, dim=-1).to(torch.int32)
    return torch.where(count < s, torch.clamp(count, max=s - 1), victim)


def insert(cache: AttnCache, slot: torch.Tensor, k_new: torch.Tensor,
           v_new: torch.Tensor,
           write_mask: Optional[torch.Tensor] = None) -> AttnCache:
    """Write one token's k (B, KV, Dk) / v (B, KV, Dv) at ``slot`` (B,),
    in place; the slot's ``acc_score`` restarts at 0. Rows where
    ``write_mask`` is False keep everything (they rewrite their slot's
    old contents): the engine's inactive lanes."""
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    s = slot.long()
    k_new = k_new.to(cache.k.dtype)
    v_new = v_new.to(cache.v.dtype)
    pos_new = cache.count
    acc_new = (None if cache.acc_score is None
               else torch.zeros_like(cache.acc_score[rows, :, s]))
    if write_mask is not None:
        m = write_mask
        k_new = torch.where(m[:, None, None], k_new, cache.k[rows, :, s])
        v_new = torch.where(m[:, None, None], v_new, cache.v[rows, :, s])
        pos_new = torch.where(m, pos_new, cache.positions[rows, s])
        if acc_new is not None:
            acc_new = torch.where(m[:, None], acc_new,
                                  cache.acc_score[rows, :, s])
    cache.k[rows, :, s] = k_new
    cache.v[rows, :, s] = v_new
    cache.positions[rows, s] = pos_new
    if acc_new is not None:
        cache.acc_score[rows, :, s] = acc_new
    cache.count += 1 if write_mask is None else write_mask.to(torch.int32)
    return cache


def lane_write_tail(cache: AttnCache, lane: int, k_tail: torch.Tensor,
                    v_tail: torch.Tensor, positions: torch.Tensor,
                    start: int, new_count: int) -> AttnCache:
    """Write a prefill chunk's k (T, KV, Dk) / v (T, KV, Dv) / positions
    (T,) into ``lane`` from logical slot ``start`` (the chunk cursor), in
    place; slots below ``start`` stay untouched. Slots at or past
    ``start`` are cleared first (position -1): a recycled lane's previous
    tenant must never read as valid, so the first chunk wipes the lane and
    later chunks clear ahead of themselves. Rows past the cache are
    dropped. Full-cache slot placement only (slot i holds position i)."""
    n = max(0, min(k_tail.shape[0], cache.num_slots - start))
    cache.positions[lane, start:] = -1
    cache.k[lane, :, start:start + n] = k_tail[:n].transpose(0, 1).to(
        cache.k.dtype)
    cache.v[lane, :, start:start + n] = v_tail[:n].transpose(0, 1).to(
        cache.v.dtype)
    cache.positions[lane, start:start + n] = positions[:n].to(torch.int32)
    cache.count[lane] = new_count
    return cache


def valid_mask(cache: AttnCache, *, window: Optional[int] = None
               ) -> torch.Tensor:
    """(B, S) bool — slots attendable by the current token."""
    return valid_mask_from(cache.positions, cache.count, window=window)


def valid_mask_from(positions: torch.Tensor, count: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B, S) bool — slots attendable by the token at position count-1:
    written, not in its future, and (with a window) ``pos > cur -
    window``."""
    cur = count[:, None] - 1
    m = (positions >= 0) & (positions <= cur)
    if window is not None:
        m &= positions > (cur - window)
    return m


def accumulate_h2o(cache: AttnCache, attn_weights: torch.Tensor,
                   write_mask: Optional[torch.Tensor] = None,
                   tp=None) -> AttnCache:
    """Add one step's attention probabilities (B, KV, G, S), summed over
    the G query heads of each KV group, to ``acc_score``, in place; rows
    where ``write_mask`` is False add nothing. ``tp``: the sum over query
    heads spans every rank of ``model`` where those shard it."""
    upd = attn_weights.float().sum(dim=2)
    if tp is not None:
        upd = tp.sum_groups(upd)
    if write_mask is not None:
        upd = torch.where(write_mask[:, None, None], upd,
                          torch.zeros_like(upd))
    cache.acc_score += upd
    return cache


# ---------------------------------------------------------------------------
# Block-paged cache: global page pool + per-lane page tables
# ---------------------------------------------------------------------------


@dataclass
class PagedAttnCache:
    """k_pool (…, P, KV, ps, Dk); v_pool (…, P, KV, ps, Dv); pos_pool
    (…, P, ps) int32 position held by each pool slot, -1 empty; acc_pool
    (…, P, KV, ps) float32 H2O accumulated attention mass; page_table
    (…, B, NP) int32 physical page of each logical page, -1 unmapped;
    count (…, B) int32. Optional leading layer axis.

    Quantized pools (``QuantSpec(kv_dtype="int8")``): ``k_pool``/``v_pool``
    hold int8 and ``k_scale``/``v_scale`` (…, P, SH) float32 hold each
    page's scale (``real = int * scale``, 0 = unwritten page); SH is KV
    for per-(page, kv head) scales and 1 for one scale per page.

    Hot residents (``QuantSpec.hot_resident_fraction`` > 0, int8 pools
    only): ``k_hot`` (…, H, KV, ps, Dk) / ``v_hot`` (…, H, KV, ps, Dv) in
    the model dtype hold H pages in full precision and ``hot_ids`` (…, H)
    int32 the physical page each holds (-1 free). Inserts write through
    to a resident page; a graft promotes the lane's freshest page in
    place of the resident with the least ``acc_pool`` mass; a page that
    is evicted, cleared or reset is demoted."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    pos_pool: torch.Tensor
    acc_pool: torch.Tensor
    page_table: torch.Tensor
    count: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    k_hot: Optional[torch.Tensor] = None
    v_hot: Optional[torch.Tensor] = None
    hot_ids: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def has_residents(self) -> bool:
        """True where the pool carries the full-precision hot overlay."""
        return self.hot_ids is not None

    @property
    def num_pages(self) -> int:
        return self.k_pool.shape[-4]

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[-2]

    @property
    def pages_per_lane(self) -> int:
        return self.page_table.shape[-1]

    @property
    def num_slots(self) -> int:
        return self.pages_per_lane * self.page_size

    def layer(self, i: int) -> "PagedAttnCache":
        return _layer(self, i)


def paged_pages(slots: int, page_size: int) -> int:
    """Pages per lane for a logical capacity of ``slots``."""
    assert slots % page_size == 0, \
        f"cache slots {slots} must be a multiple of page_size {page_size}"
    return slots // page_size


#: int8 symmetric quantization range (zero-point is always 0).
QUANT_MAX = 127.0


def init_paged_cache(batch: int, num_kv: int, num_pages: int,
                     pages_per_lane: int, page_size: int, dk: int, dv: int,
                     dtype=torch.bfloat16, device=None,
                     num_layers: Optional[int] = None,
                     kv_dtype: str = "bf16",
                     scale_granularity: str = "page_head",
                     hot_pages: int = 0) -> PagedAttnCache:
    """``kv_dtype`` "bf16" keeps full-precision pools (in ``dtype``);
    "int8" stores quantized pools with float32 per-page scales of
    ``scale_granularity`` "page_head" (one per page and kv head) or
    "page" (one per page), and with ``hot_pages`` > 0 the hot-resident
    overlay of that many pages (in ``dtype``), as in JAX."""
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    quant = kv_dtype == "int8"
    lead = () if num_layers is None else (num_layers,)
    pool_dtype = torch.int8 if quant else dtype
    scales = {}
    if quant:
        sh = num_kv if scale_granularity == "page_head" else 1
        scales = {name: torch.zeros(*lead, num_pages, sh, dtype=torch.float32,
                                    device=device)
                  for name in ("k_scale", "v_scale")}
        if hot_pages > 0:
            scales.update(
                k_hot=torch.zeros(*lead, hot_pages, num_kv, page_size, dk,
                                  dtype=dtype, device=device),
                v_hot=torch.zeros(*lead, hot_pages, num_kv, page_size, dv,
                                  dtype=dtype, device=device),
                hot_ids=torch.full((*lead, hot_pages), -1, dtype=torch.int32,
                                   device=device))
    return PagedAttnCache(
        k_pool=torch.zeros(*lead, num_pages, num_kv, page_size, dk,
                           dtype=pool_dtype, device=device),
        v_pool=torch.zeros(*lead, num_pages, num_kv, page_size, dv,
                           dtype=pool_dtype, device=device),
        pos_pool=torch.full((*lead, num_pages, page_size), -1,
                            dtype=torch.int32, device=device),
        acc_pool=torch.zeros(*lead, num_pages, num_kv, page_size,
                             dtype=torch.float32, device=device),
        page_table=torch.full((*lead, batch, pages_per_lane), -1,
                              dtype=torch.int32, device=device),
        count=torch.zeros(*lead, batch, dtype=torch.int32, device=device),
        **scales)


def dequant_pages(pool: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 pages (..., KV, ps, D) x per-page scales (..., SH) -> float32;
    SH broadcasts over KV when there is one scale per page."""
    return pool.float() * scale[..., :, None, None]


def quantize_tokens(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float tokens (..., D) / scales broadcastable to ``x[..., 0]`` ->
    int8, rounding half to even (as ``jnp.round``). A zero scale
    (unwritten page, all-zero content) quantizes to 0."""
    s = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.round(x.float() / s[..., None])
    return q.clamp(-QUANT_MAX, QUANT_MAX).to(torch.int8)


def _page_scales(tok: torch.Tensor, ps: int, sh: int,
                 tp=None) -> torch.Tensor:
    """Per-page scales for (T, KV, D) tokens laid out from a page boundary
    -> (ceil(T / ps), SH); the partial last page pads with zeros (which
    never grow the amax). ``tp``: on a mesh, one scale per page (SH 1,
    ``tp.max_heads``) takes its amax over every rank's KV heads."""
    t, kvh, d = tok.shape
    npg = -(-t // ps)
    x = torch.nn.functional.pad(tok.float().abs(), (0, 0, 0, 0, 0,
                                                    npg * ps - t))
    amax = x.reshape(npg, ps, kvh, d).amax(dim=(1, 3))      # (NPG, KV)
    if sh == 1:
        amax = amax.amax(dim=-1, keepdim=True)
        if tp is not None:
            amax = tp.max_heads(amax)
    return amax / QUANT_MAX


def _insert_quant_token(pool: torch.Tensor, scale: torch.Tensor,
                        phys: torch.Tensor, off: torch.Tensor,
                        x_new: torch.Tensor, any_ok: torch.Tensor,
                        tp=None) -> None:
    """Quantized single-token insert with a per-page *running* scale, in
    place: grow each page's scale to cover the new token's amax,
    requantizing the page's stored ints when it grows, then write the
    token. ``phys``/``off`` (B,) and ``x_new`` (B, KV, D) address and
    carry every row as :func:`_stand_in` redirects them: a row that does
    not write repeats a writing row's page requantization and token write
    (same page, same values). With no writing row (``any_ok`` False) the
    scales stay, the ratio is exactly 1 and every row rewrites its slot,
    so the pool keeps its ints bit for bit. ``tp``: as
    :func:`_page_scales`' (every rank of ``model`` then grows the page by
    the same ratio)."""
    x = x_new.float()                                    # (B, KV, D)
    amax = x.abs().amax(dim=-1)                          # (B, KV)
    if scale.shape[1] == 1:
        amax = amax.amax(dim=-1, keepdim=True)           # (B, 1)
        if tp is not None:
            amax = tp.max_heads(amax)
    s_old = scale[phys]                                  # (B, SH)
    s_cand = torch.where(any_ok, torch.maximum(s_old, amax / QUANT_MAX),
                         s_old)
    ratio = torch.where(s_cand > 0.0, s_old / s_cand, torch.ones_like(s_old))
    page = pool[phys].float()                            # (B, KV, ps, D)
    pool[phys] = torch.round(page * ratio[:, :, None, None]).clamp(
        -QUANT_MAX, QUANT_MAX).to(pool.dtype)
    pool[phys, :, off] = torch.where(any_ok, quantize_tokens(x, s_cand),
                                     pool[phys, :, off])
    scale[phys] = s_cand


def _demote_residents(hot_ids: torch.Tensor, freed: torch.Tensor,
                      ok: torch.Tensor) -> None:
    """Drop, in place, the hot residents whose physical page is one of
    ``freed`` (1-D) where ``ok``: a recycled page must not serve a stale
    full-precision overlay."""
    stale = ((hot_ids[:, None] == freed[None, :]) & ok[None, :]).any(dim=1)
    hot_ids.masked_fill_(stale, -1)


def _hot_overlay(vals: torch.Tensor, hot_pool: torch.Tensor,
                 table: torch.Tensor, hot_ids: torch.Tensor) -> torch.Tensor:
    """Resident pages read their full-precision copy: ``vals`` (B, NP, KV,
    ps, D) gathered through ``table`` (B, NP); an entry that matches a
    live ``hot_ids`` slot takes ``hot_pool``'s page (the first matching
    slot, as ``jnp.argmax``) cast to ``vals``' dtype."""
    m = (table[..., None] == hot_ids) & (hot_ids >= 0)    # (B, NP, H)
    hit = m.any(dim=-1)
    hidx = torch.argmax(m.to(torch.int32), dim=-1)
    hot = hot_pool.to(vals.dtype)[hidx]                   # (B, NP, KV, ps, D)
    return torch.where(hit[..., None, None, None], hot, vals)


def paged_lane_view(cache: PagedAttnCache) -> AttnCache:
    """Gather the per-lane contiguous view of a (single-layer) paged cache
    — slot-for-slot what the contiguous cache would hold, dequantized to
    float32 for int8 pools; unmapped pages read position -1. The
    reference decode path runs on this; the CUDA kernel walks the page
    table instead and never gathers."""
    b = cache.page_table.shape[0]
    table = cache.page_table.long()
    pages = table.clamp(min=0)
    kvh = cache.k_pool.shape[1]
    k, v = cache.k_pool[pages], cache.v_pool[pages]      # (B, NP, KV, ps, D)
    if cache.quantized:
        k = dequant_pages(k, cache.k_scale[pages])
        v = dequant_pages(v, cache.v_scale[pages])
        if cache.has_residents:
            k = _hot_overlay(k, cache.k_hot, table, cache.hot_ids)
            v = _hot_overlay(v, cache.v_hot, table, cache.hot_ids)
    k = k.transpose(1, 2).reshape(b, kvh, cache.num_slots, -1)
    v = v.transpose(1, 2).reshape(b, kvh, cache.num_slots, -1)
    pos = torch.where(table[..., None] >= 0, cache.pos_pool[pages],
                      torch.full_like(cache.pos_pool[pages], -1))
    return AttnCache(k=k, v=v, positions=pos.reshape(b, cache.num_slots),
                     count=cache.count)


def paged_lane_pages(cache: PagedAttnCache, row: torch.Tensor, dtype=None):
    """The pages a lane's page-table ``row`` (NP,) maps, as a contiguous
    view: (k (1, KV, S_log, Dk), v (1, KV, S_log, Dv), positions (1,
    S_log)). int8 pools come back
    dequantized (to ``dtype``, float32 by default), so quantization stays
    a storage detail of the pool (resident pages read their
    full-precision copy); full-precision pools are cast to ``dtype`` when
    given. Unmapped pages read position -1. The chunked prefill reads the
    prefix it already wrote through this."""
    tbl = row.long()                                        # (NP,)
    phys = tbl.clamp(min=0)
    pk, pv = cache.k_pool[phys], cache.v_pool[phys]         # (NP, KV, ps, D)
    if cache.quantized:
        pk = dequant_pages(pk, cache.k_scale[phys])
        pv = dequant_pages(pv, cache.v_scale[phys])
    if dtype is not None:
        pk, pv = pk.to(dtype), pv.to(dtype)
    if cache.has_residents:
        pk = _hot_overlay(pk[None], cache.k_hot, tbl[None], cache.hot_ids)[0]
        pv = _hot_overlay(pv[None], cache.v_hot, tbl[None], cache.hot_ids)[0]
    ppos = torch.where(tbl[:, None] >= 0, cache.pos_pool[phys],
                       torch.full_like(cache.pos_pool[phys], -1))
    kvh, s_log = pk.shape[1], cache.num_slots
    pk = pk.transpose(0, 1).reshape(1, kvh, s_log, -1)
    pv = pv.transpose(0, 1).reshape(1, kvh, s_log, -1)
    return pk, pv, ppos.reshape(1, s_log)


def gather_positions(cache: PagedAttnCache) -> torch.Tensor:
    """(B, S_log) int32 logical-slot positions (-1 empty or unmapped)."""
    b = cache.page_table.shape[0]
    table = cache.page_table.long()
    pos = cache.pos_pool[table.clamp(min=0)]                # (B, NP, ps)
    pos = torch.where(table[..., None] >= 0, pos, torch.full_like(pos, -1))
    return pos.reshape(b, cache.num_slots)


def paged_select_slot(cache: PagedAttnCache, *,
                      window: Optional[int] = None, h2o: bool = False,
                      recent_len: int = 0, tp=None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Paged twin of :func:`select_slot`: ``(slot (B,), evict_page (B,) |
    None)``. Full-cache and ring policies are the contiguous cache's
    arithmetic. H2O evicts whole pages: while the lane has an empty slot
    the first one is filled (``evict_page`` -1); once full, the logical
    page with the least summed ``acc_pool`` mass goes — pages holding one
    of the ``recent_len`` newest positions are protected, and under a
    window a page wholly out of it goes first — and the token lands in its
    first slot. :func:`paged_insert` clears the victim page. ``tp``: as
    :func:`select_slot`'s."""
    b, npl = cache.page_table.shape
    ps = cache.page_size
    count = cache.count
    if window is not None and not h2o:
        return count % cache.num_slots, None
    if not h2o:
        return torch.clamp(count, max=cache.num_slots - 1), None
    pos = gather_positions(cache)                       # (B, S_log)
    cur = count[:, None]
    empty = pos < 0
    has_empty = empty.any(dim=-1)
    first_empty = torch.argmax(empty.to(torch.int32), dim=-1)
    page_prot = (pos > cur - recent_len).reshape(b, npl, ps).any(dim=-1)
    # unmapped entries read page 0, as in JAX: such a lane has empties
    acc = cache.acc_pool[cache.page_table.long().clamp(min=0)]
    score = acc.sum(dim=(2, 3))                         # (B, NP)
    if tp is not None:
        score = tp.sum_heads(score)
    score = torch.where(page_prot, torch.full_like(score, float("inf")),
                        score)
    if window is not None:
        stale = (pos >= 0) & (pos <= cur - window)
        page_stale = stale.reshape(b, npl, ps).all(dim=-1)
        score = torch.where(page_stale & ~page_prot,
                            torch.full_like(score, -float("inf")), score)
    victim = torch.argmin(score, dim=-1)
    slot = torch.where(has_empty, first_empty, victim * ps).to(torch.int32)
    evict = torch.where(has_empty, torch.full_like(victim, -1),
                        victim).to(torch.int32)
    return slot, evict


def _stand_in(ok: torch.Tensor, *index: torch.Tensor):
    """Sync-free masked scatter, addressing: rows where ``ok`` is False
    take the address of the first row where it is True (each index (B,)).
    Returns (the redirected indices, the donor row, whether any row is
    ok)."""
    donor = torch.argmax(ok.to(torch.int32)).reshape(1)
    return tuple(torch.where(ok, i, i.index_select(0, donor))
                 for i in index), donor, ok.any()


def _stand_in_values(ok, donor, any_ok, new: torch.Tensor,
                     old: torch.Tensor) -> torch.Tensor:
    """Values for :func:`_stand_in`'s addresses: a redirected row writes
    its donor's value (same address, same value); with no ok row at all
    every row rewrites what its address holds."""
    okx = ok.reshape(-1, *([1] * (new.ndim - 1)))
    return torch.where(any_ok, torch.where(okx, new,
                                           new.index_select(0, donor)), old)


def paged_insert(cache: PagedAttnCache, slot: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 write_mask: Optional[torch.Tensor] = None,
                 evict_page: Optional[torch.Tensor] = None,
                 tp=None) -> PagedAttnCache:
    """Write one token's k/v at logical ``slot`` through the page table, in
    place (quantized with the page's running scale for int8 pools, and
    written through to the page's full-precision copy where it is a hot
    resident; the slot's accumulated score is cleared). Rows masked off,
    or whose slot's page is unmapped, write nothing; masked-off rows keep
    their count. ``evict_page`` (B,) (page-granular H2O, -1 = none): the
    victim logical page's positions, scores and, for int8 pools, scales
    are cleared first (and the page is demoted from residency), so its
    other slots read as empty from the next step on.

    ``tp``: this rank's mesh layout: one scale per page grows by the amax
    over every rank's heads; where lanes split over the data axes and the
    pool keeps residents, every data rank's victims are demoted on every
    rank (the resident set is pool-wide, as in JAX)."""
    b = cache.page_table.shape[0]
    ps = cache.page_size
    rows = torch.arange(b, device=slot.device)
    entry = cache.page_table[rows, (slot // ps).long()]
    ok = entry >= 0
    if write_mask is not None:
        ok &= write_mask
    if evict_page is not None:
        ev = cache.page_table[rows, evict_page.long().clamp(min=0)]
        ev_ok = (evict_page >= 0) & (ev >= 0)
        if write_mask is not None:
            ev_ok &= write_mask
        victims = torch.where(ev_ok, ev.long(),
                              torch.full_like(ev.long(), -1))
        _clear_pages(cache, victims)
        if cache.has_residents and tp is not None and tp.lanes is not None:
            every = tp.gather_lanes(victims)
            _demote_residents(cache.hot_ids, every.clamp(min=0), every >= 0)
    (phys, off), donor, any_ok = _stand_in(
        ok, entry.long().clamp(min=0), (slot % ps).long())
    if cache.quantized:
        for pool, scale, new in ((cache.k_pool, cache.k_scale, k_new),
                                 (cache.v_pool, cache.v_scale, v_new)):
            donated = torch.where(ok[:, None, None], new,
                                  new.index_select(0, donor))
            _insert_quant_token(pool, scale, phys, off, donated, any_ok, tp)
        if cache.has_residents:
            _write_through(cache, phys, off, ok, k_new, v_new)
    else:
        for pool, new in ((cache.k_pool, k_new), (cache.v_pool, v_new)):
            pool[phys, :, off] = _stand_in_values(
                ok, donor, any_ok, new.to(pool.dtype), pool[phys, :, off])
    cache.pos_pool[phys, off] = _stand_in_values(
        ok, donor, any_ok, cache.count, cache.pos_pool[phys, off])
    cache.acc_pool[phys, :, off] = _stand_in_values(
        ok, donor, any_ok, torch.zeros_like(cache.acc_pool[phys, :, off]),
        cache.acc_pool[phys, :, off])
    cache.count += 1 if write_mask is None else write_mask.to(torch.int32)
    return cache


def _write_through(cache: PagedAttnCache, phys: torch.Tensor,
                   off: torch.Tensor, ok: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor) -> None:
    """The write-through of an int8 insert: a writing row whose page is a
    hot resident also writes its exact token into the page's copy (the
    first matching slot, as ``jnp.argmax``), so the overlay never lags the
    pool. ``phys``/``off`` as :func:`_stand_in` redirected them; rows that
    write no resident repeat the write of one that does, and with none
    every row rewrites what its address holds."""
    hm = cache.hot_ids[None, :] == phys[:, None]           # (B, H)
    hit = hm.any(dim=1) & ok
    hslot = torch.argmax(hm.to(torch.int32), dim=1)
    (hslot, hoff), donor, any_hit = _stand_in(hit, hslot, off)
    for hot, new in ((cache.k_hot, k_new), (cache.v_hot, v_new)):
        hot[hslot, :, hoff] = _stand_in_values(
            hit, donor, any_hit, new.to(hot.dtype), hot[hslot, :, hoff])


def paged_accumulate_h2o(cache: PagedAttnCache, attn_weights: torch.Tensor,
                         write_mask: Optional[torch.Tensor] = None,
                         tp=None) -> PagedAttnCache:
    """Scatter-add one step's probabilities over the *logical* slot view
    (B, KV, G, S_log), summed over the G heads of each KV group, into
    ``acc_pool`` through the page table, in place. Rows masked off and
    unmapped pages add exactly 0 (to page 0); no two lanes share a page
    under H2O (no prefix sharing), so every other address is written once
    and the sum is order-free. ``tp``: as :func:`accumulate_h2o`'s; where
    lanes split over the data axes and the pool keeps residents (whose
    promotion reads the pool-wide mass), every lane's update lands on
    every data rank's replica, as in JAX's one pool."""
    table = cache.page_table
    ps = cache.page_size
    upd = attn_weights.float().sum(dim=2)                 # (B, KV, S_log)
    if tp is not None:
        upd = tp.sum_groups(upd)
    mapped = (table >= 0).repeat_interleave(ps, dim=1)
    if write_mask is not None:
        mapped = mapped & write_mask[:, None]
    upd = torch.where(mapped[:, None, :], upd, torch.zeros_like(upd))
    if cache.has_residents and tp is not None and tp.lanes is not None:
        upd, table = tp.gather_lanes(upd), tp.gather_lanes(table)
    npl = table.shape[1]
    phys = table.long().clamp(min=0).repeat_interleave(ps, dim=1)
    off = torch.arange(ps, device=phys.device).repeat(npl)
    kvi = torch.arange(upd.shape[1], device=phys.device)
    cache.acc_pool.index_put_(
        (phys[:, None, :], kvi[None, :, None], off[None, None, :]), upd,
        accumulate=True)
    return cache


def lane_index(lane, device) -> torch.Tensor:
    """``lane`` (or a page id) as a (1,) int64 tensor on ``device``: a
    Python int is filled in on the device (no host-to-device copy), a 0-d
    or 1-element int tensor (an admission graph's lane buffer) is
    reshaped, never read on the host."""
    if isinstance(lane, torch.Tensor):
        return lane.reshape(1).long()
    return torch.full((1,), int(lane), dtype=torch.int64, device=device)


def _set_lane(t: torch.Tensor, lane: torch.Tensor, value) -> None:
    """``t[lane] = value`` in place for a (1,) lane tensor; ``value`` a
    Python number or a 0-d / 1-element tensor, never read on the host."""
    if isinstance(value, torch.Tensor):
        t.index_copy_(0, lane, value.reshape(1).to(t.dtype))
    else:
        t.index_fill_(0, lane, value)


def install_table_row(cache: PagedAttnCache, lane, row: torch.Tensor
                      ) -> PagedAttnCache:
    """Install ``row`` (NP,) int32 as ``lane``'s page-table row, in
    place: in every layer of a stacked cache (page_table (L, B, NP))."""
    lane = lane_index(lane, row.device)
    table = cache.page_table
    table.index_copy_(table.ndim - 2, lane, row.to(table.dtype).expand(
        *table.shape[:-2], 1, table.shape[-1]))
    return cache


def _lane_table(cache: PagedAttnCache, lane: torch.Tensor) -> torch.Tensor:
    """(NP,) int64: ``lane``'s page-table row, gathered on the device."""
    return cache.page_table.index_select(0, lane)[0].long()


def _clear_pages(cache: PagedAttnCache, tbl: torch.Tensor) -> None:
    """Clear the pages that ``tbl`` (a lane's table row (NP,), or H2O's
    victims (B,)) maps (entries >= 0): positions -1, scores 0, and scales
    0 for int8 pools, in place; hot residents on them are demoted. Unmapped entries repeat a mapped entry's clear
    (:func:`_stand_in`); with none mapped every entry rewrites what its
    address holds."""
    ok = tbl >= 0
    (phys,), donor, any_ok = _stand_in(ok, tbl.clamp(min=0))
    pools = [(cache.pos_pool, -1), (cache.acc_pool, 0.0)]
    if cache.quantized:
        pools += [(cache.k_scale, 0.0), (cache.v_scale, 0.0)]
    for t, empty in pools:
        old = t[phys]
        t[phys] = _stand_in_values(ok, donor, any_ok,
                                   torch.full_like(old, empty), old)
    if cache.has_residents:
        _demote_residents(cache.hot_ids, phys, ok)


def _write_tokens(cache: PagedAttnCache, tbl: torch.Tensor, start_page: int,
                  k_tok: torch.Tensor, v_tok: torch.Tensor,
                  positions: torch.Tensor,
                  acc: Optional[torch.Tensor] = None, tp=None) -> None:
    """Write T tokens (k (T, KV, Dk), v (T, KV, Dv), positions (T,), and
    an H2O prefill's scores ``acc`` (T, KV)) to logical slots
    ``start_page * page_size + arange(T)`` of the lane whose table row is
    ``tbl``, in place. int8 pools: each page the tokens start gets its
    scale from them (the partial last page padded with zeros). Rows whose
    page is unmapped repeat a mapped row's write (same address, same
    value), the scale writes of unmapped pages too; with no row mapped
    every write rewrites what its address holds."""
    ps = cache.page_size
    t = k_tok.shape[0]
    rel = torch.arange(t, device=tbl.device)
    idx = start_page * ps + rel
    entry = tbl[idx // ps]
    ok = entry >= 0
    (phys, off), donor, any_ok = _stand_in(ok, entry.clamp(min=0), idx % ps)

    def write(t_, index, new):
        old = t_[index]
        t_[index] = _stand_in_values(ok, donor, any_ok, new.to(t_.dtype), old)
    if cache.quantized:
        for pool, scale, tok in ((cache.k_pool, cache.k_scale, k_tok),
                                 (cache.v_pool, cache.v_scale, v_tok)):
            pg = _page_scales(tok, ps, scale.shape[1], tp)  # (NPG, SH)
            pg_tbl = tbl[start_page:start_page + pg.shape[0]]
            pg_ok = pg_tbl >= 0
            (pg_phys,), pg_donor, pg_any = _stand_in(pg_ok,
                                                     pg_tbl.clamp(min=0))
            old = scale[pg_phys]
            scale[pg_phys] = _stand_in_values(pg_ok, pg_donor, pg_any, pg,
                                              old)
            write(pool, (phys, slice(None), off),
                  quantize_tokens(tok, pg[rel // ps]))
    else:
        write(cache.k_pool, (phys, slice(None), off), k_tok)
        write(cache.v_pool, (phys, slice(None), off), v_tok)
    write(cache.pos_pool, (phys, off), positions)
    if acc is not None:
        write(cache.acc_pool, (phys, slice(None), off), acc)


def _promote(cache: PagedAttnCache, req: AttnCache, tbl: torch.Tensor,
             num_slots: int, tp=None) -> None:
    """The graft's precision policy, in place: the lane's freshest page
    (logical page ``(num_slots - 1) // page_size``, which eviction
    protects as recent) becomes a hot resident in place of the resident
    with the least summed ``acc_pool`` mass (a free slot first; the first
    index among ties, as ``jnp.argmin``), with the grafted tokens of that
    page, zero-padded, as its full-precision copy. An unmapped page
    promotes nothing (every write rewrites what its address holds).
    ``tp``: on a mesh the mass sums every rank's KV heads, so every rank
    picks the same slot (the page itself is the same on every rank)."""
    ps = cache.page_size
    lp = (num_slots - 1) // ps
    new_page = tbl[lp:lp + 1]                                # (1,)
    hot_ids = cache.hot_ids
    mass = cache.acc_pool[hot_ids.long().clamp(min=0)].sum(dim=(1, 2))
    if tp is not None:
        mass = tp.sum_heads(mass)
    mass = torch.where(hot_ids >= 0, mass, torch.full_like(mass,
                                                           -float("inf")))
    vslot = torch.argmin(mass).reshape(1)
    ok = new_page >= 0
    pad = (lp + 1) * ps - num_slots
    for hot, seg in ((cache.k_hot, req.k[0][:, lp * ps:num_slots]),
                     (cache.v_hot, req.v[0][:, lp * ps:num_slots])):
        seg = torch.nn.functional.pad(seg, (0, 0, 0, pad)).to(hot.dtype)
        hot[vslot] = torch.where(ok[:, None, None, None], seg[None],
                                 hot[vslot])
    hot_ids[vslot] = torch.where(ok, new_page.to(hot_ids.dtype),
                                 hot_ids[vslot])


def paged_graft(cache: PagedAttnCache, req: AttnCache, lane,
                num_slots: int, row: torch.Tensor, tp=None) -> PagedAttnCache:
    """Copy logical slots [0, num_slots) of a B=1 contiguous cache (an
    admission prefill) into the pages that ``row`` (NP,), the lane's
    page-table row, maps, in place, and set ``lane``'s count. Every page
    the row maps is cleared first (positions -1, scores 0, and scales 0
    for int8 pools; residents on them demoted): pool pages are recycled,
    so a previous tenant's state must never read as valid. int8 pools get
    per-page scales over the grafted tokens, and with hot residents the
    lane's freshest page is promoted (:func:`_promote`); an H2O prefill's
    ``acc_score`` lands in ``acc_pool``.

    ``lane`` is a Python int or a 0-d / 1-element int tensor on the
    cache's device, or None: no count is set (a mesh rank that holds a
    replica of the pool but not the lane). ``row`` is a device tensor;
    nothing is read on the host (an admission graph captures this), and
    when no page is mapped the pool stays as it was, bit for bit. ``tp``:
    this rank's mesh layout (:func:`_page_scales`, :func:`_promote`)."""
    tbl = row.long()
    _clear_pages(cache, tbl)
    if cache.has_residents:
        _promote(cache, req, tbl, num_slots, tp)
    _write_tokens(cache, tbl, 0, req.k[0][:, :num_slots].transpose(0, 1),
                  req.v[0][:, :num_slots].transpose(0, 1),
                  req.positions[0, :num_slots],
                  None if req.acc_score is None
                  else req.acc_score[0][:, :num_slots].transpose(0, 1), tp)
    if lane is not None:
        _set_lane(cache.count, lane_index(lane, cache.count.device),
                  req.count[:1])
    return cache


def paged_write_tail(cache: PagedAttnCache, lane, k_tail: torch.Tensor,
                     v_tail: torch.Tensor, positions: torch.Tensor,
                     start_page: int, new_count,
                     row: torch.Tensor, tp=None) -> PagedAttnCache:
    """Write a prefill chunk's k (T, KV, Dk) / v (T, KV, Dv) / positions
    (T,) into the pages that ``row`` (NP,), the lane's page-table row,
    maps, from the page-aligned logical page ``start_page``, in place, and
    set ``lane``'s count to ``new_count``. The row's pages from
    ``start_page`` on are cleared first (positions -1, scores 0, and
    scales 0 for int8 pools): pool pages are recycled. On int8 pools each
    written page gets its scale from the chunk's tokens (padding rows
    included, as in JAX); pages below ``start_page`` keep theirs. Rows
    whose page is unmapped are dropped. ``lane`` and ``new_count`` are
    Python ints or device tensors, ``lane`` None as :func:`paged_graft`'s;
    nothing is read on the host. ``tp``: as :func:`paged_graft`'s."""
    tbl = row.long()                                         # (NP,)
    from_start = torch.arange(tbl.shape[0], device=tbl.device) >= start_page
    _clear_pages(cache, torch.where(from_start, tbl,
                                    torch.full_like(tbl, -1)))
    t = min(k_tail.shape[0], cache.num_slots - start_page * cache.page_size)
    _write_tokens(cache, tbl, start_page, k_tail[:t], v_tail[:t],
                  positions[:t], tp=tp)
    if lane is not None:
        _set_lane(cache.count, lane_index(lane, cache.count.device),
                  new_count)
    return cache


def paged_reset_lane(cache: PagedAttnCache, lane) -> PagedAttnCache:
    """Return ``lane`` to the empty condition, in place: clear its mapped
    pages' positions, scores (and scales), unmap its table row, zero its
    count. (Returning the pages to the free list is the host allocator's
    job.) Nothing is read on the host."""
    lane = lane_index(lane, cache.count.device)
    _clear_pages(cache, _lane_table(cache, lane))
    cache.page_table.index_fill_(0, lane, -1)
    cache.count.index_fill_(0, lane, 0)
    return cache


def paged_copy_page(cache: PagedAttnCache, src, dst) -> PagedAttnCache:
    """The device half of the host allocator's copy-on-write
    (``PagePool.make_private``): copy physical page ``src`` into the newly
    reserved ``dst``, in place, in every layer of a stacked cache. K/V,
    positions, H2O scores and, for int8 pools, the page scales go
    together, so the copy dequantizes bit for bit as the original does.
    ``src`` and ``dst`` are Python ints or device tensors; nothing is read
    on the host."""
    dev = cache.count.device
    src, dst = lane_index(src, dev), lane_index(dst, dev)
    # each pool's page axis, counted from its end
    pools = [(cache.k_pool, 4), (cache.v_pool, 4), (cache.pos_pool, 2),
             (cache.acc_pool, 3)]
    if cache.quantized:
        pools += [(cache.k_scale, 2), (cache.v_scale, 2)]
    for t, tail in pools:
        axis = t.ndim - tail
        t.index_copy_(axis, dst, t.index_select(axis, src))
    return cache


#: fields whose empty value is -1 (positions, page tables); the others 0
_EMPTY_IS_MINUS_ONE = ("positions", "pos_pool", "page_table", "hot_ids")


def reset_cache(cache):
    """Return every lane of an :class:`AttnCache`, :class:`PagedAttnCache`,
    :class:`SSMCache`, :class:`RGLRUCache` or :class:`HybridCache` to what
    its initializer allocates, in place: the tensors keep their storage
    (a captured decode step holds their addresses)."""
    for f in dataclasses.fields(cache):
        t = getattr(cache, f.name)
        if dataclasses.is_dataclass(t):
            reset_cache(t)
        elif t is not None:
            t.fill_(-1 if f.name in _EMPTY_IS_MINUS_ONE else 0)
    return cache


# ---------------------------------------------------------------------------
# SSM / recurrent states
# ---------------------------------------------------------------------------


@dataclass
class SSMCache:
    """Mamba-2 per-layer state: the rolling window of the last
    ``conv_width - 1`` raw (pre-conv) inputs and the SSD state. conv (…,
    B, conv_width - 1, conv_channels) in the model dtype; state (…, B,
    nheads, head_dim, state_dim) float32; count (…, B) int32 tokens
    processed. The optional leading axis is the layer."""

    conv: torch.Tensor
    state: torch.Tensor
    count: torch.Tensor

    def layer(self, i: int) -> "SSMCache":
        return _layer(self, i)


@dataclass
class RGLRUCache:
    """RecurrentGemma recurrent-block state: conv (…, B, conv_width - 1,
    lru_width) raw (pre-conv) inputs in the model dtype; state (…, B,
    lru_width) float32 RG-LRU hidden state; count (…, B) int32. The
    optional leading axis is the layer."""

    conv: torch.Tensor
    state: torch.Tensor
    count: torch.Tensor

    def layer(self, i: int) -> "RGLRUCache":
        return _layer(self, i)


@dataclass
class HybridCache:
    """A hybrid model's decode state: its attention layers' caches stacked
    in one :class:`AttnCache` (``attn``, layers at axis 0 in model order)
    and its recurrent layers' states in one :class:`RGLRUCache` (``rec``),
    lanes at axis 1 in both. ``count`` is the attention cache's (L_attn,
    B), which every lane advances with the recurrent ones' (the
    recurrent stack's where the model has no attention layer)."""

    attn: AttnCache
    rec: RGLRUCache

    @property
    def count(self) -> torch.Tensor:
        return self.attn.count if self.attn.count.shape[0] else self.rec.count


def tree_bytes(obj) -> int:
    """Total bytes of the tensors in a (nested) dataclass / sequence /
    dict of tensors — the cache-footprint accounting the engine reports."""
    if isinstance(obj, torch.Tensor):
        return math.prod(obj.shape) * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(tree_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(tree_bytes(x) for x in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tree_bytes(x) for x in obj)
    return 0
