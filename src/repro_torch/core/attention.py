"""Multi-head attention with AQUA, for prefill and decode (PyTorch port).

Port of the JAX package's ``core/attention.py`` for the single-device
serving path: RoPE (half-split), qk-norm, GQA, AQUA projection and
magnitude selection, the backend registry, prefill attention, the
full-cache prefill→cache handoff and one-token decode over a contiguous or
paged cache.

Backend registry contract (as in the JAX package): a backend's ``prefill``
receives model-layout tensors q (B, S, KV, G, Dq), k (B, S, KV, Dq),
v (B, S, KV, Dv) and returns (out (B, S, KV, G, Dv), weights | None);
``decode`` / ``paged_decode`` receive the projected query (B, KV, G, Dq)
and the cache and return (B, KV, G, Dv). Built-in backends:

* ``dense`` — materialized-score reference (the JAX ``dense-jnp``);
* ``aqua-masked-dense`` — the same with the per-query magnitude mask;
* ``flash`` — the CUDA flash kernel for prefill (its plain version for CPU
  tensors); decode runs the masked-dense core, as in JAX;
* ``aqua-block-sparse`` — the CUDA prefill and decode kernels (their plain
  versions for CPU tensors). With ``block_dims`` <= 1 (the paper's per-dim
  selection) or a kept head dim that is not a multiple of it, prefill runs
  the flash kernel on the masked q̂ and decode the masked-dense core, as in
  JAX. Decode runs the kernel for the full-cache policy only: window rings
  and H2O eviction decode on the masked-dense core (per-slot position
  masks, and the weights H2O accumulates), as in JAX;
* ``aqua-block-sparse-plain`` — the same selection and arithmetic through
  the kernels' plain versions on any device: the reference that a run on
  the GPU compares the kernels against. Never chosen automatically.

A chunked-prefill step (:func:`chunk_attention`) attends a prompt chunk
against the lane's stored prefix plus itself. The two block-sparse
backends run it through their ``chunk`` entry, the prefill kernel with
``q_offset``; every other backend runs :func:`prefixed_tail_attention`,
the masked-dense reference the JAX package serves chunk steps on.

``auto`` resolves as the JAX package does where it prefers its kernels:
``aqua-block-sparse`` with AQUA on, ``flash`` with AQUA off.

Stored width under AQUA (``aqua.stored_dims``): q̂ and K̂ keep the
``kept_dims`` leading projected dims, padded with zero columns to a
multiple of 8 when the selection is by whole dim-blocks (AQUA-Memory
slices such as 90 of 128 dims), so the bf16 kernels can read them. A zero
column adds exactly 0 to every score, and selection ranks only the real
blocks (``kept`` in ``kernels/ops.py``), so scores and selections are the
unpadded ones.

Cache policies (``kvcache``): full, sliding-window ring, H2O, and both.
:func:`build_cache_from_prefill` places a prefill's tokens as each policy
does; :func:`decode_attention` picks the slot, writes, attends and, under
H2O, accumulates the step's attention mass.

Encoder-decoder (whisper): ``AttentionConfig.use_rope`` off leaves q and k
unrotated, ``causal`` off drops the causal mask (the encoder's
self-attention); ``prefill_attention(..., kv_x=)`` and
``decode_attention(..., cross=)`` are cross-attention over the encoder's
output. As in JAX, these run on the ``dense`` reference (materialized
scores, plain tensor operations), never on a kernel.

On a serving mesh (``tp``, a ``distributed.layout.MeshLayout``, passed
down by the model) every function here runs on this rank's shard-local
shapes: its KV heads (or query groups) and, in the decode state, its
lanes; the kernels take those tensors as they are. The collectives GSPMD
inserts implicitly in the JAX package are named: k and v all-gathered
over ``model`` after the projection where ``wk``/``wv`` shard head_dim,
the output all-reduced after the row-parallel ``wo``, and H2O's and the
page ranking's sums over heads. Where the mesh geometry keeps the
kernels out (a batch the data axes do not divide, pages off the kernel's
8-token blocks: ``distributed.sharding.kernel_shardable``), the call
serves through the reference core instead and records the fallback,
with the JAX package's reason, in the engine's sink
(:func:`log_mesh_fallback`).

Conventions: x (B, S, d_model); q (B, S, KV, G, D); k, v (B, S, KV, D);
proj P (KV, D, D) per layer.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AquaConfig, AttentionConfig
from repro_torch.core import aqua as aqua_lib
from repro_torch.core import h2o as h2o_lib
from repro_torch.core import kvcache as kv
from repro_torch.core import selection
from repro_torch.core.dispatch import (REASON_NONDIVISIBLE_MESH,
                                       REASON_QUANT_RESIDENCY)
from repro_torch.distributed import sharding as dsh
from repro_torch.kernels import ops as kops
from repro_torch.kernels.aqua_decode import (aqua_decode_attention,
                                             aqua_decode_plain,
                                             aqua_paged_decode_attention)
from repro_torch.kernels.aqua_prefill import (aqua_prefill_attention,
                                              aqua_prefill_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

NEG_INF = -1e30

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Mesh fallbacks: the per-engine record
# ---------------------------------------------------------------------------


def log_mesh_fallback(tp, backend_name: str, mode: str, reason: str) -> None:
    """Record that ``mode`` ("prefill" or "decode") of ``backend_name``
    served through the reference core on ``tp``'s mesh for ``reason`` (a
    ``core.dispatch.REASON_*``) in the engine's sink (``tp.fallback_sink``,
    read by ``ContinuousBatchingEngine.mesh_fallback_events``), warning
    once per engine and key."""
    key = (backend_name, mode, reason)
    if key in tp.fallback_sink:
        return
    tp.fallback_sink.add(key)
    logger.warning(
        "attention backend %r: %s is falling back to the reference path "
        "for mesh-native serving%s", backend_name, mode,
        f" ({reason})" if reason else "")


# ---------------------------------------------------------------------------
# RoPE, norm, parameters, QKV
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, half-split (NeoX) form, over the last axis.
    x: (B, S, *, D); positions (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # (B, S, half)
    for _ in range(x.ndim - 3):
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x[..., 2 * half:]],
                     dim=-1)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm computed in float32, returned in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def init_attention_params(gen: torch.Generator, d_model: int,
                          cfg: AttentionConfig, dtype=torch.float32,
                          device=None) -> dict:
    """Random attention weights in the JAX layouts: wq (M, KV, G, D),
    wk/wv (M, KV, D), wo (KV, G, D, M); with ``qkv_bias`` zero biases bq
    (KV, G, D), bk/bv (KV, D), as the JAX package initializes them."""
    h, g, d = cfg.num_kv_heads, cfg.group_size, cfg.head_dim
    std = d_model ** -0.5

    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(std).to(dtype)
    p = {"wq": normal(d_model, h, g, d), "wk": normal(d_model, h, d),
         "wv": normal(d_model, h, d), "wo": normal(h, g, d, d_model)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h, g, d, dtype=dtype, device=device)
        p["bk"] = torch.zeros(h, d, dtype=dtype, device=device)
        p["bv"] = torch.zeros(h, d, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(d, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(d, dtype=dtype, device=device)
    return p


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., M) @ w (M, *rest) -> (..., *rest)."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def qkv(params: dict, x: torch.Tensor, cfg: AttentionConfig,
        positions: torch.Tensor, src: Optional[torch.Tensor] = None,
        tp=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q (B,S,KV,G,D), k (B,S,KV,D), v (B,S,KV,D), RoPE'd unless
    ``cfg.use_rope`` is off (learned or sinusoidal positions). ``src``
    (B, T, d_model): keys and values from it instead (cross-attention: no
    RoPE). The biases (``qkv_bias``) add before qk-norm and RoPE, as in
    JAX; every prefill, chunk and decode path projects through here.
    ``tp``: on a mesh where ``wk``/``wv`` shard head_dim, k and v are
    all-gathered over ``model`` before the biases, qk-norm and RoPE."""
    kv_src = x if src is None else src
    q = _proj_in(x, params["wq"])
    k = _proj_in(kv_src, params["wk"])
    v = _proj_in(kv_src, params["wv"])
    if tp is not None:
        k, v = tp.kv_full(k), tp.kv_full(v)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if not cfg.use_rope or src is not None:
        return q, k, v
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _proj_out(out: torch.Tensor, wo: torch.Tensor, tp=None) -> torch.Tensor:
    """out (..., KV, G, D) @ wo (KV, G, D, M) -> (..., M); on a mesh
    (``tp``) where ``wo`` is row-parallel, all-reduced over ``model``."""
    lead = out.shape[:-3]
    y = out.reshape(*lead, -1) @ wo.to(out.dtype).reshape(-1, wo.shape[-1])
    return y if tp is None else tp.attn_out(y)


# ---------------------------------------------------------------------------
# AQUA projection helpers
# ---------------------------------------------------------------------------


def project_q(q: torch.Tensor, proj: Optional[torch.Tensor]) -> torch.Tensor:
    if proj is None:
        return q
    return torch.einsum("bskgd,kde->bskge", q, proj.to(q.dtype))


def project_k(k: torch.Tensor, proj: Optional[torch.Tensor]) -> torch.Tensor:
    if proj is None:
        return k
    return torch.einsum("bskd,kde->bske", k, proj.to(k.dtype))


def _aqua_on(aqua: Optional[AquaConfig]) -> bool:
    return aqua is not None and aqua.enabled


def _stored(x: torch.Tensor, aqua: AquaConfig, head_dim: int
            ) -> torch.Tensor:
    """A projected q̂ or k̂ (…, E) in stored form (…, ``stored_dims``):
    its kept dims, then zeros. ``E`` is the projection's width: the full
    head dim, or the stored width of a projection the engine padded once
    (``aqua.stored_projection``), whose padding is already zero."""
    kept = aqua.kept_dims(head_dim)
    width = aqua_lib.stored_dims(aqua, head_dim)
    if x.shape[-1] >= width:
        x = x[..., :width]
    else:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    if kept < width:
        x[..., kept:] = 0
    return x


def _aqua_project(q, k, aqua: Optional[AquaConfig], proj, head_dim: int):
    """Project and statically slice q̂, k̂ to the stored width (no
    magnitude mask)."""
    if not _aqua_on(aqua):
        return q, k
    return (_stored(project_q(q, proj), aqua, head_dim),
            _stored(project_k(k, proj), aqua, head_dim))


def _aqua_mask(qh, aqua: AquaConfig, head_dim: int):
    """Per-query magnitude mask over the stored width: the top dims of the
    kept (real) ones; padding columns are 0."""
    kept = aqua.kept_dims(head_dim)
    m = aqua_lib.magnitude_mask(qh[..., :kept], aqua.topk_dims(head_dim),
                                block_dims=aqua.block_dims)
    return torch.nn.functional.pad(m, (0, qh.shape[-1] - kept))


def _chunk_tile_mask(qh, aqua: AquaConfig, q_blk: int,
                     lengths: Optional[torch.Tensor],
                     head_dim: Optional[int] = None) -> torch.Tensor:
    """Per-*tile* dim-block mask reproducing the block-sparse prefill's
    chunk-aggregated selection on the reference layout: all ``q_blk``
    queries of a tile share the block set their summed |q̂| picks.
    qh (B, T, KV, G, D) projected queries in stored form; ``lengths`` (B,)
    valid rows (padding is not aggregated). Returns a 0/1 mask shaped
    like ``qh`` (0 on padding columns; ``head_dim`` None: no padding)."""
    width = qh.shape[-1]
    if head_dim is not None:
        qh = qh[..., :aqua.kept_dims(head_dim)]
    b, t, kvh, g, d = qh.shape
    bd = aqua.block_dims
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=qh.device)
    qf = qh.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, t, d)
    tpad = aqua_lib.ceil_to(t, q_blk)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, tpad - t))
    bidx = aqua_lib.chunk_topk_block_indices(
        qf, kops.round_k_dims(d, aqua.k_ratio, bd), bd, q_blk, lengths)
    bmask = torch.zeros(b, kvh * g, tpad // q_blk, d // bd,
                        dtype=qh.dtype, device=qh.device)
    bmask.scatter_(-1, bidx.long(), 1.0)
    mask = bmask.repeat_interleave(bd, dim=-1).repeat_interleave(q_blk, dim=2)
    mask = mask[:, :, :t].reshape(b, kvh, g, t, d).permute(0, 3, 1, 2, 4)
    return torch.nn.functional.pad(mask, (0, width - d))


# ---------------------------------------------------------------------------
# Attention backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionBackend:
    """One registry entry (see the module docstring for the contract).
    ``aqua_native`` backends consume unmasked q̂/k̂ and need AQUA on;
    ``per_dim`` is the backend that serves their prefill when the
    selection is not by whole dim-blocks (on the masked q̂)."""

    name: str
    prefill: Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]
    decode: Optional[Callable[..., torch.Tensor]] = None
    paged_decode: Optional[Callable[..., torch.Tensor]] = None
    aqua_native: bool = False
    per_dim: Optional["AttentionBackend"] = None
    # the chunked-prefill step over the prefix stripe (block-sparse only)
    chunk: Optional[Callable[..., torch.Tensor]] = None
    # launches CUDA kernels (the JAX package's ``requires_pallas``)
    kernel: bool = False


_BACKENDS: Dict[str, AttentionBackend] = {}


def register_backend(backend: AttentionBackend) -> AttentionBackend:
    _BACKENDS[backend.name] = backend
    return backend


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def get_backend(name: str) -> AttentionBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown attention backend {name!r}; "
                       f"available: {available_backends()}") from None


def resolve_backend(name: str = "auto",
                    aqua: Optional[AquaConfig] = None,
                    grad: bool = False) -> AttentionBackend:
    """``auto`` is ``aqua-block-sparse`` with AQUA on and ``flash`` with it
    off; an AQUA-native backend with AQUA off resolves to ``flash`` (there
    are no projections to select over). ``grad`` (a call that autograd
    differentiates): ``auto`` is ``aqua-masked-dense`` with AQUA on and
    ``dense`` with it off, JAX's ``auto`` off the TPU and the only
    backends reverse mode runs through (the kernels have none and raise
    under grad). ``dense`` is never chosen automatically otherwise."""
    aqua_on = _aqua_on(aqua)
    if name in (None, "", "auto") and grad:
        name = "aqua-masked-dense" if aqua_on else "dense"
    if name in (None, "", "auto"):
        name = "aqua-block-sparse" if aqua_on else "flash"
    be = get_backend(name)
    if be.aqua_native and not aqua_on:
        be = get_backend("flash")
    return be


def _whole_blocks(aqua: AquaConfig, head_dim: int) -> bool:
    """Whether the selection is by whole dim-blocks of the kept head dim
    (``aqua.kept_dims(head_dim)``), which the block-sparse kernels need;
    otherwise prefill runs the backend's ``per_dim`` twin and decode the
    masked-dense core."""
    return (aqua.block_dims > 1
            and aqua.kept_dims(head_dim) % aqua.block_dims == 0)


def _dense_prefill(qq, kk, v, *, cfg, aqua, positions, lengths, causal):
    """Materialized-score reference (positions are 1-D here), with the
    sliding window of ``cfg`` on causal calls, as JAX's ``dense-jnp``. A
    non-causal call without ``lengths`` masks nothing: the encoder's
    self-attention, and cross-attention, whose T keys (the encoder's
    frames) need not be the S queries."""
    scores = torch.einsum("bskgd,btkd->bkgst", qq, kk)
    scores = scores.float() / float(cfg.head_dim) ** 0.5
    s = qq.shape[1]
    pos = positions
    if causal or lengths is not None:
        mask = torch.ones(1, s, s, dtype=torch.bool, device=qq.device)
        if causal:
            mask = mask & (pos[:, None] >= pos[None, :])[None]
            if cfg.window is not None:
                mask = mask & (pos[None, :] > pos[:, None] - cfg.window)[None]
        if lengths is not None:
            mask = mask & (pos[None, None, :] < lengths[:, None, None])
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", weights.to(v.dtype), v)
    return out, weights


def _flash_backend(name: str, flash_fn) -> AttentionBackend:
    """Flash prefill over ``flash_fn`` (the kernel or its plain version),
    on the head-major views of the model's tensors (no copy). Non-causal
    calls, 2-D positions and dk != dv (AQUA-Memory slices) go to
    ``dense``, as in JAX's ``_flash_prefill``.

    One deliberate difference from JAX, which sends every call with
    ``lengths`` to its dense reference: the engine's bucket-padded
    admissions (``lengths`` set, causal, 1-D positions) run the kernel,
    with the lengths masking the keys, so every row, pad rows too, is the
    dense-with-lengths result (an MoE routes the pad rows with the real
    ones, so their values decide which real tokens drop). Without this
    the engine's baseline would never launch the kernel."""

    def prefill(qq, kk, v, *, cfg, aqua, positions, lengths, causal):
        if not causal or positions.ndim == 2 or qq.shape[-1] != v.shape[-1]:
            return _dense_prefill(qq, kk, v, cfg=cfg, aqua=aqua,
                                  positions=positions, lengths=lengths,
                                  causal=causal)
        b, s, kvh, g, d = qq.shape
        of = flash_fn(qq.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, d),
                      kk.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                      causal=True, window=cfg.window,
                      lengths=None if lengths is None
                      else lengths.to(torch.int32).contiguous())
        return of.reshape(b, kvh, g, s, -1).permute(0, 3, 1, 2, 4), None

    return AttentionBackend(name, prefill, kernel=flash_fn is flash_attention)


def _block_sparse_backend(name: str, prefill_kernel, decode_kernel,
                          paged_decode_kernel,
                          per_dim: AttentionBackend) -> AttentionBackend:
    """AQUA block-sparse backend over the given kernel functions, with the
    shared selection of ``ops.prefill_blocks`` / ``ops.decode_blocks``
    (paged: ``selection.build_decode_plan``, which adds the participating
    pages of hierarchical AQUA), over the real (kept) dims of the stored
    q̂. Scores use the FULL head_dim. Prefill passes the sliding window of
    ``cfg`` to the kernel. Paged decode hands the kernel the page table
    (and an int8 pool's scales): no lane view is gathered."""

    def prefill(qh, kh, v, *, cfg, aqua, positions, lengths, causal):
        b, s, kvh, g, dk = qh.shape
        qf = qh.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, dk)
        of = kops.aqua_prefill(
            qf, kh.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), lengths,
            k_ratio=aqua.k_ratio, block_dims=aqua.block_dims,
            q_blk=aqua.prefill_q_blk, causal=causal, window=cfg.window,
            scale=1.0 / float(cfg.head_dim) ** 0.5,
            kept=aqua.kept_dims(cfg.head_dim), prefill_fn=prefill_kernel)
        return of.reshape(b, kvh, g, s, -1).permute(0, 3, 1, 2, 4), None

    def chunk(qh, k_stripe, v_stripe, *, cfg, aqua, q_offset, lengths,
              q_blk):
        """A prefill chunk of queries qh (B, T, KV, G, Dk) at sequence rows
        [q_offset, q_offset + T) against the key stripe k_stripe (B, KV,
        q_offset + T, Dk) / v_stripe; ``lengths`` (B,) global. Selection
        tiles of ``q_blk`` rows anchor at the chunk's first row
        (``ops.aqua_prefill_chunk``; the engine keeps cursors on tile
        boundaries, so no partial tile carries over)."""
        b, t, kvh, g, dk = qh.shape
        qf = qh.permute(0, 2, 3, 1, 4).reshape(b, kvh * g, t, dk)
        of, _ = kops.aqua_prefill_chunk(
            qf, k_stripe, v_stripe, lengths, q_offset=q_offset,
            k_ratio=aqua.k_ratio, block_dims=aqua.block_dims, q_blk=q_blk,
            scale=1.0 / float(cfg.head_dim) ** 0.5,
            kept=aqua.kept_dims(cfg.head_dim), prefill_fn=prefill_kernel)
        return of.reshape(b, kvh, g, t, -1).permute(0, 3, 1, 2, 4)

    def lengths_of(cache):
        return torch.clamp(cache.count, max=cache.num_slots).to(
            torch.int32).contiguous()

    def contiguous_decode(q_hat, cache: kv.AttnCache, *, cfg, aqua):
        b, kvh, g, dk = q_hat.shape
        q = q_hat.reshape(b, kvh * g, dk).contiguous()
        out = decode_kernel(q, cache.k, cache.v,
                            kops.decode_blocks(q, aqua.k_ratio,
                                               aqua.block_dims,
                                               aqua.kept_dims(cfg.head_dim)),
                            lengths_of(cache), block_dims=aqua.block_dims,
                            scale=1.0 / float(cfg.head_dim) ** 0.5)
        return out.reshape(b, kvh, g, -1)

    def paged_decode(q_hat, cache: kv.PagedAttnCache, *, cfg, aqua,
                     token_sparsity=None, tp=None):
        b, kvh, g, dk = q_hat.shape
        q = q_hat.reshape(b, kvh * g, dk).contiguous()
        kept_pages, pin = token_sparsity or (None, 0)
        plan = selection.build_decode_plan(
            q, cache, topk_dims=aqua.topk_dims(cfg.head_dim),
            block_dims=aqua.block_dims, kept_pages=kept_pages,
            pin_recent_pages=pin, kept=aqua.kept_dims(cfg.head_dim), tp=tp)
        out = paged_decode_kernel(
            q, cache.k_pool, cache.v_pool, plan.block_idx.contiguous(),
            page_table=cache.page_table.to(torch.int32).contiguous(),
            lengths=lengths_of(cache), block_dims=aqua.block_dims,
            scale=1.0 / float(cfg.head_dim) ** 0.5, k_scale=cache.k_scale,
            v_scale=cache.v_scale,
            part_idx=None if plan.pages is None else plan.pages.contiguous())
        return out.reshape(b, kvh, g, -1)

    return AttentionBackend(name, prefill, decode=contiguous_decode,
                            paged_decode=paged_decode, aqua_native=True,
                            per_dim=per_dim, chunk=chunk,
                            kernel=prefill_kernel is aqua_prefill_attention)


register_backend(AttentionBackend("dense", _dense_prefill))
register_backend(AttentionBackend("aqua-masked-dense", _dense_prefill))
register_backend(_flash_backend("flash", flash_attention))
register_backend(_block_sparse_backend(
    "aqua-block-sparse", aqua_prefill_attention, aqua_decode_attention,
    aqua_paged_decode_attention, get_backend("flash")))
register_backend(_block_sparse_backend(
    "aqua-block-sparse-plain", aqua_prefill_plain,
    functools.partial(aqua_decode_plain, page_table=None), aqua_decode_plain,
    _flash_backend("flash-plain", flash_attention_plain)))


# ---------------------------------------------------------------------------
# Prefill attention and the prefill -> cache handoff
# ---------------------------------------------------------------------------


def prefill_attention(params: dict, x: torch.Tensor, cfg: AttentionConfig,
                      aqua: Optional[AquaConfig] = None,
                      proj: Optional[torch.Tensor] = None,
                      positions: Optional[torch.Tensor] = None,
                      return_aux: bool = False,
                      lengths: Optional[torch.Tensor] = None,
                      kv_x: Optional[torch.Tensor] = None, tp=None):
    """Self-attention over a sequence, causal unless ``cfg.causal`` is off
    (windowed where ``cfg.window`` is set), dispatched through the backend
    registry (``cfg.backend``). ``lengths`` (B,) masks ragged rows' keys.
    ``kv_x`` (B, T, d_model) makes it cross-attention: keys and values
    from the encoder's output, no RoPE, no causal mask, on the ``dense``
    reference (as JAX sends it to ``dense-jnp``; pass ``aqua`` None).
    Returns out (B, S, d_model) [, aux with the post-RoPE ``q``/``k``
    (calibration capture), ``q_hat`` (the projected query in stored form
    under AQUA, else None), ``k_cache`` (k in the cache's stored form:
    projected and sliced under AQUA) and ``v``]. ``tp``: this rank's mesh
    layout (heads shard-local; a kernel backend whose geometry the mesh
    does not admit serves the reference, recorded as a fallback)."""
    s = x.shape[1]
    if kv_x is not None and lengths is not None:
        raise ValueError(
            "`lengths` masks self-attention keys; ragged cross-attention "
            "would need encoder-side lengths (unsupported)")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = qkv(params, x, cfg, positions, src=kv_x, tp=tp)
    causal = cfg.causal and kv_x is None
    aqua_on = _aqua_on(aqua)
    qh, kh = _aqua_project(q, k, aqua, proj, cfg.head_dim)
    backend = resolve_backend(cfg.backend, aqua=aqua,
                              grad=torch.is_grad_enabled()
                              and (q.requires_grad or k.requires_grad
                                   or v.requires_grad))
    if kv_x is not None:
        backend = get_backend("dense")
    if backend.aqua_native and not _whole_blocks(aqua, cfg.head_dim):
        backend = backend.per_dim
    if (tp is not None and backend.kernel and not dsh.kernel_shardable(
            tp.mesh, cfg, aqua if backend.aqua_native else None,
            batch=x.shape[0])):
        log_mesh_fallback(tp, backend.name, "prefill",
                          REASON_NONDIVISIBLE_MESH)
        backend = get_backend("aqua-masked-dense" if aqua_on else "dense")
    if backend.aqua_native:
        qq, kk = qh, kh
    elif aqua_on:
        qq, kk = qh * _aqua_mask(qh, aqua, cfg.head_dim), kh
    else:
        qq, kk = q, k
    out, weights = backend.prefill(qq, kk, v, cfg=cfg, aqua=aqua,
                                   positions=positions, lengths=lengths,
                                   causal=causal)
    out = _proj_out(out.to(v.dtype), params["wo"], tp)
    if return_aux:
        return out, {"q": q, "k": k, "weights": weights,
                     "q_hat": qh if aqua_on else None, "k_cache": kh,
                     "v": v}
    return out


def build_cache_from_prefill(k_cache: torch.Tensor, v: torch.Tensor,
                             max_seq: int,
                             lengths: Optional[torch.Tensor] = None, *,
                             window: Optional[int] = None,
                             aqua: Optional[AquaConfig] = None,
                             q_hat: Optional[torch.Tensor] = None,
                             head_dim: Optional[int] = None, tp=None
                             ) -> kv.AttnCache:
    """Contiguous decode state after a prefill, for the slot policy that
    ``window`` and ``aqua.h2o_ratio`` imply. k_cache (B, S, KV, Dk) in
    stored form, v (B, S, KV, Dv).

    * Full cache and window ring: the last ``slots`` tokens, position p in
      slot p (full) or p % slots (ring). ``lengths`` (B,) (full cache
      only) starts ragged rows' ``count`` at their valid length; prompts
      longer than a full cache keep their last ``max_seq`` tokens.
    * H2O with S > slots: the ``slots - recent`` heavy hitters by the
      prompt's accumulated attention mass (AQUA-masked scores over q_hat
      (B, S, KV, G, Dk) in stored form, causal and windowed, softmax,
      summed over queries, heads and KV heads), then the ``recent`` last
      tokens; ``acc_score`` holds each kept slot's per-KV-head mass.

    Window rings and H2O place slots assuming a rectangular batch, so
    they refuse ``lengths``, as in JAX. ``tp``: on a mesh, the H2O mass
    sums over every rank's heads."""
    b, s, kvh, dk = k_cache.shape
    budget = h2o_lib.h2o_budget(aqua, max_seq)
    if lengths is not None and (window is not None or budget is not None):
        raise ValueError(
            "ragged `lengths` require the contiguous full-cache policy; "
            "sliding-window and H2O caches place slots assuming a "
            "rectangular batch — prefill unpadded rows separately or drop "
            "`lengths`")
    slots = kv.cache_slots(max_seq, window, budget)
    dev = k_cache.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    if budget is not None and s > slots:
        qq = q_hat * _aqua_mask(q_hat, aqua, head_dim)
        sc = torch.einsum("bskgd,btkd->bkgst", qq, k_cache).float()
        sc = sc / float(head_dim) ** 0.5
        seen = positions[:, None] >= positions[None, :]
        if window is not None:
            # combined H2O + window: out-of-window keys receive no mass
            seen &= positions[None, :] > positions[:, None] - window
        sc = torch.where(seen, sc, torch.full_like(sc, NEG_INF))
        acc = torch.softmax(sc, dim=-1).sum(dim=(2, 3))    # (B, KV, S)
        recent = h2o_lib.recent_len(aqua, slots)
        if tp is not None:
            acc = tp.sum_groups(acc)
        score = acc.sum(dim=1)
        if tp is not None:
            score = tp.sum_heads(score)
        score[:, s - recent:] = -float("inf")          # recents kept apart
        heavy = aqua_lib.topk_indices(score, slots - recent)
        sel = torch.cat([torch.sort(heavy, dim=-1)[0],
                         torch.arange(s - recent, s, device=dev).expand(
                             b, recent)], dim=-1)           # (B, slots)
        rows = torch.arange(b, device=dev)[:, None]
        return kv.AttnCache(
            k=k_cache[rows, sel].transpose(1, 2).contiguous(),
            v=v[rows, sel].transpose(1, 2).contiguous(),
            positions=sel.to(torch.int32),
            count=torch.full((b,), s, dtype=torch.int32, device=dev),
            acc_score=acc.gather(-1, sel[:, None, :].expand(-1, kvh, -1)))
    cache = kv.init_attn_cache(b, kvh, slots, dk, v.shape[-1],
                               k_cache.dtype, dev, h2o=budget is not None)
    start = max(0, s - slots)
    tok_pos = positions[start:]
    slot_idx = (tok_pos % slots if window is not None
                else tok_pos - start).long()
    cache.k[:, :, slot_idx] = k_cache[:, start:].transpose(1, 2)
    cache.v[:, :, slot_idx] = v[:, start:].transpose(1, 2)
    cache.positions[:, slot_idx] = tok_pos
    if lengths is None:
        cache.count.fill_(s)
    else:
        cache.count.copy_(lengths)
    return cache


# ---------------------------------------------------------------------------
# Chunked prefill: a prompt chunk against the lane's stored prefix
# ---------------------------------------------------------------------------


def prefixed_tail_attention(params: dict, x: torch.Tensor,
                            cfg: AttentionConfig, aqua: Optional[AquaConfig],
                            proj: Optional[torch.Tensor], *,
                            prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                            prefix_positions: torch.Tensor, prefix_len: int,
                            positions: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None,
                            select_q_blk: Optional[int] = None, tp=None):
    """Causal attention of a prompt chunk against a read-only cache prefix
    plus itself: the masked-dense reference chunk step (the JAX package
    serves every chunk step on it).

    x (1, T, d_model); prefix_k (1, KV, S, Dk) / prefix_v (1, KV, S, Dv)
    the lane's cache view (keys in stored form); prefix_positions (1, S),
    -1 empty; prefix keys attend where their position is in [0,
    prefix_len). positions (1, T) the chunk's absolute positions; lengths
    (1,) masks chunk padding. ``select_q_blk`` switches the AQUA selection
    from per query to per ``q_blk`` tile (:func:`_chunk_tile_mask`).
    Returns (out (1, T, d_model), k_cache (1, T, KV, Dk) in stored form,
    v (1, T, KV, Dv)). ``tp``: this rank's mesh layout."""
    q, k, v = qkv(params, x, cfg, positions, tp=tp)
    qh, kh = _aqua_project(q, k, aqua, proj, cfg.head_dim)
    if _aqua_on(aqua):
        if select_q_blk is not None:
            qq = qh * _chunk_tile_mask(qh, aqua, select_q_blk, lengths,
                                       cfg.head_dim)
        else:
            qq = qh * _aqua_mask(qh, aqua, cfg.head_dim)
        kk = kh
    else:
        qq, kk = q, k
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    qpos, ppos = positions, prefix_positions
    sp = torch.einsum("bskgd,bktd->bkgst", qq, prefix_k.to(qq.dtype))
    sp = sp.float() * scale
    mp = ((ppos >= 0) & (ppos < prefix_len))[:, None, None, None, :]
    st = torch.einsum("bskgd,btkd->bkgst", qq, kk).float() * scale
    mt = qpos[:, None, None, :, None] >= qpos[:, None, None, None, :]
    if lengths is not None:
        t = q.shape[1]
        mt = mt & (torch.arange(t, device=x.device)[None, :]
                   < lengths[:, None])[:, None, None, None, :]
    neg = torch.tensor(NEG_INF, device=x.device)
    scores = torch.cat([torch.where(mp, sp, neg), torch.where(mt, st, neg)],
                       dim=-1)
    weights = torch.softmax(scores, dim=-1)
    vals = torch.cat([prefix_v.to(v.dtype), v.transpose(1, 2)], dim=2)
    out = torch.einsum("bkgst,bktd->bskgd", weights.to(v.dtype), vals)
    return _proj_out(out.to(v.dtype), params["wo"], tp), kk, v


def chunk_attention(params: dict, x: torch.Tensor, cfg: AttentionConfig,
                    aqua: Optional[AquaConfig], proj: Optional[torch.Tensor],
                    *, prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                    prefix_positions: torch.Tensor, prefix_len: int,
                    positions: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    select_q_blk: Optional[int] = None, tp=None):
    """One layer's chunked-prefill attention (arguments and result as in
    :func:`prefixed_tail_attention`), dispatched by backend.

    With ``select_q_blk`` set on a block-sparse backend whose selection is
    by whole dim-blocks, the chunk runs the prefill kernel (or its plain
    version) with ``q_offset = prefix_len`` over the key stripe [0,
    prefix_len + T): the lane's stored prefix keys and values (already in
    ``prefix_k``/``prefix_v``, dequantized for int8 pools) followed by the
    chunk's fresh ones, with global lengths ``prefix_len + lengths``.
    With the chunk cursor a ``select_q_blk`` multiple its tiles select the
    monolithic admission's dim-blocks. Every other case runs
    :func:`prefixed_tail_attention`. The prefix is read before the chunk
    is written: recycled slots past the prefix still hold a previous
    tenant's state."""
    backend = resolve_backend(cfg.backend, aqua=aqua)
    if (select_q_blk is None or backend.chunk is None
            or not _whole_blocks(aqua, cfg.head_dim)):
        return prefixed_tail_attention(
            params, x, cfg, aqua, proj, prefix_k=prefix_k,
            prefix_v=prefix_v, prefix_positions=prefix_positions,
            prefix_len=prefix_len, positions=positions, lengths=lengths,
            select_q_blk=select_q_blk, tp=tp)
    q, k, v = qkv(params, x, cfg, positions, tp=tp)
    qh, kh = _aqua_project(q, k, aqua, proj, cfg.head_dim)
    t = x.shape[1]
    if lengths is None:
        lengths = torch.full((1,), t, dtype=torch.int32, device=x.device)
    k_stripe = torch.cat([prefix_k[:, :, :prefix_len].to(kh.dtype),
                          kh.transpose(1, 2)], dim=2)
    v_stripe = torch.cat([prefix_v[:, :, :prefix_len].to(v.dtype),
                          v.transpose(1, 2)], dim=2)
    out = backend.chunk(qh, k_stripe, v_stripe, cfg=cfg, aqua=aqua,
                        q_offset=prefix_len, lengths=prefix_len + lengths,
                        q_blk=select_q_blk)
    return _proj_out(out.to(v.dtype), params["wo"], tp), kh, v


# ---------------------------------------------------------------------------
# Decode attention (one step)
# ---------------------------------------------------------------------------


def _masked_dense_decode_core(qq, k, v, positions, count, *, head_dim: int,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference decode core. qq (B, KV, G, Dk) — masked when AQUA is on;
    k (B, KV, S, Dk); v (B, KV, S, Dv); positions (B, S); count (B,).
    Returns (out (B, KV, G, Dv), weights (B, KV, G, S) float32): the
    attention probabilities, which H2O accumulates."""
    scores = torch.einsum("bkgd,bksd->bkgs", qq, k.to(qq.dtype))
    scores = scores.float() / float(head_dim) ** 0.5
    vm = kv.valid_mask_from(positions, count, window=window)
    scores = torch.where(vm[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", weights.to(v.dtype), v), weights


def decode_attention(params: dict, x_t: torch.Tensor, cache,
                     cfg: AttentionConfig, aqua: Optional[AquaConfig] = None,
                     proj: Optional[torch.Tensor] = None,
                     write_mask: Optional[torch.Tensor] = None,
                     token_sparsity: Optional[Tuple[int, int]] = None,
                     cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     tp=None) -> torch.Tensor:
    """One decode step. x_t (B, d_model); ``cache`` an :class:`AttnCache`
    or :class:`PagedAttnCache` (one layer), updated in place. Returns out
    (B, d_model) in x_t's dtype. ``write_mask`` (B,) bool freezes
    masked-off lanes' cache (no write, no count advance, no H2O mass).
    ``cross`` = (k_enc, v_enc), each (B, S_enc, KV, D): cross-attention
    over the encoder's keys and values (the whisper decoder's), which
    leaves ``cache`` alone; plain tensor operations, as in JAX.

    The slot comes from the cache policy (ring under ``cfg.window``, H2O
    eviction under ``aqua.h2o_ratio`` < 1, both, or the full cache); the
    block-sparse kernels serve the full-cache policy only, exactly as
    JAX's ``kernel_ok`` decides. Window and H2O, and int8 pools with hot
    residents, decode the masked-dense core on the (gathered, dequantized,
    resident-overlaid) lane view, and H2O then adds the step's weights to
    the accumulated scores. ``token_sparsity`` (kept_pages,
    pin_recent_pages) engages hierarchical AQUA on a paged full cache:
    only each lane's participating pages (``core.selection``, ranked by
    this layer's ``acc_pool``) are attended, by the kernel and by the
    reference path alike.

    ``tp``: this rank's mesh layout. The lanes and heads are shard-local;
    where the engine found the mesh geometry closed to the kernels
    (``tp.decode_kernel_reason``), a step the kernel would serve runs the
    masked-dense core instead and records the fallback.
    """
    if cross is not None:
        k_enc, v_enc = cross
        # the query alone (k and v come from the encoder), RoPE-free
        q = qkv(params, x_t[:, None, :], cfg, None, src=x_t[:, None, :])[0]
        sc = torch.einsum("bkgd,bskd->bkgs", q[:, 0], k_enc).float()
        w = torch.softmax(sc / float(cfg.head_dim) ** 0.5, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", w.to(v_enc.dtype), v_enc)
        return _proj_out(out, params["wo"]).to(x_t.dtype)
    pos = cache.count
    q, k, v = qkv(params, x_t[:, None, :], cfg, pos[:, None], tp=tp)
    q, k_t, v_t = q[:, 0], k[:, 0], v[:, 0]        # (B,KV,G,D), (B,KV,D)
    aqua_on = _aqua_on(aqua)
    if aqua_on:
        q = _stored(torch.einsum("bkgd,kde->bkge", q, proj.to(q.dtype)),
                    aqua, cfg.head_dim)
        k_t = _stored(torch.einsum("bkd,kde->bke", k_t, proj.to(k_t.dtype)),
                      aqua, cfg.head_dim)
    window = cfg.window
    h2o = aqua_on and aqua.h2o_ratio < 1.0
    recent = h2o_lib.recent_len(aqua, cache.num_slots) if h2o else 0
    paged = isinstance(cache, kv.PagedAttnCache)
    if paged:
        slot, evict = kv.paged_select_slot(cache, window=window, h2o=h2o,
                                           recent_len=recent, tp=tp)
        kv.paged_insert(cache, slot, k_t, v_t, write_mask=write_mask,
                        evict_page=evict, tp=tp)
    else:
        kv.insert(cache, kv.select_slot(cache, window=window, h2o=h2o,
                                        recent_len=recent, tp=tp),
                  k_t, v_t, write_mask=write_mask)

    backend = resolve_backend(cfg.backend, aqua=aqua)
    full_cache = window is None and not h2o
    if (token_sparsity is not None and
            (not full_cache or token_sparsity[0] >= cache.pages_per_lane)):
        token_sparsity = None                  # every page participates
    kernel = (backend.aqua_native and full_cache
              and _whole_blocks(aqua, cfg.head_dim))
    if kernel and paged and cache.has_residents:
        # hot residents live only in the dequantized lane view: the int8
        # kernel reads the raw pages (on a mesh recorded, as in JAX)
        if tp is not None:
            log_mesh_fallback(tp, backend.name, "decode",
                              REASON_QUANT_RESIDENCY)
        kernel = False
    if kernel and tp is not None and tp.decode_kernel_reason is not None:
        log_mesh_fallback(tp, backend.name, "decode",
                          tp.decode_kernel_reason)
        kernel = False
    if kernel:
        if paged:
            out = backend.paged_decode(q, cache, cfg=cfg, aqua=aqua,
                                       token_sparsity=token_sparsity, tp=tp)
        else:
            out = backend.decode(q, cache, cfg=cfg, aqua=aqua)
    else:
        qq = q * _aqua_mask(q, aqua, cfg.head_dim) if aqua_on else q
        view = kv.paged_lane_view(cache) if paged else cache
        positions = view.positions
        if token_sparsity is not None:
            # the reference twin of the kernel's participation: slots of
            # dropped pages read position -1, which the valid mask drops
            part = selection.participating_pages(
                cache.acc_pool, cache.page_table, cache.count,
                page_size=cache.page_size, kept_pages=token_sparsity[0],
                pin_recent_pages=token_sparsity[1], tp=tp)
            keep = selection.participation_slot_mask(
                part, page_size=cache.page_size, num_slots=cache.num_slots)
            positions = torch.where(keep, positions,
                                    torch.full_like(positions, -1))
        out, weights = _masked_dense_decode_core(
            qq, view.k, view.v, positions, view.count, head_dim=cfg.head_dim,
            window=window)
        if h2o:
            if paged:
                kv.paged_accumulate_h2o(cache, weights, write_mask, tp)
            else:
                kv.accumulate_h2o(cache, weights, write_mask, tp)
    # an int8 pool's kernel (and its dequantized view) give float32, as
    # in JAX; the residual stream keeps the model dtype
    return _proj_out(out, params["wo"], tp).to(x_t.dtype)
