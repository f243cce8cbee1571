"""The serving-dispatch plan (port of the JAX package's ``core/dispatch.py``).

:class:`DispatchPlan` is the engine's one resolved, inspectable decision
(``ContinuousBatchingEngine.dispatch_plan()``): backend, cache layout,
pool precision, whether admissions chunk, whether hierarchical token
sparsity engages, and the reasons for each fallback. The ``REASON_*``
strings are the JAX package's, word for word, so a plan of the port reads
like the reference's.

A plan on a serving mesh (``mesh``, a ``launch.mesh.Mesh`` or any object
with a ``shape`` dict) resolves as JAX's does: ``mesh_native`` when the
attention kernels serve on shard-local shapes, else the reasons, among
them ``REASON_NONDIVISIBLE_MESH`` (a decode batch the data axes do not
divide) and ``REASON_PAGE_GEOMETRY`` (pages off the kernel's 8-token
blocks). Which meshes the engine serves at all is the engine's to say:
the ``encdec``, ``ssm`` and ``hybrid`` families are still refused there.
"Kernel" here means the port's CUDA kernels where the JAX package says
Pallas; the reason strings keep the reference's wording.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Cache layouts a plan can pick.
CACHE_CONTIGUOUS = "contiguous"
CACHE_PAGED = "paged"

# Fallback reasons (the JAX package's vocabulary).
REASON_NO_MESH = "no serving mesh installed"
REASON_REFERENCE_BACKEND = "backend has no Pallas decode kernel"
REASON_PER_DIM_SELECTION = (
    "block_dims <= 1 keeps the paper's per-dim selection "
    "(masked-dense semantics)")
REASON_WINDOW = "sliding-window policy needs per-slot position masking"
REASON_H2O = "H2O eviction needs the reference path's dense weights"
REASON_NONDIVISIBLE_MESH = "axis extents don't divide the serving mesh"
REASON_PAGE_GEOMETRY = (
    "page size doesn't tile into the kernel's 8-token sequence blocks")
REASON_QUANT_RESIDENCY = (
    "mixed-precision hot residents need the reference path's "
    "dequantized lane view")
REASON_QUANT_GEOMETRY = (
    "quantized pages only decode through the paged kernel's scale-folded "
    "path; this layout/backend combination dequantizes via the reference "
    "lane view")
# Chunked-prefill attribution (``DispatchPlan.chunked_prefill``).
REASON_NO_PREFILL_BUDGET = "no prefill_budget_tokens configured"
REASON_FRONTEND = (
    "modality frontend splices non-token embeddings at prefill time")
REASON_MOE_CAPACITY = (
    "MoE capacity routing is batch-shape dependent; chunk boundaries "
    "would change which tokens drop")
REASON_FAMILY_SURGERY = (
    "model family lacks chunk-resumable lane surgery (recurrent state "
    "is not a slot cache)")
REASON_CHUNK_GEOMETRY = (
    "prefill budget is not a multiple of the kernel's q-chunk tile — "
    "chunk boundaries would change the dim-block selection")
# Hierarchical token-sparsity attribution (``DispatchPlan.token_sparsity``).
REASON_TOKEN_WINDOW = (
    "sliding-window policy already bounds the token set; page-granular "
    "participation would double-mask it")
REASON_TOKEN_H2O = (
    "H2O eviction reshapes the page set mid-flight; page participation "
    "needs a stable table within a step")

#: Backends whose prefill selects dim-blocks per kernel q-tile: chunk
#: cursors must land on tile boundaries (``REASON_CHUNK_GEOMETRY``).
TILE_SELECTING_BACKENDS = ("aqua-block-sparse", "aqua-block-sparse-plain")


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """The engine's resolved serving-dispatch decision (fields as in the
    JAX package): ``backend`` name, ``cache_layout``, ``mesh_native``
    (the kernels serve on the mesh's shard-local shapes: what
    ``launch.serve --expect-kernel-mesh`` requires), ``prefix_sharing``,
    ``reasons`` (why not mesh-native), ``chunked_prefill`` and ``chunked_reasons`` (why
    admissions stay monolithic), ``quantization`` ("none" / "int8" /
    "int8-mixed") and ``token_sparsity`` ("none" / "hierarchical") with
    ``token_reasons``."""

    backend: str
    cache_layout: str
    mesh_native: bool
    prefix_sharing: bool
    reasons: Tuple[str, ...] = ()
    chunked_prefill: bool = False
    chunked_reasons: Tuple[str, ...] = ()
    quantization: str = "none"
    token_sparsity: str = "none"
    token_reasons: Tuple[str, ...] = ()

    @property
    def paged(self) -> bool:
        return self.cache_layout == CACHE_PAGED


def resolve_dispatch_plan(*, attention, aqua, serving, mesh,
                          prefix_sharing: bool = False,
                          batch: Optional[int] = None,
                          family: str = "dense",
                          frontend: str = "none") -> DispatchPlan:
    """Resolve the plan for a model's ``attention``/``aqua`` configs, a
    ``ServingConfig`` and a serving ``mesh`` (or None), with the JAX
    package's rules. ``batch`` is the decode batch (default
    ``serving.max_lanes``).
    ``prefix_sharing`` is the engine's effective decision (the config's,
    folded with the slot policy), recorded as it is, as in JAX.
    ``family`` and ``frontend`` (the model's family and frontend kind)
    decide, with the rest, whether admissions may chunk: capacity-routed
    MoE and embedding-splicing frontends may not, as in JAX."""
    from repro_torch.configs.base import (resolve_cache_specs,
                                          resolve_sparsity_spec)
    from repro_torch.core.attention import resolve_backend
    from repro_torch.core.h2o import h2o_budget
    from repro_torch.distributed import sharding as dsh

    cache_spec, quant_spec = resolve_cache_specs(serving)
    sparsity_spec = resolve_sparsity_spec(serving)
    paged = cache_spec.paged
    aqua_on = aqua is not None and aqua.enabled
    h2o = aqua_on and h2o_budget(aqua, serving.max_seq) is not None
    if batch is None:
        batch = serving.max_lanes
    reasons = [REASON_NO_MESH] if mesh is None else []
    be = None
    backend_name = "none"
    if attention is not None:
        be = resolve_backend(attention.backend, aqua=aqua)
        backend_name = be.name
    decode_fn = None
    if be is not None:
        decode_fn = be.paged_decode if paged else be.decode
    if be is None or not (be.kernel and decode_fn is not None):
        reasons.append(REASON_REFERENCE_BACKEND)
    else:
        if aqua_on and aqua.block_dims <= 1:
            reasons.append(REASON_PER_DIM_SELECTION)
        if attention.window is not None:
            reasons.append(REASON_WINDOW)
        if h2o:
            reasons.append(REASON_H2O)
        if quant_spec.quantized and quant_spec.hot_resident_fraction > 0:
            reasons.append(REASON_QUANT_RESIDENCY)
        if mesh is not None and not dsh.kernel_shardable(
                mesh, attention, aqua, batch=batch,
                page_size=cache_spec.page_size):
            if (cache_spec.page_size is not None
                    and cache_spec.page_size % dsh.KERNEL_PAGE_MULTIPLE != 0):
                reasons.append(REASON_PAGE_GEOMETRY)
            else:
                reasons.append(REASON_NONDIVISIBLE_MESH)
    if quant_spec.mode != "none" and any(
            r not in (REASON_NO_MESH, REASON_QUANT_RESIDENCY)
            for r in reasons):
        reasons.append(REASON_QUANT_GEOMETRY)

    chunked_reasons = []
    if serving.prefill_budget_tokens is None:
        chunked_reasons.append(REASON_NO_PREFILL_BUDGET)
    if attention is None or family not in ("dense", "vlm", "moe"):
        chunked_reasons.append(REASON_FAMILY_SURGERY)
    elif family == "moe":
        chunked_reasons.append(REASON_MOE_CAPACITY)
    if frontend != "none":
        chunked_reasons.append(REASON_FRONTEND)
    if attention is not None:
        if attention.window is not None:
            chunked_reasons.append(REASON_WINDOW)
        if h2o:
            chunked_reasons.append(REASON_H2O)
        # the block-sparse prefill selects per q_blk tile: chunk cursors
        # must land on tile boundaries or a straddling tile would select
        # other dim-blocks than the monolithic admission
        if (serving.prefill_budget_tokens is not None
                and backend_name in TILE_SELECTING_BACKENDS and aqua_on
                and aqua.block_dims > 1
                and serving.prefill_budget_tokens % aqua.prefill_q_blk != 0):
            chunked_reasons.append(REASON_CHUNK_GEOMETRY)

    token_reasons = []
    if sparsity_spec.hierarchical and attention is not None:
        if attention.window is not None:
            token_reasons.append(REASON_TOKEN_WINDOW)
        if h2o:
            token_reasons.append(REASON_TOKEN_H2O)
    hierarchical = (sparsity_spec.hierarchical and attention is not None
                    and not token_reasons)

    return DispatchPlan(
        backend=backend_name,
        cache_layout=CACHE_PAGED if paged else CACHE_CONTIGUOUS,
        mesh_native=mesh is not None and not reasons,
        prefix_sharing=prefix_sharing,
        reasons=tuple(reasons), chunked_prefill=not chunked_reasons,
        chunked_reasons=tuple(chunked_reasons),
        quantization=quant_spec.mode,
        token_sparsity="hierarchical" if hierarchical else "none",
        token_reasons=tuple(token_reasons))
