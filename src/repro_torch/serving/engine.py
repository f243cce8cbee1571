"""Serving engines (PyTorch port): rectangular batch (``ServeEngine``) and
continuous batching (``ContinuousBatchingEngine``).

``ServeEngine`` is the JAX package's calibrate-once/serve API: one
rectangular prompt batch prefills together and decodes in lockstep for a
fixed number of steps. It steps eagerly (``model.decode_step`` per step,
no step graph): it serves comparisons and scoring-style drives, not
traffic.

``ContinuousBatchingEngine`` is the port of the JAX package's engine of
that name, on the contiguous
or the paged KV cache (paged: optionally with int8 pools, ``QuantSpec``,
and hierarchical AQUA, ``SparsitySpec``). Requests are admitted into fixed
decode *lanes* (batch rows of one shared decode state); a monolithic
admission prefills its prompt alone (bucket-padded, ragged ``lengths``)
and grafts the cache into its lane — a row copy on the contiguous cache, a
scatter into the pages the host allocator reserved on the paged pool.

Chunked prefill (``ServingConfig.prefill_budget_tokens``, when the
:class:`~repro_torch.core.dispatch.DispatchPlan` admits it): a prompt
whose padded prefill exceeds the budget enters a PREFILLING lane and is
written chunk by chunk between decode steps (``DenseLM.prefill_chunk``),
oldest lane first, at most the budget per step; non-final chunks keep the
cursor aligned to the bucket, the page size and, on the block-sparse
backends, the kernel's ``prefill_q_blk``; the final chunk samples the
first token. A decoding lane thus never waits longer than one budget of
prefill. Greedy tokens equal monolithic admission's.

Sliding-window and H2O models (``CacheSpec.eviction``, resolved from the
config) hold fewer slots per lane (``kvcache.cache_slots``): a ring, a
heavy-hitter budget, or both. They admit at the prompt's exact length (no
bucket padding, no ragged ``lengths``: their slot placement assumes a
rectangular batch), a paged lane reserves its whole page stripe (the ring
wraps and eviction reuses pages), and they never chunk, as in JAX.

Every decode step runs all ``max_lanes`` lanes; inactive and PREFILLING
lanes ride along under a ``write_mask`` that freezes their cache. The
per-lane bookkeeping (last token, counters, stop rules) lives on the host:
the host reads each step's sampled tokens anyway.

On the card the decode step is one CUDA graph (:class:`~repro_torch.
serving.step_graph.StepGraph`, the counterpart of the JAX engine's jitted
step), captured once per engine over its decode state at the first
``serve()``, before any admission, and replayed every step; sampling runs
on the replayed logits. A bucket-padded monolithic admission is one CUDA
graph per prompt bucket (:class:`~repro_torch.serving.admit_graph.
AdmitGraph`, the counterpart of the JAX engine's jitted ``_admit`` /
``_admit_paged``): captured at the bucket's first admission, replayed for
every later one into any lane, all of an engine's admission graphs in one
shared memory pool. Exact-length window and H2O admissions and chunk
steps run eagerly. The state is allocated once and emptied in place at
each later ``serve()``: the graphs hold its addresses, so admissions, page
tables and chunk writes update it in place too. On the CPU the engine
runs the same admission and ``model.decode_step`` directly.

Under AQUA the engine pads the projections once, at construction, to the
stored K̂ width (``aqua.stored_projection``): AQUA-Memory kept widths that
are not a multiple of 8 then run the bf16 kernels on zero-padded q̂/K̂.

Greedy sampling is ``argmax`` (first index among ties, as in the JAX
package). Temperature sampling draws Gumbel noise from a
``torch.Generator`` seeded per (serve, request uid, token index), so it is
independent of lane placement but not the JAX package's random stream.

Prefix sharing (``CacheSpec.prefix_sharing``, on by default as in JAX;
paged, full-cache policy): prompts that share page-aligned leading pages
map the same physical pages (``PagePool``: refcounts and a chain-hash
index). An admission whose prompt's leading full pages are indexed maps
them read-only, keeping at least one tail token, and prefills only the
tail against them (``DenseLM.prefill_with_prefix``, per-query dim
selection as in JAX's ``_admit_prefix``), eagerly on the card too;
a fresh admission replays its bucket's graph. Both then index the
prompt's full pages (a chunked admission after its final chunk). Decode
writes only private pages: a shared page is always a full prompt page.

Recurrent families (``ssm``: Mamba-2, no attention, served without
AQUA; ``hybrid``: RecurrentGemma, RG-LRU blocks beside local attention
with AQUA): admissions run at the prompt's exact length and eagerly (no
bucket: JAX's ``_supports_ragged`` holds for dense, vlm and moe only),
never chunk (the plan's ``REASON_FAMILY_SURGERY``) and never share a
prefix; the decode state is contiguous only (a paged cache raises
``ValueError``, as in JAX) and, on the card, the step graph captures their
decode step as any other's.

Modality frontends (``Request.extra_inputs``, merged into the request's
prefill batch, as in JAX): a VLM (``vlm``) splices a request's projected
patch embeddings over its first prompt positions, bucket-padded like any
prompt, paged or contiguous; on the card such an admission replays its
bucket's graph for admissions with patches (``frontend_admit_graphs``),
one without patches the bucket's plain graph. The encoder-decoder
(``encdec``, whisper) encodes a request's frames at its admission, which
runs at the prompt's exact length (no bucket, as JAX's ``_supports_ragged``
decides) and eagerly, like window and H2O admissions, and grafts the
lane's cross K/V with its cache; its decode state is contiguous only (a
paged cache raises ``ValueError``, as in JAX). Admissions with frontend
inputs never chunk (``REASON_FRONTEND``) and never share or index a
prefix: their embeddings are not the tokens'.

int8 pools serve every slot policy: a window's wrapped ring keeps growing
a re-entered page's running scale, as in JAX, and an evicted page's
scales are cleared. Mixed-precision hot residents
(``QuantSpec.hot_resident_fraction`` > 0, int8 pools): ``max(1,
round(fraction · num_pages))`` pages are also kept in the model dtype; each
admission promotes its lane's freshest page, inserts write through, and
decode reads the dequantized lane view with the residents overlaid (the
masked-dense core, as in JAX: the int8 kernel reads raw pages).

Serving on a mesh (``mesh=``, a :class:`~repro_torch.launch.mesh.Mesh`,
or ``ServingConfig.mesh_shape``, which builds one from the ``torchrun``
environment): the engine is one rank of an SPMD program, one per mesh
position, every rank driving the same trace. Params and the KV cache
shard over ``model`` by ``distributed.sharding``'s rules (the rank's
model holds its heads, ``distributed.layout.MeshLayout`` names the
collectives), decode lanes over the data axes (an order interleaved
across data shards fills them); a lane count the data axes do not divide
keeps every lane on every rank. The slot axis stays whole on every rank
(JAX's kernel-native layout, ``slot_absorb=False``). An admission (B=1)
is computed by every data rank that holds the lane's cache: paged, every
data rank (each writes its replica of the pool, which never shards over
data; only the owner installs the lane's table row), contiguous, the
owning data rank. Decode computes the rank's own lanes; the sampled
tokens are all-gathered over the data axes, so every rank's host-side
lanes and scheduler stay in lockstep (arrivals are in decode steps; no
rank reads its clock to schedule). With a ``model`` axis of 1 the decode
step and the owner's admissions keep their CUDA graphs; with ``model`` >
1 (collectives inside the step, over gloo where ranks share a card) both
run eagerly and ``step_graph`` stays None; so does an MoE's decode step
where lanes split over the data axes (its routing block gathers every
lane). Every cache policy is served on a mesh: int8 pools (per-page
scales with their KV heads, or one per page, its amax taken over
``model``), hot residents (promotion's mass summed over every head;
decode on the masked-dense core, ``REASON_QUANT_RESIDENCY`` recorded as
a fallback, as in JAX), sliding windows (each data rank owns its lanes'
rings; exact-length admissions), H2O and hierarchical AQUA. The families
``dense``, ``moe`` and ``vlm`` are served; ``encdec``, ``ssm`` and
``hybrid`` are refused (``NotImplementedError``, by name).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ModelConfig, ServingConfig,
                                      resolve_cache_specs, resolve_eviction,
                                      resolve_sparsity_spec)
from repro_torch.core import aqua as aqua_lib
from repro_torch.core import kvcache as kvc
from repro_torch.core.attention import resolve_backend
from repro_torch.core.calibration import AquaProjections
from repro_torch.core.dispatch import (REASON_NONDIVISIBLE_MESH,
                                       REASON_PAGE_GEOMETRY,
                                       TILE_SELECTING_BACKENDS, DispatchPlan,
                                       resolve_dispatch_plan)
from repro_torch.models import build_model
from repro_torch.models.base import MESH_FAMILIES, PagingSpec
from repro_torch.models.layers import cross_entropy, with_unembedding
from repro_torch.runtime import resolve_device
from repro_torch.serving.admit_graph import AdmitGraph, admission
from repro_torch.serving.scheduler import (LaneScheduler, PagePool, Request,
                                           RequestOutput, ScheduleStats,
                                           StreamEvent)
from repro_torch.serving.step_graph import StepGraph

NEG_INF = -1e30


def decode_state_bytes(model, batch_size: int, max_seq: int) -> int:
    """KV-cache footprint of a decode state, shape-only (allocated on the
    ``meta`` device): the one source of cache-byte accounting for both
    engines. A paged pool is counted once, not per lane."""
    state = model.init_decode_state(batch_size, max_seq, device="meta")
    return kvc.tree_bytes(state.layers)


def sample_tokens(logits: torch.Tensor, temperature: np.ndarray,
                  top_k: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """Per-row sampling. logits (N, V); temperature (N,) (<= 0: greedy);
    top_k (N,) (0: no filter; ties at the k-th logit are kept); seeds (N,)
    per-row noise seeds. Returns (N,) int32 tokens on the host."""
    tok = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
    for i in np.nonzero(temperature > 0)[0]:
        lg = logits[i].float()
        if top_k[i] > 0:
            thr = torch.topk(lg, int(top_k[i])).values[-1]
            lg = torch.where(lg >= thr, lg, torch.full_like(lg, NEG_INF))
        gen = torch.Generator(device=lg.device)
        gen.manual_seed(int(seeds[i]))
        u = torch.rand(lg.shape, generator=gen, device=lg.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        tok[i] = int(torch.argmax(lg / float(temperature[i]) + gumbel))
    return tok


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, steps)
    logits_last: np.ndarray     # (B, V) float32: the last step's logits


class ServeEngine:
    """Rectangular-batch engine::

        eng = ServeEngine(cfg, params, proj, max_seq=256)
        res = eng.generate({"tokens": prompts}, steps=16)   # (B, 16)

    ``device`` None serves on the CUDA card (raises without one); the
    tests pass ``device="cpu"``. Greedy (temperature 0) tokens are the
    JAX ``ServeEngine``'s; temperature sampling draws Gumbel noise from
    ``torch.Generator``s seeded per (call, step, row), not JAX's stream.
    """

    def __init__(self, cfg: ModelConfig, params,
                 projections: Optional[AquaProjections] = None,
                 max_seq: int = 4096, rng_seed: int = 0,
                 backend: Optional[str] = None, device=None):
        if backend is not None and cfg.attention is not None:
            resolve_backend(backend, aqua=cfg.aqua)
            cfg = dataclasses.replace(
                cfg, attention=dataclasses.replace(cfg.attention,
                                                   backend=backend))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.params = with_unembedding(params, self.model.tied_unembedding)
        self.proj = None
        if cfg.aqua is not None and cfg.aqua.enabled:
            assert projections is not None, \
                "AQUA enabled: calibrated projections required"
            self.proj = aqua_lib.stored_projection(
                projections.p.to(self.device), cfg.aqua,
                cfg.attention.head_dim)
        self.max_seq = max_seq
        self._rng_seed = rng_seed
        self._calls = 0

    def _sample(self, logits: torch.Tensor, temperature: float,
                step: int) -> np.ndarray:
        b = logits.shape[0]
        seeds = np.array([int(np.random.SeedSequence(
            [self._rng_seed, self._calls, step, row]).generate_state(1)[0])
            for row in range(b)]) if temperature > 0 else np.zeros(b)
        return sample_tokens(logits, np.full(b, temperature, np.float32),
                             np.zeros(b, np.int64), seeds)

    def generate(self, batch: Dict[str, object], steps: int,
                 temperature: float = 0.0) -> GenerationResult:
        """batch: prompt inputs ({"tokens": (B, S_prompt)}, optionally
        ragged ``"lengths"`` (B,) — the dense, vlm and moe families only,
        as in JAX — and a frontend's "patches" or "frames"), numpy arrays
        or tensors. The first token comes from the prefill, the other
        ``steps - 1`` from decode steps."""
        if "lengths" in batch and self.cfg.family not in ("dense", "vlm",
                                                          "moe"):
            raise ValueError(
                "ragged `lengths` prefill is only supported by the "
                "dense-transformer families (dense/vlm/moe); "
                f"{self.cfg.family!r} prefill is rectangular")
        self._calls += 1
        inputs = {k: torch.as_tensor(v).to(
            self.device, torch.int32 if k in ("tokens", "lengths") else None)
            for k, v in batch.items()}
        logits, state = self.model.prefill(self.params, inputs, self.max_seq,
                                           aqua_proj=self.proj)
        out = [self._sample(logits, temperature, 0)]
        for i in range(1, steps):
            tok = torch.from_numpy(out[-1]).to(self.device)
            logits, state = self.model.decode_step(self.params, state, tok,
                                                   aqua_proj=self.proj)
            out.append(self._sample(logits, temperature, i))
        return GenerationResult(tokens=np.stack(out, axis=1),
                                logits_last=logits.float().cpu().numpy())

    @torch.no_grad()
    def score(self, batch: Dict[str, object]) -> torch.Tensor:
        """Teacher-forced mean NLL (0-d float32 tensor) of
        ``batch["labels"]`` given ``batch["tokens"]`` (and a frontend's
        inputs) at the engine's AQUA operating point, every position
        counted, as JAX's ``score``: the full-sequence forward on the
        engine's backend (on the card the prefill kernel, or flash with
        AQUA off), under ``torch.no_grad()``."""
        inputs = {k: torch.as_tensor(v).to(
            self.device, torch.int32 if k in ("tokens", "labels") else None)
            for k, v in batch.items()}
        logits = self.model.forward(self.params, inputs, aqua_proj=self.proj)
        if isinstance(logits, tuple):
            logits = logits[0]
        return cross_entropy(logits, inputs["labels"])

    def cache_bytes(self, batch_size: int) -> int:
        """KV-cache footprint at ``batch_size`` (AQUA-Memory savings show
        up here); see :func:`decode_state_bytes`."""
        return decode_state_bytes(self.model, batch_size, self.max_seq)


@dataclasses.dataclass
class LaneState:
    """Per-lane host bookkeeping (arrays of length ``max_lanes``)."""

    last_token: np.ndarray
    active: np.ndarray
    generated: np.ndarray
    max_new: np.ndarray
    temperature: np.ndarray
    top_k: np.ndarray
    eos_id: np.ndarray
    uid: np.ndarray

    @classmethod
    def empty(cls, n: int) -> "LaneState":
        z = np.zeros(n, np.int32)
        return cls(last_token=z.copy(), active=np.zeros(n, bool),
                   generated=z.copy(), max_new=z.copy(),
                   temperature=np.zeros(n, np.float32), top_k=z.copy(),
                   eos_id=z - 1, uid=z - 1)


class ContinuousBatchingEngine:
    """Continuous-batching serve stack (see the module docstring)::

        eng = ContinuousBatchingEngine(cfg, params, proj,
                                       serving=ServingConfig(max_lanes=4))
        for ev in eng.serve(requests):          # StreamEvent per token
            ...
        outs = eng.run(requests)                # or terminal outputs

    ``device`` None serves on the CUDA card (raises without one); the
    tests pass ``device="cpu"``. ``params`` must already live on it.
    ``last_admit_logits`` / ``last_step_logits`` hold the logits of the
    latest admission and decode step; on the card ``last_step_logits`` is
    the step graph's output tensor, valid until the next decode step, and
    ``last_admit_logits`` of a graphed admission the admission graph's,
    valid until the next admission (clone them to keep them).
    ``step_graph`` is the captured decode step (None on the CPU and before
    the first ``serve()``); ``admit_graphs`` the captured admissions by
    prompt bucket (empty on the CPU); ``graph_accounting()`` their
    capture ms and pool bytes; ``uses_graphs`` whether the engine captures
    them at all (on the card, unless a mesh's ``model`` axis puts
    collectives inside the step).

    ``mesh``: serve as this rank of a mesh (see the module docstring);
    ``params`` are then the rank's blocks, placed from host arrays by
    ``bridge.params_from_numpy(mesh=)`` (a whole tensor is refused), and
    ``projections`` whole (the engine keeps the rank's KV heads).
    ``mesh_fallback_events()`` lists the (backend, mode, reason) of every
    call that served the reference core instead of a kernel on the mesh.
    """

    def __init__(self, cfg: ModelConfig, params,
                 projections: Optional[AquaProjections] = None,
                 serving: ServingConfig = ServingConfig(),
                 rng_seed: int = 0, backend: Optional[str] = None,
                 device=None, mesh=None):
        if backend is not None and cfg.attention is not None:
            resolve_backend(backend, aqua=cfg.aqua)
            cfg = dataclasses.replace(
                cfg, attention=dataclasses.replace(cfg.attention,
                                                   backend=backend))
        serving.validate()
        cache, quant = resolve_cache_specs(serving)
        if mesh is None and serving.mesh_shape is not None:
            from repro_torch.launch.mesh import make_serving_mesh
            mesh = make_serving_mesh(serving.mesh_shape, serving.mesh_axes,
                                     device="cuda" if device is None
                                     else device)
        if mesh is not None:
            _check_mesh(mesh, cfg, serving, device)
        self.mesh = mesh
        self.sparsity_spec = resolve_sparsity_spec(serving)
        # an attention-free model (ssm) holds no slots to evict
        self.eviction = ("none" if cfg.attention is None
                         else resolve_eviction(cache, cfg.attention, cfg.aqua))
        self.cfg = cfg
        self.scfg = serving
        self.cache_spec = cache
        # ragged bucketed prefill needs the full-cache policy (window
        # rings and H2O eviction place slots assuming a rectangular batch);
        # the dense, vlm and moe families take it, as in JAX (an MoE's pad
        # rows are routed with its real ones, as JAX routes them); the
        # encoder-decoder, the ssm and the hybrid prefill at the exact
        # prompt length (a recurrent state would scan the pad rows)
        self._supports_ragged = (self.eviction == "none"
                                 and cfg.family in ("dense", "vlm", "moe"))
        # prefix sharing: shared pages are read-only, so the full-cache
        # policy only (H2O statistics and ring overwrites would write
        # them), and position-pure token K/V: no frontend splice
        self._prefix_ok = (cache.paged and cache.prefix_sharing
                           and self._supports_ragged
                           and cfg.frontend.kind == "none")
        # chunked prefill is the plan's to refuse (an MoE's capacity
        # routing depends on the chunk boundaries)
        self._plan = resolve_dispatch_plan(attention=cfg.attention,
                                           aqua=cfg.aqua, serving=serving,
                                           mesh=mesh,
                                           prefix_sharing=self._prefix_ok,
                                           family=cfg.family,
                                           frontend=cfg.frontend.kind)
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.layout = None
        self._lane_blocks, self._lane_lo = 1, 0
        self._local_lanes = serving.max_lanes
        self._lane_order = None
        if mesh is None:
            self.model = build_model(cfg, self.device)
        else:
            params = self._install_mesh(params)
        if cache.paged and not self.model.supports_paging:
            raise ValueError(f"family {cfg.family!r} does not support the "
                             "paged KV cache")
        # once, at load: the float32 unembedding (the step graph holds its
        # address)
        self.params = with_unembedding(params, self.model.tied_unembedding)
        self.proj = None
        if cfg.aqua is not None and cfg.aqua.enabled:
            assert projections is not None, \
                "AQUA enabled: calibrated projections required"
            # once, at load: cut to the kept dims and zero-padded to the
            # stored width, so q̂ and K̂ come out in stored form
            p = projections.p.to(self.device)
            if self.layout is not None:
                p = self.layout.shard_projection(p)
            self.proj = aqua_lib.stored_projection(p, cfg.aqua,
                                                   cfg.attention.head_dim)
        self._rng_seed = rng_seed
        self._serves = 0
        self._serve_idx = 0
        self.stats = ScheduleStats()
        self.page_pool: Optional[PagePool] = None
        self.last_state = None
        self.step_graph: Optional[StepGraph] = None
        # on the card a bucket-padded monolithic admission replays its
        # bucket's graph (one shared pool), a VLM's with patches that of
        # its bucket among the frontend graphs; exact-length window, H2O
        # and encoder-decoder admissions and chunk steps run eagerly
        self.admit_graphs: Dict[int, AdmitGraph] = {}
        self.frontend_admit_graphs: Dict[int, AdmitGraph] = {}
        self._admit_pool = None
        # collectives inside the step and the admission (a model axis > 1,
        # or an MoE routing lanes gathered over the data axes) keep both
        # eager
        self.uses_graphs = self.device.type == "cuda" and (
            mesh is None or (mesh.axis_size("model") == 1
                             and not (cfg.family == "moe"
                                      and self._lane_blocks > 1)))
        self._graphed_admissions = self.uses_graphs and self._supports_ragged
        self._num_slots = self.model.cache_slots(serving.max_seq)
        self._paged = cache.paged
        self._kept_pages = None
        self._hot_pages = 0
        if self._paged:
            if self._num_slots % cache.page_size != 0:
                raise ValueError(
                    f"cache slots ({self._num_slots}: window/H2O budget) "
                    f"must be a multiple of page_size={cache.page_size} so "
                    "the ring/eviction slot arithmetic tiles into whole "
                    "pages")
            self._pages_per_lane = kvc.paged_pages(self._num_slots,
                                                   cache.page_size)
            self._num_pages = cache.num_pages or (serving.max_lanes
                                                  * self._pages_per_lane)
            # hot residents: a fraction of the int8 pool also kept in full
            # precision (mixed precision), sized as in JAX
            if quant.quantized and quant.hot_resident_fraction > 0:
                self._hot_pages = max(1, int(round(
                    quant.hot_resident_fraction * self._num_pages)))
            # hierarchical AQUA: the participating page count, resolved
            # once (the table itself is per step and layer) where the plan
            # engages it and it drops a page
            if self._plan.token_sparsity == "hierarchical":
                kp = self.sparsity_spec.kept_pages(self._pages_per_lane)
                if kp < self._pages_per_lane:
                    self._kept_pages = kp
            self.model.enable_paging(PagingSpec(
                cache.page_size, self._num_pages, kv_dtype=quant.kv_dtype,
                scale_granularity=quant.scale_granularity,
                kept_pages=self._kept_pages,
                pin_recent_pages=self.sparsity_spec.pin_recent_pages,
                hot_pages=self._hot_pages))
        # chunked prefill, gated by the plan. Non-final chunks keep the
        # cursor bucket-aligned (ragged chunk batches) and page-aligned
        # (paged tail writes start at a page); on the block-sparse
        # backends also q_blk-aligned, so each chunk's kernel tiles select
        # the monolithic admission's dim-blocks
        self._chunked = (serving.prefill_budget_tokens is not None
                         and self._plan.chunked_prefill)
        self._chunk_align = serving.prompt_bucket
        if self._paged:
            self._chunk_align = math.lcm(self._chunk_align, cache.page_size)
        if mesh is not None:
            self._check_state_layout()
        self._tile_q_blk = None
        aq = cfg.aqua
        if (self._chunked and self._plan.backend in TILE_SELECTING_BACKENDS
                and aq is not None and aq.enabled and aq.block_dims > 1
                and aq.kept_dims(cfg.attention.head_dim) % aq.block_dims == 0):
            self._tile_q_blk = aq.prefill_q_blk
            self._chunk_align = math.lcm(self._chunk_align, self._tile_q_blk)

    def _install_mesh(self, params):
        """Build this rank's model (its heads, ``MeshLayout``), keep its
        blocks of ``params``, and lay the lanes over the data axes.
        Returns the rank's params."""
        from repro_torch.distributed.layout import MeshLayout
        mesh, s, cfg = self.mesh, self.scfg, self.cfg
        self.layout = MeshLayout.build(cfg, mesh)
        quant = resolve_cache_specs(s)[1]
        self.layout.scale_per_page = (quant.quantized
                                      and quant.scale_granularity == "page")
        for r in (REASON_NONDIVISIBLE_MESH, REASON_PAGE_GEOMETRY):
            if r in self._plan.reasons:
                self.layout.decode_kernel_reason = r
        self.model = build_model(self.layout.local_config(cfg), self.device)
        self.model.enable_mesh(self.layout)
        params = self.layout.check_params(params)
        dsize = mesh.data_size()
        if dsize > 1 and s.max_lanes % dsize == 0:
            # lanes in whole per-data-shard blocks; admissions fill them
            # interleaved across the shards, as JAX's engine does
            self._lane_blocks = dsize
            self._local_lanes = s.max_lanes // dsize
            self._lane_lo = mesh.data_index() * self._local_lanes
            per = self._local_lanes
            self._lane_order = [g * per + i for i in range(per)
                                for g in range(dsize)]
            self.layout.lanes = (self._lane_lo, per)
        return params

    def _check_state_layout(self) -> None:
        """The rank's decode state is exactly its blocks of the whole state
        under ``distributed.sharding.decode_state_pspec`` in the
        kernel-native layout (``slot_absorb=False``): shapes on the meta
        device."""
        from repro_torch.distributed import sharding as dsh
        s = self.scfg
        whole = build_model(self.cfg, "cpu")
        whole.enable_paging(self.model.paging)
        kv_ok, b_ok = dsh.state_shardable(
            self.mesh, kv_heads=self.cfg.attention.num_kv_heads,
            batch=s.max_lanes)
        glob = whole.init_decode_state(s.max_lanes, s.max_seq,
                                       device="meta").layers
        mine = self.model.init_decode_state(self._local_lanes, s.max_seq,
                                            device="meta").layers
        for f in dataclasses.fields(glob):
            name, g, loc = f.name, getattr(glob, f.name), getattr(mine,
                                                                  f.name)
            if g is None:
                continue
            spec = dsh.decode_state_pspec(name, tuple(g.shape), self.mesh,
                                          kv_shardable=kv_ok,
                                          batch_shardable=b_ok,
                                          slot_absorb=False)
            want = dsh.local_shape(g.shape, spec, self.mesh)
            if tuple(loc.shape) != want:
                raise AssertionError(f"rank's {name} {tuple(loc.shape)} is "
                                     f"not its block {want} of {spec}")

    def _local_lane(self, lane: int) -> Optional[int]:
        """``lane``'s index in this rank's decode state, or None when
        another data rank holds it."""
        i = lane - self._lane_lo
        return i if 0 <= i < self._local_lanes else None

    def _agree(self, tok: Optional[int], lane: int) -> int:
        """The token that ``lane``'s data rank sampled (on a mesh every data
        rank takes that rank's: ``tok`` None where this rank did not sample
        it); the lockstep of the host-side lanes."""
        mesh = self.mesh
        if mesh is None or mesh.data_size() == 1:
            return tok
        from repro_torch.distributed.collectives import all_gather
        t = torch.tensor([-1 if tok is None else tok], dtype=torch.int64,
                         device=self.device)
        got = all_gather(t, mesh, mesh.data_axes).tolist()
        return int(got[lane // self._local_lanes
                       if self._lane_blocks > 1 else 0])

    def dispatch_plan(self) -> DispatchPlan:
        """The engine's resolved :class:`DispatchPlan` (backend, layout,
        precision, chunked prefill, token sparsity, and the reasons)."""
        return self._plan

    def mesh_fallback_events(self):
        """(backend, mode, reason) of every call of THIS engine that served
        the reference core on its mesh instead of a kernel: empty means
        every kernel-backend step ran the kernels on shard-local shapes
        (``launch.serve --verify`` requires it of a mesh-native plan). The
        reasons are ``core.dispatch.REASON_*``, as in the plan."""
        if self.layout is None:
            return ()
        return tuple(sorted(self.layout.fallback_sink))

    @property
    def paged(self) -> bool:
        return self._paged

    @property
    def kept_pages(self) -> Optional[int]:
        """Participating pages per lane under hierarchical AQUA, or None
        when every page participates."""
        return self._kept_pages

    @property
    def hot_pages(self) -> int:
        """Full-precision hot-resident pages of an int8 pool (0: none)."""
        return self._hot_pages

    @property
    def pages_per_lane(self) -> Optional[int]:
        return self._pages_per_lane if self._paged else None

    @property
    def pool_geometry(self):
        """(num_pages, pages_per_lane, page_size) in paged mode, None
        otherwise. ``num_pages < max_lanes * pages_per_lane`` means the
        pool is smaller than the lane-stripe layout it replaces."""
        if not self._paged:
            return None
        return (self._num_pages, self._pages_per_lane,
                self.cache_spec.page_size)

    # -- host-side helpers ------------------------------------------------
    def _normalize(self, req: Request) -> Request:
        s = self.scfg
        out = dataclasses.replace(
            req,
            max_new_tokens=(s.max_new_tokens if req.max_new_tokens is None
                            else req.max_new_tokens),
            temperature=(s.temperature if req.temperature is None
                         else req.temperature),
            top_k=s.top_k if req.top_k is None else req.top_k,
            eos_id=s.eos_id if req.eos_id is None else req.eos_id)
        if out.prompt_len < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if out.prompt_len + out.max_new_tokens > s.max_seq:
            raise ValueError(
                f"request {req.uid}: prompt_len={out.prompt_len} + "
                f"max_new_tokens={out.max_new_tokens} exceeds "
                f"max_seq={s.max_seq}")
        return out

    def _padded_prompt_len(self, prompt_len: int,
                           budget: Optional[int] = None) -> int:
        """Prefill length after bucket padding, never past ``budget``
        slots (default ``max_seq``; a prefix-shared tail's is what the
        prefix leaves)."""
        if not self._supports_ragged:
            return prompt_len
        bucket = self.scfg.prompt_bucket
        padded = max(bucket, -(-prompt_len // bucket) * bucket)
        return min(padded, self.scfg.max_seq if budget is None else budget)

    def _prefill_batch(self, tokens: np.ndarray,
                       budget: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
        """Bucket-padded prompt (or prefix-shared tail) with its ragged
        length (one prefill shape per bucket, as in the JAX engine); the
        exact prompt, without ``lengths``, under a window or H2O."""
        tokens = np.asarray(tokens, np.int32)
        s = tokens.shape[-1]
        if not self._supports_ragged:
            return {"tokens": torch.from_numpy(tokens.reshape(1, s)).to(
                self.device)}
        padded = np.zeros((1, self._padded_prompt_len(s, budget)), np.int32)
        padded[0, :s] = tokens
        return {"tokens": torch.from_numpy(padded).to(self.device),
                "lengths": torch.tensor([s], dtype=torch.int32,
                                        device=self.device)}

    def _plan_pages(self, req: Request):
        """The page reservation of an admission, for the request's whole
        lifetime (prefill and decode): (shared prefix pages already in the
        pool, fresh pages), or None while the pool cannot cover it. Only
        full prompt pages are shared, and at least one tail token is left
        to give the prefill's logits. A window or H2O lane reserves its
        whole stripe: its slots wrap and evict across all of it."""
        ps = self.cache_spec.page_size
        shared = []
        if not self._supports_ragged:
            total_pages = self._pages_per_lane
        else:
            if self._prefix_ok and not req.extra_inputs:
                shared = self.page_pool.lookup_prefix(
                    req.tokens)[:(req.prompt_len - 1) // ps]
            prefix_len = len(shared) * ps
            tail_padded = self._padded_prompt_len(
                req.prompt_len - prefix_len, self.scfg.max_seq - prefix_len)
            total_slots = min(max(prefix_len + tail_padded,
                                  req.prompt_len + req.max_new_tokens),
                              self._num_slots)
            total_pages = -(-total_slots // ps)
        num_new = total_pages - len(shared)
        if not self.page_pool.can_reserve(num_new):
            return None
        return shared, num_new

    def _seed(self, uid: int, index: int) -> int:
        ss = np.random.SeedSequence([self._rng_seed, self._serve_idx, uid,
                                     index])
        return int(ss.generate_state(1)[0])

    # -- device work ------------------------------------------------------
    def _decode_state(self):
        """The lanes' decode state, empty: allocated at the first
        ``serve()`` (on the card the decode step is then captured over it,
        once), emptied in place at every later one."""
        if self.last_state is None:
            self.last_state = self.model.init_decode_state(
                self._local_lanes, self.scfg.max_seq)
            if self.uses_graphs:
                self.step_graph = StepGraph(self.model, self.params,
                                            self.last_state,
                                            aqua_proj=self.proj)
        else:
            # the extras (an encoder-decoder's cross K/V) stay: each
            # admission grafts its lane's whole share
            kvc.reset_cache(self.last_state.layers)
        return self.last_state

    def _frontend_inputs(self, req: Request) -> Dict[str, torch.Tensor]:
        """The request's frontend inputs as tensors on the device (the
        model casts them to its dtype)."""
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in (req.extra_inputs or {}).items()}

    def _admit(self, req: Request, lane: int, state, lanes: LaneState,
               page_plan=None):
        """Prefill ``req`` into ``lane`` and sample its first token (on the
        card a bucket-padded admission replays its bucket's admission
        graph; a prefix-shared one prefills its tail eagerly).
        ``page_plan`` is :meth:`_plan_pages`' reservation (paged).
        Returns (token, done)."""
        row = pages = None
        if self._paged:
            pages, row = self._reserve_pages(lane, page_plan)
        shared = 0 if page_plan is None else len(page_plan[0])
        # on a mesh: this rank's index of the lane, None when another data
        # rank holds it (then a paged admission still writes this rank's
        # replica of the pool, a contiguous one is that rank's alone)
        local = self._local_lane(lane)
        if shared:
            logits = self._admit_prefix(req, local, state, row, shared)
        elif local is None and not self._paged:
            logits = None
        elif self._graphed_admissions and local is not None:
            logits = self._admit_graphed(req, local, row)
        else:
            # what an admission graph captures, run eagerly (the CPU, and
            # window / H2O admissions: the exact prompt grafted into every
            # slot of the lane's stripe; encoder-decoder ones: the exact
            # prompt and the lane's cross K/V)
            batch = self._prefill_batch(req.tokens)
            logits = admission(
                self.model, self.params, state, self.proj, self.scfg.max_seq,
                batch["tokens"], batch.get("lengths"), local,
                None if row is None else torch.from_numpy(row).to(
                    self.device),
                num_slots=None if self._supports_ragged else self._num_slots,
                extra=self._frontend_inputs(req))
        if self._prefix_ok and not req.extra_inputs:
            # both kinds index the prompt's full pages: a prompt that
            # extends a shared prefix by more full pages indexes those too
            self.page_pool.register_prefix(req.tokens, pages, req.prompt_len)
        return self._finish_admit(req, lane, logits, lanes)

    def _admit_graphed(self, req: Request, lane: int,
                       row: Optional[np.ndarray]) -> torch.Tensor:
        """A monolithic admission through its bucket's
        :class:`AdmitGraph` (captured at the bucket's first admission; an
        admission with frontend inputs through the bucket's graph among
        ``frontend_admit_graphs``): the page-table row and the frontend
        inputs go in with the prompt and the lane. Returns the graph's
        logits (1, V)."""
        bucket = self._padded_prompt_len(req.prompt_len)
        extra = {k: np.asarray(torch.as_tensor(v).float().cpu())
                 for k, v in (req.extra_inputs or {}).items()}
        graphs = self.frontend_admit_graphs if extra else self.admit_graphs
        graph = graphs.get(bucket)
        if graph is None:
            if self._admit_pool is None:
                self._admit_pool = torch.cuda.graph_pool_handle()
            graph = graphs[bucket] = AdmitGraph(
                self.model, self.params, self.last_state, self.proj, bucket,
                self.scfg.max_seq, pool=self._admit_pool,
                frontend={k: v.shape for k, v in extra.items()})
        return graph.admit(np.asarray(req.tokens, np.int32), lane, row,
                           extra)

    def _admit_prefix(self, req: Request, lane: Optional[int], state,
                      row: np.ndarray, shared: int) -> torch.Tensor:
        """A prefix-shared admission (JAX's ``_admit_prefix``): the lane's
        row maps ``shared`` indexed prefix pages read-only, and only the
        prompt's tail prefills, bucket-padded within the slots the prefix
        leaves, against them, per-query dim selection; its K/V land from
        the first private page. Eager on the card too (the prefix length
        is a host int in ``prefill_with_prefix``). ``lane`` is the index in
        this rank's state, None on a mesh rank that holds the pool but not
        the lane (pages are read and written through ``row`` either way).
        Returns logits (1, V)."""
        pool = self.page_pool
        prefix_len = shared * self.cache_spec.page_size
        pool.prefix_hits += 1
        pool.tokens_saved += prefix_len
        row_t = torch.from_numpy(row).to(self.device)
        if lane is not None:
            kvc.install_table_row(state.layers, lane, row_t)
        batch = self._prefill_batch(np.asarray(req.tokens)[prefix_len:],
                                    budget=self.scfg.max_seq - prefix_len)
        logits, _ = self.model.prefill_with_prefix(
            self.params, batch, state, lane, prefix_len, aqua_proj=self.proj,
            select_q_blk=None, row=row_t)
        return logits

    def _reserve_pages(self, lane: int, page_plan) -> tuple:
        """Reserve ``page_plan``'s pages (:meth:`_plan_pages`) for
        ``lane``; returns (the lane's pages, its page-table row
        (pages_per_lane,) int32, -1 unmapped)."""
        shared, num_new = page_plan
        pages = self.page_pool.reserve(lane, shared, num_new)
        assert pages is not None       # _plan_pages checked can_reserve
        row = np.full(self._pages_per_lane, -1, np.int32)
        row[:len(pages)] = pages
        return pages, row

    def graph_accounting(self) -> dict:
        """The captured graphs of this engine: ``admit_graphs`` (one per
        prompt bucket admitted so far, and per bucket admitted with
        frontend inputs: ``frontend_admit_graphs``), each bucket's capture
        ms and pool growth (those with frontend inputs under
        ``frontend_admit_*``), the admission graphs' shared pool bytes,
        and the step graph's capture ms and pool bytes (None before the
        first serve and on the CPU)."""
        graphs = sorted(self.admit_graphs.items())
        fgraphs = sorted(self.frontend_admit_graphs.items())
        step = self.step_graph
        return dict(
            admit_graphs=len(graphs) + len(fgraphs),
            admit_capture_ms={b: g.capture_ms for b, g in graphs},
            admit_pool_growth_bytes={b: g.pool_bytes for b, g in graphs},
            frontend_admit_capture_ms={b: g.capture_ms for b, g in fgraphs},
            frontend_admit_pool_growth_bytes={b: g.pool_bytes
                                              for b, g in fgraphs},
            admit_pool_bytes=sum(g.pool_bytes for _, g in graphs + fgraphs),
            step_capture_ms=None if step is None else step.capture_ms,
            step_pool_bytes=None if step is None else step.pool_bytes)

    def _finish_admit(self, req: Request, lane: int, logits, lanes: LaneState):
        """The admission tail: sample the first token from the prefill
        logits and install the lane's bookkeeping (on a mesh, the token the
        lane's data rank sampled: ``logits`` None where this rank computed
        none). Returns (token, done)."""
        tok = None
        if logits is not None:
            self.last_admit_logits = logits
            tok = int(sample_tokens(logits, np.array([req.temperature],
                                                     np.float32),
                                    np.array([req.top_k]),
                                    np.array([self._seed(req.uid, 0)]))[0])
        tok = self._agree(tok, lane)
        done = ((req.eos_id >= 0 and tok == req.eos_id)
                or req.max_new_tokens <= 1)
        lanes.last_token[lane] = tok
        lanes.active[lane] = not done
        lanes.generated[lane] = 1
        lanes.max_new[lane] = req.max_new_tokens
        lanes.temperature[lane] = req.temperature
        lanes.top_k[lane] = req.top_k
        lanes.eos_id[lane] = req.eos_id
        lanes.uid[lane] = req.uid
        return tok, done

    # -- chunked prefill (host side) ------------------------------------
    def _should_chunk(self, req: Request, page_plan) -> bool:
        """Chunk this admission: the engine interleaves and the padded
        prefill (of the tail, past a shared prefix) exceeds the budget
        (shorter prompts admit monolithically, exactly as without a
        budget; a request with frontend inputs never chunks, as in JAX)."""
        if not self._chunked or req.extra_inputs:
            return False
        prefix_len = 0
        if page_plan is not None:
            prefix_len = len(page_plan[0]) * self.cache_spec.page_size
        return (self._padded_prompt_len(req.prompt_len - prefix_len,
                                        self.scfg.max_seq - prefix_len)
                > self.scfg.prefill_budget_tokens)

    def _admit_chunked(self, sched: LaneScheduler, req: Request, state,
                       page_plan) -> tuple:
        """Admit ``req`` into a PREFILLING lane: reserve its pages for the
        whole lifetime and install its page-table row (paged), and set the
        chunk cursor, past a shared prefix at its end. The budget loop
        writes the prompt. Returns (lane, job): the job holds the request,
        its pages to index after the final chunk and the chunks' dim
        selection (per tile for a fresh prompt on the block-sparse
        backends, per query past a shared prefix, as the prefix-shared
        admission selects)."""
        lane = sched.assign(req, prefilling=True)
        job = dict(req=req, pages=None, select=self._tile_q_blk, row=None)
        if self._paged:
            job["pages"], row = self._reserve_pages(lane, page_plan)
            job["row"] = torch.from_numpy(row).to(self.device)
            local = self._local_lane(lane)
            if local is not None:
                kvc.install_table_row(state.layers, local, job["row"])
            if page_plan[0]:
                pool = self.page_pool
                prefix_len = len(page_plan[0]) * self.cache_spec.page_size
                pool.prefix_hits += 1
                pool.tokens_saved += prefix_len
                sched.begin_prefill(lane, prefix_len, req.prompt_len)
                job["select"] = None
        return lane, job

    def _chunk_padded_len(self, cursor: int, count: int) -> int:
        """Tokens of a chunk's batch after bucket padding (its cost against
        the budget), clamped so the padding never runs past the cache."""
        bucket = self.scfg.prompt_bucket
        padded = max(bucket, -(-count // bucket) * bucket)
        cap = self._num_slots if self._paged else self.scfg.max_seq
        return min(padded, cap - cursor)

    def _chunk_batch(self, req: Request, cursor: int,
                     count: int) -> Dict[str, torch.Tensor]:
        """Prompt tokens [cursor, cursor + count), bucket-padded, with the
        ragged count (non-final chunks are align-sized: no padding)."""
        padded = np.zeros((1, self._chunk_padded_len(cursor, count)),
                          np.int32)
        padded[0, :count] = np.asarray(req.tokens, np.int32)[
            cursor:cursor + count]
        return {"tokens": torch.from_numpy(padded).to(self.device),
                "lengths": torch.tensor([count], dtype=torch.int32,
                                        device=self.device)}

    def _chunk(self, job: dict, lane: int, cursor: int, count: int,
               state, final: bool):
        """Run one chunk of ``job``'s prefill into ``lane``; returns the
        logits of its last valid row for the ``final`` chunk, else None
        (and None on a mesh rank that does not compute the lane's
        chunks: contiguous, another data rank's lane)."""
        local = self._local_lane(lane)
        if local is None and not self._paged:
            return None
        logits, _ = self.model.prefill_chunk(
            self.params, self._chunk_batch(job["req"], cursor, count), state,
            local, cursor, aqua_proj=self.proj, select_q_blk=job["select"],
            logits=final, row=job["row"])
        return logits

    def _step(self, state, lanes: LaneState):
        """One decode step over all lanes (on the card: one replay of the
        step graph); inactive lanes are frozen by the write mask and report
        ``pad_id``. On a mesh the step runs this rank's lanes and the
        sampled tokens are all-gathered over the data axes. Returns (tok,
        emitted, done)."""
        mine = slice(self._lane_lo, self._lane_lo + self._local_lanes)
        if self.step_graph is not None:
            logits = self.step_graph.replay(lanes.last_token[mine],
                                            lanes.active[mine])
        else:
            logits, _ = self.model.decode_step(
                self.params, state,
                torch.from_numpy(lanes.last_token[mine]).to(self.device),
                aqua_proj=self.proj,
                write_mask=torch.from_numpy(lanes.active[mine]).to(
                    self.device))
        self.last_step_logits = logits
        seeds = np.array([self._seed(int(u), int(g)) if t > 0 else 0
                          for u, g, t in zip(lanes.uid[mine],
                                             lanes.generated[mine],
                                             lanes.temperature[mine])])
        tok = sample_tokens(logits, lanes.temperature[mine],
                            lanes.top_k[mine], seeds)
        if self._lane_blocks > 1:
            from repro_torch.distributed.collectives import all_gather
            tok = all_gather(torch.from_numpy(tok).to(self.device),
                             self.mesh, self.mesh.data_axes).cpu().numpy()
        emitted = lanes.active.copy()
        tok = np.where(emitted, tok, self.scfg.pad_id).astype(np.int32)
        lanes.generated += emitted.astype(np.int32)
        done = emitted & (((tok == lanes.eos_id) & (lanes.eos_id >= 0))
                          | (lanes.generated >= lanes.max_new))
        lanes.last_token = np.where(emitted, tok, lanes.last_token)
        lanes.active &= ~done
        return tok, emitted, done

    # -- drive ---------------------------------------------------------------
    def serve(self, requests: Iterable[Request]) -> Iterator[StreamEvent]:
        """Drive a trace to completion, yielding one ``StreamEvent`` per
        generated token in emission order. Statistics land in
        ``self.stats`` (and ``self.page_pool`` when paged)."""
        self._serve_idx = self._serves
        self._serves += 1
        sched = LaneScheduler(self.scfg.max_lanes,
                              lane_order=self._lane_order)
        for r in requests:
            sched.submit(self._normalize(r))
        if self._paged:
            self.page_pool = PagePool(self._num_pages,
                                      self.cache_spec.page_size,
                                      prefix_sharing=self._prefix_ok)
        state = self._decode_state()
        lanes = LaneState.empty(self.scfg.max_lanes)
        self.last_lanes = lanes
        stats = ScheduleStats()
        self.stats = stats
        emitted_count: Dict[int, int] = {}
        last_emit: Dict[int, float] = {}
        jobs: Dict[int, dict] = {}         # PREFILLING lanes' bookkeeping
        now = 0.0

        def finish_reason(tok: int, req: Request) -> str:
            return ("eos" if req.eos_id is not None and req.eos_id >= 0
                    and tok == req.eos_id else "length")

        def record_emit(uid: int) -> None:
            t = time.perf_counter()
            if uid in last_emit:
                stats.itl_gaps.append(t - last_emit[uid])
            last_emit[uid] = t

        def retire(lane: int, uid: int) -> None:
            sched.retire(lane)
            if self._paged:
                self.page_pool.release(lane)
            stats.requests_finished += 1
            last_emit.pop(uid, None)

        def first_token(req: Request, lane: int, tok: int,
                        done: bool) -> StreamEvent:
            stats.admissions += 1
            stats.tokens_emitted += 1
            emitted_count[req.uid] = 1
            record_emit(req.uid)
            if done:
                retire(lane, req.uid)
            return StreamEvent(req.uid, tok, 0, done,
                               finish_reason(tok, req) if done else "")

        while sched.has_work:
            # admissions: fill free lanes with every arrived request; a
            # paged admission waits until the pool covers its lifetime,
            # with a bounded lookahead past a head that does not fit
            while True:
                req, page_plan, skip = None, None, 0
                unbounded = sched.num_active == 0
                while True:
                    cand = sched.pop_admissible(now, skip=skip)
                    if cand is None:
                        break
                    plan = None
                    if self._paged:
                        plan = self._plan_pages(cand)
                        if plan is None:
                            sched.unpop(cand)
                            skip += 1
                            if (not unbounded and skip
                                    >= self.scfg.admission_lookahead):
                                break
                            continue
                    req, page_plan = cand, plan
                    break
                if req is None:
                    if skip > 0 and sched.num_active == 0:
                        raise RuntimeError(
                            f"page pool ({self._num_pages} pages of "
                            f"{self.cache_spec.page_size}) cannot fit any of "
                            f"the {skip} arrived request(s) with every lane "
                            "free — raise CacheSpec.num_pages")
                    break
                if self._should_chunk(req, page_plan):
                    # PREFILLING lane: pages reserved for the whole
                    # lifetime now, prompt written by the budget loop below
                    lane, job = self._admit_chunked(sched, req, state,
                                                    page_plan)
                    jobs[lane] = job
                    stats.chunked_admissions += 1
                    continue
                lane = sched.assign(req)
                t0 = time.perf_counter()
                tok, done = self._admit(req, lane, state, lanes, page_plan)
                dt = time.perf_counter() - t0
                stats.admit_seconds += dt
                if page_plan is not None and page_plan[0]:
                    stats.shared_admit_seconds += dt
                yield first_token(req, lane, tok, done)
            if sched.num_active == 0:
                if sched.has_pending:
                    now = max(now, sched.next_arrival)   # idle-jump
                    continue
                break

            # spend the prefill budget on PREFILLING lanes, oldest first
            # (strict FIFO: when the oldest lane's next chunk does not fit
            # what is left, younger lanes wait too). The final chunk
            # samples the first token and flips the lane to DECODING.
            if self._chunked and sched.num_prefilling > 0:
                left = self.scfg.prefill_budget_tokens
                for lane in sched.prefilling_lanes():
                    job = jobs[lane]
                    req = job["req"]
                    cursor = sched.prefill_cursor(lane)
                    rem = sched.prefill_remaining(lane)
                    if rem > left:
                        # non-final chunk, align-sized: the next cursor
                        # stays aligned
                        n = (left // self._chunk_align) * self._chunk_align
                        if n <= 0:
                            break
                        t0 = time.perf_counter()
                        self._chunk(job, lane, cursor, n, state, final=False)
                        stats.admit_seconds += time.perf_counter() - t0
                        sched.advance_prefill(lane, n)
                        stats.prefill_chunks += 1
                        left -= n
                        if left <= 0:
                            break
                        continue
                    padded = self._chunk_padded_len(cursor, rem)
                    if padded > left:
                        break
                    t0 = time.perf_counter()
                    logits = self._chunk(job, lane, cursor, rem, state,
                                         final=True)
                    tok, done = self._finish_admit(req, lane, logits, lanes)
                    stats.admit_seconds += time.perf_counter() - t0
                    jobs.pop(lane)
                    if self._prefix_ok and not req.extra_inputs:
                        # indexed only now that the whole prompt is
                        # written: a sharer reads the pages at admission
                        self.page_pool.register_prefix(
                            req.tokens, job["pages"], req.prompt_len)
                    sched.advance_prefill(lane, rem)
                    sched.mark_decoding(lane)
                    stats.prefill_chunks += 1
                    left -= padded
                    yield first_token(req, lane, tok, done)
                    if left <= 0:
                        break

            # decode step over the DECODING lanes (PREFILLING lanes ride
            # along frozen); skipped while only prefills are in flight —
            # time still advances, so arrivals keep flowing
            if sched.num_decoding == 0:
                now += 1.0
                continue
            t0 = time.perf_counter()
            tok, emitted, done = self._step(state, lanes)
            stats.decode_seconds += time.perf_counter() - t0
            stats.decode_steps += 1
            stats.occupancy_sum += int(emitted.sum())
            if self._paged:
                self.page_pool.sample_utilization()
            now += 1.0
            for lane in sched.decoding_lanes():
                if not emitted[lane]:
                    continue
                req = sched.request_in(lane)
                t, d = int(tok[lane]), bool(done[lane])
                idx = emitted_count[req.uid]
                emitted_count[req.uid] = idx + 1
                stats.tokens_emitted += 1
                record_emit(req.uid)
                if d:
                    retire(lane, req.uid)
                yield StreamEvent(req.uid, t, idx, d,
                                  finish_reason(t, req) if d else "")

    def run(self, requests: Iterable[Request]) -> Dict[int, RequestOutput]:
        """Serve to completion and collect per-request terminal outputs."""
        reqs = {r.uid: r for r in requests}
        outs = {uid: RequestOutput(uid=uid, prompt_len=r.prompt_len)
                for uid, r in reqs.items()}
        for ev in self.serve(reqs.values()):
            o = outs[ev.uid]
            if ev.index == 0:
                o.admitted_at = self.stats.decode_steps
            o.tokens.append(ev.token)
            if ev.finished:
                o.finish_reason = ev.finish_reason
                o.finished_at = self.stats.decode_steps
        return outs

    def cache_bytes(self) -> int:
        """KV-cache footprint of the lane state (shape-only, see
        :func:`decode_state_bytes`): the page pool is counted once. On a
        mesh, the whole state's, as one device would hold it (each rank
        holds its blocks: ``rank_cache_bytes``)."""
        model = self.model
        if self.mesh is not None:
            model = build_model(self.cfg, "cpu")
            model.enable_paging(self.model.paging)
        return decode_state_bytes(model, self.scfg.max_lanes,
                                  self.scfg.max_seq)

    def rank_cache_bytes(self) -> int:
        """The KV-cache bytes this rank holds (its lanes and heads)."""
        return decode_state_bytes(self.model, self._local_lanes,
                                  self.scfg.max_seq)


def _check_mesh(mesh, cfg: ModelConfig, serving: ServingConfig,
                device) -> None:
    """Refuse what is not served on a mesh yet, naming it, and a mesh that
    contradicts the config or the device asked for."""
    if (serving.mesh_shape is not None
            and tuple(serving.mesh_shape) != tuple(mesh.dims)):
        raise ValueError(f"ServingConfig.mesh_shape {serving.mesh_shape} "
                         f"but the mesh is {mesh.dims}")
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} but the mesh's rank is on "
                         f"{mesh.device}")
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not served on a mesh yet: its "
            "decode state carries more than the slot cache (encdec: cross "
            "K/V; ssm and hybrid: recurrent states)")
