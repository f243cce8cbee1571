"""Configuration dataclasses of the PyTorch port (stdlib only).

The port's own copy of the JAX package's ``configs/base.py``, cut to what
the serving and training paths use: ``AquaConfig``, ``AttentionConfig``,
``MoEConfig``, ``SSMConfig``, ``RGLRUConfig``, ``FrontendConfig``,
``ModelConfig``, ``reduce_config``,
``CacheSpec``,
``QuantSpec``, ``SparsitySpec`` (with their resolvers),
``ServingConfig`` and ``TrainConfig``.
Field names and defaults match the JAX package so a config built from the
same arguments means the same thing in both.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class AquaConfig:
    """Paper hyperparameters (§8.1, §8.4) plus kernel tiling knobs."""

    enabled: bool = True
    # Fraction of (remaining) dims kept for the score dot-product.
    k_ratio: float = 0.75
    # AQUA-Memory static slice: fraction of trailing principal dims dropped
    # before caching. 0.0 disables AQUA-Memory.
    s_ratio: float = 0.0
    # H2O heavy-hitter cache budget as a fraction of the context (1.0 =
    # off), and the fraction of that budget reserved for the most recent
    # tokens.
    h2o_ratio: float = 1.0
    h2o_recent_frac: float = 0.5
    # Magnitude selection granularity in dims. 1 is the paper's per-dim
    # selection: the block-sparse backend then runs the flash kernel on the
    # masked q̂ (prefill) and the masked-dense core (decode), as in JAX.
    block_dims: int = 1
    # Queries per prefill selection chunk: one dim-block set per chunk.
    prefill_q_blk: int = 128
    # Keys per participating key chunk of the hierarchical prefill kernel
    # (``kc_part`` indexes chunks of this size; a multiple of 64).
    prefill_k_blk: int = 128

    def kept_dims(self, head_dim: int) -> int:
        """Dims retained after the static slice (AQUA-Memory stage 1)."""
        d = int(round((1.0 - self.s_ratio) * head_dim))
        return max(self.block_dims, min(head_dim, d))

    def topk_dims(self, head_dim: int) -> int:
        """Dims kept by dynamic magnitude selection (stage 2)."""
        d_kept = self.kept_dims(head_dim)
        k = int(round(self.k_ratio * d_kept))
        k = max(self.block_dims, min(d_kept, k))
        b = self.block_dims
        return ((k + b - 1) // b) * b


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    kind: str = "full"            # full | swa (sliding-window) | local
    window: Optional[int] = None  # for swa / local: keys kpos > qpos - window
    qk_norm: bool = False
    qkv_bias: bool = False        # Qwen2-style q/k/v projection biases
    rope_theta: float = 10000.0
    use_rope: bool = True         # False: absolute learned positions (whisper)
    causal: bool = True           # False for encoder self-attention
    # Backend registry key (repro_torch.core.attention): "auto" | "dense" |
    # "aqua-masked-dense" | "aqua-block-sparse" | "aqua-block-sparse-plain".
    backend: str = "auto"

    @property
    def group_size(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class MoEConfig:
    """Routed experts of a ``moe`` family FFN (``models/moe.py``):
    ``num_experts`` gated-SiLU experts of width ``expert_ff``, each token
    routed to its ``top_k``; ``num_shared`` shared experts run as one
    gated MLP of width ``expert_ff * num_shared`` for every token. Each
    expert takes ``capacity_factor * top_k * block / num_experts`` (+1)
    tokens of a routing block; the rest drop."""

    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0
    router_aux_weight: float = 0.01
    router_jitter: float = 0.0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block parameters (``models/mamba2.py``)."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 64
    ngroups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block parameters (``models/rglru.py``): the
    layers follow ``block_pattern`` cyclically."""

    lru_width: int = 0            # 0 -> d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontends: a request carries precomputed embeddings
    (batch, num_embeds, embed_dim) in its prefill batch, vision patches
    under "patches" (projected by ``patch_proj`` and spliced over the
    first prompt positions) or audio frames under "frames" (of width
    d_model, the encoder's input)."""

    kind: str = "none"            # none | audio_frames | vision_patches
    num_embeds: int = 0
    embed_dim: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    aqua: Optional[AquaConfig] = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # encoder-decoder (whisper): encoder depth; the decoder has num_layers
    num_encoder_layers: int = 0
    act: str = "silu"             # silu (gated MLP) | gelu | relu
    max_positions: int = 32768    # learned-position table (use_rope=False)
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True            # activation checkpointing per block
    # long-context capability flag of the JAX package's shape table
    skip_long_context: bool = False

    @property
    def subquadratic(self) -> bool:
        """Sub-quadratic in context: an SSM or hybrid, or a windowed
        attention (the JAX package's long-context capability flag)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return (self.attention is not None
                and self.attention.kind in ("swa", "local"))

    def with_aqua(self, aqua: AquaConfig) -> "ModelConfig":
        return replace(self, aqua=aqua)

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec",
                               "vlm"), self.family
        if self.family != "ssm":
            assert self.attention is not None
        if self.family == "hybrid":
            assert self.rglru is not None, \
                "family 'hybrid' needs ModelConfig.rglru"
        if self.family == "moe":
            assert self.moe is not None, "family 'moe' needs ModelConfig.moe"
        if self.family == "encdec":
            assert self.num_encoder_layers > 0, \
                "family 'encdec' needs num_encoder_layers > 0"
        assert self.act in ("silu", "gelu", "relu"), self.act


def reduce_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
                  vocab: int = 128, ff: int = 128) -> ModelConfig:
    """Shrink a production config to a CPU-test size, keeping its
    structure (GQA ratio, qk-norm, tied embeddings, MoE routing, the
    SSD's state of 16 in chunks of 8, the RG-LRU at d_model, the
    frontend's kind at 4 embeddings of width 32, an encoder of 2 layers) —
    the same rule as the JAX package's ``reduce_config``."""
    att = cfg.attention
    if att is not None:
        heads = max(2, min(4, att.num_heads))
        kv = (heads if att.num_kv_heads == att.num_heads
              else max(1, heads // 2))
        att = replace(att, num_heads=heads, num_kv_heads=kv,
                      head_dim=max(8, d_model // heads),
                      window=None if att.window is None else 16)
    moe = cfg.moe
    if moe is not None:
        moe = replace(moe, num_experts=8, top_k=min(2, moe.top_k),
                      expert_ff=ff // 2, num_shared=min(1, moe.num_shared),
                      capacity_factor=8.0)  # effectively dropless
    kw = {}
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, state_dim=16, head_dim=16, chunk_size=8)
    if cfg.rglru is not None:
        kw["rglru"] = replace(cfg.rglru, lru_width=0)
    if cfg.frontend.kind != "none":
        kw["frontend"] = replace(cfg.frontend, num_embeds=4, embed_dim=32)
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = 2
    return replace(cfg, num_layers=layers, d_model=d_model, vocab_size=vocab,
                   d_ff=ff, attention=att, moe=moe, remat=False,
                   dtype="float32", **kw)


@dataclass(frozen=True)
class CacheSpec:
    """KV-cache layout. ``page_size`` tokens per page turns the per-lane
    slot stripes into a global page pool with per-lane page tables; None
    keeps the contiguous layout. ``num_pages`` sizes the pool (None =
    lane-stripe parity). ``prefix_sharing`` (on by default, as in JAX)
    maps page-aligned prompt prefixes that admissions share onto the same
    physical pages; the engine engages it on a paged full cache (no
    window, no H2O). ``eviction``
    names the slot policy; "auto" derives it from the model config
    (:func:`resolve_eviction`), and an explicit name that contradicts the
    model is refused, as in the JAX package."""

    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    prefix_sharing: bool = True
    eviction: str = "auto"        # auto | none | ring | h2o

    @property
    def paged(self) -> bool:
        return self.page_size is not None

    def validate(self) -> None:
        assert self.eviction in ("auto", "none", "ring", "h2o"), self.eviction
        if self.page_size is not None:
            assert self.page_size >= 1
            if self.num_pages is not None:
                assert self.num_pages >= 1
        elif self.num_pages is not None:
            raise ValueError("CacheSpec.num_pages needs page_size")


@dataclass(frozen=True)
class QuantSpec:
    """KV-pool quantization (paged layout only). ``kv_dtype`` "bf16" keeps
    full-precision pools (the model dtype); "int8" stores per-page
    symmetric-quantized K̂/V with float32 scales beside the page table
    (zero-point 0). ``scale_granularity`` "page_head" keeps one scale per
    (page, kv head), "page" one per page. ``hot_resident_fraction`` > 0
    (int8 only; mixed precision) also keeps that fraction of the pool's
    pages, the lanes' freshest, in the model dtype, overlaid on the
    dequantized pages."""

    kv_dtype: str = "bf16"                # bf16 | int8
    scale_granularity: str = "page_head"  # page_head | page
    hot_resident_fraction: float = 0.0

    @property
    def quantized(self) -> bool:
        return self.kv_dtype != "bf16"

    @property
    def mode(self) -> str:
        """Pool precision mode: "none", "int8" or "int8-mixed"."""
        if not self.quantized:
            return "none"
        return "int8-mixed" if self.hot_resident_fraction > 0 else "int8"

    def validate(self) -> None:
        assert self.kv_dtype in ("bf16", "int8"), self.kv_dtype
        assert self.scale_granularity in ("page_head", "page"), \
            self.scale_granularity
        assert 0.0 <= self.hot_resident_fraction <= 1.0, \
            self.hot_resident_fraction


@dataclass(frozen=True)
class SparsitySpec:
    """Two-stage hierarchical sparsity (paged layout only). Stage 1 keeps
    only the top ``page_keep_ratio`` of a lane's pages, ranked by their
    accumulated attention mass (``PagedAttnCache.acc_pool``), with the
    last ``pin_recent_pages`` pages always kept; stage 2 is AQUA's |q̂|
    dim-block selection within them. Ratio 1.0 disables stage 1."""

    page_keep_ratio: float = 1.0
    pin_recent_pages: int = 2

    @property
    def hierarchical(self) -> bool:
        return self.page_keep_ratio < 1.0

    def kept_pages(self, pages_per_lane: int) -> int:
        """Participating pages per lane (the kernel's page walk)."""
        k = math.ceil(self.page_keep_ratio * pages_per_lane - 1e-9)
        k = max(k, min(self.pin_recent_pages, pages_per_lane), 1)
        return min(k, pages_per_lane)

    def validate(self) -> None:
        assert 0.0 < self.page_keep_ratio <= 1.0, self.page_keep_ratio
        assert self.pin_recent_pages >= 1, self.pin_recent_pages


def resolve_eviction(cache: CacheSpec, attention: AttentionConfig,
                     aqua: Optional[AquaConfig]) -> str:
    """The slot-eviction policy a model config implies: "h2o" when AQUA's
    ``h2o_ratio`` < 1 (combined with a window ring when the attention is
    windowed too), "ring" for a windowed attention, "none" otherwise.
    ``cache.eviction`` "auto" takes it; an explicit name must equal it."""
    h2o = aqua is not None and aqua.enabled and aqua.h2o_ratio < 1.0
    policy = ("h2o" if h2o else "ring" if attention.window is not None
              else "none")
    if cache.eviction not in ("auto", policy):
        raise ValueError(
            f"CacheSpec(eviction={cache.eviction!r}) contradicts the model's "
            f"slot policy {policy!r} (set by AttentionConfig.window and "
            "AquaConfig.h2o_ratio); use eviction='auto'")
    return policy


def resolve_cache_specs(serving: "ServingConfig"
                        ) -> Tuple[CacheSpec, QuantSpec]:
    """A ``ServingConfig``'s (CacheSpec, QuantSpec), validated: the
    quantization state is per-page metadata, so it needs the paged
    layout."""
    cache, quant = serving.cache_spec, serving.quant_spec
    cache.validate()
    quant.validate()
    if quant.quantized and not cache.paged:
        raise ValueError(
            f"QuantSpec(kv_dtype={quant.kv_dtype!r}) needs the paged cache "
            "layout; set CacheSpec.page_size")
    return cache, quant


def resolve_sparsity_spec(serving: "ServingConfig") -> SparsitySpec:
    """A ``ServingConfig``'s SparsitySpec, validated: stage-1 selection is
    page-granular, so hierarchical mode needs the paged layout."""
    spec = serving.sparsity if serving.sparsity is not None else SparsitySpec()
    spec.validate()
    if spec.hierarchical and not serving.cache_spec.paged:
        raise ValueError(
            f"SparsitySpec(page_keep_ratio={spec.page_keep_ratio}) needs the "
            "paged cache layout; set CacheSpec.page_size")
    return spec


@dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching engine knobs (repro_torch.serving). A *lane* is
    one batch row of the shared decode state; the decode step always runs
    over all ``max_lanes`` lanes. ``prefill_budget_tokens`` caps the
    prefill tokens advanced between decode steps (chunked prefill; a
    multiple of ``prompt_bucket``, and of the page size when paged).
    ``mesh_shape`` over ``mesh_axes`` (data x model, or pod x data x
    model) serves on a mesh: decode lanes over the data axes, params and
    the KV cache over ``model`` by ``distributed.sharding``'s rules, one
    rank per position (``launch.mesh``). The ``dense``, ``moe`` and
    ``vlm`` families are served there under every cache policy; the
    ``encdec``, ``ssm`` and ``hybrid`` families are still refused on a
    mesh (``NotImplementedError`` from the engine)."""

    max_lanes: int = 8
    max_seq: int = 4096
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1
    pad_id: int = 0
    prompt_bucket: int = 16
    admission_lookahead: int = 4
    cache: Optional[CacheSpec] = None
    quant: Optional[QuantSpec] = None
    sparsity: Optional[SparsitySpec] = None
    prefill_budget_tokens: Optional[int] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("data", "model")

    @property
    def cache_spec(self) -> CacheSpec:
        return self.cache if self.cache is not None else CacheSpec()

    @property
    def quant_spec(self) -> QuantSpec:
        return self.quant if self.quant is not None else QuantSpec()

    def validate(self) -> None:
        assert self.max_lanes >= 1
        assert self.max_new_tokens >= 1
        assert self.prompt_bucket >= 1
        assert self.admission_lookahead >= 1
        cache, _ = resolve_cache_specs(self)
        resolve_sparsity_spec(self)
        if self.prefill_budget_tokens is not None:
            assert self.prefill_budget_tokens >= 1
            assert self.prefill_budget_tokens % self.prompt_bucket == 0, \
                (self.prefill_budget_tokens, self.prompt_bucket)
            if cache.page_size is not None:
                assert self.prefill_budget_tokens % cache.page_size == 0, \
                    (self.prefill_budget_tokens, cache.page_size)
        if cache.page_size is not None:
            assert self.max_seq % cache.page_size == 0, \
                (self.max_seq, cache.page_size)
        if self.mesh_shape is not None:
            assert len(self.mesh_shape) == len(self.mesh_axes), \
                (self.mesh_shape, self.mesh_axes)
            assert all(s >= 1 for s in self.mesh_shape), self.mesh_shape
            assert all(a in ("pod", "data", "model")
                       for a in self.mesh_axes), self.mesh_axes


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and checkpoint knobs of ``launch/train.py``
    (the JAX package's ``TrainConfig``, field for field)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1          # gradient accumulation
    grad_compress: bool = False    # int8 error-feedback allreduce
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
