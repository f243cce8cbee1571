"""Model protocol and decode-state container (PyTorch port)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kvcache import lane_index
from repro_torch.models.layers import cross_entropy
from repro_torch.runtime import resolve_device, torch_dtype

#: the families served on a mesh (their decode state is the slot cache)
MESH_FAMILIES = ("dense", "moe", "vlm")


@dataclass
class DecodeState:
    """Serving state: the per-layer caches stacked on a leading layer axis
    (an ``AttnCache`` or ``PagedAttnCache`` whose tensors are (L, ...), a
    Mamba-2's ``SSMCache``, or a hybrid's ``HybridCache`` of both its
    stacks) plus model-level extras (whisper's cross K/V), tensors or
    tuples of them with lanes at axis 1 too."""

    layers: Any
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class PagingSpec:
    """Page-pool geometry installed on a model by the serving engine
    (``LM.enable_paging``): ``init_decode_state`` then allocates a global
    page pool + per-lane page tables instead of per-lane slot stripes.
    ``kv_dtype`` / ``scale_granularity`` / ``hot_pages`` carry the
    engine's ``QuantSpec`` (int8 pools with per-page scales, and that many
    full-precision hot residents); ``kept_pages`` (None = every page)
    and ``pin_recent_pages`` its ``SparsitySpec`` (hierarchical AQUA:
    decode attends each lane's ``kept_pages`` participating pages)."""

    page_size: int
    num_pages: int
    kv_dtype: str = "bf16"                # bf16 | int8
    scale_granularity: str = "page_head"  # page_head | page
    kept_pages: Optional[int] = None
    pin_recent_pages: int = 2
    hot_pages: int = 0


def cache_tensors(cache) -> list:
    """The tensors of a cache dataclass, nested dataclasses (a hybrid's
    attention and recurrent stacks) flattened in field order; None fields
    left out."""
    out = []
    for f in dataclasses.fields(cache):
        t = getattr(cache, f.name)
        if dataclasses.is_dataclass(t):
            out.extend(cache_tensors(t))
        elif t is not None:
            out.append(t)
    return out


def extra_tensors(extra) -> list:
    """The tensors of a ``DecodeState.extra`` (nested dicts, tuples and
    lists of tensors), in a fixed order."""
    if isinstance(extra, torch.Tensor):
        return [extra]
    items = extra.values() if isinstance(extra, dict) else extra
    return [t for item in items for t in extra_tensors(item)]


def _wants_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_wants_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_wants_grad(v) for v in tree)
    return False


def remat(cfg: ModelConfig, fn: Callable, *args, pick: Optional[int] = None):
    """``fn(*args)``, one block of a layer loop, or with ``pick`` only
    ``fn(*args)[pick]`` (the part the loss needs), under activation
    checkpointing (``torch.utils.checkpoint``, non-reentrant: the block
    runs again in the backward pass instead of keeping its activations)
    when ``cfg.remat`` is on, grad mode is on and some argument requires
    grad: JAX's ``jax.checkpoint`` over the scanned body. Inference runs
    the block as it is."""
    block = fn if pick is None else (lambda *a: fn(*a)[pick])
    if cfg.remat and torch.is_grad_enabled() and _wants_grad(args):
        return torch.utils.checkpoint.checkpoint(block, *args,
                                                 use_reentrant=False)
    return block(*args)


class LM:
    """Base class: subclasses implement the per-family wiring. ``self``
    carries the static config and the device; params are passed in.

    Lane surgery (continuous batching): a *lane* is one batch row of a
    DecodeState. Every cache tensor (nested stacks too, :func:`cache_tensors`),
    and every tensor of its extras, carries layers at axis 0 and lanes at
    axis 1, so lane surgery is uniform indexing. The state is updated in
    place."""

    supports_paging = False

    def __init__(self, cfg: ModelConfig, device=None):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.param_dtype = torch_dtype(cfg.param_dtype)
        self._paging: Optional[PagingSpec] = None
        # this rank's mesh layout (``enable_mesh``); None on one device
        self.tp = None

    def enable_mesh(self, layout) -> None:
        """Serve as one rank of a mesh: ``layout`` is the rank's
        ``distributed.layout.MeshLayout`` (the model's config must hold the
        rank's heads: ``layout.local_config``). The ``dense``, ``moe`` and
        ``vlm`` families; ``encdec``, ``ssm`` and ``hybrid`` raise."""
        if self.cfg.family not in MESH_FAMILIES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not served on a mesh yet")
        self.tp = layout

    def enable_paging(self, spec: Optional[PagingSpec]) -> None:
        if spec is not None and not self.supports_paging:
            raise NotImplementedError(
                f"family {self.cfg.family!r} does not support the paged cache")
        self._paging = spec

    @property
    def paging(self) -> Optional[PagingSpec]:
        return self._paging

    # -- required API -------------------------------------------------
    def init(self, gen: torch.Generator):
        raise NotImplementedError

    def forward(self, params, batch, aqua_proj=None, capture: bool = False):
        """Logits (B, S, V) float32; ``capture`` adds calibration
        activations: (logits, {"qk": ...}). A ``moe`` model returns
        (logits, {"aux_loss": ...}) without ``capture`` (its router's
        weighted load-balance loss, what a trainer adds to its loss) and
        "aux_loss" beside "qk" with it (``DenseLM.forward``)."""
        raise NotImplementedError

    def init_decode_state(self, batch_size: int, max_seq: int) -> DecodeState:
        raise NotImplementedError

    def prefill(self, params, batch, max_seq: int, aqua_proj=None
                ) -> Tuple[torch.Tensor, DecodeState]:
        raise NotImplementedError

    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor,
                    aqua_proj=None, write_mask=None
                    ) -> Tuple[torch.Tensor, DecodeState]:
        raise NotImplementedError

    def graft_paged(self, state: DecodeState, req_state: DecodeState,
                    lane: Optional[int], num_slots: int,
                    row: torch.Tensor) -> DecodeState:
        raise NotImplementedError

    def prefill_chunk(self, params, batch, state: DecodeState, lane: int,
                      prefix_len: int, aqua_proj=None, select_q_blk=None,
                      logits: bool = True, row=None
                      ) -> Tuple[Optional[torch.Tensor], DecodeState]:
        """Advance ``lane``'s cache by one chunked-prefill chunk starting
        at position ``prefix_len`` (paged: through the pages of the lane's
        table ``row``); returns (logits (1, V) or, with ``logits=False``,
        None, state)."""
        raise NotImplementedError

    # -- lane surgery -------------------------------------------------
    def insert_lane(self, state: DecodeState, req_state: DecodeState,
                    lane) -> DecodeState:
        """Overwrite lane ``lane`` of ``state`` with the single-lane
        ``req_state`` (K/V slots, positions, count, and the extras), in
        place. ``lane`` is a Python int or a 0-d / 1-element int tensor on
        the state's device, never read on the host (an admission graph
        captures this)."""
        index = lane_index(lane, state.layers.count.device)
        for dst, src in zip(cache_tensors(state.layers),
                            cache_tensors(req_state.layers)):
            dst.index_copy_(1, index, src[:, :1])
        for dst, src in zip(extra_tensors(state.extra),
                            extra_tensors(req_state.extra)):
            dst.index_copy_(1, index, src[:, :1])
        return state

    @staticmethod
    def freeze_rows(new_state: DecodeState, old_state: DecodeState,
                    write_mask: Optional[torch.Tensor],
                    batch_axis: int = 1) -> DecodeState:
        """Write ``new_state`` into ``old_state`` in place, keeping
        ``old_state``'s rows where ``write_mask`` (B,) is False (bit for
        bit); every row when it is None. The state-level masked write of
        families whose decode step rewrites the whole (small) recurrent
        state anyway (attention caches mask per slot in
        ``kvcache.insert``). Lanes at ``batch_axis`` of every tensor.
        Returns ``old_state``."""
        pairs = list(zip(cache_tensors(new_state.layers),
                         cache_tensors(old_state.layers)))
        pairs += list(zip(extra_tensors(new_state.extra),
                          extra_tensors(old_state.extra)))
        for new, old in pairs:
            if write_mask is None:
                old.copy_(new)
                continue
            shape = [1] * new.ndim
            shape[batch_axis] = write_mask.shape[0]
            old.copy_(torch.where(write_mask.reshape(shape), new, old))
        return old_state

    def loss(self, params, batch):
        """(loss, {"ce": loss}): the mean next-token cross-entropy of
        ``batch["labels"]`` (weighted by ``batch["loss_mask"]`` where the
        batch has one) plus, for a model whose ``forward`` returns it, the
        MoE router's ``aux_loss``, as JAX's ``LM.loss``."""
        logits = self.forward(params, batch)
        aux = {}
        if isinstance(logits, tuple):
            logits, aux = logits
        loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
        if "aux_loss" in aux:
            loss = loss + aux["aux_loss"]
        return loss, {"ce": loss}

    def reset_lane(self, state: DecodeState, lane,
                   max_seq: int) -> DecodeState:
        """Return lane ``lane`` to the freshly-initialized condition."""
        return self.insert_lane(state, self.init_decode_state(1, max_seq),
                                lane)

    def prefill_into(self, params, batch, max_seq: int, state: DecodeState,
                     lane, aqua_proj=None
                     ) -> Tuple[torch.Tensor, DecodeState]:
        """Prefill one request (batch size 1, optionally ragged via
        ``batch["lengths"]``) and graft its cache into ``lane``. Returns
        (next-token logits (1, V), state)."""
        logits, req_state = self.prefill(params, batch, max_seq, aqua_proj)
        return logits, self.insert_lane(state, req_state, lane)
