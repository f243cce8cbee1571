"""AQUA core primitives (paper §4, §6, §7) in PyTorch.

* offline SVD projection (per GQA group), via eigh of the Gram matrix;
* dynamic magnitude-based dim-block selection (per query, or per query
  chunk for the prefill kernel), which a :class:`SelectionTape` can
  record and replay;
* the fidelity helpers of the JAX package: the GQA calibration matrix,
  approximate scores, AQUA-Memory's static slice, the information
  retention loss (§6.2), LoKi's slicing mask and weight folding.

Tie-break: ``jax.lax.top_k`` keeps the lower index among equal values and
``torch.topk`` promises no order, so selection here is a *stable*
descending sort truncated to k — equal magnitudes resolve to the lower
index exactly as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def compute_projection(d_calib: torch.Tensor) -> torch.Tensor:
    """SVD of the calibration matrix; returns P = V (d_head × d_head).

    ``d_calib``: (M, d_head) stacked query+key activations for one layer /
    GQA group. Right singular vectors via eigh of the Gram matrix, columns
    in descending-variance order. Columns are defined up to sign.
    """
    d_calib = d_calib.float()
    gram = d_calib.T @ d_calib
    eigval, eigvec = torch.linalg.eigh(gram)
    order = torch.argsort(eigval, descending=True, stable=True)
    return eigvec[:, order]


def gqa_calibration_matrix(queries: torch.Tensor, keys: torch.Tensor
                           ) -> torch.Tensor:
    """Stack a GQA group's queries and its shared key head (paper §6.3):
    queries (group_size, M, d_head), keys (M, d_head) -> ((group_size +
    1) * M, d_head)."""
    g, m, d = queries.shape
    return torch.cat([queries.reshape(g * m, d), keys], dim=0)


def check_orthogonal(p: torch.Tensor, atol: float = 1e-3) -> torch.Tensor:
    """Whether ``p p^T`` is the identity within ``atol`` (0-d bool)."""
    eye = torch.eye(p.shape[-1], dtype=p.dtype, device=p.device)
    return (p @ p.transpose(-1, -2) - eye).abs().max() < atol


def ceil_to(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n``."""
    return -(-n // m) * m


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, lower index
    first among ties (``jax.lax.top_k`` order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def magnitude_mask(q_hat: torch.Tensor, k_dims: int, *,
                   block_dims: int = 1) -> torch.Tensor:
    """0/1 mask over the last axis keeping the top-``k_dims`` dims by |q̂|,
    quantized to whole blocks of ``block_dims`` dims when > 1."""
    d = q_hat.shape[-1]
    if k_dims >= d:
        return torch.ones_like(q_hat)
    mag = q_hat.float().abs()
    if block_dims == 1:
        idx = topk_indices(mag, k_dims)
        return torch.zeros_like(mag).scatter_(-1, idx, 1.0).to(q_hat.dtype)
    assert d % block_dims == 0 and k_dims % block_dims == 0, \
        (d, k_dims, block_dims)
    nb, kb = d // block_dims, k_dims // block_dims
    bmag = mag.reshape(*mag.shape[:-1], nb, block_dims).sum(-1)
    bmask = torch.zeros_like(bmag).scatter_(-1, topk_indices(bmag, kb), 1.0)
    return bmask.repeat_interleave(block_dims, dim=-1).to(q_hat.dtype)


def topk_block_indices(q_hat: torch.Tensor, k_dims: int,
                       block_dims: int) -> torch.Tensor:
    """Selected dim-block indices (sorted ascending, int32); the last
    axis of the result has ``k_dims // block_dims`` entries."""
    d = q_hat.shape[-1]
    assert d % block_dims == 0 and k_dims % block_dims == 0
    nb, kb = d // block_dims, k_dims // block_dims
    mag = q_hat.float().abs()
    bmag = mag.reshape(*mag.shape[:-1], nb, block_dims).sum(-1)
    return _taped("decode", torch.sort(topk_indices(bmag, kb),
                                       dim=-1)[0].to(torch.int32))


def chunk_topk_block_indices(q_hat: torch.Tensor, k_dims: int,
                             block_dims: int, q_chunk: int,
                             lengths: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Per-query-*chunk* dim-block selection for the prefill kernel: |q̂|
    block magnitudes are summed over each ``q_chunk`` queries before the
    top-k, rows at or past ``lengths`` excluded.

    q_hat: (B, H, S, D) with S a multiple of ``q_chunk``;
    returns (B, H, S // q_chunk, k_dims // block_dims) int32, sorted.
    """
    b, h, s, d = q_hat.shape
    assert s % q_chunk == 0, (s, q_chunk)
    assert d % block_dims == 0 and k_dims % block_dims == 0, \
        (d, k_dims, block_dims)
    nb, kb = d // block_dims, k_dims // block_dims
    mag = q_hat.float().abs()
    if lengths is not None:
        valid = (torch.arange(s, device=q_hat.device)[None, :]
                 < lengths.to(q_hat.device)[:, None])
        mag = mag * valid[:, None, :, None]
    bmag = mag.reshape(b, h, s // q_chunk, q_chunk, nb, block_dims
                       ).sum(dim=(3, 5))
    return _taped("prefill", torch.sort(topk_indices(bmag, kb),
                                        dim=-1)[0].to(torch.int32))


#: the installed :class:`SelectionTape` by device
_TAPES: Dict[Tuple[str, int], "SelectionTape"] = {}


def _key(device) -> Tuple[str, int]:
    device = torch.device(device)
    return device.type, 0 if device.index is None else device.index


def _taped(stream: str, block_idx: torch.Tensor) -> torch.Tensor:
    tape = _TAPES.get(_key(block_idx.device))
    return block_idx if tape is None else tape.pass_through(stream,
                                                           block_idx)


class SelectionTape:
    """Every dim-block selection of a drive on ``device``, in call order:
    the per-row selections (:func:`topk_block_indices`: decode steps)
    and the per-chunk ones (:func:`chunk_topk_block_indices`: prefill)
    apart, each call in a slot of ``slots[stream]`` of up to
    ``numel[stream]`` indices. ``install("record")`` records while
    selecting as usual; ``install("replay")`` gives each call the
    recording of the same call instead: a second drive of one trace
    makes the same calls in the same order, so a drive whose bf16
    rounding ranks near-tied dim-blocks otherwise (the plain reference
    of a kernel drive) can be held to the first's selections (as
    ``models.moe.RoutingTape`` holds a drive to another's routing). The
    call counters live on the device and every write is in place, so CUDA
    graphs captured while a tape is installed record and replay too
    (calls past the last slot share it: ``overflowed``); the tape must
    outlive such graphs. ``n[stream]`` holds each recorded call's index
    count (its selection's numel), so a recording made on a mesh rank's
    heads and lanes can be put together into one device's."""

    STREAMS = ("decode", "prefill")

    def __init__(self, device, slots=(4096, 1024), numel=(2048, 4096)):
        dev = torch.device(device)
        self.buf = {s: torch.zeros(n, m, dtype=torch.int16, device=dev)
                    for s, n, m in zip(self.STREAMS, slots, numel)}
        # each slot's call's index count (its shape's numel)
        self.n = {s: torch.zeros(n, dtype=torch.int64, device=dev)
                  for s, n in zip(self.STREAMS, slots)}
        self.calls = torch.zeros(2, dtype=torch.int64, device=dev)
        self.mode = "record"
        self._device = dev

    def install(self, mode: str) -> None:
        """Select the device's block indices through this tape
        (``"record"`` or ``"replay"``) from call 0 on."""
        assert mode in ("record", "replay"), mode
        self.mode = mode
        self.calls.zero_()
        _TAPES[_key(self._device)] = self

    def remove(self) -> None:
        _TAPES.pop(_key(self._device), None)

    @property
    def overflowed(self) -> bool:
        """Whether some stream made more calls than it has slots (read
        on the host)."""
        return any(int(self.calls[i]) > self.buf[s].shape[0]
                   for i, s in enumerate(self.STREAMS))

    def pass_through(self, stream: str, block_idx: torch.Tensor
                     ) -> torch.Tensor:
        """One call's selection: ``block_idx`` recorded (and returned), or
        replaced by the recording of the same call (its shape)."""
        tape, c = self.buf[stream], self.STREAMS.index(stream)
        n = block_idx.numel()
        if n > tape.shape[1]:
            raise ValueError(f"a {stream} selection of {n} indices in a "
                             f"tape of {tape.shape[1]} a call")
        slot = self.calls[c:c + 1].clamp(max=tape.shape[0] - 1)
        if self.mode == "record":
            tape.index_copy_(0, slot, F.pad(
                block_idx.reshape(1, n).to(torch.int16),
                (0, tape.shape[1] - n)))
            self.n[stream].index_fill_(0, slot, n)
        else:
            block_idx = tape.index_select(0, slot)[0, :n].reshape(
                block_idx.shape).to(block_idx.dtype)
        self.calls[c:c + 1].add_(1)
        return block_idx


def stored_dims(aqua, head_dim: int) -> int:
    """Width of the stored (cached) K̂ and of q̂ under AQUA: the kept dims
    (``aqua.kept_dims``), padded with zero columns up to a multiple of 8
    where the selection is by whole dim-blocks of them — the bf16 kernels
    copy 16-byte pieces, and a zero column adds exactly 0 to every score.
    Other kept widths (per-dim selection, or blocks that do not tile the
    kept dims) run the masked-dense paths and stay unpadded."""
    kept = aqua.kept_dims(head_dim)
    if aqua.block_dims > 1 and kept % aqua.block_dims == 0:
        return ceil_to(kept, 8)
    return kept


def stored_projection(p: torch.Tensor, aqua, head_dim: int) -> torch.Tensor:
    """A projection (…, D, D) cut to its kept columns and padded with zero
    columns to :func:`stored_dims`: (…, D, width). Projected once with it,
    q̂ and K̂ come out in stored form with exact zeros in the padding."""
    kept, width = aqua.kept_dims(head_dim), stored_dims(aqua, head_dim)
    return torch.nn.functional.pad(p[..., :kept], (0, width - kept))


def project(x: torch.Tensor, p: Optional[torch.Tensor]) -> torch.Tensor:
    """q̂ = q P (runtime path, used when RoPE prevents folding)."""
    if p is None:
        return x
    return x @ p.to(x.dtype)


def approx_scores(q_hat: torch.Tensor, khat: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """S̃ = (q̂ ⊙ m) K̂ᵀ, alg. 1 lines 6-8 in masked-dense form: q_hat
    (..., d), khat (..., S, d), mask broadcastable to q_hat -> (..., S)."""
    return torch.einsum("...d,...sd->...s", q_hat * mask, khat)


def static_slice(v_hat: torch.Tensor, cfg, head_dim: int) -> torch.Tensor:
    """AQUA-Memory (paper §8.4 stage 1): drop the trailing
    (lowest-variance) principal dims before caching, keeping
    ``cfg.kept_dims(head_dim)``."""
    return v_hat[..., :cfg.kept_dims(head_dim)]


def info_retention_loss(v: torch.Tensor, v_hat: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """L_info = | ||v|| - ||v̂ ⊙ m|| | / ||v|| over the last axis (paper
    §6.2), in float32."""
    norm_v = torch.linalg.vector_norm(v.float(), dim=-1)
    norm_kept = torch.linalg.vector_norm(v_hat.float() * mask, dim=-1)
    return (norm_v - norm_kept).abs() / torch.clamp(norm_v, min=1e-12)


def slicing_mask(d: int, k_dims: int, like: torch.Tensor) -> torch.Tensor:
    """The LoKi-style static slice (the first ``k_dims`` dims), the
    baseline of the paper's Fig. 2: a 0/1 mask of ``like``'s shape and
    dtype."""
    m = (torch.arange(d, device=like.device) < k_dims).to(like.dtype)
    return m.expand(*like.shape[:-1], d)


def fold_projection_into_weights(wq: torch.Tensor, wk: torch.Tensor,
                                 p: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W_Q P, W_K P): legal only when nothing (RoPE) sits between the
    projection and its use. wq / wk (..., d_head); p (d_head, d_head)."""
    return wq @ p, wk @ p
