"""AQUA block-sparse decode attention: CUDA kernel, plain version, wrappers.

Replaces the Pallas TPU kernels ``src/repro/kernels/aqua_decode.py``
``_kernel`` (contiguous cache, via ``aqua_decode_attention``) and
``_paged_kernel`` (page pool, via ``aqua_paged_decode_attention``). Both
wrappers launch the one CUDA kernel in ``csrc/aqua_decode.cu``: the
contiguous cache is a page pool with one page per lane and no table.

Bound on the H100: bytes — per lane, the selected dim-blocks (k_ratio) of
every valid K̂ row plus every valid V row. The kernel reads K̂ in the
cache's own seq-major layout (no dim-major copy of the cache per step, which
would move the whole K̂ once more than the kernel saves), only the selected
blocks and only positions below ``lengths``, split over the sequence so
that a small batch still fills the card; see the source's header.

Dispatch is by the device of the tensors: CPU tensors run the plain PyTorch
version (:func:`aqua_decode_plain`), CUDA tensors launch the kernel or
raise. Each wrapper counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import aqua_decode_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"aqua_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                               _P],
        "aqua_decode_split": []}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def aqua_decode_plain(q_hat: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_idx: torch.Tensor, lengths: torch.Tensor,
                      page_table: Optional[torch.Tensor], *, block_dims: int,
                      scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (masked-dense, float32).

    q_hat (B, H, D); k (P, KV, ps, D); v (P, KV, ps, Dv); block_idx
    (B, H, NB_sel) int32; lengths (B,) int32; page_table (B, NP) int32 with
    -1 unmapped, or None for a contiguous cache (P = B, ps = S). Returns
    (B, H, Dv) in v's dtype. A lane with ``lengths`` 0 gets the mean of the
    V slots of its view, as the Pallas kernel does.
    """
    if page_table is not None:
        b, kvh = page_table.shape[0], k.shape[1]
        pages = page_table.long().clamp(min=0)               # (B, NP)
        k = k[pages].transpose(1, 2).reshape(b, kvh, -1, k.shape[-1])
        v = v[pages].transpose(1, 2).reshape(b, kvh, -1, v.shape[-1])
    return aqua_decode_ref(q_hat, k, v, block_idx, lengths, block_dims,
                           scale=scale)


def _launch(q_hat, k, v, block_idx, lengths, page_table, block_dims, scale):
    b, h, d = q_hat.shape
    _, kvh, ps, dk = k.shape
    dv = v.shape[-1]
    nb_sel = block_idx.shape[-1]
    if q_hat.dtype not in _DTYPES or k.dtype != q_hat.dtype \
            or v.dtype != q_hat.dtype:
        raise TypeError(f"aqua_decode kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q_hat.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if dk != d or h % kvh or nb_sel * block_dims > 256 or dv > 256:
        raise ValueError(f"aqua_decode kernel: unsupported shapes q {q_hat.shape} "
                         f"k {k.shape} v {v.shape} NB_sel {nb_sel}")
    if page_table is None and k.shape[0] != b:
        raise ValueError("contiguous cache must have one page per lane")
    tensors = [q_hat, k, v, block_idx, lengths]
    if page_table is not None:
        tensors.append(page_table)
    dev = q_hat.device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("aqua_decode kernel needs contiguous tensors on "
                             "one CUDA device")
    for t in (block_idx, lengths, page_table):
        if t is not None and t.dtype != torch.int32:
            raise TypeError("block_idx, lengths and page_table must be int32")
    lib = _build.load("aqua_decode", _SIG)
    npl = 0 if page_table is None else page_table.shape[1]
    # one partial block per `split` positions of the lane capacity; the
    # float32 scratch holds each split's (max, sum, acc[Dv])
    nsplit = -(-ps * max(npl, 1) // lib.aqua_decode_split())
    out = torch.empty((b, h, dv), dtype=v.dtype, device=dev)
    scratch = torch.empty((b, h, nsplit, dv + 2), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.aqua_decode_launch(
            q_hat.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
            None if page_table is None else page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h, kvh,
            d, dv, nb_sel, block_dims, ps, npl, nsplit, float(scale),
            _DTYPES[q_hat.dtype], stream)
    _build.check(err, "aqua_decode")
    return out


def _dispatch(q_hat, k, v, block_idx, lengths, page_table, block_dims, scale):
    """Kernel output for CUDA tensors; None for CPU tensors (the caller
    then runs the plain version); raises for any other device."""
    dev = q_hat.device.type
    if dev == "cpu":
        return None
    if dev != "cuda":
        raise ValueError(f"aqua_decode: unsupported device {q_hat.device}")
    return _launch(q_hat, k, v, block_idx, lengths, page_table, block_dims,
                   scale)


def aqua_decode_attention(q_hat: torch.Tensor, khat: torch.Tensor,
                          v: torch.Tensor, block_idx: torch.Tensor,
                          lengths: torch.Tensor, *, block_dims: int = 8,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse AQUA decode over a contiguous cache.

    q_hat (B, H, D) projected query; khat (B, KV, S, D) seq-major projected
    key cache; v (B, KV, S, Dv); block_idx (B, H, NB_sel) int32 selected
    dim-blocks; lengths (B,) int32. ``scale`` defaults to 1/sqrt(D).
    Returns (B, H, Dv) in v's dtype."""
    if scale is None:
        scale = 1.0 / q_hat.shape[-1] ** 0.5
    out = _dispatch(q_hat, khat, v, block_idx, lengths, None, block_dims,
                    scale)
    if out is None:
        return aqua_decode_plain(q_hat, khat, v, block_idx, lengths, None,
                                 block_dims=block_dims, scale=scale)
    aqua_decode_attention.launches += 1
    return out


def aqua_paged_decode_attention(q_hat: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, block_idx: torch.Tensor,
                                page_table: torch.Tensor,
                                lengths: torch.Tensor, *, block_dims: int = 8,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Block-sparse AQUA decode over a page pool.

    k_pool (P, KV, ps, D) / v_pool (P, KV, ps, Dv) seq-major per page;
    page_table (B, NP) int32, -1 unmapped (masked by ``lengths``).
    Position ``pos`` of lane b lives in page ``page_table[b, pos // ps]`` at
    offset ``pos % ps``; the kernel resolves it per token."""
    if scale is None:
        scale = 1.0 / q_hat.shape[-1] ** 0.5
    out = _dispatch(q_hat, k_pool, v_pool, block_idx, lengths, page_table,
                    block_dims, scale)
    if out is None:
        return aqua_decode_plain(q_hat, k_pool, v_pool, block_idx, lengths,
                                 page_table, block_dims=block_dims,
                                 scale=scale)
    aqua_paged_decode_attention.launches += 1
    return out


aqua_decode_attention.launches = 0
aqua_paged_decode_attention.launches = 0
