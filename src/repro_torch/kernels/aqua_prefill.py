"""AQUA block-sparse prefill attention: CUDA kernel, plain version, wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/aqua_prefill.py``
``_kernel`` (``aqua_prefill_attention`` with ``kc_part=None``): causal
block attention where every query of a ``q_blk`` chunk shares the chunk's
selected dim-blocks. The CUDA source is ``csrc/aqua_prefill.cu``.

Bound on the H100: operations at serving prompt lengths (the S²/2 score
and value products against S·(D + Dv) bytes of K̂/V per KV head). The
kernel reads only the selected K̂ dims of each live key tile, skips tiles
past the causal bound and past ``lengths``, and reads q/k/v through
strides so the model's (B, S, KV, G, D) layout needs no transpose; see the
source's header for the tiling.

Dispatch is by device: CPU tensors run :func:`aqua_prefill_plain`, CUDA
tensors launch the kernel or raise. Launches count in
``_build.LAUNCHES["aqua_prefill"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import aqua_prefill_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"aqua_prefill_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I,
                                ctypes.POINTER(ctypes.c_longlong),
                                ctypes.c_float, _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def aqua_prefill_plain(q_hat: torch.Tensor, khat: torch.Tensor,
                       v: torch.Tensor, block_idx: torch.Tensor,
                       lengths: torch.Tensor, *, block_dims: int, q_blk: int,
                       causal: bool, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the masked-dense oracle
    (:func:`repro_torch.kernels.ref.aqua_prefill_ref`) in float32."""
    return aqua_prefill_ref(q_hat, khat, v, block_idx, lengths, block_dims,
                            q_blk, causal=causal, scale=scale)


def _rows_per_block(q_blk: int) -> int:
    for qr in (32, 16, 8):
        if q_blk % qr == 0:
            return qr
    raise ValueError(f"aqua_prefill kernel needs q_blk % 8 == 0, got {q_blk}")


def _launch(q_hat, khat, v, block_idx, lengths, block_dims, q_blk, causal,
            scale):
    b, h, s, d = q_hat.shape
    kvh = khat.shape[1]
    dv = v.shape[-1]
    nqc, nb_sel = block_idx.shape[2], block_idx.shape[3]
    if q_hat.dtype not in _DTYPES or khat.dtype != q_hat.dtype \
            or v.dtype != q_hat.dtype:
        raise TypeError("aqua_prefill kernel takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q_hat.dtype}, {khat.dtype}, "
                        f"{v.dtype}")
    if (khat.shape[-1] != d or h % kvh or nb_sel * block_dims > 128
            or dv > 128 or nqc * q_blk < s):
        raise ValueError(f"aqua_prefill kernel: unsupported shapes q "
                         f"{q_hat.shape} k {khat.shape} v {v.shape} "
                         f"block_idx {block_idx.shape}")
    dev = q_hat.device
    for t in (q_hat, khat, v):
        if t.device != dev or t.stride(-1) != 1:
            raise ValueError("aqua_prefill kernel needs q/k/v on one CUDA "
                             "device with a contiguous last axis")
    for t in (block_idx, lengths):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("block_idx and lengths must be contiguous int32 "
                             "on the kernel's device")
    out = torch.empty((b, h, s, dv), dtype=v.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*q_hat.stride()[:3], *khat.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    lib = _build.load("aqua_prefill", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.aqua_prefill_launch(
            q_hat.data_ptr(), khat.data_ptr(), v.data_ptr(),
            block_idx.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
            kvh, s, dv, nb_sel, block_dims, q_blk, nqc,
            _rows_per_block(q_blk), strides, float(scale), int(causal),
            _DTYPES[q_hat.dtype], stream)
    _build.check(err, "aqua_prefill")
    return out


def aqua_prefill_attention(q_hat: torch.Tensor, khat: torch.Tensor,
                           v: torch.Tensor, block_idx: torch.Tensor,
                           lengths: torch.Tensor, *, block_dims: int = 8,
                           q_blk: int = 128, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse AQUA prefill attention.

    q_hat (B, H, S, D) projected queries; khat (B, KV, S, D); v (B, KV, S,
    Dv) — any strides with a contiguous last axis; block_idx (B, H,
    ceil(S / q_blk), NB_sel) int32 per-chunk selections; lengths (B,)
    int32. ``scale`` defaults to 1/sqrt(D). Returns (B, H, S, Dv); rows at
    or past a row's length are don't-care."""
    if scale is None:
        scale = 1.0 / q_hat.shape[-1] ** 0.5
    dev = q_hat.device.type
    if dev == "cpu":
        return aqua_prefill_plain(q_hat, khat, v, block_idx, lengths,
                                  block_dims=block_dims, q_blk=q_blk,
                                  causal=causal, scale=scale)
    if dev != "cuda":
        raise ValueError(f"aqua_prefill: unsupported device {q_hat.device}")
    return _launch(q_hat, khat, v, block_idx, lengths, block_dims, q_blk,
                   causal, scale)
