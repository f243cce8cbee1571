"""AQUA block-sparse prefill attention: CUDA kernel, plain version, wrapper.

Replaces the Pallas TPU kernel bodies of ``src/repro/kernels/aqua_prefill.py``:
``_kernel`` (``aqua_prefill_attention`` with ``kc_part=None``) and
``_part_kernel`` (with ``kc_part``: each q-tile attends only its
participating key chunks, hierarchical AQUA's prefill stage). Causal block
attention where every query of a ``q_blk`` chunk shares the chunk's
selected dim-blocks; ``q_offset`` places the queries at sequence rows
``[q_offset, q_offset + T)`` of the key stripe (the chunk-resumable entry
of chunked prefill); ``window`` keeps only keys ``kpos > qpos - window``
(sliding-window models). The CUDA source is ``csrc/aqua_prefill.cu``, the
participating walk its compile-time variant ``kPart``.

Bound on the H100: operations at serving prompt lengths (the S²/2 score
and value products against S·(D + Dv) bytes of K̂/V per KV head). The
kernel reads only the selected K̂ dims of each live key tile, skips tiles
past the causal bound and past ``lengths`` and, under a window, the tiles
before each block's band (so the work scales with the window), and reads q/k/v through
strides so the model's (B, S, KV, G, D) layout needs no transpose. Both
dtypes run on the tensor cores: bf16 on ``wgmma`` (``csrc/attn_tile.cuh``),
float32 on ``wgmma`` with every product split into three TF32 passes,
which hold the float32 limits (``csrc/f32_tile.cuh``); see the headers
for the tiling. The bf16 kernel copies K̂ and V by TMA tensor maps and q̂ in
16-byte pieces: it needs D and Dv multiples of 8, D <= 256, 16-byte
aligned bases and outer strides, under 2**40 bytes (``ValueError``
otherwise). The float32 kernel copies 16-byte pieces where the views,
``block_dims``, D and Dv allow, else 4-byte ones; it gathers the union of
the selections of the ``q_blk`` tiles a 64-row block covers, at most 256
dims, and computes the scores once for every output column. Both take a
selection and a Dv of at most 256 (``ValueError`` past those; JAX's
Pallas kernel takes any; the bf16 kernel a Dv above 128, RecurrentGemma's
head_dim 256, in 128-column slices, one per block) and need
``q_blk % 8 == 0``.

Dispatch is by device: CPU tensors run :func:`aqua_prefill_plain`, CUDA
tensors launch the kernel or raise. Launches count in
``_build.LAUNCHES["aqua_prefill"]`` (every key chunk) and
``_build.LAUNCHES["aqua_prefill_part"]`` (participating chunks).
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
                                _I, _I, _I, _I, _I, _I, _I, _I,
                                ctypes.POINTER(ctypes.c_longlong),
                                ctypes.c_float, _I, _I, _P, _I, _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: keys per tile of the CUDA walk: a participating chunk is walked as
#: ``k_blk / KEY_TILE`` tiles
KEY_TILE = 64


def aqua_prefill_plain(q_hat: torch.Tensor, khat: torch.Tensor,
                       v: torch.Tensor, block_idx: torch.Tensor,
                       lengths: torch.Tensor, *, block_dims: int, q_blk: int,
                       causal: bool, scale: float, q_offset: int = 0,
                       kc_part: Optional[torch.Tensor] = None,
                       k_blk: int = 128,
                       window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the masked-dense oracle
    (:func:`repro_torch.kernels.ref.aqua_prefill_ref`) in float32."""
    return aqua_prefill_ref(q_hat, khat, v, block_idx, lengths, block_dims,
                            q_blk, causal=causal, scale=scale,
                            q_offset=q_offset, kc_part=kc_part, k_blk=k_blk,
                            window=window)


#: rows of a float32 block, and the widest union of selected dims it gathers
F32_ROWS, F32_MAX_DEPTH = 64, 256
#: the widest selection and value width either route takes (head_dim 256)
MAX_WIDTH = 256


def _f32_union_width(d: int, nsel: int, q_blk: int, nqc: int) -> int:
    """Widest union of selected dims a 64-row float32 block can gather
    (``f32_tile::union_width``)."""
    tiles = (1 if q_blk % F32_ROWS == 0 else F32_ROWS // q_blk
             if F32_ROWS % q_blk == 0 else (F32_ROWS - 1) // q_blk + 2)
    return min(d, min(tiles, nqc) * nsel)


def _launch(q_hat, khat, v, block_idx, lengths, block_dims, q_blk, causal,
            scale, q_offset, kc_part, k_blk, window):
    b, h, t, d = q_hat.shape
    kvh, s = khat.shape[1], khat.shape[2]
    dv = v.shape[-1]
    nqc, nb_sel = block_idx.shape[2], block_idx.shape[3]
    if q_hat.dtype not in _DTYPES or khat.dtype != q_hat.dtype \
            or v.dtype != q_hat.dtype:
        raise TypeError("aqua_prefill kernel takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q_hat.dtype}, {khat.dtype}, "
                        f"{v.dtype}")
    if (khat.shape[-1] != d or h % kvh or nb_sel * block_dims > MAX_WIDTH
            or dv > MAX_WIDTH or nqc * q_blk < t or v.shape[2] != s
            or q_blk % 8):
        raise ValueError(f"aqua_prefill kernel: unsupported shapes q "
                         f"{q_hat.shape} k {khat.shape} v {v.shape} "
                         f"block_idx {block_idx.shape} (it takes a "
                         f"selection and Dv up to {MAX_WIDTH})")
    dev = q_hat.device
    for x in (q_hat, khat, v):
        if x.device != dev or x.stride(-1) != 1:
            raise ValueError("aqua_prefill kernel needs q/k/v on one CUDA "
                             "device with a contiguous last axis")
    if q_hat.dtype == torch.bfloat16:
        if d % 8 or d > MAX_WIDTH or dv % 8:
            raise ValueError(f"aqua_prefill bf16 kernel needs D and Dv "
                             f"multiples of 8 and D <= {MAX_WIDTH}, got "
                             f"{d}, {dv}")
        _build.check_cp_async("aqua_prefill", q_hat, khat, v)
        _build.check_tma("aqua_prefill", khat, v)
    elif _f32_union_width(d, nb_sel * block_dims, q_blk, nqc) > F32_MAX_DEPTH:
        raise ValueError(f"aqua_prefill float32 kernel gathers at most "
                         f"{F32_MAX_DEPTH} dims a block: D {d} with "
                         f"q_blk {q_blk} covers more")
    for x in (block_idx, lengths) + (() if kc_part is None else (kc_part,)):
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("block_idx, lengths and kc_part must be "
                             "contiguous int32 on the kernel's device")
    if kc_part is not None and kc_part.shape[:2] != (b, nqc):
        raise ValueError(f"kc_part {tuple(kc_part.shape)} must be (B, NQC, "
                         f"KT) with (B, NQC) = {(b, nqc)}")
    out = torch.empty((b, h, t, dv), dtype=v.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*q_hat.stride()[:3], *khat.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    lib = _build.load("aqua_prefill", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.aqua_prefill_launch(
            q_hat.data_ptr(), khat.data_ptr(), v.data_ptr(),
            block_idx.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
            kvh, t, s, q_offset, d, dv, nb_sel, block_dims, q_blk, nqc,
            _build.f32_copy_width(q_hat, khat, v, block_dims=block_dims),
            strides, float(scale), int(causal),
            0 if window is None else int(window),
            None if kc_part is None else kc_part.data_ptr(),
            0 if kc_part is None else kc_part.shape[2], k_blk,
            _DTYPES[q_hat.dtype], stream)
    _build.check(err, "aqua_prefill" if kc_part is None
                 else "aqua_prefill_part")
    return out


def aqua_prefill_attention(q_hat: torch.Tensor, khat: torch.Tensor,
                           v: torch.Tensor, block_idx: torch.Tensor,
                           lengths: torch.Tensor, *, block_dims: int = 8,
                           q_blk: int = 128, causal: bool = True,
                           scale: Optional[float] = None, q_offset: int = 0,
                           kc_part: Optional[torch.Tensor] = None,
                           k_blk: int = 128,
                           window: Optional[int] = None) -> torch.Tensor:
    """Block-sparse AQUA prefill attention.

    q_hat (B, H, T, D) projected queries, sequence rows [q_offset,
    q_offset + T); khat (B, KV, S, D); v (B, KV, S, Dv) with q_offset + T
    <= S — any strides with a contiguous last axis; block_idx (B, H,
    ceil(T / q_blk), NB_sel) int32 selections per chunk-local q_blk tile;
    lengths (B,) int32 valid sequence lengths (global positions).
    kc_part (B, ceil(T / q_blk), KT) int32: per q-tile, the participating
    chunks of ``k_blk`` keys (sorted ascending, -1 = none,
    ``selection.chunk_participating_tiles``), or None for every key;
    ``k_blk`` must be a multiple of 64. ``window`` (>= 1, or None for
    none) keeps only keys ``kpos > qpos - window``, causal or not, as the
    Pallas kernels do. ``scale`` defaults to 1/sqrt(D). Returns (B, H, T,
    Dv); rows at or past a row's length attend every valid key, as the
    Pallas kernel's (an MoE routes a padded admission's pad rows); a lane
    of length 0 gets the mean of its V over all S keys in every row, as
    the plain version and JAX's dense reference give."""
    _build.refuse_grad("aqua_prefill", q_hat, khat, v)
    if scale is None:
        scale = 1.0 / q_hat.shape[-1] ** 0.5
    if not 0 <= q_offset <= khat.shape[2] - q_hat.shape[2]:
        raise ValueError(f"aqua_prefill: q_offset {q_offset} + T "
                         f"{q_hat.shape[2]} exceeds the {khat.shape[2]} keys")
    if window is not None and window < 1:
        raise ValueError(f"aqua_prefill: window must be >= 1, got {window}")
    if kc_part is not None and (k_blk <= 0 or k_blk % KEY_TILE):
        raise ValueError(f"aqua_prefill: k_blk {k_blk} must be a multiple "
                         f"of {KEY_TILE} (the kernel's key tile)")
    dev = q_hat.device.type
    if dev == "cpu":
        return aqua_prefill_plain(q_hat, khat, v, block_idx, lengths,
                                  block_dims=block_dims, q_blk=q_blk,
                                  causal=causal, scale=scale,
                                  q_offset=q_offset, kc_part=kc_part,
                                  k_blk=k_blk, window=window)
    if dev != "cuda":
        raise ValueError(f"aqua_prefill: unsupported device {q_hat.device}")
    return _launch(q_hat, khat, v, block_idx, lengths, block_dims, q_blk,
                   causal, scale, q_offset, kc_part, k_blk, window)
