"""Dense flash attention: CUDA kernel, plain version, wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
``_kernel``: causal (or not) GQA attention with an optional sliding window
and optional valid key counts per row (``lengths``), scale 1/sqrt(D),
float32 online softmax. The CUDA source is
``csrc/flash_attention.cu``. It serves the dense baseline (AQUA off) and
per-dim AQUA prefill (``block_dims`` 1, on the masked q̂).

Bound on the H100: operations at prompt lengths (the S²/2 score and value
products against S·2D bytes of K/V per KV head). The kernel walks only the
key tiles inside the causal bound and the window, and reads q/k/v through
strides so the model's (B, S, KV, G, D) layout needs no transpose. Both
dtypes run on the tensor cores: bf16 on ``wgmma`` (``csrc/attn_tile.cuh``),
float32 on ``wgmma`` with every product split into three TF32 passes,
which hold the float32 limits (``csrc/f32_tile.cuh``); see the headers
for the tiling. The bf16 kernel copies K and V by TMA tensor maps and Q
in 16-byte pieces: it needs D % 8 == 0, 16-byte aligned bases and outer
strides, under 2**40 bytes (``ValueError`` otherwise). The float32 kernel
copies 16-byte pieces where D % 4 == 0 and the views allow, else 4-byte
ones. Both take D <= 256 (``ValueError`` past it; JAX's Pallas kernel
takes any); the bf16 kernel computes a D above 128 (RecurrentGemma's 256)
in 128-column slices of the output, one per block, the float32 kernel
every column in one block.

Dispatch is by device: CPU tensors run :func:`flash_attention_plain`, CUDA
tensors launch the kernel or raise. Launches count in
``_build.LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"flash_attention_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.c_float, _I, _I, _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest head dim either route takes (RecurrentGemma's 256)
MAX_WIDTH = 256


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          lengths: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the dense oracle
    (:func:`repro_torch.kernels.ref.flash_attention_ref`) in float32."""
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               lengths=lengths)


def _launch(q, k, v, causal, window, lengths):
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if (k.shape != (b, kvh, s, d) or v.shape != k.shape or h % kvh
            or d > MAX_WIDTH):
        raise ValueError(f"flash_attention kernel: unsupported shapes q "
                         f"{q.shape} k {k.shape} v {v.shape}")
    dev = q.device
    for t in (q, k, v):
        if t.device != dev or t.stride(-1) != 1:
            raise ValueError("flash_attention kernel needs q/k/v on one CUDA "
                             "device with a contiguous last axis")
    if lengths is not None and (lengths.shape != (b,) or lengths.device != dev
                                or lengths.dtype != torch.int32
                                or not lengths.is_contiguous()):
        raise ValueError("flash_attention kernel: lengths must be a "
                         "contiguous (B,) int32 tensor on q's device")
    if q.dtype == torch.bfloat16:
        if d % 8:
            raise ValueError(f"flash_attention bf16 kernel needs D % 8 == 0, "
                             f"got {d}")
        _build.check_cp_async("flash_attention", q, k, v)
        _build.check_tma("flash_attention", k, v)
    out = torch.empty((b, h, s, d), dtype=v.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    lib = _build.load("flash_attention", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lengths is None else lengths.data_ptr(), b, h,
            kvh, s, d, strides, 1.0 / d ** 0.5, int(causal),
            0 if window is None else int(window), _DTYPES[q.dtype],
            _build.f32_copy_width(q, k, v), stream)
    _build.check(err, "flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention. q (B, H, S, D); k, v (B, KV, S, D) — any strides
    with a contiguous last axis; kv head = h // (H / KV). ``window``
    keeps keys with ``kpos > qpos - window``; ``lengths`` (B,) int32 keys
    with ``kpos < lengths[b]`` (a bucket-padded admission's pad rows then
    see every valid key, as JAX's dense reference computes them; a lane
    of length 0 gets the mean of its V over all S keys in every row, as
    that reference does). Returns (B, H, S, D) in v's dtype."""
    _build.refuse_grad("flash_attention", q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    dev = q.device.type
    if dev == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     lengths=lengths)
    if dev != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window, lengths)
