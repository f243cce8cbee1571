"""AQUA block-sparse decode attention: CUDA kernel, plain version, wrappers.

Replaces the Pallas TPU kernels of ``src/repro/kernels/aqua_decode.py``:
``_kernel`` (contiguous cache, via ``aqua_decode_attention``) and, via
``aqua_paged_decode_attention``, ``_paged_kernel`` (page pool),
``_paged_quant_kernel`` (int8 pool with per-page scales),
``_paged_part_kernel`` (hierarchical AQUA: participating pages only) and
``_paged_part_quant_kernel`` (both). All live in ``csrc/aqua_decode.cu``:
the contiguous cache is a page pool with one page per lane and no table.

Bound on the H100: bytes — per lane and KV head, the union of its G heads'
selected dim-blocks (k_ratio) of every valid K̂ row plus every valid V row,
of the participating pages only (one byte per element for int8 pools). The
kernel reads K̂ in the cache's own seq-major layout (no dim-major copy of
the cache per step, which would move the whole K̂ once more than the kernel
saves), only the selected blocks and only valid positions, split over the
sequence so that a small batch still fills the card.

Three routes (see the source's header), chosen by :func:`decode_route`
from dtype, flags and shapes alone. The group route takes bf16 q̂ over a
contiguous cache, a page pool, an int8 pool, the participating pages or
the participating pages of an int8 pool (``_kernel``, ``_paged_kernel``,
``_paged_quant_kernel``, ``_paged_part_kernel``,
``_paged_part_quant_kernel``): one block per (split, KV head, lane) for
all G heads of the group, so each K̂ piece and V row is read once per
group; TMA bulk copies bring the rows into a ring per warp (bf16: the
union of the group's selected 8-dim chunks and the V rows; int8: whole
rows, converted exactly to bf16 in registers), and the scores and P·V run
on the tensor cores (``mma.sync``). It needs D and Dv multiples of 8
(int8: of 16), D <= 256, and 16-byte aligned views (``ValueError``
otherwise). The float32 group route (``"group_f32"``) takes float32 q̂
over a contiguous cache or a page pool at full precision (``_kernel`` and
``_paged_kernel`` as a served HF checkpoint runs them): the same blocks,
each 8-position tile's K̂ and V rows copied whole (two bulk copies where
the tile lies in one page), the scores and P·V exactly in float32 on FFMA.
It needs D and Dv multiples of 4, D <= 256, and 16-byte aligned views
(``ValueError`` otherwise). float32 with int8 pools or participating
pages, float32 widths off its route, and the bf16 int8 and participating
widths off the group route run the per-head route of the first port (one
block per query head, scalar loads). Every route splits the sequence into
256-position blocks (``aqua_decode_split``), which sizes the float32
scratch.

Dispatch is by the device of the tensors: CPU tensors run the plain PyTorch
version (:func:`aqua_decode_plain`), CUDA tensors launch the kernel or
raise. Launches count in ``_build.LAUNCHES`` under the name of the body
they replace (:func:`body_name`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, _block_mask

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"aqua_decode_launch": [_P] * 11 + [_I] * 12 + [ctypes.c_float, _I,
                                                        _I, _P],
        "aqua_decode_split": []}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"per_head": 0, "group": 1, "group_f32": 2}


def body_name(paged: bool, quant: bool = False, part: bool = False) -> str:
    """Launch-count key of the TPU kernel body a call replaces."""
    if not paged:
        return "aqua_decode"
    return "aqua_paged" + ("_part" if part else "") + (
        "_quant" if quant else "") + "_decode"


def decode_route(dtype: torch.dtype, *, quant: bool, part: bool, d: int,
                 dv: int, nsel: int) -> str:
    """The route a CUDA call takes: ``"group"`` (bf16), ``"group_f32"``
    (float32 at full precision over every page) or ``"per_head"``, from
    q̂'s dtype, int8 pools (``quant``), participating pages (``part``), the
    widths D and Dv and the selected dims NB_sel·block_dims. Raises
    ``TypeError`` for a q̂ dtype no route takes and ``ValueError`` for
    shapes none takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"aqua_decode kernel takes float32 or bfloat16 q, "
                        f"got {dtype}")
    if nsel > 256 or dv > 256:
        raise ValueError(f"aqua_decode kernel takes at most 256 selected dims "
                         f"and Dv <= 256, got {nsel} and {dv}")
    if dtype == torch.float32:
        # bulk copies move whole 16-byte units: float32 rows of a multiple
        # of 4 dims
        if not (quant or part) and d % 4 == 0 and dv % 4 == 0 and d <= 256:
            return "group_f32"
        return "per_head"
    # bf16 rows of a multiple of 8 dims, int8 rows of a multiple of 16
    # (with or without participating pages)
    unit = 16 if quant else 8
    if d % unit == 0 and dv % unit == 0 and d <= 256:
        return "group"
    if quant or part:
        return "per_head"
    raise ValueError(f"aqua_decode bf16 kernel needs D and Dv multiples "
                     f"of 8 and D <= 256, got D {d}, Dv {dv}")


def aqua_decode_plain(q_hat: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_idx: torch.Tensor, lengths: torch.Tensor,
                      page_table: Optional[torch.Tensor], *, block_dims: int,
                      scale: float, k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      part_idx: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (masked-dense, float32).

    q_hat (B, H, D); k (P, KV, ps, D); v (P, KV, ps, Dv); block_idx
    (B, H, NB_sel) int32; lengths (B,) int32; page_table (B, NP) int32 with
    -1 unmapped, or None for a contiguous cache (P = B, ps = S).
    int8 pools: k_scale / v_scale (P, SH) float32; the key scale multiplies
    the score, the value scale each V row. part_idx (B, KP) int32: only
    those logical pages are attended. Returns (B, H, Dv) in v's dtype, or
    float32 for int8 pools. A lane with no valid position gets the mean of
    the V slots the Pallas kernel visits (every slot of its view, or of
    its participating pages), as that kernel writes there.
    """
    b, h, d = q_hat.shape
    kvh, ps = k.shape[1], k.shape[2]
    rows = (torch.arange(b, device=k.device)[:, None] if page_table is None
            else page_table.long().clamp(min=0))         # (B, NP) pages
    s = rows.shape[1] * ps
    kf, vf = k[rows].float(), v[rows].float()            # (B, NP, KV, ps, D)
    g = h // kvh
    factor = scale
    if k_scale is not None:
        # the key scale of each (lane, kv head, position), through its page
        ks = k_scale[rows].float().expand(-1, -1, kvh)   # (B, NP, KV)
        factor = scale * ks.transpose(1, 2).repeat_interleave(
            ps, dim=-1)[:, :, None, :]
        vf = vf * v_scale[rows].float()[..., :, None, None]
    kf = kf.transpose(1, 2).reshape(b, kvh, s, -1)
    vf = vf.transpose(1, 2).reshape(b, kvh, s, -1)
    mask = _block_mask(block_idx, d, block_dims)
    qm = (q_hat.float() * mask).reshape(b, kvh, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qm, kf) * factor
    pos = torch.arange(s, device=k.device)
    valid = pos[None, :] < lengths.to(k.device)[:, None]     # (B, S)
    visited = None
    if part_idx is not None:
        hit = (torch.arange(s // ps, device=k.device)[None, :, None]
               == part_idx.to(k.device)[:, None, :]).any(-1)
        visited = hit.repeat_interleave(ps, dim=1)
        valid &= visited
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    if visited is not None:
        # a lane with no valid position weighs its visited slots alike
        # (every score NEG_INF) and the others not at all
        off = ~valid.any(-1, keepdim=True) & ~visited
        scores = torch.where(off[:, None, None, :],
                             torch.full_like(scores, 2 * NEG_INF), scores)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, vf).reshape(b, h, -1)
    return out if k_scale is not None else out.to(v.dtype)


def _launch(q_hat, k, v, block_idx, lengths, page_table, block_dims, scale,
            k_scale, v_scale, part_idx):
    b, h, d = q_hat.shape
    _, kvh, ps, dk = k.shape
    dv = v.shape[-1]
    nb_sel = block_idx.shape[-1]
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else q_hat.dtype
    if q_hat.dtype not in _DTYPES or k.dtype != kv_dtype \
            or v.dtype != kv_dtype:
        raise TypeError(f"aqua_decode kernel takes float32 or bfloat16 q with "
                        f"k/v of the same dtype (int8 with scales), got "
                        f"{q_hat.dtype}, {k.dtype}, {v.dtype}")
    if dk != d or h % kvh:
        raise ValueError(f"aqua_decode kernel: unsupported shapes q "
                         f"{q_hat.shape} "
                         f"k {k.shape} v {v.shape} NB_sel {nb_sel}")
    route = decode_route(q_hat.dtype, quant=quant, part=part_idx is not None,
                         d=d, dv=dv, nsel=nb_sel * block_dims)
    if page_table is None and (k.shape[0] != b or quant
                               or part_idx is not None):
        raise ValueError("contiguous cache must have one page per lane, no "
                         "scales and no participation table")
    if quant and (v_scale is None or k_scale.shape != v_scale.shape
                  or k_scale.shape[0] != k.shape[0]
                  or k_scale.shape[1] not in (1, kvh)):
        raise ValueError("k_scale / v_scale must both be (P, 1) or (P, KV)")
    optional = (page_table, part_idx, k_scale, v_scale)
    dev = q_hat.device
    for t in (q_hat, k, v, block_idx, lengths, *optional):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("aqua_decode kernel needs contiguous tensors on "
                             "one CUDA device")
    for t in (block_idx, lengths, page_table, part_idx):
        if t is not None and t.dtype != torch.int32:
            raise TypeError("block_idx, lengths, page_table and part_idx "
                            "must be int32")
    for t in (k_scale, v_scale):
        if t is not None and t.dtype != torch.float32:
            raise TypeError("k_scale and v_scale must be float32")
    if route != "per_head":
        _build.check_cp_async("aqua_decode", q_hat, k, v)
    lib = _build.load("aqua_decode", _SIG)
    npl = 0 if page_table is None else page_table.shape[1]
    kp = 0 if part_idx is None else part_idx.shape[1]
    # one partial block per `split` positions walked; the float32 scratch
    # holds each split's (max, sum, acc[Dv])
    walked = ps * (kp if part_idx is not None else max(npl, 1))
    nsplit = -(-walked // lib.aqua_decode_split())
    out = torch.empty((b, h, dv), dtype=torch.float32 if quant else v.dtype,
                      device=dev)
    scratch = torch.empty((b, h, nsplit, dv + 2), dtype=torch.float32,
                          device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.aqua_decode_launch(
            q_hat.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
            *map(ptr, optional), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, h, kvh, d, dv, nb_sel, block_dims, ps, npl,
            kp, 0 if k_scale is None else k_scale.shape[1], nsplit,
            float(scale), _DTYPES[q_hat.dtype], _ROUTES[route],
            stream)
    _build.check(err, body_name(page_table is not None, quant,
                                part_idx is not None))
    return out


def _on_cpu(q_hat: torch.Tensor) -> bool:
    """True for CPU tensors (the plain version runs); False for CUDA
    tensors (the kernel launches); raises for any other device."""
    dev = q_hat.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"aqua_decode: unsupported device {q_hat.device}")
    return dev == "cpu"


def aqua_decode_attention(q_hat: torch.Tensor, khat: torch.Tensor,
                          v: torch.Tensor, block_idx: torch.Tensor,
                          lengths: torch.Tensor, *, block_dims: int = 8,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse AQUA decode over a contiguous cache.

    q_hat (B, H, D) projected query; khat (B, KV, S, D) seq-major projected
    key cache; v (B, KV, S, Dv); block_idx (B, H, NB_sel) int32 selected
    dim-blocks; lengths (B,) int32. ``scale`` defaults to 1/sqrt(D).
    Returns (B, H, Dv) in v's dtype."""
    _build.refuse_grad("aqua_decode", q_hat, khat, v)
    if scale is None:
        scale = 1.0 / q_hat.shape[-1] ** 0.5
    if _on_cpu(q_hat):
        return aqua_decode_plain(q_hat, khat, v, block_idx, lengths, None,
                                 block_dims=block_dims, scale=scale)
    return _launch(q_hat, khat, v, block_idx, lengths, None, block_dims,
                   scale, None, None, None)


def aqua_paged_decode_attention(q_hat: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, block_idx: torch.Tensor,
                                page_table: torch.Tensor,
                                lengths: torch.Tensor, *, block_dims: int = 8,
                                scale: Optional[float] = None,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None,
                                part_idx: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Block-sparse AQUA decode over a page pool.

    k_pool (P, KV, ps, D) / v_pool (P, KV, ps, Dv) seq-major per page;
    page_table (B, NP) int32, -1 unmapped (masked by ``lengths``).
    Position ``pos`` of lane b lives in page ``page_table[b, pos // ps]`` at
    offset ``pos % ps``; the kernel resolves it per token. int8 pools
    take k_scale / v_scale (P, SH) float32 and return float32. part_idx
    (B, KP) int32 (sorted logical pages, ``core.selection``) restricts
    the walk to those pages."""
    _build.refuse_grad("aqua_paged_decode", q_hat, k_pool, v_pool)
    if scale is None:
        scale = 1.0 / q_hat.shape[-1] ** 0.5
    if _on_cpu(q_hat):
        return aqua_decode_plain(q_hat, k_pool, v_pool, block_idx, lengths,
                                 page_table, block_dims=block_dims,
                                 scale=scale, k_scale=k_scale,
                                 v_scale=v_scale, part_idx=part_idx)
    return _launch(q_hat, k_pool, v_pool, block_idx, lengths, page_table,
                   block_dims, scale, k_scale, v_scale, part_idx)
