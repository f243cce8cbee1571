"""CUDA kernels of the port against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided in the
fixture, never at import). Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Tolerances, per element, |out - ref| <= rtol * |ref| + atol: both sides
compute in float32 from the same inputs, in different summation orders.
float32: rtol = atol = 1e-5 (a few hundred terms of magnitude <= 1).
bfloat16: both round the float32 result to bf16 once, so they may differ
by one bf16 ulp, which is at most 2^-7 * |ref|; atol 1e-4 covers the
float32 difference near zero.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, SparsitySpec, reduced)
from repro_torch.core import selection
from repro_torch.core.calibration import identity_projections
from repro_torch.kernels import aqua_decode as dk
from repro_torch.kernels import aqua_prefill as pk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.kernels._build import LAUNCHES
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, poisson_trace

pytestmark = pytest.mark.gpu
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}


def _within_tol(out, ref, dtype, valid=None):
    rtol, atol = TOL[dtype]
    over = (out.float() - ref.float()).abs() - rtol * ref.float().abs() - atol
    if valid is not None:
        over = torch.where(valid, over, torch.zeros_like(over))
    return over.max().item() <= 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


# (h, kv, d, k_ratio, block_dims): groups of G = 1, 2, 3, 4, 8 and 16
# heads (16: two blocks per KV head on both group routes, also at the
# served head dim 128); 8-dim chunks shared by several blocks (block_dims
# 2, 4) and blocks spanning chunks (16); head dims past 128 (the group
# routes' wide kernels) and one that is not a multiple of 16 (a padded
# output slice)
DECODE_CASES = [(16, 8, 128, 0.75, 8), (8, 2, 64, 0.5, 8), (4, 4, 32, 1.0, 8),
                (32, 8, 128, 0.75, 8), (16, 2, 64, 0.75, 8),
                (12, 4, 64, 0.75, 8), (32, 2, 64, 0.75, 8),
                (32, 2, 128, 0.75, 8),
                (8, 2, 64, 0.5, 2), (8, 4, 64, 0.75, 4), (16, 4, 128, 0.5, 16),
                (8, 4, 256, 0.75, 8), (8, 2, 72, 0.75, 8),
                # Qwen1.5-4B (MHA, group 1) and Minitron-4B (group 3)
                (20, 20, 128, 0.75, 8), (24, 8, 128, 0.75, 8),
                # OLMoE-1B-7B and Qwen2-MoE-A2.7B (MHA, 16 heads)
                (16, 16, 128, 0.75, 8),
                # Whisper-tiny's decoder (MHA, 6 heads of 64 dims: 6 of 8
                # blocks)
                (6, 6, 64, 0.75, 8)]


# page sizes 16 and 64 hold whole 16-position tiles; 8 splits a tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged,ps", [(False, None), (True, 8), (True, 16),
                                      (True, 64)])
@pytest.mark.parametrize("h,kv,d,k_ratio,bd", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, dtype, paged, ps, h, kv, d,
                                     k_ratio, bd):
    """Lengths: the full table, 1, not a multiple of a tile (8 or 128
    positions), and 0 (an idle lane: the mean of the V slots the Pallas
    kernel visits, its own stripe or, unmapped, page 0, which an MoE
    routes with the live lanes). Every head of a group matches the plain
    version, where the group's heads select different dim-blocks. bf16
    takes the group route, float32 the float32 group route."""
    gen = torch.Generator(device="cuda").manual_seed(d + h + bd)
    b, s = 6, 320
    q = _rand(gen, b, h, d, dtype=dtype)
    k = _rand(gen, b, kv, s + 20, d, dtype=dtype)[:, :, :s].contiguous()
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    lengths = torch.tensor([s, 1, 77, 129, 0, 203], dtype=torch.int32,
                           device=cuda)
    block_idx = ops.decode_blocks(q, k_ratio, bd)
    sel = block_idx.reshape(b, kv, h // kv, -1)
    if h > kv and k_ratio < 1:
        assert (sel != sel[:, :, :1]).any()
    assert dk.decode_route(dtype, quant=False, part=False, d=d, dv=d,
                           nsel=ops.round_k_dims(d, k_ratio, bd)) == (
        "group" if dtype == torch.bfloat16 else "group_f32")
    before = LAUNCHES.copy()
    if paged:
        npl = s // ps
        table = torch.randperm(b * npl, generator=gen, device=cuda).reshape(
            b, npl).to(torch.int32)
        k_pool = torch.zeros(b * npl, kv, ps, d, dtype=dtype, device=cuda)
        v_pool = torch.zeros_like(k_pool)
        k_pool[table.long()] = k.reshape(b, kv, npl, ps, d).transpose(1, 2)
        v_pool[table.long()] = v.reshape(b, kv, npl, ps, d).transpose(1, 2)
        table[1, 1:] = -1                  # lane 1 maps one page only
        table[4] = -1                      # lane 4 (length 0) maps none
        out = ops.aqua_paged_decode(q, k_pool, v_pool, table, lengths,
                                    k_ratio=k_ratio, block_dims=bd)
    else:
        table, k_pool, v_pool = None, k, v
        out = ops.aqua_decode(q, k, v, lengths, k_ratio=k_ratio,
                              block_dims=bd)
    ref = dk.aqua_decode_plain(q, k_pool, v_pool, block_idx, lengths, table,
                               block_dims=bd, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (b, h, d)
    assert _within_tol(out, ref, dtype)
    assert out[lengths == 0].abs().max() > 0
    name = dk.body_name(paged)
    assert LAUNCHES - before == {name: 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d,s,q_blk", [(16, 8, 128, 300, 128),
                                            (8, 2, 64, 100, 16),
                                            (4, 4, 32, 64, 8),
                                            (4, 2, 128, 200, 24),
                                            # a 72-row tile straddles the
                                            # bf16 kernel's 64-row blocks
                                            (32, 8, 128, 300, 72),
                                            # 24 gathered dims, padded to 32
                                            (4, 4, 32, 200, 64),
                                            # groups 1 and 3
                                            (20, 20, 128, 300, 128),
                                            (24, 8, 128, 300, 128),
                                            # the MoE configs' 16 / 16
                                            (16, 16, 128, 300, 128),
                                            # Whisper-tiny's decoder: a
                                            # prompt off the tile, and its
                                            # 448 decoder positions
                                            (6, 6, 64, 229, 128),
                                            (6, 6, 64, 448, 128)])
def test_prefill_kernel_matches_plain(cuda, dtype, h, kv, d, s, q_blk):
    """Every row, those at or past a lane's length too: a bucket-padded
    admission's pad rows see every valid key, and an MoE routes them with
    the real rows."""
    gen = torch.Generator(device="cuda").manual_seed(s + q_blk)
    b = 2
    q = _rand(gen, b, s, h, d, dtype=dtype).transpose(1, 2)   # strided view
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    lengths = torch.tensor([s, s // 3], dtype=torch.int32, device=cuda)
    before = LAUNCHES["aqua_prefill"]
    out = ops.aqua_prefill(q, k, v, lengths, q_blk=q_blk)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, q_blk)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, block_dims=8,
                                q_blk=chunk, causal=True, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert LAUNCHES["aqua_prefill"] == before + 1
    assert _within_tol(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_dims,q_blk", [(4, 128), (2, 24), (16, 32)])
def test_prefill_kernel_other_block_sizes(cuda, dtype, block_dims, q_blk):
    """Dim-blocks smaller than the bf16 kernel's 16-byte chunk (a chunk
    partly selected) and larger ones, aligned and straddling tiles."""
    gen = torch.Generator(device="cuda").manual_seed(block_dims)
    b, h, kv, d, s = 2, 8, 2, 64, 150
    q = _rand(gen, b, s, h, d, dtype=dtype).transpose(1, 2)
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    lengths = torch.tensor([s, s // 2], dtype=torch.int32, device=cuda)
    out = ops.aqua_prefill(q, k, v, lengths, block_dims=block_dims,
                           q_blk=q_blk)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, block_dims,
                                             q_blk)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths,
                                block_dims=block_dims, q_blk=chunk,
                                causal=True, scale=d ** -0.5)
    torch.cuda.synchronize()
    valid = (torch.arange(s, device=cuda)[None] < lengths[:, None])[
        :, None, :, None]
    assert _within_tol(out, ref, dtype, valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d,s,t,q_offset,q_blk", [
    (16, 8, 128, 300, 100, 200, 32),     # ragged last chunk (100 rows)
    (8, 2, 64, 256, 64, 128, 16),
    (4, 4, 32, 100, 37, 63, 8)])         # offset off the key tiles
def test_prefill_chunk_kernel_matches_plain(cuda, dtype, h, kv, d, s, t,
                                            q_offset, q_blk):
    """The ``q_offset`` form: T query rows at sequence offset q_offset
    against S keys; lane 1 ends inside the chunk."""
    gen = torch.Generator(device="cuda").manual_seed(s + t)
    b = 2
    q = _rand(gen, b, t, h, d, dtype=dtype).transpose(1, 2)   # strided view
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    lengths = torch.tensor([s, q_offset + t // 2], dtype=torch.int32,
                           device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths - q_offset, 0.75, 8,
                                             q_blk)
    kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5,
              q_offset=q_offset)
    before = LAUNCHES.copy()
    out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {"aqua_prefill": 1}
    assert out.shape == (b, h, t, d)
    valid = ((q_offset + torch.arange(t, device=cuda))[None]
             < lengths[:, None])[:, None, :, None]
    assert _within_tol(out, ref, dtype, valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d,s,t,q_offset,blk,kept,pin", [
    (16, 8, 128, 512, 512, 0, 128, 2, 1),
    (8, 2, 64, 320, 200, 120, 64, 3, 2)])    # ragged, straddling tiles
def test_prefill_part_kernel_matches_plain(cuda, dtype, h, kv, d, s, t,
                                           q_offset, blk, kept, pin):
    """Participating key chunks (``chunk_participating_tiles`` on random
    scores) against the masked-dense plain version; the identity table
    against the dense walk, bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(s + kept)
    b = 2
    q = _rand(gen, b, h, t, d, dtype=dtype)
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    lengths = torch.tensor([s, s - 70], dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths - q_offset, 0.75, 8,
                                             blk)
    nqc, nkc = block_idx.shape[2], -(-s // blk)
    table = selection.chunk_participating_tiles(
        torch.rand(b, nkc, generator=gen, device=cuda), nqc=nqc, q_blk=blk,
        k_blk=blk, kept_tiles=kept, pin_tiles=pin, q_offset=q_offset)
    kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5,
              q_offset=q_offset, k_blk=blk)
    before = LAUNCHES.copy()
    out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                    kc_part=table, **kw)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, kc_part=table,
                                **kw)
    ident = torch.arange(nkc, dtype=torch.int32, device=cuda).expand(
        b, nqc, nkc).contiguous()
    walk = pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                     kc_part=ident, **kw)
    dense = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {"aqua_prefill_part": 2, "aqua_prefill": 1}
    valid = ((q_offset + torch.arange(t, device=cuda))[None]
             < lengths[:, None])[:, None, :, None]
    assert _within_tol(out, ref, dtype, valid)
    assert torch.equal(walk, dense)
    with pytest.raises(ValueError):
        pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                  kc_part=table, **dict(kw, k_blk=32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d,s,causal,window", [
    (16, 8, 128, 300, True, None), (8, 2, 64, 100, False, None),
    (4, 4, 32, 200, True, 50), (4, 1, 128, 77, False, 20),
    (16, 8, 128, 600, True, 100)])       # a window across key tiles
def test_flash_kernel_matches_plain(cuda, dtype, h, kv, d, s, causal,
                                    window):
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    b = 2
    q = _rand(gen, b, s, h, d, dtype=dtype).transpose(1, 2)   # strided view
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, s, kv, d, dtype=dtype).transpose(1, 2)
    before = LAUNCHES.copy()
    out = fk.flash_attention(q, k, v, causal=causal, window=window)
    ref = fk.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {"flash_attention": 1}
    assert out.dtype == dtype and out.shape == (b, h, s, d)
    assert _within_tol(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d,s", [(16, 16, 128, 300), (8, 2, 64, 200),
                                      (4, 1, 80, 77)])
def test_flash_kernel_with_lengths_matches_plain(cuda, dtype, h, kv, d, s):
    """A bucket-padded admission's flash call: keys at or past each row's
    length masked, every row held (pad rows see every valid key, as JAX's
    dense reference with lengths computes them), a length in the first
    key tile, one across tiles and the full one."""
    gen = torch.Generator(device="cuda").manual_seed(s + d + h)
    b = 3
    q = _rand(gen, b, s, h, d, dtype=dtype).transpose(1, 2)
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    lengths = torch.tensor([s, 5, s // 2 + 3], dtype=torch.int32,
                           device=cuda)
    before = LAUNCHES.copy()
    out = fk.flash_attention(q, k, v, causal=True, lengths=lengths)
    ref = fk.flash_attention_plain(q, k, v, causal=True, lengths=lengths)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {"flash_attention": 1}
    assert _within_tol(out, ref, dtype)
    # without lengths the pad rows see the pad keys
    assert not _within_tol(fk.flash_attention(q, k, v, causal=True), ref,
                           dtype)


@pytest.mark.parametrize("score_scale", [1.0, 3.0])
@pytest.mark.parametrize("kernel", ["prefill", "flash"])
def test_f32_kernels_at_the_served_shape(cuda, kernel, score_scale):
    """float32 (a served HF checkpoint's dtype) at Qwen3-0.6B's served
    prefill: B=1, H 16, KV 8, S 1024, head_dim 128, q_blk 128, 96 of 128
    dims selected. score_scale 3 multiplies q, so the scores, by 3 (a
    standard deviation near 3): the three-pass TF32 split's error grows
    with the scores (tests/test_torch_f32_split.py's emulation reads 0.47
    and 0.54 of the limit there, 0.07 and 0.09 at 1x)."""
    gen = torch.Generator(device="cuda").manual_seed(1024)
    f32 = torch.float32
    b, h, kv, d, s = 1, 16, 8, 128, 1024
    q = _rand(gen, b, s, h, d, dtype=f32).transpose(1, 2) * score_scale
    k = _rand(gen, b, kv, s, d, dtype=f32)
    v = _rand(gen, b, kv, s, d, dtype=f32)
    before = LAUNCHES.copy()
    if kernel == "prefill":
        lengths = torch.full((b,), s, dtype=torch.int32, device=cuda)
        block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, 128)
        kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5)
        out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
        ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
        name = "aqua_prefill"
    else:
        out = fk.flash_attention(q, k, v, causal=True)
        ref = fk.flash_attention_plain(q, k, v, causal=True)
        name = "flash_attention"
    torch.cuda.synchronize()
    assert LAUNCHES - before == {name: 1}
    assert out.dtype == f32 and out.shape == (b, h, s, d)
    assert _within_tol(out, ref, f32)


def test_prefill_chunk_rows_bitwise_equal_monolithic(cuda):
    """bf16: a chunk at a q_offset that is a multiple of the kernel's
    128-row blocks (here 384, with q_blk 128) has the monolithic call's
    blocks and selections, and each row's sum runs over the same key tiles
    in the same order whichever block or consumer warpgroup holds it, so
    its rows are bitwise the monolithic rows."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, kv, d, s, off, q_blk = 1, 16, 8, 128, 640, 384, 128
    bf = torch.bfloat16
    q = _rand(gen, b, h, s, d, dtype=bf)
    k = _rand(gen, b, kv, s, d, dtype=bf)
    v = _rand(gen, b, kv, s, d, dtype=bf)
    lengths = torch.full((b,), s, dtype=torch.int32, device=cuda)
    kw = dict(block_dims=8, q_blk=q_blk, causal=True, scale=d ** -0.5)
    full_idx, _, _ = ops.prefill_blocks(q, lengths, 0.75, 8, q_blk)
    mono = pk.aqua_prefill_attention(q, k, v, full_idx, lengths, **kw)
    chunk = pk.aqua_prefill_attention(
        q[:, :, off:], k, v, full_idx[:, :, off // q_blk:].contiguous(),
        lengths, q_offset=off, **kw)
    assert torch.equal(chunk, mono[:, :, off:])


@pytest.mark.parametrize("off,q_blk", [(384, 128), (320, 32)])
def test_f32_prefill_chunk_rows_bitwise_equal_monolithic(cuda, off, q_blk):
    """float32: a chunk at a q_offset that is a multiple of the kernel's
    64-row blocks and of q_blk has the monolithic call's blocks and
    gathered unions (q_blk 32: two tiles a block), so its rows are bitwise
    the monolithic rows."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, h, kv, d, s = 1, 16, 8, 128, 640
    f32 = torch.float32
    q = _rand(gen, b, h, s, d, dtype=f32)
    k = _rand(gen, b, kv, s, d, dtype=f32)
    v = _rand(gen, b, kv, s, d, dtype=f32)
    lengths = torch.full((b,), s, dtype=torch.int32, device=cuda)
    kw = dict(block_dims=8, q_blk=q_blk, causal=True, scale=d ** -0.5)
    full_idx, _, _ = ops.prefill_blocks(q, lengths, 0.75, 8, q_blk)
    mono = pk.aqua_prefill_attention(q, k, v, full_idx, lengths, **kw)
    chunk = pk.aqua_prefill_attention(
        q[:, :, off:], k, v, full_idx[:, :, off // q_blk:].contiguous(),
        lengths, q_offset=off, **kw)
    assert torch.equal(chunk, mono[:, :, off:])


# (S, G): S 4096 wraps the bf16 kernels' four-stage ring many times, 300
# and 1000 are ragged (a partial last key tile and row block); group sizes
# 1, 2 and 4 (flash: one head per block at G 1, two otherwise)
PIPELINE_CASES = [(s, g) for s in (300, 1000, 4096) for g in (1, 2, 4)]


@pytest.mark.parametrize("s,g", PIPELINE_CASES)
def test_flash_pipeline_shapes_match_plain(cuda, s, g):
    """bf16 flash, B=3, causal, two KV heads of G query heads, against the
    plain version."""
    gen = torch.Generator(device="cuda").manual_seed(s + g)
    b, kv, d, bf = 3, 2, 128, torch.bfloat16
    q = _rand(gen, b, s, kv * g, d, dtype=bf).transpose(1, 2)
    k = _rand(gen, b, kv, s, d, dtype=bf)
    v = _rand(gen, b, s, kv, d, dtype=bf).transpose(1, 2)
    before = LAUNCHES.copy()
    out = fk.flash_attention(q, k, v, causal=True)
    ref = fk.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {"flash_attention": 1}
    assert _within_tol(out, ref, bf)


@pytest.mark.parametrize("s,g", PIPELINE_CASES)
def test_prefill_pipeline_shapes_match_plain(cuda, s, g):
    """bf16 prefill, B=3 with per-lane lengths (the whole row, a ragged
    cut, a third), two KV heads of G query heads, against the plain
    version on each lane's valid rows."""
    gen = torch.Generator(device="cuda").manual_seed(s + 10 * g)
    b, kv, d, bf = 3, 2, 128, torch.bfloat16
    q = _rand(gen, b, s, kv * g, d, dtype=bf).transpose(1, 2)
    k = _rand(gen, b, kv, s, d, dtype=bf)
    v = _rand(gen, b, kv, s, d, dtype=bf)
    lengths = torch.tensor([s, s - 37, s // 3], dtype=torch.int32,
                           device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, 128)
    kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5)
    before = LAUNCHES.copy()
    out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {"aqua_prefill": 1}
    valid = (torch.arange(s, device=cuda)[None] < lengths[:, None])[
        :, None, :, None]
    assert _within_tol(out, ref, bf, valid)


@pytest.mark.parametrize("part", [False, True])
@pytest.mark.parametrize("window", [64, 1000])
@pytest.mark.parametrize("d", [80, 128])
def test_prefill_dv80_window_matches_plain(cuda, part, window, d):
    """bf16 prefill with Dv 80 (P·V as a 64-wide and a 16-wide product)
    under a window, K̂ 80 or 128 wide, with and without participating key
    chunks, at a q_offset."""
    gen = torch.Generator(device="cuda").manual_seed(window + d + part)
    b, h, kv, s, dv, off, blk, bf = 2, 8, 2, 640, 80, 128, 64, torch.bfloat16
    t = s - off
    q = _rand(gen, b, h, t, d, dtype=bf)
    k = _rand(gen, b, kv, s, d, dtype=bf)
    v = _rand(gen, b, kv, s, dv, dtype=bf)
    lengths = torch.tensor([s, s - 50], dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths - off, 0.75, 8, blk)
    table = None
    if part:
        table = selection.chunk_participating_tiles(
            torch.rand(b, s // blk, generator=gen, device=cuda),
            nqc=block_idx.shape[2], q_blk=blk, k_blk=blk, kept_tiles=4,
            pin_tiles=1, q_offset=off)
    kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5,
              q_offset=off, kc_part=table, k_blk=blk, window=window)
    out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    assert out.shape == (b, h, t, dv)
    valid = ((off + torch.arange(t, device=cuda))[None]
             < lengths[:, None])[:, None, :, None]
    assert _within_tol(out, ref, bf, valid)


# head dims past 128 (the engine's wide kernels, 128-column value slices):
# RecurrentGemma's geometry (16 heads over one KV head, D = Dv = 256) cut
# to 4 heads, under its window, bucket-padded lengths, a q_offset,
# participating key chunks, a non-causal call and a lane of length 0
WIDE_CASES = [dict(window=None), dict(window=64), dict(window=200, pad=37),
              dict(window=None, pad=21), dict(window=96, off=128),
              dict(window=None, off=256, part=True),
              dict(window=300, part=True), dict(window=None, causal=False),
              dict(window=150, causal=False), dict(window=None, empty=True)]


def _empty_lane_held(out, ref, dtype, empty):
    """Every lane against the plain version; with ``empty`` lane 1 has
    length 0, and each of its rows is the mean of V over all S keys in
    both (a softmax over keys all masked is uniform, as in JAX's dense
    reference), not zeros."""
    if not _within_tol(out, ref, dtype):
        return False
    return not empty or bool(out[1].float().abs().amax() > 0)


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_prefill_matches_plain(cuda, case):
    """bf16 prefill at D = Dv = 256 (a selected union of 192 dims per
    128-row q-tile, up to 256 across the q-tiles of 16 rows) against the
    plain version: the window form, lengths, a q_offset, participating
    key chunks, non-causal calls, a lane of length 0."""
    gen = torch.Generator(device="cuda").manual_seed(len(str(case)))
    b, h, kv, s, d, bf = 2, 4, 1, 600, 256, torch.bfloat16
    off, pad, blk = case.get("off", 0), case.get("pad", 0), 64
    causal, empty = case.get("causal", True), case.get("empty", False)
    t = s - off
    q = _rand(gen, b, h, t, d, dtype=bf)
    k = _rand(gen, b, kv, s, d, dtype=bf)
    v = _rand(gen, b, kv, s, d, dtype=bf)
    lengths = torch.tensor([s, 0 if empty else s - pad - 50],
                           dtype=torch.int32, device=cuda)
    for q_blk in (128, 16):
        block_idx, _, chunk = ops.prefill_blocks(q, lengths - off, 0.75, 8,
                                                 q_blk)
        table = None
        if case.get("part"):
            table = selection.chunk_participating_tiles(
                torch.rand(b, -(-s // blk), generator=gen, device=cuda),
                nqc=block_idx.shape[2], q_blk=chunk, k_blk=blk,
                kept_tiles=4, pin_tiles=1, q_offset=off)
        kw = dict(block_dims=8, q_blk=chunk, causal=causal,
                  scale=d ** -0.5, q_offset=off, kc_part=table, k_blk=blk,
                  window=case["window"])
        before = LAUNCHES.copy()
        out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
        ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
        torch.cuda.synchronize()
        assert sum((LAUNCHES - before).values()) == 1
        assert out.shape == (b, h, t, d)
        assert _empty_lane_held(out, ref, bf, empty), (case, q_blk)


@pytest.mark.parametrize("window,pad,causal", [
    (None, 0, True), (64, 0, True), (200, 0, True), (None, 33, True),
    (100, 21, True), (None, 0, False), (120, 0, False), (None, -1, True)])
def test_wide_flash_matches_plain(cuda, window, pad, causal):
    """bf16 flash at D 256 (RecurrentGemma with AQUA off, its 16 heads cut
    to 4 over one KV head) against the plain version: the window form, a
    padded admission's lengths, non-causal calls and (pad -1) a lane of
    length 0."""
    gen = torch.Generator(device="cuda").manual_seed(window or 1)
    b, h, kv, s, d, bf = 2, 4, 1, 500, 256, torch.bfloat16
    q = _rand(gen, b, h, s, d, dtype=bf)
    k = _rand(gen, b, kv, s, d, dtype=bf)
    v = _rand(gen, b, kv, s, d, dtype=bf)
    lengths = (torch.tensor([s - pad, s - pad - 40] if pad > 0 else [s, 0],
                            dtype=torch.int32, device=cuda) if pad else None)
    out = fk.flash_attention(q, k, v, causal=causal, window=window,
                             lengths=lengths)
    ref = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   lengths=lengths)
    torch.cuda.synchronize()
    assert _empty_lane_held(out, ref, bf, pad < 0)


# the wide kernels' other fixed depths and a narrow last value slice:
# (kernel, D, Dv, k_ratio, q_blk): a 16-chunk union with Dv 256 (k_ratio
# 0.5), a 24-chunk union with Dv 160 (a 32-column second slice, one V box
# of two), a 32-chunk union with Dv 136 (q_blk 16), flash at D 160 (depth
# 192) and D 200 (depth 256, a 72-column second slice)
WIDE_SHAPES = [("prefill", 256, 256, 0.5, 128),
               ("prefill", 256, 160, 0.75, 128),
               ("prefill", 256, 136, 0.75, 16),
               ("flash", 160, 160, None, None),
               ("flash", 200, 200, None, None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel,d,dv,k_ratio,q_blk", WIDE_SHAPES)
def test_wide_depths_and_slices_match_plain(cuda, dtype, kernel, d, dv,
                                            k_ratio, q_blk):
    """Head dims past 128 off RecurrentGemma's shape against the plain
    versions, under a window and with a lane cut short."""
    gen = torch.Generator(device="cuda").manual_seed(d + dv)
    b, h, kv, s = 2, 4, 1, 450
    q = _rand(gen, b, h, s, d, dtype=dtype)
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, kv, s, dv, dtype=dtype)
    lengths = torch.tensor([s, s - 99], dtype=torch.int32, device=cuda)
    if kernel == "prefill":
        block_idx, _, chunk = ops.prefill_blocks(q, lengths, k_ratio, 8,
                                                 q_blk)
        kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5,
                  window=170)
        out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
        ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
    else:
        out = fk.flash_attention(q, k, v, causal=True, window=170,
                                 lengths=lengths)
        ref = fk.flash_attention_plain(q, k, v, causal=True, window=170,
                                       lengths=lengths)
    torch.cuda.synchronize()
    assert out.shape == (b, h, s, dv)
    assert _within_tol(out, ref, dtype)


def test_float32_routes_take_dv_256(cuda):
    """The float32 prefill (192 of 256 dims selected a q-tile, unions up to
    256 across the q-tiles of 16 rows, every dim; plain and under a
    window) and flash (with lengths, and under a window) at D = Dv = 256,
    RecurrentGemma's head dim as a float32 run computes it, against their
    plain versions at the float32 limit. Past 256 both dtypes raise
    ``ValueError`` (JAX's Pallas kernels take any width; no config has a
    wider head)."""
    gen = torch.Generator(device="cuda").manual_seed(256)
    b, h, kv, s, d, f32 = 2, 4, 1, 600, 256, torch.float32
    q = _rand(gen, b, s, h, d, dtype=f32).transpose(1, 2)   # strided view
    k = _rand(gen, b, kv, s, d, dtype=f32)
    v = _rand(gen, b, kv, s, d, dtype=f32)
    lengths = torch.tensor([s, s - 77], dtype=torch.int32, device=cuda)
    for k_ratio, q_blk, window in ((0.75, 128, None), (0.75, 128, 200),
                                   (0.75, 16, None), (1.0, 128, None)):
        block_idx, _, chunk = ops.prefill_blocks(q, lengths, k_ratio, 8,
                                                 q_blk)
        kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5,
                  window=window)
        before = LAUNCHES.copy()
        out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
        ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES - before == {"aqua_prefill": 1}
        assert out.shape == (b, h, s, d)
        assert _within_tol(out, ref, f32), (k_ratio, q_blk, window)
    for window, lens in ((None, lengths), (200, None)):
        out = fk.flash_attention(q, k, v, causal=True, window=window,
                                 lengths=lens)
        ref = fk.flash_attention_plain(q, k, v, causal=True, window=window,
                                       lengths=lens)
        torch.cuda.synchronize()
        assert _within_tol(out, ref, f32), window
    for dtype in (f32, torch.bfloat16):
        wq = torch.zeros(1, 4, 64, 264, device=cuda, dtype=dtype)
        wk = torch.zeros(1, 1, 64, 264, device=cuda, dtype=dtype)
        ln = torch.full((1,), 64, dtype=torch.int32, device=cuda)
        idx, _, chunk = ops.prefill_blocks(wq, ln, 1.0, 8, 64)
        with pytest.raises(ValueError):
            pk.aqua_prefill_attention(wq, wk, wk, idx, ln, block_dims=8,
                                      q_blk=chunk)
        with pytest.raises(ValueError):
            fk.flash_attention(wq, wk, wk)


def test_f32_prefill_chunk_rows_bitwise_equal_monolithic_at_256(cuda):
    """float32 at D = Dv = 256 (RecurrentGemma's head dim: 16-key tiles,
    the union of 192 selected dims): a chunk at a q_offset that is a
    multiple of the 64-row blocks has the monolithic call's blocks and
    unions, so its rows are bitwise the monolithic rows, and both hold the
    plain version at the float32 limit."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, h, kv, d, s, off, q_blk = 1, 4, 1, 256, 640, 384, 128
    f32 = torch.float32
    q = _rand(gen, b, h, s, d, dtype=f32)
    k = _rand(gen, b, kv, s, d, dtype=f32)
    v = _rand(gen, b, kv, s, d, dtype=f32)
    lengths = torch.full((b,), s, dtype=torch.int32, device=cuda)
    kw = dict(block_dims=8, q_blk=q_blk, causal=True, scale=d ** -0.5)
    full_idx, _, _ = ops.prefill_blocks(q, lengths, 0.75, 8, q_blk)
    mono = pk.aqua_prefill_attention(q, k, v, full_idx, lengths, **kw)
    chunk_idx = full_idx[:, :, off // q_blk:].contiguous()
    chunk = pk.aqua_prefill_attention(q[:, :, off:], k, v, chunk_idx, lengths,
                                      q_offset=off, **kw)
    ref = pk.aqua_prefill_plain(q[:, :, off:], k, v, chunk_idx, lengths,
                                q_offset=off, **kw)
    torch.cuda.synchronize()
    assert torch.equal(chunk, mono[:, :, off:])
    assert _within_tol(chunk, ref, f32)


def test_f32_prefill_forms_agree_bitwise(cuda):
    """The float32 engine's two forms compute a row alike: the monolithic
    call at S 4096 (32 x 16 blocks of 128 rows: the narrow form) and its
    last 512 rows as a chunk (4 x 16 blocks: the wide form, 64-row blocks
    whose warpgroups split the depth and the columns) give the same bits,
    both at the float32 limit of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, h, kv, d, s, off, q_blk = 1, 16, 8, 128, 4096, 3584, 128
    f32 = torch.float32
    q = _rand(gen, b, h, s, d, dtype=f32)
    k = _rand(gen, b, kv, s, d, dtype=f32)
    v = _rand(gen, b, kv, s, d, dtype=f32)
    lengths = torch.full((b,), s, dtype=torch.int32, device=cuda)
    kw = dict(block_dims=8, q_blk=q_blk, causal=True, scale=d ** -0.5)
    full_idx, _, _ = ops.prefill_blocks(q, lengths, 0.75, 8, q_blk)
    mono = pk.aqua_prefill_attention(q, k, v, full_idx, lengths, **kw)
    chunk_idx = full_idx[:, :, off // q_blk:].contiguous()
    chunk = pk.aqua_prefill_attention(q[:, :, off:], k, v, chunk_idx, lengths,
                                      q_offset=off, **kw)
    ref = pk.aqua_prefill_plain(q[:, :, off:], k, v, chunk_idx, lengths,
                                q_offset=off, **kw)
    torch.cuda.synchronize()
    assert torch.equal(chunk, mono[:, :, off:])
    assert _within_tol(chunk, ref, f32)


@pytest.mark.parametrize("kernel", ["prefill", "flash"])
@pytest.mark.parametrize("edge", ["empty_lane", "unaligned_view"])
def test_f32_edges_at_dv_256(cuda, kernel, edge):
    """float32 at D = Dv = 256 against the plain version at the float32
    limit: a lane of length 0 beside a full one (every row of it the mean
    of V), and views whose base is one float off a 16-byte boundary (the
    4-byte copies, VEC 1)."""
    gen = torch.Generator(device="cuda").manual_seed(256 + len(edge))
    b, h, kv, s, d, f32 = 2, 4, 1, 330, 256, torch.float32
    empty = edge == "empty_lane"
    lengths = torch.tensor([s, 0 if empty else s - 41], dtype=torch.int32,
                           device=cuda)
    if empty:
        q, k, v = (_rand(gen, b, n, s, d, dtype=f32) for n in (h, kv, kv))
    else:
        q, k, v = (_rand(gen, b, n, s, d + 1, dtype=f32)[..., 1:]
                   for n in (h, kv, kv))
        assert q.data_ptr() % 16 and not q.is_contiguous()
    if kernel == "flash":
        out = fk.flash_attention(q, k, v, causal=True, lengths=lengths)
        ref = fk.flash_attention_plain(q, k, v, causal=True, lengths=lengths)
    else:
        block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, 128)
        kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5)
        out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
        ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    assert _empty_lane_held(out, ref, f32, empty)
    if empty:
        mean = v[1].mean(1).repeat_interleave(h // kv, 0)[:, None]
        assert _within_tol(out[1], mean.expand_as(out[1]), f32)


def test_f32_part_kernel_at_dv_256(cuda):
    """The float32 participating-chunk prefill at D = Dv = 256 (ragged, a
    q_offset, 64-row blocks covering two 32-row q-tiles) against the
    masked-dense plain version at the float32 limit; the identity table
    walks the dense walk's tiles, bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(2560)
    b, h, kv, s, t, off, d, blk = 2, 4, 1, 600, 450, 150, 256, 64
    f32 = torch.float32
    q = _rand(gen, b, h, t, d, dtype=f32)
    k = _rand(gen, b, kv, s, d, dtype=f32)
    v = _rand(gen, b, kv, s, d, dtype=f32)
    lengths = torch.tensor([s, s - 70], dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths - off, 0.75, 8, 32)
    nqc, nkc = block_idx.shape[2], -(-s // blk)
    table = selection.chunk_participating_tiles(
        torch.rand(b, nkc, generator=gen, device=cuda), nqc=nqc, q_blk=32,
        k_blk=blk, kept_tiles=4, pin_tiles=1, q_offset=off)
    kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5,
              q_offset=off, k_blk=blk)
    out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                    kc_part=table, **kw)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, kc_part=table,
                                **kw)
    ident = torch.arange(nkc, dtype=torch.int32, device=cuda).expand(
        b, nqc, nkc).contiguous()
    walk = pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                     kc_part=ident, **kw)
    dense = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    valid = ((off + torch.arange(t, device=cuda))[None]
             < lengths[:, None])[:, None, :, None]
    assert _within_tol(out, ref, f32, valid)
    assert torch.equal(walk, dense)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_value_slices_equal_narrow_calls(cuda, dtype):
    """A value width of 256 runs in bf16 as two 128-column slices, each
    walking the same key tiles with the same scores, and in float32 in one
    block whose warpgroups take 128 columns each, every column from the
    same P: either way the output's halves are bit for bit the calls on
    V's halves (RecurrentGemma's 192 of 256 selected dims, under a
    window)."""
    gen = torch.Generator(device="cuda").manual_seed(128)
    b, h, kv, s, d = 2, 4, 1, 700, 256
    q = _rand(gen, b, h, s, d, dtype=dtype)
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    lengths = torch.tensor([s, s - 123], dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, 128)
    kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5,
              window=300)
    out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
    halves = [pk.aqua_prefill_attention(q, k, v[..., c:c + 128], block_idx,
                                        lengths, **kw) for c in (0, 128)]
    torch.cuda.synchronize()
    assert torch.equal(out, torch.cat(halves, -1))


# (dtype, d, h, kv): the narrow kernels at Qwen3-0.6B's geometry, and at
# head dim 256 (RecurrentGemma's, 8 heads over one KV head) the engine's
# wide kernels and the float32 engine's wide form
REPEAT_CASES = [(torch.bfloat16, 128, 16, 8), (torch.bfloat16, 256, 8, 1),
                (torch.float32, 256, 8, 1)]


@pytest.mark.parametrize("dtype,d,h,kv", REPEAT_CASES)
def test_flash_and_prefill_bitwise_repeatable(cuda, dtype, d, h, kv):
    """Two calls on the same inputs give the same bits, whatever the
    timing of the ring and of the consumers' turns: flash (causal and
    windowed) and the prefill (plain, q_offset, participating chunks,
    window)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, s, blk, bf = 2, 1000, 128, dtype
    q = _rand(gen, b, h, s, d, dtype=bf)
    k = _rand(gen, b, kv, s, d, dtype=bf)
    v = _rand(gen, b, kv, s, d, dtype=bf)
    lengths = torch.tensor([s, s - 300], dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, blk)
    nkc = -(-s // blk)
    table = selection.chunk_participating_tiles(
        torch.rand(b, nkc, generator=gen, device=cuda),
        nqc=block_idx.shape[2], q_blk=blk, k_blk=blk, kept_tiles=3,
        pin_tiles=1)
    kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5)
    off = 512
    calls = {
        "flash": lambda: fk.flash_attention(q, k, v, causal=True),
        "flash_window": lambda: fk.flash_attention(q, k, v, causal=True,
                                                   window=300),
        "prefill": lambda: pk.aqua_prefill_attention(
            q, k, v, block_idx, lengths, **kw),
        "prefill_q_offset": lambda: pk.aqua_prefill_attention(
            q[:, :, off:], k, v, block_idx[:, :, off // blk:].contiguous(),
            lengths, q_offset=off, **kw),
        "prefill_part": lambda: pk.aqua_prefill_attention(
            q, k, v, block_idx, lengths, kc_part=table, k_blk=blk, **kw),
        "prefill_window": lambda: pk.aqua_prefill_attention(
            q, k, v, block_idx, lengths, window=200, **kw),
    }
    for name, call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second), name


def test_bf16_kernels_reject_misaligned_views(cuda):
    """The bf16 kernels copy 16-byte pieces: a view whose base is 4
    elements (8 bytes) off raises ValueError from every wrapper (prefill,
    flash, and decode for q̂, K̂ and V)."""
    b, h, kv, s, d = 1, 4, 2, 64, 64
    bf = torch.bfloat16
    k = torch.zeros(b, kv, s, d, device=cuda, dtype=bf)
    q = torch.zeros(b * h * s * d + 4, device=cuda, dtype=bf)[4:].reshape(
        b, h, s, d)
    lengths = torch.full((b,), s, dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, 64)
    with pytest.raises(ValueError):
        pk.aqua_prefill_attention(q, k, k, block_idx, lengths, block_dims=8,
                                  q_blk=chunk)
    with pytest.raises(ValueError):
        fk.flash_attention(q, k, k)
    # a K view four elements into a row: its base and seq stride are off
    wide = torch.zeros(b, kv, s, d + 4, device=cuda, dtype=bf)
    with pytest.raises(ValueError):
        fk.flash_attention(q.clone(), wide[..., 4:], k)
    # decode: q̂, K̂ or V contiguous but 8 bytes off a 16-byte boundary
    qd = torch.zeros(b, h, d, device=cuda, dtype=bf)
    lens = torch.full((b,), s, dtype=torch.int32, device=cuda)
    idx = ops.decode_blocks(qd, 0.75, 8)

    def off(x):
        return torch.zeros(x.numel() + 4, device=cuda, dtype=bf)[4:].view(
            x.shape)
    for args in ((off(qd), k, k), (qd, off(k), k), (qd, k, off(k))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            dk.aqua_decode_attention(*args, idx, lens, block_dims=8)


@pytest.mark.parametrize("d,dv,bd", [(30, 30, 2), (320, 128, 8),
                                     (128, 102, 8)])
def test_f32_decode_off_the_group_route_widths(cuda, d, dv, bd):
    """float32 widths the group route does not take (D or Dv not a
    multiple of 4, D past 256) run the per-head route, contiguous and
    paged, and match the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(d + dv)
    b, h, kv, s, ps = 3, 8, 2, 160, 16
    f32 = torch.float32
    nsel = ops.round_k_dims(d, 0.5, bd)
    assert dk.decode_route(f32, quant=False, part=False, d=d, dv=dv,
                           nsel=nsel) == "per_head"
    q = _rand(gen, b, h, d, dtype=f32)
    k = _rand(gen, b, kv, s, d, dtype=f32)
    v = _rand(gen, b, kv, s, dv, dtype=f32)
    lengths = torch.tensor([s, 1, 99], dtype=torch.int32, device=cuda)
    block_idx = ops.decode_blocks(q, 0.5, bd)
    out = ops.aqua_decode(q, k, v, lengths, k_ratio=0.5, block_dims=bd)
    ref = dk.aqua_decode_plain(q, k, v, block_idx, lengths, None,
                               block_dims=bd, scale=d ** -0.5)
    npl = s // ps
    table = torch.randperm(b * npl, generator=gen, device=cuda).reshape(
        b, npl).to(torch.int32)
    k_pool = torch.empty(b * npl, kv, ps, d, dtype=f32, device=cuda)
    v_pool = torch.empty(b * npl, kv, ps, dv, dtype=f32, device=cuda)
    k_pool[table.long()] = k.reshape(b, kv, npl, ps, d).transpose(1, 2)
    v_pool[table.long()] = v.reshape(b, kv, npl, ps, dv).transpose(1, 2)
    out_p = ops.aqua_paged_decode(q, k_pool, v_pool, table, lengths,
                                  k_ratio=0.5, block_dims=bd)
    torch.cuda.synchronize()
    assert out.shape == out_p.shape == (b, h, dv)
    assert _within_tol(out, ref, f32) and _within_tol(out_p, ref, f32)


def test_f32_decode_rejects_misaligned_views(cuda):
    """The float32 group route copies 16-byte pieces: q̂, K̂ or V
    contiguous but one float (4 bytes) off a 16-byte boundary raises
    ValueError, contiguous and paged."""
    b, h, kv, s, d, ps = 2, 4, 2, 64, 64, 16
    f32 = torch.float32
    q = torch.zeros(b, h, d, device=cuda, dtype=f32)
    k = torch.zeros(b, kv, s, d, device=cuda, dtype=f32)
    pool = torch.zeros(b * s // ps, kv, ps, d, device=cuda, dtype=f32)
    table = torch.arange(b * s // ps, device=cuda, dtype=torch.int32
                         ).reshape(b, -1)
    lens = torch.full((b,), s, dtype=torch.int32, device=cuda)
    idx = ops.decode_blocks(q, 0.75, 8)
    assert dk.decode_route(f32, quant=False, part=False, d=d, dv=d,
                           nsel=48) == "group_f32"

    def off(x):
        return torch.zeros(x.numel() + 1, device=cuda, dtype=f32)[1:].view(
            x.shape)
    for args in ((off(q), k, k), (q, off(k), k), (q, k, off(k))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            dk.aqua_decode_attention(*args, idx, lens, block_dims=8)
    for args in ((off(q), pool, pool), (q, off(pool), pool),
                 (q, pool, off(pool))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            dk.aqua_paged_decode_attention(*args, idx, table, lens,
                                           block_dims=8)


def test_f32_paged_decode_graph_replay_equals_eager(cuda):
    """The float32 paged decode captured in a CUDA graph (as the engine's
    step graph holds it): replays after new lengths, selections and cache
    contents are written in place equal eager calls bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, kv, d, ps, npl = 8, 16, 8, 128, 64, 32
    f32 = torch.float32
    q = _rand(gen, b, h, d, dtype=f32)
    k_pool = _rand(gen, b * npl, kv, ps, d, dtype=f32)
    v_pool = _rand(gen, b * npl, kv, ps, d, dtype=f32)
    table = torch.randperm(b * npl, generator=gen, device=cuda).reshape(
        b, npl).to(torch.int32)
    lengths = torch.randint(128, 1057, (b,), generator=gen, device=cuda,
                            dtype=torch.int32)
    block_idx = ops.decode_blocks(q, 0.75, 8).contiguous()

    def call():
        return dk.aqua_paged_decode_attention(q, k_pool, v_pool, block_idx,
                                              table, lengths, block_dims=8)
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for step in range(3):
        q.copy_(_rand(gen, b, h, d, dtype=f32))
        block_idx.copy_(ops.decode_blocks(q, 0.75, 8))
        lengths.add_(step * 37)
        k_pool[table[:, 0].long()] = _rand(gen, b, kv, ps, d, dtype=f32)
        before = LAUNCHES.copy()
        graph.replay()
        assert LAUNCHES == before          # a replay launches from no wrapper
        want = call()
        torch.cuda.synchronize()
        assert torch.equal(out, want), step
        ref = dk.aqua_decode_plain(q, k_pool, v_pool, block_idx, lengths,
                                   table, block_dims=8, scale=d ** -0.5)
        assert _within_tol(out, ref, f32), step


def _pools(gen, p, kv, ps, d, dtype, quant):
    if quant:
        k = torch.randint(-127, 128, (p, kv, ps, d), generator=gen,
                          device="cuda").to(torch.int8)
        v = torch.randint(-127, 128, (p, kv, ps, d), generator=gen,
                          device="cuda").to(torch.int8)
        return k, v
    return (_rand(gen, p, kv, ps, d, dtype=dtype),
            _rand(gen, p, kv, ps, d, dtype=dtype))


# (quant, part, per-(page, kv head) scales): int8 pools with one scale per
# page and per page and KV head, participating pages, and both (bf16 takes
# the group route for all of them, float32 the per-head route)
VARIANTS = [(True, False, False), (True, False, True), (False, True, False),
            (True, True, False), (True, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant,part,per_head_scale", VARIANTS)
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("h,kv,d,k_ratio,bd", DECODE_CASES)
def test_paged_variant_kernels_match_plain(cuda, dtype, quant, part,
                                           per_head_scale, ps, h, kv, d,
                                           k_ratio, bd):
    """int8 pools (per-page scales looked up per position: a split spans
    several pages, pages of 8 split a tile) and participating pages (a
    partial tail page, pages past the tail, and a lane of one token), and
    an idle lane (length 0: the mean of the V slots the Pallas kernel
    visits, dequantized, over its participating pages), over the group
    route's geometries. bf16 with int8 pools, participating
    pages or both takes the group route (int8 widths of a multiple of 16),
    float32 the per-head route (``decode_route``); each call counts one
    launch under its body's name."""
    gen = torch.Generator(device="cuda").manual_seed(h + d + bd + ps)
    b, npl = 5, 40
    p = b * npl + 3
    q = _rand(gen, b, h, d, dtype=dtype)
    k_pool, v_pool = _pools(gen, p, kv, ps, d, dtype, quant)
    scales = [None, None]
    if quant:
        scales = [torch.rand(p, kv if per_head_scale else 1, generator=gen,
                             device="cuda") * 0.02 + 0.001 for _ in range(2)]
    table = torch.randperm(p, generator=gen, device=cuda)[:b * npl].reshape(
        b, npl).to(torch.int32)
    table[1, 5:] = -1
    table[4, 3:] = -1                      # lane 4 (idle) maps three pages
    lengths = torch.tensor([npl * ps, 5 * ps - 3, 1, 21 * ps - 5, 0],
                           dtype=torch.int32, device=cuda)
    part_idx = None
    if part:
        kp = 12
        part_idx = torch.stack([
            torch.sort(torch.randperm(npl, generator=gen, device=cuda)[:kp]
                       )[0] for _ in range(b)]).to(torch.int32)
        part_idx[1] = torch.arange(kp, device=cuda)     # pages past the tail
        part_idx[2, 0] = 0                              # lane 2's one token
        part_idx[2] = torch.sort(part_idx[2])[0]
    assert dk.decode_route(dtype, quant=quant, part=part, d=d, dv=d,
                           nsel=ops.round_k_dims(d, k_ratio, bd)) == (
        "group" if dtype == torch.bfloat16 and not (quant and d % 16)
        else "per_head")
    before = LAUNCHES.copy()
    out = ops.aqua_paged_decode(q, k_pool, v_pool, table, lengths, *scales,
                                part_idx=part_idx, k_ratio=k_ratio,
                                block_dims=bd)
    ref = dk.aqua_decode_plain(q, k_pool, v_pool,
                               ops.decode_blocks(q, k_ratio, bd), lengths,
                               table, block_dims=bd, scale=d ** -0.5,
                               k_scale=scales[0], v_scale=scales[1],
                               part_idx=part_idx)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {dk.body_name(True, quant, part): 1}
    out_dtype = torch.float32 if quant else dtype
    assert out.dtype == out_dtype and out.shape == (b, h, d)
    assert _within_tol(out, ref, out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant,part", [(False, False), (True, False),
                                        (False, True), (True, True)])
@pytest.mark.parametrize("ps", [8, 64])
def test_paged_decode_through_aliased_page_tables_matches_plain(
        cuda, dtype, quant, part, ps):
    """Prefix sharing's tables: every lane maps the same first physical
    pages (a shared prompt prefix) and its own after them, with lengths
    inside and past the shared pages; the paged decode (full precision,
    int8, participating pages, both) against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(ps + 2 * quant + part)
    b, npl, shared, h, kv, d = 4, 12, 5, 16, 8, 128
    p = shared + b * (npl - shared) + 2
    q = _rand(gen, b, h, d, dtype=dtype)
    k_pool, v_pool = _pools(gen, p, kv, ps, d, dtype, quant)
    scales = [None, None]
    if quant:
        scales = [torch.rand(p, kv, generator=gen, device="cuda") * 0.02
                  + 0.001 for _ in range(2)]
    own = torch.randperm(p - shared, generator=gen, device=cuda)[
        :b * (npl - shared)].reshape(b, npl - shared) + shared
    table = torch.cat([torch.arange(shared, device=cuda).expand(b, -1), own],
                      dim=1).to(torch.int32)
    lengths = torch.tensor([npl * ps, shared * ps + 1, 3 * ps - 2,
                            9 * ps + 5], dtype=torch.int32, device=cuda)
    part_idx = None
    if part:
        part_idx = torch.stack([torch.sort(torch.randperm(
            npl, generator=gen, device=cuda)[:6])[0] for _ in range(b)]
        ).to(torch.int32)
    before = LAUNCHES.copy()
    out = ops.aqua_paged_decode(q, k_pool, v_pool, table, lengths, *scales,
                                part_idx=part_idx, k_ratio=0.75,
                                block_dims=8)
    ref = dk.aqua_decode_plain(q, k_pool, v_pool,
                               ops.decode_blocks(q, 0.75, 8), lengths, table,
                               block_dims=8, scale=d ** -0.5,
                               k_scale=scales[0], v_scale=scales[1],
                               part_idx=part_idx)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {dk.body_name(True, quant, part): 1}
    assert _within_tol(out, ref, torch.float32 if quant else dtype)


@pytest.mark.parametrize("quant,part", [(True, False), (False, True),
                                        (True, True)])
def test_paged_variants_off_the_group_route_widths(cuda, quant, part):
    """int8 and participating pages, apart and together, at widths the
    group route does not take (D 36: not a multiple of 8; int8 rows of 72
    bytes) run the per-head route and match the plain version (pages of 16
    and of 7 positions)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for d, ps, bd in ((36, 16, 4), (72, 7, 8)):
        b, npl, h, kv = 3, 20, 8, 2
        p = b * npl
        assert dk.decode_route(torch.bfloat16, quant=quant, part=part, d=d,
                               dv=d, nsel=d // 2) == (
            "per_head" if quant or d % 8 else "group")
        q = _rand(gen, b, h, d, dtype=torch.bfloat16)
        k_pool, v_pool = _pools(gen, p, kv, ps, d, torch.bfloat16, quant)
        scales = [None, None]
        if quant:
            scales = [torch.rand(p, kv, generator=gen, device="cuda") * 0.02
                      + 0.001 for _ in range(2)]
        table = torch.randperm(p, generator=gen, device=cuda).reshape(
            b, npl).to(torch.int32)
        lengths = torch.tensor([npl * ps, 3 * ps - 2, 1], dtype=torch.int32,
                               device=cuda)
        part_idx = None
        if part:
            part_idx = torch.stack([torch.arange(0, npl, 2, device=cuda)
                                    for _ in range(b)]).to(torch.int32)
        out = ops.aqua_paged_decode(q, k_pool, v_pool, table, lengths,
                                    *scales, part_idx=part_idx, k_ratio=0.5,
                                    block_dims=bd)
        ref = dk.aqua_decode_plain(q, k_pool, v_pool,
                                   ops.decode_blocks(q, 0.5, bd), lengths,
                                   table, block_dims=bd, scale=d ** -0.5,
                                   k_scale=scales[0], v_scale=scales[1],
                                   part_idx=part_idx)
        torch.cuda.synchronize()
        out_dtype = torch.float32 if quant else torch.bfloat16
        assert out.dtype == out_dtype
        assert _within_tol(out, ref, out_dtype), (d, ps)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros(1, 2, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.aqua_decode(q, q.new_zeros(1, 1, 8, 32), q.new_zeros(1, 1, 8, 32),
                        torch.tensor([8]))
    q = torch.zeros(1, 2, 32, 32, device=cuda)
    with pytest.raises(ValueError):
        ops.aqua_prefill(q, q[:, :1], q[:, :1], q_blk=12)


def test_engine_on_the_card_matches_plain_reference(cuda):
    aq = AquaConfig(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
    cfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=256,
                                      vocab=512), aqua=aq)
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    proj = identity_projections(cfg.num_layers, cfg.attention.num_kv_heads,
                                cfg.attention.head_dim)
    reqs = lambda: poisson_trace(6, mean_interarrival=2.0,
                                 prompt_lens=(9, 33, 70), max_new_tokens=8,
                                 vocab_size=512, seed=1)
    paged = CacheSpec(page_size=16, prefix_sharing=False)
    for kw in (dict(cache=None), dict(cache=paged),
               dict(cache=paged, quant=QuantSpec(kv_dtype="int8")),
               dict(cache=paged, sparsity=SparsitySpec(page_keep_ratio=0.5)),
               dict(cache=paged, quant=QuantSpec(kv_dtype="int8"),
                    sparsity=SparsitySpec(page_keep_ratio=0.5))):
        scfg = ServingConfig(max_lanes=3, max_seq=128, max_new_tokens=8,
                             **kw)
        outs = [ContinuousBatchingEngine(cfg, params, proj, serving=scfg,
                                         backend=be).run(reqs())
                for be in ("aqua-block-sparse", "aqua-block-sparse-plain")]
        assert {u: o.tokens for u, o in outs[0].items()} == \
            {u: o.tokens for u, o in outs[1].items()}, kw


def test_flash_engine_on_the_card_matches_dense_reference(cuda):
    """AQUA off, and per-dim AQUA (block_dims 1): prefill runs the flash
    kernel (per admission, once per layer); tokens equal the dense
    reference's."""
    for aq in (None, AquaConfig(prefill_q_blk=16)):
        cfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=256,
                                          vocab=512), aqua=aq)
        params = build_model(cfg).init(torch.Generator(device="cuda")
                                       .manual_seed(0))
        proj = None if aq is None else identity_projections(
            cfg.num_layers, cfg.attention.num_kv_heads,
            cfg.attention.head_dim)
        reqs = lambda: poisson_trace(4, mean_interarrival=2.0,
                                     prompt_lens=(9, 70), max_new_tokens=6,
                                     vocab_size=512, seed=2)
        scfg = ServingConfig(max_lanes=2, max_seq=128, max_new_tokens=6,
                             cache=CacheSpec(page_size=16,
                                             prefix_sharing=False))
        before = LAUNCHES.copy()
        got = ContinuousBatchingEngine(cfg, params, proj,
                                       serving=scfg).run(reqs())
        assert LAUNCHES - before == {"flash_attention": 4 * cfg.num_layers}
        ref = ContinuousBatchingEngine(
            cfg, params, proj, serving=scfg,
            backend="dense" if aq is None else "aqua-masked-dense").run(
                reqs())
        assert {u: o.tokens for u, o in got.items()} == \
            {u: o.tokens for u, o in ref.items()}


# An int8 chunk attends its prefix dequantized from the pool, where a
# monolithic admission attends the fresh keys (as in the JAX package), so
# its admission logits drift: at most 1.4% of a row's largest magnitude on
# an H100 (these weights) and 6.9% on the CPU (the CPU's weights). A page
# scale stored 1.25x too large, or taken from the neighbouring page, moves
# them by 34-45% of it.
INT8_CHUNK_DRIFT = 0.15


def _serve_with_admit_logits(eng, reqs):
    toks, logits = {}, {}
    for ev in eng.serve(reqs):
        if ev.index == 0:
            logits[ev.uid] = eng.last_admit_logits.float().clone()
        toks.setdefault(ev.uid, []).append(ev.token)
    return toks, logits


def test_chunked_engine_on_the_card_matches_plain_reference(cuda):
    """Chunked prefill (budget 32, every prompt over it) through the
    prefill kernel's ``q_offset`` form, contiguous, paged and int8: the
    same greedy tokens as the plain backend, and (full-precision pools)
    as monolithic admission; the prefill kernel launches once per layer
    per chunk. int8 admissions are held to the monolithic ones' logits
    within ``INT8_CHUNK_DRIFT`` of each row's largest magnitude."""
    aq = AquaConfig(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
    cfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=256,
                                      vocab=512), aqua=aq)
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    proj = identity_projections(cfg.num_layers, cfg.attention.num_kv_heads,
                                cfg.attention.head_dim)
    reqs = lambda: poisson_trace(5, mean_interarrival=1.0,
                                 prompt_lens=(40, 70, 100), max_new_tokens=8,
                                 vocab_size=512, seed=4)
    paged = CacheSpec(page_size=16, prefix_sharing=False)
    for kw in (dict(cache=None), dict(cache=paged),
               dict(cache=paged, quant=QuantSpec(kv_dtype="int8"))):
        scfg = ServingConfig(max_lanes=3, max_seq=128, max_new_tokens=8,
                             prefill_budget_tokens=32, **kw)
        before = LAUNCHES.copy()
        eng = ContinuousBatchingEngine(cfg, params, proj, serving=scfg)
        got, got_logits = _serve_with_admit_logits(eng, reqs())
        st = eng.stats
        assert st.chunked_admissions == 5 and st.prefill_chunks > 5
        launches = LAUNCHES - before
        assert launches["aqua_prefill"] == cfg.num_layers * st.prefill_chunks
        ref = ContinuousBatchingEngine(
            cfg, params, proj, serving=scfg,
            backend="aqua-block-sparse-plain").run(reqs())
        assert got == {u: o.tokens for u, o in ref.items()}, kw
        mono, mono_logits = _serve_with_admit_logits(
            ContinuousBatchingEngine(
                cfg, params, proj,
                serving=dataclasses.replace(scfg, prefill_budget_tokens=None)),
            reqs())
        if "quant" not in kw:
            assert got == mono, kw
        else:
            for u, want in mono_logits.items():
                drift = (got_logits[u] - want).abs().max() / want.abs().max()
                assert drift <= INT8_CHUNK_DRIFT, (u, float(drift))


# (block_dims, D, kept): Danube's head_dim 80, the 128 of Qwen3/Llama with
# blocks spanning two 16-byte chunks, and an AQUA-Memory K̂ of 90 real
# dims stored as 96 (blocks of 2: chunks partly selected)
WINDOW_GEOMS = [(8, 80, 80), (16, 128, 128), (2, 96, 90)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("part", [False, True])
@pytest.mark.parametrize("bd,d,kept", WINDOW_GEOMS)
@pytest.mark.parametrize("q_offset", [0, 128])
@pytest.mark.parametrize("window", [1, 64, 100, 1000])
def test_windowed_prefill_kernel_matches_plain(cuda, dtype, part, bd, d,
                                               kept, q_offset, window):
    """The window form (``kpos > qpos - window``; 1000 >= S is no cut),
    monolithic and at ``q_offset``, with and without participating key
    chunks, against the plain version; launches count under the body's
    key."""
    gen = torch.Generator(device="cuda").manual_seed(window + d + q_offset)
    b, h, kv, s, blk = 2, 8, 2, 384, 64
    t = s - q_offset
    q = _rand(gen, b, h, t, d, dtype=dtype)
    k = _rand(gen, b, kv, s, d, dtype=dtype)
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    q[..., kept:] = 0                      # stored-form padding
    k[..., kept:] = 0
    lengths = torch.tensor([s, s - 50], dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths - q_offset, 0.75, bd,
                                             blk, kept)
    table = None
    if part:
        nqc, nkc = block_idx.shape[2], s // blk
        table = selection.chunk_participating_tiles(
            torch.rand(b, nkc, generator=gen, device=cuda), nqc=nqc,
            q_blk=blk, k_blk=blk, kept_tiles=3, pin_tiles=1,
            q_offset=q_offset)
    kw = dict(block_dims=bd, q_blk=chunk, causal=True, scale=d ** -0.5,
              q_offset=q_offset, kc_part=table, k_blk=blk, window=window)
    before = LAUNCHES.copy()
    out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES - before == {
        "aqua_prefill_part" if part else "aqua_prefill": 1}
    valid = ((q_offset + torch.arange(t, device=cuda))[None]
             < lengths[:, None])[:, None, :, None]
    assert _within_tol(out, ref, dtype, valid)
    if window < s:    # the window cuts: a wider one gives other rows
        wide = pk.aqua_prefill_attention(q, k, v, block_idx, lengths,
                                         **dict(kw, window=window + 1))
        assert not _within_tol(wide, ref, dtype, valid)


def test_danube_geometry_prefill_kernel_matches_plain(cuda):
    """H2O-Danube-1.8B's heads (H 32, KV 8, head_dim 80: 10 chunks of
    V, 8 of 10 K̂ blocks selected) over a 4096-token window at S 5120."""
    gen = torch.Generator(device="cuda").manual_seed(80)
    b, h, kv, d, s, window = 1, 32, 8, 80, 5120, 4096
    q = _rand(gen, b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
    k = _rand(gen, b, kv, s, d, dtype=torch.bfloat16)
    v = _rand(gen, b, kv, s, d, dtype=torch.bfloat16)
    lengths = torch.full((b,), s, dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, 128)
    assert block_idx.shape[-1] == 8
    kw = dict(block_dims=8, q_blk=chunk, causal=True, scale=d ** -0.5,
              window=window)
    out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
    ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    assert _within_tol(out, ref, torch.bfloat16)


def test_aqua_memory_engine_on_the_card_matches_plain_reference(cuda):
    """``s_ratio`` 0.3 with ``block_dims`` 2 keeps 90 of 128 dims, stored
    as 96: the bf16 engine runs the kernels (prefill once per layer per
    admission, decode once per layer per step), and every admission's
    logits stay within 5% of their largest magnitude of the plain
    reference's (bf16: the two differ by about one ulp per layer),
    contiguous and paged."""
    aq = AquaConfig(k_ratio=0.75, s_ratio=0.3, block_dims=2,
                    prefill_q_blk=16)
    cfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=512, vocab=512),
                              aqua=aq, dtype="bfloat16",
                              param_dtype="bfloat16")
    assert cfg.attention.head_dim == 128 and aq.kept_dims(128) == 90
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    proj = identity_projections(cfg.num_layers, cfg.attention.num_kv_heads,
                                cfg.attention.head_dim)
    reqs = lambda: poisson_trace(6, mean_interarrival=2.0,
                                 prompt_lens=(9, 33, 70), max_new_tokens=8,
                                 vocab_size=512, seed=1)
    for cache in (None, CacheSpec(page_size=16, prefix_sharing=False)):
        scfg = ServingConfig(max_lanes=3, max_seq=128, max_new_tokens=8,
                             cache=cache)
        LAUNCHES.clear()
        eng = ContinuousBatchingEngine(cfg, params, proj, serving=scfg)
        _, got = _serve_with_admit_logits(eng, reqs())
        body = "aqua_decode" if cache is None else "aqua_paged_decode"
        assert LAUNCHES == {
            "aqua_prefill": cfg.num_layers * eng.stats.admissions,
            body: cfg.num_layers * eng.stats.decode_steps}, dict(LAUNCHES)
        _, want = _serve_with_admit_logits(ContinuousBatchingEngine(
            cfg, params, proj, serving=scfg,
            backend="aqua-block-sparse-plain"), reqs())
        assert got.keys() == want.keys()
        for uid, logits in want.items():
            err = (got[uid] - logits).abs().max().item()
            assert err <= 0.05 * logits.abs().max().item(), (cache, uid)


# the decode body each reduced drive launches once per layer per step
# (window and H2O decode on the masked-dense core, as do hot residents;
# AQUA off on dense)
STEP_BODY = {"paged": "aqua_paged_decode", "contiguous": "aqua_decode",
             "flash_paged": None, "int8_paged": "aqua_paged_quant_decode",
             "hier_paged": "aqua_paged_part_decode",
             "hier_int8_paged": "aqua_paged_part_quant_decode",
             "chunked_paged": "aqua_paged_decode", "swa_paged": None,
             "h2o_paged": None, "aqua_memory_paged": "aqua_paged_decode",
             "prefix_paged": "aqua_paged_decode", "int8_swa_paged": None,
             "int8_h2o_paged": None, "hot_int8_paged": None,
             "olmoe-1b-7b": "aqua_paged_decode",
             "qwen2-moe-a2.7b": "aqua_paged_decode",
             "pixtral-12b": "aqua_paged_decode", "whisper-tiny": "aqua_decode",
             "mamba2-370m": None, "recurrentgemma-9b": None}


@pytest.mark.parametrize("name", list(STEP_BODY))
def test_step_graph_replays_eager_decode_bitwise(cuda, name):
    """The engine's captured decode step (bf16, the reduced drives of
    ``tests/test_torch_step_graph.py``): after three lanes' admissions and
    two served steps, six replays with seeded tokens and write masks give
    the logits and state of eager ``decode_step`` on a twin of the state,
    bit for bit; each replay adds the capture's launches, one decode
    launch per layer."""
    import numpy as np
    from test_torch_step_graph import (assert_bitwise, bits, clone_state,
                                       drive_engine, serve_until,
                                       state_tensors)
    eng, reqs = drive_engine(name, device="cuda", dtype="bfloat16")
    serve_until(eng, reqs(at_once=True), steps=2)
    graph, body = eng.step_graph, STEP_BODY[name]
    assert graph.launches == ({} if body is None
                              else {body: eng.cfg.num_layers})
    state = eng.last_state
    twin = clone_state(state)
    rng = np.random.default_rng(0)
    lanes = eng.scfg.max_lanes
    for _ in range(6):
        tokens = rng.integers(0, eng.cfg.vocab_size, lanes).astype(np.int32)
        active = rng.random(lanes) < 0.75
        before = LAUNCHES.copy()
        got = graph.replay(tokens, active).clone()
        assert LAUNCHES - before == graph.launches
        want, _ = eng.model.decode_step(
            eng.params, twin, torch.from_numpy(tokens).cuda(),
            aqua_proj=eng.proj, write_mask=torch.from_numpy(active).cuda())
        assert torch.equal(bits(got), bits(want))
    assert_bitwise(state_tensors(state), state_tensors(twin))


@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8"])
def test_second_serve_through_the_captured_graph_matches_a_fresh_engine(
        cuda, layout):
    """One engine serves the same trace twice: its second ``serve()``
    replays the step graph captured at the first, over the state emptied in
    place, and must give the tokens of a fresh engine (float32, so the
    per-head decode route)."""
    aq = AquaConfig(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
    cfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=256,
                                      vocab=512), aqua=aq)
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(3))
    proj = identity_projections(cfg.num_layers, cfg.attention.num_kv_heads,
                                cfg.attention.head_dim)
    reqs = lambda: poisson_trace(6, mean_interarrival=1.5,
                                 prompt_lens=(9, 33, 70), max_new_tokens=8,
                                 vocab_size=512, seed=6)
    paged = CacheSpec(page_size=16, prefix_sharing=False)
    kw = {"contiguous": dict(cache=None), "paged": dict(cache=paged),
          "int8": dict(cache=paged, quant=QuantSpec(kv_dtype="int8"))}[layout]
    scfg = ServingConfig(max_lanes=3, max_seq=128, max_new_tokens=8, **kw)
    eng = ContinuousBatchingEngine(cfg, params, proj, serving=scfg)
    first = eng.run(reqs())
    graph = eng.step_graph
    second = eng.run(reqs())
    assert eng.step_graph is graph
    fresh = ContinuousBatchingEngine(cfg, params, proj, serving=scfg).run(
        reqs())
    want = {u: o.tokens for u, o in fresh.items()}
    assert {u: o.tokens for u, o in first.items()} == want
    assert {u: o.tokens for u, o in second.items()} == want


def test_safetensors_reader_round_trips_bf16_onto_the_card(cuda, tmp_path):
    """bf16 written from the card, read back by the port's codec and moved
    to the card bit for bit; an HF checkpoint stored in bf16 loads onto the
    card exactly as onto the CPU (the float32 widening is exact)."""
    from repro_torch.checkpoint import fixtures, hf
    from repro_torch.checkpoint import safetensors as st
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(3, 257, generator=gen, device="cuda").to(torch.bfloat16)
    odd = torch.randn(7, generator=gen, device="cuda").to(torch.bfloat16)
    path = str(tmp_path / "x.safetensors")
    st.save_file({"odd": odd, "x": x}, path)
    back = st.load_file(path)
    assert back["x"].dtype == torch.bfloat16
    assert torch.equal(back["x"].to("cuda").view(torch.int16),
                       x.view(torch.int16))
    assert torch.equal(back["odd"].to("cuda"), odd)
    out = str(tmp_path / "ckpt")
    fixtures.write_hf_fixture(out, variant="sharded", dtype="bfloat16",
                              device="cuda")
    cfg = hf.config_from_hf(out)
    on_card = hf.load_hf_checkpoint(out, cfg)
    on_cpu = hf.load_hf_checkpoint(out, cfg, device="cpu")

    def leaves(t, p=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], p + (k,))
        else:
            yield p, t
    for (pa, a), (pb, b) in zip(leaves(on_card), leaves(on_cpu)):
        assert pa == pb and a.device.type == "cuda"
        assert torch.equal(a.cpu(), b), pa


# the prefill body each reduced drive's admission launches once per layer
# (AQUA off: flash); the drives whose monolithic admissions replay graphs
ADMIT_BODY = {"paged": "aqua_prefill", "contiguous": "aqua_prefill",
              "flash_paged": "flash_attention", "int8_paged": "aqua_prefill",
              "hier_paged": "aqua_prefill",
              "hier_int8_paged": "aqua_prefill",
              "aqua_memory_paged": "aqua_prefill",
              "hot_int8_paged": "aqua_prefill",
              "olmoe-1b-7b": "aqua_prefill", "qwen2-moe-a2.7b": "aqua_prefill",
              "pixtral-12b": "aqua_prefill"}


@pytest.mark.parametrize("name", list(ADMIT_BODY))
def test_admit_graph_replays_eager_admission_bitwise(cuda, name):
    """The engine's captured admissions (bf16, the reduced drives of
    ``tests/test_torch_step_graph.py``): after a serve has captured one
    graph per bucket (four buckets of 8 tokens), eight admissions replayed
    in orders other than the capture order, into other lanes and pages, give
    the logits and state of the eager admission (``admission`` on a twin
    of the state), bit for bit; each replay adds the capture's launches,
    one prefill launch per layer. A second serve captures nothing new and
    gives the first serve's tokens. A VLM's requests carry patches: its
    graphs are the frontend ones, each admission with other patches."""
    import numpy as np
    from repro_torch.serving.admit_graph import admission
    from repro_torch.data.corpus import request_frontend_inputs
    from test_torch_step_graph import (assert_bitwise, bits, drive_engine,
                                       state_tensors)
    eng, reqs = drive_engine(name, device="cuda", dtype="bfloat16")
    first = eng.run(reqs())
    graphs = eng.frontend_admit_graphs or eng.admit_graphs
    assert not (eng.frontend_admit_graphs and eng.admit_graphs)
    captured = list(graphs)                  # buckets in capture order
    assert len(captured) == 4
    body = ADMIT_BODY[name]
    state = eng.last_state
    twin = dataclasses.replace(state, layers=type(state.layers)(**{
        k: t.clone() for k, t in state_tensors(state).items()}))
    rng = np.random.default_rng(0)
    npl = eng.pages_per_lane
    for i, bucket in enumerate(captured[::-1] + captured[1:] + captured[:1]):
        n = int(rng.integers(bucket - 7, bucket + 1))
        prompt = rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
        lane = i % eng.scfg.max_lanes
        row = None
        if eng.paged:
            need = -(-bucket // eng.cache_spec.page_size)
            row = np.full(npl, -1, np.int32)
            row[:need] = rng.permutation(eng.pool_geometry[0])[:need]
        graph = graphs[bucket]
        extra = request_frontend_inputs(eng.cfg, 100 + i)
        before = LAUNCHES.copy()
        got = graph.admit(prompt, lane, row, extra).clone()
        assert LAUNCHES - before == graph.launches \
            == {body: eng.cfg.num_layers}
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt
        want = admission(
            eng.model, eng.params, twin, eng.proj, eng.scfg.max_seq,
            torch.from_numpy(toks).cuda(),
            torch.tensor([n], dtype=torch.int32, device="cuda"),
            torch.tensor([lane], device="cuda"),
            None if row is None else torch.from_numpy(row).cuda(),
            extra={k: torch.from_numpy(v).cuda()
                   for k, v in (extra or {}).items()})
        assert torch.equal(bits(got), bits(want)), (i, bucket)
        assert_bitwise(state_tensors(state), state_tensors(twin))
    second = eng.run(reqs())
    assert len(graphs) == 4 and any(graphs is g for g in (
        eng.admit_graphs, eng.frontend_admit_graphs))
    assert {u: o.tokens for u, o in second.items()} == \
        {u: o.tokens for u, o in first.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel,d", [("prefill", 128), ("prefill", 80),
                                      ("flash", 128), ("flash", 80)])
def test_empty_lane_takes_the_mean_of_v(cuda, kernel, d, dtype):
    """A lane of length 0 (``ServeEngine.generate`` passes a caller's
    lengths through) in the narrow and generic kernels of both dtypes:
    every row of it the mean of V over all S keys, as the plain version
    and JAX's dense reference give; the other lane as before."""
    gen = torch.Generator(device="cuda").manual_seed(d)
    b, h, kv, s, off = 2, 8, 2, 320, 64
    lengths = torch.tensor([s, 0], dtype=torch.int32, device=cuda)
    v = _rand(gen, b, kv, s, d, dtype=dtype)
    if kernel == "flash":
        q = _rand(gen, b, h, s, d, dtype=dtype)
        k = _rand(gen, b, kv, s, d, dtype=dtype)
        out = fk.flash_attention(q, k, v, lengths=lengths)
        ref = fk.flash_attention_plain(q, k, v, lengths=lengths)
    else:
        q = _rand(gen, b, h, s - off, d, dtype=dtype)
        k = _rand(gen, b, kv, s, d, dtype=dtype)
        block_idx, _, chunk = ops.prefill_blocks(q, lengths - off, 0.75, 8,
                                                 64)
        kw = dict(block_dims=8, q_blk=chunk, q_offset=off, causal=True,
                  scale=d ** -0.5)
        out = pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)
        ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)
    torch.cuda.synchronize()
    assert _empty_lane_held(out, ref, dtype, True)
    mean = v[1].float().mean(1)                     # (KV, D)
    want = mean.repeat_interleave(h // kv, 0)[:, None].expand_as(out[1])
    assert _within_tol(out[1], want.to(dtype), dtype)


# -- training and the evaluation path ------------------------------------------

def _train_setup(cfg, device):
    """A train state from the CPU init (seed 0) and a copy-task batch, on
    ``device``."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.train import TrainState, to_device
    from repro_torch.optim import adamw
    params = tree_lib.tree_map(lambda t: t.to(device), build_model(
        cfg, "cpu").init(torch.Generator().manual_seed(0)))
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4, kind="copy"), 0)
    state = TrainState(params=params, opt=adamw.init(params),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=device))
    return state, to_device(batch, device)


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Three train steps of the reduced Qwen3 (float32, TF32 off) from the
    same params on the card and on the CPU: the losses within 1e-5
    relative; each leaf's update (params after less params before) within
    1e-3 of its norm (AdamW's normalized step turns the last bits of a
    gradient element near its eps of 1e-8 into a visible share of that
    element's step: one element moved 7e-5 of a 3e-3 total); no kernel
    is launched (``auto`` under grad is ``dense``)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import make_train_step
    cfg = reduced("qwen3-0.6b", d_model=128)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    before = LAUNCHES.copy()
    for dev in ("cpu", "cuda"):
        state, batch = _train_setup(cfg, dev)
        start = tree_lib.tree_map(lambda t: t.detach().cpu().clone(),
                                  state.params)
        step = make_train_step(build_model(cfg, dev), tcfg)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out[dev] = (losses, state)
    assert sum((LAUNCHES - before).values()) == 0
    (lc, sc), (lg, sg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(torch.tensor(lg), torch.tensor(lc),
                               rtol=1e-5, atol=0)
    for a, b, p0 in zip(tree_lib.leaves(sg.params),
                        tree_lib.leaves(sc.params), tree_lib.leaves(start)):
        want = b - p0
        assert (a.cpu() - p0 - want).norm() <= 1e-3 * want.norm()


@pytest.mark.parametrize("name", ["flash_attention", "aqua_prefill",
                                  "aqua_decode"])
def test_kernel_wrappers_raise_under_grad_on_the_card(cuda, name):
    """On CUDA tensors too: a wrapper given an input that requires grad
    raises before it launches; under ``no_grad`` it launches."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, kv, s, d, bf = 1, 16, 8, 128, 128, torch.bfloat16
    q4 = _rand(gen, b, h, s, d, dtype=bf)
    k = _rand(gen, b, kv, s, d, dtype=bf)
    v = _rand(gen, b, kv, s, d, dtype=bf)
    lengths = torch.tensor([s], dtype=torch.int32, device=cuda)
    block_idx, _, chunk = ops.prefill_blocks(q4, lengths, 0.75, 8, 128)
    calls = {
        "flash_attention": lambda q: fk.flash_attention(q, k, v),
        "aqua_prefill": lambda q: pk.aqua_prefill_attention(
            q, k, v, block_idx, lengths, block_dims=8, q_blk=chunk),
        "aqua_decode": lambda q: dk.aqua_decode_attention(
            q[:, :, 0].contiguous(), k, v,
            block_idx[:, :, 0].contiguous(), lengths, block_dims=8)}
    before = LAUNCHES.copy()
    with pytest.raises(NotImplementedError, match="no reverse mode"):
        calls[name](q4.clone().requires_grad_())
    assert sum((LAUNCHES - before).values()) == 0
    with torch.no_grad():
        calls[name](q4.clone().requires_grad_())
    assert sum((LAUNCHES - before).values()) == 1


def test_score_through_the_kernels_matches_plain(cuda):
    """``ServeEngine.score`` of the reduced Qwen3 (float32) through the
    prefill kernel (AQUA k 0.5, block_dims 8) and through flash (AQUA off)
    against the plain backends, within 1e-5 relative; the kernel launched
    once a layer."""
    from repro_torch.configs import AquaConfig as Aqua
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.serving import ServeEngine
    cfg = reduced("qwen3-0.6b", d_model=128)
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    proj = identity_projections(cfg.num_layers, cfg.attention.num_kv_heads,
                                cfg.attention.head_dim, "cuda")
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=4, kind="copy"), 7)
    for aqua, plain, body in ((None, "dense", "flash_attention"),
                              (Aqua(k_ratio=0.5, block_dims=8),
                               "aqua-block-sparse-plain", "aqua_prefill")):
        c = cfg.with_aqua(aqua)
        before = LAUNCHES.copy()
        got = ServeEngine(c, params, proj, max_seq=64).score(batch)
        launched = LAUNCHES - before
        want = ServeEngine(c, params, proj, max_seq=64,
                           backend=plain).score(batch)
        assert launched[body] == cfg.num_layers
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_trained_model_serves_on_the_card(cuda):
    """A model trained on the card (its params never require grad) serves
    through the continuous-batching engine's graphs and scores."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import AquaConfig as Aqua
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.serving import Request, ServeEngine
    cfg = reduced("qwen3-0.6b", d_model=128).with_aqua(
        Aqua(k_ratio=0.5, block_dims=8))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    state, losses = Trainer(cfg, TrainConfig(learning_rate=3e-3,
                                             warmup_steps=1, total_steps=4),
                            dcfg).run(4)
    assert losses[-1] < losses[0]
    assert not any(t.requires_grad for t in tree_lib.leaves(state.params))
    proj = identity_projections(cfg.num_layers, cfg.attention.num_kv_heads,
                                cfg.attention.head_dim, "cuda")
    eng = ContinuousBatchingEngine(cfg, state.params, proj, serving=
                                   ServingConfig(max_lanes=2, max_seq=64,
                                                 max_new_tokens=4))
    outs = eng.run([Request(uid=i, tokens=(torch.arange(5 + i) % 100).to(
        torch.int32).numpy(), max_new_tokens=4) for i in range(2)])
    assert all(len(o.tokens) == 4 for o in outs.values())
    score = ServeEngine(cfg, state.params, proj, max_seq=64).score(
        {"tokens": torch.arange(32).reshape(1, 32),
         "labels": torch.arange(1, 33).reshape(1, 32)})
    assert torch.isfinite(score)
