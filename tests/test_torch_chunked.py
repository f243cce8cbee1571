"""Chunked prefill of the port against the JAX package, below the engine:
the chunk-resumable prefill (``ops.aqua_prefill_chunk``: aligned splits,
the ragged carry and the ``mag_state`` fold), the participating-chunk
prefill (``aqua_prefill_attention(kc_part=...)``, JAX's ``_part_kernel``),
``selection.chunk_participating_tiles`` (ties included), the dispatch plan
(``resolve_dispatch_plan`` with ``mesh=None``), the chunk writers and
readers of the caches, the per-tile selection mask, the reference chunk
step and the scheduler's PREFILLING state machine.

The JAX kernels run in Pallas interpret mode, as tests/test_kernels.py
runs them. Tolerances: float32 outputs at atol = rtol = 1e-5 (the plain
versions take one softmax over materialized scores, the Pallas kernels an
online softmax over tiles: summation order only); selections, page and
chunk tables, cache ints, scales and positions exactly.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime_flags
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import AttentionConfig as JaxAttentionConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import QuantSpec as JaxQuantSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.configs.base import SparsitySpec as JaxSparsitySpec
from repro.core import attention as jax_attn
from repro.core import dispatch as jax_dispatch
from repro.core import kvcache as jax_kv
from repro.core import selection as jax_sel
from repro.core.aqua import chunk_topk_block_indices as jax_chunk_topk
from repro.kernels import ops as jax_ops
from repro.kernels.aqua_prefill import aqua_prefill_attention as jax_prefill
from repro.serving.scheduler import LaneScheduler as JaxLaneScheduler
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs import (AquaConfig, AttentionConfig, CacheSpec,
                                 QuantSpec, ServingConfig, SparsitySpec)
from repro_torch.core import attention as attn
from repro_torch.core import dispatch
from repro_torch.core import kvcache as kv
from repro_torch.core import selection as sel
from repro_torch.kernels import aqua_prefill as pk
from repro_torch.kernels import ops
from repro_torch.launch.mesh import run_mesh_threads
from repro_torch.serving.scheduler import LaneScheduler, Request

TOL = dict(atol=1e-5, rtol=1e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _valid(lengths, q_offset, t):
    """(B, 1, T, 1) rows of a chunk below their lane's length."""
    pos = q_offset + np.arange(t)
    return (pos[None, :] < np.asarray(lengths)[:, None])[:, None, :, None]


# ---------------------------------------------------------------------------
# The chunk-resumable prefill
# ---------------------------------------------------------------------------

CHUNK_KW = dict(k_ratio=0.5, block_dims=8, q_blk=16)


@pytest.mark.parametrize("split", [16, 32, 48])
def test_prefill_chunk_aligned_splits_match_jax(split):
    """q_blk-aligned chunks (the shapes of tests/test_chunked_prefill.py):
    each chunk equals JAX's ``aqua_prefill_chunk``, carries nothing, and
    the concatenated chunks equal the port's monolithic prefill."""
    rng = np.random.default_rng(0)
    b, h, kvh, s, d = 2, 4, 2, 64, 32
    q, k = _randn(rng, b, h, s, d), _randn(rng, b, kvh, s, d)
    v = _randn(rng, b, kvh, s, 16)
    lengths = np.array([s, 40], np.int32)
    parts = []
    for lo, hi in ((0, split), (split, s)):
        want, jcarry = jax_ops.aqua_prefill_chunk(
            q[:, :, lo:hi], k, v, lengths, q_offset=lo, k_blk=16, **CHUNK_KW)
        got, carry = ops.aqua_prefill_chunk(
            _t(q[:, :, lo:hi]), _t(k), _t(v), _t(lengths), q_offset=lo,
            **CHUNK_KW)
        valid = _valid(lengths, lo, hi - lo)
        np.testing.assert_allclose(got.numpy() * valid,
                                   np.asarray(want) * valid, **TOL)
        assert not carry.any() and not np.asarray(jcarry).any()
        parts.append(got)
    mono = ops.aqua_prefill(_t(q), _t(k), _t(v), _t(lengths), **CHUNK_KW)
    valid = _valid(lengths, 0, s)
    np.testing.assert_allclose(torch.cat(parts, dim=2).numpy() * valid,
                               mono.numpy() * valid, **TOL)


def test_prefill_chunk_ragged_carry_and_mag_state_match_jax():
    """A chunk ending mid-tile returns the partial tile's |q̂| aggregate
    (JAX's carry, and the oracle of tests/test_chunked_prefill.py); the
    next chunk folds it into its first tile (``mag_state``), and its
    output and carry match JAX's."""
    rng = np.random.default_rng(1)
    b, h, s, d, q_blk, bd, t1 = 1, 2, 48, 32, 16, 8, 24
    q, k = _randn(rng, b, h, s, d), _randn(rng, b, 1, s, d)
    v = _randn(rng, b, 1, s, 8)
    lengths = np.array([44], np.int32)
    kw = dict(k_ratio=0.5, block_dims=bd, q_blk=q_blk)
    want1, jcarry = jax_ops.aqua_prefill_chunk(q[:, :, :t1], k, v, lengths,
                                               q_offset=0, k_blk=16, **kw)
    got1, carry = ops.aqua_prefill_chunk(_t(q[:, :, :t1]), _t(k), _t(v),
                                         _t(lengths), q_offset=0, **kw)
    oracle = np.abs(q[:, :, 16:t1]).reshape(b, h, t1 - 16, d // bd,
                                            bd).sum(axis=(2, 4))
    np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry), rtol=1e-6)
    np.testing.assert_allclose(carry.numpy(), oracle, rtol=1e-6)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)
    want2, jcarry2 = jax_ops.aqua_prefill_chunk(
        q[:, :, t1:44], k, v, lengths, q_offset=t1, mag_state=jcarry,
        k_blk=16, **kw)
    got2, carry2 = ops.aqua_prefill_chunk(
        _t(q[:, :, t1:44]), _t(k), _t(v), _t(lengths), q_offset=t1,
        mag_state=carry, **kw)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)
    np.testing.assert_allclose(carry2.numpy(), np.asarray(jcarry2),
                               rtol=1e-6)
    assert carry2.any()              # 20 rows in tiles of 16: ragged again


# ---------------------------------------------------------------------------
# The participating-chunk prefill (_part_kernel)
# ---------------------------------------------------------------------------


def _jax_part_call(q, k, v, lengths, kc_part, *, q_offset, q_blk, k_blk,
                   k_ratio=0.5, bd=8):
    """JAX's ``aqua_prefill_attention`` with ``kc_part`` (the
    ``_part_kernel`` body), from model-layout inputs, and the selection
    it used."""
    b, h, t, d = q.shape
    nqc, nb = t // q_blk, d // bd
    k_dims = jax_ops.round_k_dims(d, k_ratio, bd)
    qj = jnp.asarray(q)
    local = jnp.clip(jnp.asarray(lengths) - q_offset, 0, t)
    block_idx = jax_chunk_topk(qj, k_dims, bd, q_blk, local)
    qb = qj.reshape(b, h, nqc, q_blk, nb, bd).transpose(0, 1, 2, 4, 3, 5)
    q_sel = jnp.take_along_axis(qb, block_idx[..., None, None], axis=3)
    out = jax_prefill(q_sel, jax_ops.to_dim_major_blocks(jnp.asarray(k), bd),
                      jnp.asarray(v), block_idx, jnp.asarray(lengths),
                      None if kc_part is None else jnp.asarray(kc_part),
                      block_dims=bd, q_blk=q_blk, k_blk=k_blk, causal=True,
                      q_offset=q_offset)
    return np.asarray(out), torch.from_numpy(np.array(block_idx))


def test_part_identity_table_equals_monolithic():
    """The identity participation table walks every key chunk: the
    port's output is bitwise its monolithic output, and equals JAX's
    ``_part_kernel`` on the same table."""
    rng = np.random.default_rng(5)
    b, h, kvh, s, d, blk = 1, 2, 2, 256, 32, 64
    q, k, v = (_randn(rng, b, n, s, d) for n in (h, kvh, kvh))
    lengths = np.full((b,), s, np.int32)
    nkc = s // blk
    ident = np.broadcast_to(np.arange(nkc, dtype=np.int32),
                            (b, s // blk, nkc)).copy()
    want, block_idx = _jax_part_call(q, k, v, lengths, ident, q_offset=0,
                                     q_blk=blk, k_blk=blk)
    kw = dict(block_dims=8, q_blk=blk, causal=True, scale=d ** -0.5)
    mono = pk.aqua_prefill_attention(_t(q), _t(k), _t(v), block_idx,
                                     _t(lengths), **kw)
    part = pk.aqua_prefill_attention(_t(q), _t(k), _t(v), block_idx,
                                     _t(lengths), kc_part=_t(ident),
                                     k_blk=blk, **kw)
    np.testing.assert_array_equal(part.numpy(), mono.numpy())
    np.testing.assert_allclose(part.numpy(), want, **TOL)


@pytest.mark.parametrize("q_offset,kept,pin", [(128, 2, 1), (64, 3, 2),
                                               (0, 2, 1)])
def test_part_random_table_matches_jax(q_offset, kept, pin):
    """A participation table from ``chunk_participating_tiles`` on random
    key-chunk scores, for a chunk of queries at ``q_offset``: the table
    equals JAX's and the plain version's output equals JAX's
    ``_part_kernel`` on valid rows (one lane shorter than the stripe)."""
    rng = np.random.default_rng(q_offset + kept)
    b, h, kvh, s, d, blk, t = 2, 4, 2, 256, 32, 64, 128
    q = _randn(rng, b, h, t, d)
    k, v = _randn(rng, b, kvh, s, d), _randn(rng, b, kvh, s, d)
    lengths = np.array([s, 200], np.int32)
    scores = rng.random((b, s // blk)).astype(np.float32)
    tkw = dict(nqc=t // blk, q_blk=blk, k_blk=blk, kept_tiles=kept,
               pin_tiles=pin, q_offset=q_offset)
    jtable = np.asarray(jax_sel.chunk_participating_tiles(
        jnp.asarray(scores), **tkw))
    table = sel.chunk_participating_tiles(_t(scores), **tkw)
    np.testing.assert_array_equal(table.numpy(), jtable)
    want, block_idx = _jax_part_call(q, k, v, lengths, jtable,
                                     q_offset=q_offset, q_blk=blk, k_blk=blk)
    got = pk.aqua_prefill_attention(
        _t(q), _t(k), _t(v), block_idx, _t(lengths), block_dims=8,
        q_blk=blk, causal=True, scale=d ** -0.5, q_offset=q_offset,
        kc_part=table, k_blk=blk)
    valid = _valid(lengths, q_offset, t)
    np.testing.assert_allclose(got.numpy() * valid, want * valid, **TOL)


def test_part_wrapper_refuses_k_blk_off_the_key_tile():
    z = torch.zeros(1, 1, 64, 16)
    with pytest.raises(ValueError, match="multiple of 64"):
        pk.aqua_prefill_attention(z, z, z, torch.zeros(1, 1, 1, 1,
                                                       dtype=torch.int32),
                                  torch.tensor([64], dtype=torch.int32),
                                  kc_part=torch.zeros(1, 1, 1,
                                                      dtype=torch.int32),
                                  k_blk=32, q_blk=64)
    with pytest.raises(ValueError, match="q_offset"):
        pk.aqua_prefill_attention(z, z, z, torch.zeros(1, 1, 1, 1,
                                                       dtype=torch.int32),
                                  torch.tensor([64], dtype=torch.int32),
                                  q_offset=8, q_blk=64)


@pytest.mark.parametrize("case", ["random", "zeros", "pin2", "past_diag",
                                  "offset"])
def test_chunk_participating_tiles_match_jax(case):
    """Random scores, all-zero scores (ties everywhere: sink + diagonal),
    two pinned tiles, more kept tiles than the diagonal allows (the -inf
    tiles past it are picked lowest first), and a chunk offset."""
    rng = np.random.default_rng(7)
    b, nkc = 3, 16
    scores = rng.integers(0, 3, (b, nkc)).astype(np.float32)
    kw = dict(nqc=8, q_blk=32, k_blk=32, kept_tiles=4, pin_tiles=1)
    if case == "random":
        scores = rng.random((b, nkc)).astype(np.float32)
    elif case == "zeros":
        scores = np.zeros((b, nkc), np.float32)
    elif case == "pin2":
        kw["pin_tiles"] = 2
    elif case == "past_diag":
        kw["kept_tiles"] = 6
    else:
        kw.update(q_offset=96, nqc=4, q_blk=64)
    want = np.asarray(jax_sel.chunk_participating_tiles(jnp.asarray(scores),
                                                        **kw))
    got = sel.chunk_participating_tiles(_t(scores), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "zeros":                 # q-tile 5: sink chunks + diagonal
        assert got[0, 5].tolist() == [0, 1, 2, 5]


# ---------------------------------------------------------------------------
# The dispatch plan
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_kernels_preferred(monkeypatch):
    """JAX resolves ``auto`` and AQUA-off backends as on its chip, where
    it prefers the Pallas kernels; the port always resolves so."""
    monkeypatch.setattr(runtime_flags, "PALLAS_OVERRIDE", True)


LAYOUTS = {"contiguous": {}, "paged": dict(paged=True),
           "int8": dict(paged=True, int8=True),
           "hier": dict(paged=True, hier=True),
           "hier_int8": dict(paged=True, int8=True, hier=True)}


def _plan_pair(budget, backend, bd, layout, h2o):
    spec = LAYOUTS[layout]

    def serving(pkg_cache, pkg_quant, pkg_sparsity, pkg_serving):
        return pkg_serving(
            max_lanes=4, max_seq=96, prompt_bucket=8,
            prefill_budget_tokens=budget,
            cache=(pkg_cache(page_size=8, prefix_sharing=False)
                   if spec.get("paged") else None),
            quant=pkg_quant(kv_dtype="int8") if spec.get("int8") else None,
            sparsity=(pkg_sparsity(page_keep_ratio=0.5)
                      if spec.get("hier") else None))
    aqua_kw = dict(k_ratio=0.5, block_dims=bd, prefill_q_blk=16,
                   h2o_ratio=h2o)
    on = backend != "aqua-off"
    be = "aqua-block-sparse" if backend == "aqua-off" else backend
    jplan = jax_dispatch.resolve_dispatch_plan(
        attention=JaxAttentionConfig(num_heads=4, num_kv_heads=2,
                                     head_dim=32, backend=be),
        aqua=JaxAquaConfig(**aqua_kw) if on else None,
        serving=serving(JaxCacheSpec, JaxQuantSpec, JaxSparsitySpec,
                        JaxServingConfig), mesh=None)
    plan = dispatch.resolve_dispatch_plan(
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32,
                                  backend=be),
        aqua=AquaConfig(**aqua_kw) if on else None,
        serving=serving(CacheSpec, QuantSpec, SparsitySpec, ServingConfig),
        mesh=None)
    return plan, jplan


@pytest.mark.parametrize("backend", ["aqua-block-sparse", "aqua-masked-dense",
                                     "aqua-off"])
@pytest.mark.parametrize("budget", [None, 16, 24])
def test_dispatch_plan_matches_jax(jax_kernels_preferred, budget, backend):
    """Every field of the plan, reason strings included, over block_dims
    1 and 8, contiguous / paged / int8 / hierarchical pools and an H2O
    ratio below 1."""
    for bd, layout, h2o in itertools.product((1, 8), LAYOUTS, (1.0, 0.5)):
        plan, jplan = _plan_pair(budget, backend, bd, layout, h2o)
        assert dataclasses.asdict(plan) == dataclasses.asdict(jplan), \
            (bd, layout, h2o)


def test_dispatch_plan_reports_the_chunk_geometry_guard():
    plan, _ = _plan_pair(24, "aqua-block-sparse", 8, "contiguous", 1.0)
    assert not plan.chunked_prefill
    assert plan.chunked_reasons == (dispatch.REASON_CHUNK_GEOMETRY,)
    plan, _ = _plan_pair(16, "aqua-block-sparse", 8, "paged", 1.0)
    assert plan.chunked_prefill and plan.chunked_reasons == ()
    # a plan on a real port mesh (refused before meshes were ported): the
    # block-sparse kernels serve mesh-native with the chunk geometry kept,
    # and AQUA off the reference decode keeps JAX's reason
    def rank(mesh):
        return [dispatch.resolve_dispatch_plan(
            attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                      head_dim=32, backend=be),
            aqua=aq, serving=ServingConfig(max_lanes=4, prompt_bucket=8,
                                           prefill_budget_tokens=16),
            mesh=mesh) for be, aq in (
                ("aqua-block-sparse", AquaConfig(k_ratio=0.5, block_dims=8,
                                                 prefill_q_blk=16)),
                ("flash", None))]
    for kernel, flash in run_mesh_threads((2, 2), rank, timeout=60):
        assert kernel.mesh_native and kernel.reasons == ()
        assert kernel.chunked_prefill
        assert not flash.mesh_native
        assert flash.reasons == (dispatch.REASON_REFERENCE_BACKEND,)


# ---------------------------------------------------------------------------
# Chunk writers and readers of the caches
# ---------------------------------------------------------------------------


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(tc, jc, names):
    for name in names:
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      _np(getattr(jc, name)), err_msg=name)


def test_lane_write_tail_matches_jax():
    """Chunks into a recycled lane (a previous tenant's positions): the
    first chunk wipes the lane, later ones clear ahead of themselves; a
    chunk running past the cache is cut."""
    rng = np.random.default_rng(2)
    b, kvh, s, d = 2, 2, 24, 8
    stale = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jc = dataclasses.replace(jax_kv.init_attn_cache(b, kvh, s, d, d,
                                                    jnp.float32),
                             positions=jnp.asarray(stale))
    tc = kv.init_attn_cache(b, kvh, s, d, d, torch.float32, "cpu")
    tc.positions.copy_(_t(stale))
    for start, t, count in ((0, 8, 8), (8, 8, 16), (16, 16, 20)):
        kt, vt = _randn(rng, t, kvh, d), _randn(rng, t, kvh, d)
        pos = np.arange(start, start + t, dtype=np.int32)
        jc = jax_kv.lane_write_tail(jc, 1, jnp.asarray(kt), jnp.asarray(vt),
                                    jnp.asarray(pos), start, count)
        kv.lane_write_tail(tc, 1, _t(kt), _t(vt), _t(pos), start, count)
        _same(tc, jc, ("k", "v", "positions", "count"))


@pytest.mark.parametrize("kv_dtype,gran", [("bf16", "page_head"),
                                           ("int8", "page_head"),
                                           ("int8", "page")])
def test_paged_write_tail_and_lane_pages_match_jax(kv_dtype, gran):
    """Chunks into recycled pages (stale positions, scores and scales):
    pools, per-page scales, positions and counts equal JAX's after every
    chunk, and so does the (dequantized) lane view the next chunk reads."""
    rng = np.random.default_rng(3)
    b, kvh, d, ps, npl, p = 2, 2, 8, 4, 6, 14
    table = np.array([[9, 2, 11, 5, 0, -1], [1, 3, 4, -1, -1, -1]], np.int32)
    quant = kv_dtype == "int8"
    jc = jax_kv.init_paged_cache(b, kvh, p, npl, ps, d, d, jnp.float32,
                                 kv_dtype=kv_dtype, scale_granularity=gran)
    tc = kv.init_paged_cache(b, kvh, p, npl, ps, d, d, torch.float32, "cpu",
                             kv_dtype=kv_dtype, scale_granularity=gran)
    stale = dict(pos_pool=np.full((p, ps), 3, np.int32),
                 acc_pool=np.ones((p, kvh, ps), np.float32))
    if quant:
        sh = kvh if gran == "page_head" else 1
        stale["k_scale"] = np.full((p, sh), 0.5, np.float32)
        stale["v_scale"] = np.full((p, sh), 0.25, np.float32)
    jc = dataclasses.replace(jc, page_table=jnp.asarray(table),
                             **{k: jnp.asarray(v) for k, v in stale.items()})
    tc.page_table.copy_(_t(table))
    for name, val in stale.items():
        getattr(tc, name).copy_(_t(val))
    fields = ["k_pool", "v_pool", "pos_pool", "acc_pool", "count"] + (
        ["k_scale", "v_scale"] if quant else [])
    for start_page, t, count in ((0, 8, 8), (2, 8, 14), (4, 8, 17)):
        kt = (_randn(rng, t, kvh, d) * (1 + start_page))
        vt = _randn(rng, t, kvh, d)
        pos = np.arange(start_page * ps, start_page * ps + t, dtype=np.int32)
        jc = jax_kv.paged_write_tail(jc, 0, jnp.asarray(kt), jnp.asarray(vt),
                                     jnp.asarray(pos), start_page, count)
        kv.paged_write_tail(tc, 0, _t(kt), _t(vt), _t(pos), start_page, count,
                            tc.page_table[0])
        _same(tc, jc, fields)
        for dtype, jdtype in ((None, None), (torch.bfloat16, jnp.bfloat16)):
            got = kv.paged_lane_pages(tc, tc.page_table[0], dtype=dtype)
            want = jax_kv.paged_lane_pages(jc, 0, dtype=jdtype)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g.float() if dtype else g),
                                              np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# The per-tile selection mask and the reference chunk step
# ---------------------------------------------------------------------------


def test_chunk_tile_mask_matches_jax():
    rng = np.random.default_rng(4)
    qh = _randn(rng, 2, 40, 2, 2, 32)
    aq = AquaConfig(k_ratio=0.5, block_dims=8)
    lengths = np.array([40, 27], np.int32)
    for q_blk in (8, 16):
        want = jax_attn._chunk_tile_mask(
            jnp.asarray(qh), JaxAquaConfig(k_ratio=0.5, block_dims=8), q_blk,
            jnp.asarray(lengths))
        got = attn._chunk_tile_mask(_t(qh), aq, q_blk, _t(lengths))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("aqua,select", [(False, None), (True, None),
                                         (True, 8)])
def test_prefixed_tail_attention_matches_jax(aqua, select):
    """One chunk of a layer against a prefix stripe whose slots past the
    prefix hold a previous tenant's positions: the output and the
    cache-form k/v equal JAX's."""
    rng = np.random.default_rng(6)
    m, kvh, g, hd, s, t, plen = 32, 2, 2, 16, 40, 16, 16
    params = {"wq": _randn(rng, m, kvh, g, hd) * 0.2,
              "wk": _randn(rng, m, kvh, hd) * 0.2,
              "wv": _randn(rng, m, kvh, hd) * 0.2,
              "wo": _randn(rng, kvh, g, hd, m) * 0.2}
    proj = np.linalg.qr(rng.standard_normal((kvh, hd, hd)))[0].astype(
        np.float32)
    x = _randn(rng, 1, t, m)
    pk_, pv_ = _randn(rng, 1, kvh, s, hd), _randn(rng, 1, kvh, s, hd)
    ppos = np.where(np.arange(s) < plen, np.arange(s), -1)[None].astype(
        np.int32)
    pos = (plen + np.arange(t, dtype=np.int32))[None]
    lengths = np.array([11], np.int32)
    kw = dict(k_ratio=0.5, block_dims=8)
    jcfg = JaxAttentionConfig(num_heads=kvh * g, num_kv_heads=kvh,
                              head_dim=hd)
    tcfg = AttentionConfig(num_heads=kvh * g, num_kv_heads=kvh, head_dim=hd)
    want = jax_attn.prefixed_tail_attention(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg,
        JaxAquaConfig(**kw) if aqua else None,
        jnp.asarray(proj) if aqua else None, prefix_k=jnp.asarray(pk_),
        prefix_v=jnp.asarray(pv_), prefix_positions=jnp.asarray(ppos),
        prefix_len=plen, positions=jnp.asarray(pos),
        lengths=jnp.asarray(lengths), select_q_blk=select)
    got = attn.prefixed_tail_attention(
        {k: _t(v) for k, v in params.items()}, _t(x), tcfg,
        AquaConfig(**kw) if aqua else None, _t(proj) if aqua else None,
        prefix_k=_t(pk_), prefix_v=_t(pv_), prefix_positions=_t(ppos),
        prefix_len=plen, positions=_t(pos), lengths=_t(lengths),
        select_q_blk=select)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy()[:, :11], np.asarray(w)[:, :11],
                                   **TOL)


def test_chunk_attention_kernel_route_equals_reference_step():
    """On the block-sparse backends with ``select_q_blk`` the chunk runs
    the prefill kernel's plain version with ``q_offset`` over the prefix
    stripe; its valid rows equal the reference chunk step with the same
    per-tile selection."""
    rng = np.random.default_rng(8)
    m, kvh, g, hd, s, t, plen = 32, 2, 2, 16, 48, 24, 16
    params = {"wq": _t(_randn(rng, m, kvh, g, hd) * 0.2),
              "wk": _t(_randn(rng, m, kvh, hd) * 0.2),
              "wv": _t(_randn(rng, m, kvh, hd) * 0.2),
              "wo": _t(_randn(rng, kvh, g, hd, m) * 0.2)}
    proj = _t(np.linalg.qr(rng.standard_normal((kvh, hd, hd)))[0].astype(
        np.float32))
    aq = AquaConfig(k_ratio=0.5, block_dims=8, prefill_q_blk=8)
    kw = dict(prefix_k=_t(_randn(rng, 1, kvh, s, hd)),
              prefix_v=_t(_randn(rng, 1, kvh, s, hd)),
              prefix_positions=_t(np.where(np.arange(s) < plen,
                                           np.arange(s), -1)[None]
                                  .astype(np.int32)),
              prefix_len=plen,
              positions=_t((plen + np.arange(t, dtype=np.int32))[None]),
              lengths=torch.tensor([19], dtype=torch.int32), select_q_blk=8)
    x = _t(_randn(rng, 1, t, m))
    outs = []
    for backend in ("aqua-block-sparse", "aqua-block-sparse-plain", "dense"):
        cfg = AttentionConfig(num_heads=kvh * g, num_kv_heads=kvh,
                              head_dim=hd, backend=backend)
        outs.append(attn.chunk_attention(params, x, cfg, aq, proj, **kw))
    for got in outs[:2]:
        for a, b in zip(got, outs[2]):
            np.testing.assert_allclose(a[:, :19].numpy(), b[:, :19].numpy(),
                                       **TOL)


# ---------------------------------------------------------------------------
# The PREFILLING state machine
# ---------------------------------------------------------------------------


def test_lane_scheduler_prefill_states_match_jax():
    """The same admissions, chunk advances, transitions and retirements
    drive the port's scheduler and JAX's to the same lanes, cursors and
    lane lists at every step."""
    rng = np.random.default_rng(9)
    ours, theirs = LaneScheduler(4), JaxLaneScheduler(4)
    for i in range(6):
        n = int(rng.integers(5, 40))
        toks = np.zeros(n, np.int32)
        ours.submit(Request(uid=i, tokens=toks, arrival=0.0))
        theirs.submit(JaxRequest(uid=i, tokens=toks, arrival=0.0))
    for step in range(60):
        a = ours.pop_admissible(float(step))
        b_ = theirs.pop_admissible(float(step))
        assert (a is None) == (b_ is None)
        if a is not None:
            pre = a.uid % 2 == 0
            assert ours.assign(a, prefilling=pre) == theirs.assign(
                b_, prefilling=pre)
        for lane in ours.prefilling_lanes():
            rem = ours.prefill_remaining(lane)
            n = min(rem, int(rng.integers(1, 12)))
            ours.advance_prefill(lane, n)
            theirs.advance_prefill(lane, n)
            if n == rem:
                ours.mark_decoding(lane)
                theirs.mark_decoding(lane)
        for lane in ours.decoding_lanes():
            if rng.random() < 0.3:
                ours.retire(lane)
                theirs.retire(lane)
        assert ours.prefilling_lanes() == theirs.prefilling_lanes()
        assert ours.decoding_lanes() == theirs.decoding_lanes()
        assert (ours.num_prefilling, ours.num_decoding) == \
            (theirs.num_prefilling, theirs.num_decoding)
        assert [ours.prefill_cursor(x) for x in ours.prefilling_lanes()] == \
            [theirs.prefill_cursor(x) for x in theirs.prefilling_lanes()]


def test_lane_scheduler_refuses_to_retire_mid_prefill():
    sched = LaneScheduler(2)
    lane = sched.assign(Request(uid=0, tokens=np.zeros(9, np.int32)),
                        prefilling=True)
    sched.begin_prefill(lane, 0, 9)
    sched.advance_prefill(lane, 8)
    with pytest.raises(AssertionError):
        sched.retire(lane)
    with pytest.raises(AssertionError):
        sched.mark_decoding(lane)
    sched.advance_prefill(lane, 1)
    sched.mark_decoding(lane)
    assert sched.retire(lane).uid == 0 and sched.num_active == 0
