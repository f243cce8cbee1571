"""int8 paged KV pools of the port against the JAX package: the pools'
ints and per-page scales through inserts (with running-scale growth),
grafts and resets, for both scale granularities; the paged decode's plain
version with scales and/or a participation table against the Pallas
kernel (interpret mode); the int8 engine's greedy tokens against the JAX
engine's; the byte gate of the JAX ``--verify`` drive; and what the
engine refuses.

Tolerances: the cache contents are compared exactly (both round half to
even in float32); decode outputs in float32 at atol = rtol = 1e-5
(summation order only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import QuantSpec as JaxQuantSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core import kvcache as jax_kv
from repro.core.calibration import AquaProjections as JaxProjections
from repro.kernels import ops as jax_ops
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, SparsitySpec, reduced)
from repro_torch.core import kvcache as kv
from repro_torch.core.calibration import AquaProjections
from repro_torch.kernels import ops
from repro_torch.serving import ContinuousBatchingEngine, poisson_trace

TOL = dict(atol=1e-5, rtol=1e-5)
AQUA_KW = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
TRACE = dict(mean_interarrival=2.0, prompt_lens=(5, 12, 20),
             max_new_tokens=8, vocab_size=128, seed=3)
SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=8, prompt_bucket=8)
GRANULARITY = ["page_head", "page"]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same(tc, jc, names):
    for name in names:
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      _np(getattr(jc, name)), err_msg=name)


QUANT_FIELDS = ("k_pool", "v_pool", "k_scale", "v_scale", "pos_pool",
                "acc_pool", "page_table", "count")


@pytest.mark.parametrize("gran", GRANULARITY)
def test_int8_inserts_match_jax_with_scale_growth(gran):
    """Write-masked inserts whose magnitudes grow step by step, so pages
    requantize under a growing running scale; every int and scale equals
    JAX's, and so does the dequantized lane view."""
    b, kvh, d, ps, npl = 3, 2, 8, 4, 4
    rng = np.random.default_rng(5)
    table = np.array([[5, 0, 9, -1], [1, 2, 3, 4], [7, -1, -1, -1]], np.int32)
    jp = jax_kv.init_paged_cache(b, kvh, 10, npl, ps, d, d, jnp.float32,
                                 kv_dtype="int8", scale_granularity=gran)
    jp = dataclasses.replace(jp, page_table=jnp.asarray(table))
    tp = kv.init_paged_cache(b, kvh, 10, npl, ps, d, d, torch.float32, "cpu",
                             kv_dtype="int8", scale_granularity=gran)
    tp.page_table.copy_(torch.from_numpy(table))
    assert tp.k_scale.shape == tuple(jp.k_scale.shape)
    for step in range(14):
        grow = 1.0 + 0.5 * step
        k_new = (rng.standard_normal((b, kvh, d)) * grow).astype(np.float32)
        v_new = (rng.standard_normal((b, kvh, d)) * grow).astype(np.float32)
        m = rng.random(b) < 0.8
        jslot, _ = jax_kv.paged_select_slot(jp, window=None, h2o=False,
                                            recent_len=0)
        jp = jax_kv.paged_insert(jp, jslot, jnp.asarray(k_new),
                                 jnp.asarray(v_new),
                                 write_mask=jnp.asarray(m))
        kv.paged_insert(tp, kv.paged_select_slot(tp)[0],
                        torch.from_numpy(k_new),
                        torch.from_numpy(v_new),
                        write_mask=torch.from_numpy(m))
    assert tp.k_pool.dtype == torch.int8 and np.abs(_np(tp.k_pool)).max() > 0
    _assert_same(tp, jp, QUANT_FIELDS)
    view, jview = kv.paged_lane_view(tp), jax_kv.paged_lane_view(jp)
    _assert_same(view, jview, ("k", "v", "positions"))


@pytest.mark.parametrize("gran", GRANULARITY)
def test_int8_graft_and_reset_match_jax(gran):
    """A graft into recycled pages (stale positions, scales and scores of
    a previous tenant) sets per-page scales over the prompt and clears
    every page the lane maps; a reset clears them again."""
    b, kvh, d, ps, npl, p = 2, 2, 8, 4, 4, 8
    rng = np.random.default_rng(6)
    req_k = (rng.standard_normal((1, kvh, ps * npl, d)) * 3).astype(np.float32)
    req_v = rng.standard_normal((1, kvh, ps * npl, d)).astype(np.float32)
    pos = np.where(np.arange(ps * npl) < 10, np.arange(ps * npl),
                   -1)[None].astype(np.int32)
    table = np.array([[3, 6, 1, 4], [0, 2, -1, -1]], np.int32)
    stale = dict(pos_pool=np.full((p, ps), 5, np.int32),
                 acc_pool=np.ones((p, kvh, ps), np.float32),
                 k_scale=np.full((p, kvh if gran == "page_head" else 1), 0.7,
                                 np.float32))
    stale["v_scale"] = stale["k_scale"] * 2
    jp = jax_kv.init_paged_cache(b, kvh, p, npl, ps, d, d, jnp.float32,
                                 kv_dtype="int8", scale_granularity=gran)
    jp = dataclasses.replace(jp, page_table=jnp.asarray(table),
                             **{k: jnp.asarray(v) for k, v in stale.items()})
    tp = kv.init_paged_cache(b, kvh, p, npl, ps, d, d, torch.float32, "cpu",
                             kv_dtype="int8", scale_granularity=gran)
    tp.page_table.copy_(torch.from_numpy(table))
    for k, v in stale.items():
        getattr(tp, k).copy_(torch.from_numpy(v))
    jreq = jax_kv.AttnCache(k=jnp.asarray(req_k), v=jnp.asarray(req_v),
                            positions=jnp.asarray(pos),
                            count=jnp.asarray([9], jnp.int32),
                            acc_score=jnp.zeros((1, kvh, ps * npl)))
    treq = kv.AttnCache(k=torch.from_numpy(req_k), v=torch.from_numpy(req_v),
                        positions=torch.from_numpy(pos),
                        count=torch.tensor([9], dtype=torch.int32))
    jp = jax_kv.paged_graft(jp, jreq, 0, 12)
    kv.paged_graft(tp, treq, 0, 12, tp.page_table[0])
    _assert_same(tp, jp, QUANT_FIELDS)
    # decode on, then retire lane 0 and lane 1
    for lane in (0, 1):
        jp = jax_kv.paged_reset_lane(jp, lane)
        kv.paged_reset_lane(tp, lane)
        _assert_same(tp, jp, QUANT_FIELDS)


def _quant_pools(rng, p, kvh, ps, d, sh):
    k = rng.integers(-127, 128, (p, kvh, ps, d)).astype(np.int8)
    v = rng.integers(-127, 128, (p, kvh, ps, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (p, sh)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (p, sh)).astype(np.float32)
    return k, v, ks, vs


@pytest.mark.parametrize("mode", ["quant", "part", "part+quant"])
@pytest.mark.parametrize("sh", [2, 1])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_decode_variants_match_jax(mode, sh, ps):
    """The plain version with int8 scales and/or a participation table
    against JAX ``aqua_paged_decode(k_scale, v_scale, part_idx)``."""
    rng = np.random.default_rng(ps + 3 * sh)
    b, h, kvh, d, npl, p = 3, 4, 2, 32, 4, 9
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    if "quant" in mode:
        k_pool, v_pool, ks, vs = _quant_pools(rng, p, kvh, ps, d, sh)
    else:
        k_pool = rng.standard_normal((p, kvh, ps, d)).astype(np.float32)
        v_pool = rng.standard_normal((p, kvh, ps, d)).astype(np.float32)
        ks = vs = None
    table = np.array([[0, 2, 5, -1], [2, 7, -1, -1], [8, 1, 3, 4]], np.int32)
    lengths = np.array([3 * ps - 2, ps + 3, 4 * ps], np.int32)
    # sorted logical pages; lane 1's second entry lies past its tail
    part = (np.array([[0, 2], [0, 3], [1, 3]], np.int32) if "part" in mode
            else None)
    want = np.asarray(jax_ops.aqua_paged_decode(
        *map(jnp.asarray, (q, k_pool, v_pool, table, lengths)),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        None if part is None else jnp.asarray(part),
        k_ratio=0.75, block_dims=8, seq_blk=8, scale=0.25))
    got = ops.aqua_paged_decode(
        *map(torch.from_numpy, (q, k_pool, v_pool, table, lengths)),
        *(None if x is None else torch.from_numpy(x) for x in (ks, vs, part)),
        k_ratio=0.75, block_dims=8, scale=0.25)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# The int8 engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b", d_model=128),
                               aqua=JaxAquaConfig(prefill_k_blk=16,
                                                  decode_seq_blk=16,
                                                  **AQUA_KW))
    tcfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=128),
                               aqua=AquaConfig(**AQUA_KW))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    return (jcfg, params, JaxProjections(p=jnp.asarray(proj)), tcfg,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            AquaProjections(p=torch.from_numpy(proj)))


def _port_engine(models, **serving):
    _, _, _, tcfg, tparams, tproj = models
    return ContinuousBatchingEngine(
        tcfg, tparams, tproj, serving=ServingConfig(**SERVE, **serving),
        device="cpu")


@pytest.mark.parametrize("gran", GRANULARITY)
def test_int8_engine_greedy_tokens_match_jax(models, gran):
    jcfg, params, jproj = models[:3]
    want = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(
        cache=JaxCacheSpec(page_size=8, prefix_sharing=False),
        quant=JaxQuantSpec(kv_dtype="int8", scale_granularity=gran),
        **SERVE), backend="aqua-block-sparse").run(
            jax_poisson_trace(6, **TRACE))
    eng = _port_engine(models,
                       cache=CacheSpec(page_size=8, prefix_sharing=False),
                       quant=QuantSpec(kv_dtype="int8",
                                       scale_granularity=gran))
    got = eng.run(poisson_trace(6, **TRACE))
    assert eng.last_state.layers.quantized
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid


def test_int8_cache_bytes_below_the_verify_gate(models):
    """The JAX ``--verify`` gate: int8 pool bytes < 0.60 x the
    full-precision pool's at the same geometry."""
    cache = CacheSpec(page_size=8, prefix_sharing=False)
    full = _port_engine(models, cache=cache).cache_bytes()
    int8 = _port_engine(models, cache=cache,
                        quant=QuantSpec(kv_dtype="int8")).cache_bytes()
    assert int8 < 0.60 * full, (int8, full)


def test_engine_refuses_int8_and_hierarchy_without_pages_and_hot_residents(
        models):
    with pytest.raises(ValueError, match="paged"):
        _port_engine(models, quant=QuantSpec(kv_dtype="int8"))
    with pytest.raises(ValueError, match="paged"):
        _port_engine(models, sparsity=SparsitySpec(page_keep_ratio=0.5))
    # hot residents are served (they were refused before they were
    # ported): greedy tokens equal the JAX engine's
    jcfg, params, jproj = models[:3]
    want = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(
        cache=JaxCacheSpec(page_size=8, prefix_sharing=False),
        quant=JaxQuantSpec(kv_dtype="int8", hot_resident_fraction=0.25),
        **SERVE), backend="aqua-block-sparse").run(
            jax_poisson_trace(6, **TRACE))
    eng = _port_engine(models,
                       cache=CacheSpec(page_size=8, prefix_sharing=False),
                       quant=QuantSpec(kv_dtype="int8",
                                       hot_resident_fraction=0.25))
    got = eng.run(poisson_trace(6, **TRACE))
    assert eng.hot_pages == 6 and eng.last_state.layers.has_residents
    assert eng.dispatch_plan().quantization == "int8-mixed"
    for uid, out in want.items():
        assert got[uid].tokens == list(out.tokens), uid
