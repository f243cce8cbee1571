"""Prefix sharing in the port against the JAX package, on the CPU.

* ``PagePool`` under random sequences of admissions (lookup, reserve,
  register), retirements and copy-on-write splits: the same page ids,
  refcounts, free list, index contents, hits and saved tokens as the JAX
  package's pool after every operation, and the pool invariants.
* ``make_private`` + ``kvcache.paged_copy_page``: bit for bit the JAX
  package's copy, on full-precision and int8 pools; the copy dequantizes
  as the original does; on the meta device (nothing read on the host).
* A sharer's tail write (``paged_write_tail`` from the first private
  page) leaves every shared page's K, V, positions, scores and int8
  scales as they were, bit for bit, and equals JAX's write.
* ``DenseLM.prefill_with_prefix`` (the port's ``prefill_chunk``): a tail
  against another lane's prefix pages gives JAX's logits and lane views
  within 1e-4 (float32, reduced width), bf16 and int8 pools; and runs on
  the meta device.
* The engine: greedy tokens, ``prefix_hits`` and ``tokens_saved`` equal
  the JAX engine's for a trace whose prompts share a 16-token prefix, on
  the paged bf16 pool, int8 pools, hierarchical AQUA (``page_keep_ratio``
  0.375), chunked prefill (budget 16), ``aqua-masked-dense`` and
  ``block_dims`` 1; JAX's two regressions (a prompt that extends a shared
  prefix registers the longer chain; a shared admission ignores stale
  positions on recycled pages); a repeated prompt of whole pages keeps
  its last page private; ``dispatch_plan().prefix_sharing`` equals
  JAX's for the full, window and H2O policies and the contiguous cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import QuantSpec as JaxQuantSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.configs.base import SparsitySpec as JaxSparsitySpec
from repro.core import kvcache as jkv
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.models.base import PagingSpec as JaxPagingSpec
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.scheduler import PagePool as JaxPagePool
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, SparsitySpec, reduced)
from repro_torch.core import kvcache as kv
from repro_torch.core.calibration import AquaProjections
from repro_torch.models import build_model
from repro_torch.models.base import PagingSpec
from repro_torch.serving import ContinuousBatchingEngine, Request
from repro_torch.serving.scheduler import PagePool

META = torch.device("meta")
#: float32 model outputs at reduced width (as tests/test_torch_model.py)
TOL = dict(atol=1e-4, rtol=1e-4)
AQUA_KW = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=6, prompt_bucket=8)
PREFIX = 16                         # two 8-token pages


# ---------------------------------------------------------------------------
# PagePool
# ---------------------------------------------------------------------------


def _pool_state(pool) -> dict:
    return dict(free=list(pool._free), refcount=pool.refcount.tolist(),
                lanes={k: list(v) for k, v in pool._lane_pages.items()},
                index=dict(pool._prefix_index), keys=dict(pool._page_key),
                peak=pool.peak_in_use, in_use=pool.pages_in_use,
                hits=pool.prefix_hits, saved=pool.tokens_saved)


def _check_invariants(pool) -> None:
    mapped = {}
    for pages in pool._lane_pages.values():
        for p in pages:
            mapped[p] = mapped.get(p, 0) + 1
    for p in range(pool.num_pages):
        assert pool.refcount[p] == mapped.get(p, 0), p
        if mapped.get(p, 0) > 1:
            assert p in pool._page_key, f"page {p} shared but not indexed"
    assert not set(pool._free) & set(mapped)
    assert len(pool._free) + len(mapped) == pool.num_pages


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**16),
       num_pages=st.integers(min_value=4, max_value=16),
       share=st.sampled_from([True, False]),
       ops=st.integers(min_value=5, max_value=60))
def test_page_pool_matches_jax_under_random_operations(seed, num_pages,
                                                       share, ops):
    rng = np.random.default_rng(seed)
    ps = 4
    pools = (JaxPagePool(num_pages, ps, prefix_sharing=share),
             PagePool(num_pages, ps, prefix_sharing=share))
    common = rng.integers(0, 50, size=(2 * ps,), dtype=np.int32)
    lanes, next_lane = [], 0
    for _ in range(ops):
        r = rng.random()
        if lanes and r < 0.35:                         # retire a lane
            lane = lanes.pop(int(rng.integers(len(lanes))))
            for pool in pools:
                pool.release(lane)
        elif lanes and r < 0.45:                       # copy-on-write
            lane = lanes[int(rng.integers(len(lanes)))]
            logical = int(rng.integers(len(pools[1].lane_pages(lane))))
            out = []
            for pool in pools:
                try:
                    out.append(pool.make_private(lane, logical))
                except RuntimeError as e:              # pool exhausted
                    out.append(str(e))
            assert out[0] == out[1]
        else:                          # admit: half share a common prefix
            if rng.random() < 0.5:
                tokens = np.concatenate([common, rng.integers(
                    0, 50, size=(int(rng.integers(1, 6)),), dtype=np.int32)])
            else:
                tokens = rng.integers(0, 50, size=(int(rng.integers(1, 12)),),
                                      dtype=np.int32)
            got = []
            for pool in pools:
                shared = pool.lookup_prefix(tokens)[
                    :max(0, (len(tokens) - 1) // ps)]
                num_new = -(-(len(tokens) + 2) // ps) - len(shared)
                pages = (pool.reserve(next_lane, shared, num_new)
                         if pool.can_reserve(num_new) else None)
                if pages is not None:
                    if shared:
                        pool.prefix_hits += 1
                        pool.tokens_saved += len(shared) * ps
                    pool.register_prefix(tokens, pages, len(tokens))
                got.append((shared, pages))
            assert got[0] == got[1]
            if got[1][1] is not None:
                lanes.append(next_lane)
                next_lane += 1
        assert _pool_state(pools[1]) == _pool_state(pools[0])
        _check_invariants(pools[1])
    for lane in lanes:
        for pool in pools:
            pool.release(lane)
    assert _pool_state(pools[1]) == _pool_state(pools[0])
    assert pools[1].pages_in_use == 0 and not pools[1]._prefix_index


# ---------------------------------------------------------------------------
# Cache surgery: copy-on-write and the sharer's tail write
# ---------------------------------------------------------------------------

KVH, DK, DV, PS, NP, NPL = 2, 16, 8, 4, 10, 4


def _random_pools(kv_dtype: str, seed: int = 0):
    """One single-layer paged cache of 2 lanes as (JAX, port) twins with
    the same random contents, mapped as two ``PagePool``s' first
    reservations map them: lane 0 maps pages 0, 1, 2 (its prompt, 10
    tokens), lane 1 maps 0, 1 (shared) and 3, 4."""
    rng = np.random.default_rng(seed)
    quant = kv_dtype == "int8"
    if quant:
        k = rng.integers(-127, 128, size=(NP, KVH, PS, DK)).astype(np.int8)
        v = rng.integers(-127, 128, size=(NP, KVH, PS, DV)).astype(np.int8)
    else:
        k = rng.standard_normal((NP, KVH, PS, DK)).astype(np.float32)
        v = rng.standard_normal((NP, KVH, PS, DV)).astype(np.float32)
    fields = dict(
        k_pool=k, v_pool=v,
        pos_pool=rng.integers(-1, 30, size=(NP, PS)).astype(np.int32),
        acc_pool=rng.random((NP, KVH, PS)).astype(np.float32),
        page_table=np.array([[0, 1, 2, -1], [0, 1, 3, 4]], np.int32),
        count=np.array([10, 8], np.int32))
    if quant:
        fields.update(k_scale=rng.random((NP, KVH)).astype(np.float32),
                      v_scale=rng.random((NP, KVH)).astype(np.float32))
    jc = jkv.PagedAttnCache(**{n: jnp.asarray(a) for n, a in fields.items()})
    tc = kv.PagedAttnCache(**{n: torch.from_numpy(a.copy())
                              for n, a in fields.items()})
    return jc, tc


def _fields(cache) -> dict:
    return {f: np.asarray(getattr(cache, f)) for f in
            ("k_pool", "v_pool", "pos_pool", "acc_pool", "page_table",
             "count", "k_scale", "v_scale")
            if getattr(cache, f) is not None}


def _assert_fields_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_copy_on_write_matches_jax_bitwise(kv_dtype):
    jc, tc = _random_pools(kv_dtype)
    pools = (JaxPagePool(NP, PS), PagePool(NP, PS))
    for pool in pools:
        pool.reserve(0, [], 3)
        assert pool.reserve(1, pool.lane_pages(0)[:2], 2) == [0, 1, 3, 4]
    moved = [pool.make_private(1, 1) for pool in pools]
    assert moved[0] == moved[1] is not None
    old, new = moved[1]
    jc = jkv.paged_copy_page(jc, jnp.int32(old), jnp.int32(new))
    before = kv.paged_lane_view(tc)
    kv.paged_copy_page(tc, old, new)
    _assert_fields_equal(_fields(tc), _fields(jc))
    # lane 1 remapped to its copy reads what it read before, bit for bit
    tc.page_table[1, 1] = new
    after = kv.paged_lane_view(tc)
    for f in ("k", "v", "positions"):
        assert torch.equal(getattr(after, f), getattr(before, f)), f


def test_copy_page_of_a_stacked_cache_reads_no_value_on_the_host():
    """Every layer of a stacked cache at once, with device page ids; on the
    meta device, where a host read of a tensor's value raises."""
    for dev in ("cpu", META):
        cache = kv.init_paged_cache(2, KVH, NP, NPL, PS, DK, DV,
                                    torch.float32, dev, num_layers=3,
                                    kv_dtype="int8")
        if dev == "cpu":
            for t in (cache.k_pool, cache.v_pool):
                t.copy_(torch.randint(-127, 128, t.shape, dtype=torch.int8))
            cache.k_scale.uniform_()
            cache.pos_pool.random_(0, 30)
        kv.paged_copy_page(cache, torch.tensor(2, device=dev),
                           torch.tensor(6, device=dev))
        if dev == "cpu":
            for name, t in _fields(cache).items():
                if name not in ("page_table", "count"):
                    np.testing.assert_array_equal(t[:, 6], t[:, 2], name)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sharer_tail_write_leaves_shared_pages_bitwise(kv_dtype):
    """Lane 1 shares lane 0's pages 0 and 1 and writes its 6-token tail
    from logical page 2 (its private pages 3, 4): pages 0 and 1 keep
    every bit, and the whole cache equals JAX's after the same write."""
    jc, tc = _random_pools(kv_dtype, seed=1)
    rng = np.random.default_rng(2)
    k_t = rng.standard_normal((6, KVH, DK)).astype(np.float32)
    v_t = rng.standard_normal((6, KVH, DV)).astype(np.float32)
    pos = np.arange(8, 14, dtype=np.int32)
    shared = {n: t[[0, 1]].copy() for n, t in _fields(tc).items()
              if n not in ("page_table", "count")}
    jc = jkv.paged_write_tail(jc, jnp.int32(1), jnp.asarray(k_t),
                              jnp.asarray(v_t), jnp.asarray(pos),
                              jnp.int32(2), jnp.int32(14))
    kv.paged_write_tail(tc, 1, torch.from_numpy(k_t), torch.from_numpy(v_t),
                        torch.from_numpy(pos), 2, 14, tc.page_table[1])
    after = _fields(tc)
    for name, t in shared.items():
        np.testing.assert_array_equal(after[name][[0, 1]], t, err_msg=name)
    assert int(tc.count[1]) == 14
    _assert_fields_equal(after, _fields(jc))


# ---------------------------------------------------------------------------
# DenseLM.prefill_with_prefix
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """The reduced Qwen3 of tests/test_torch_engine.py: JAX params carried
    over, seeded orthogonal projections."""
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


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_with_prefix_matches_jax(models, kv_dtype):
    """Lane 0 prefills a 28-token prompt into pages 4, 1, 6, 2 (grafted);
    lane 1's row maps pages 4 and 1 (16 tokens) and its own 9 and 3, and
    prefills a 13-token tail (bucket-padded to 16) against them."""
    jcfg, jparams, jproj, tcfg, tparams, tproj = models
    backend = "aqua-block-sparse"
    jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
        jcfg.attention, backend=backend))
    tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(
        tcfg.attention, backend=backend))
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, tcfg.vocab_size, size=(28,), dtype=np.int32)
    tail = rng.integers(0, tcfg.vocab_size, size=(13,), dtype=np.int32)
    rows = np.full((2, 8), -1, np.int32)
    rows[0, :4], rows[1, :4] = [4, 1, 6, 2], [4, 1, 9, 3]
    padded = np.zeros((1, 32), np.int32)
    padded[0, :28] = prompt
    tail_pad = np.zeros((1, 16), np.int32)
    tail_pad[0, :13] = tail

    jm = jax_build_model(jcfg)
    jm.enable_paging(JaxPagingSpec(8, 12, kv_dtype=kv_dtype))
    js = jm.init_decode_state(2, 64)
    _, jreq = jm.prefill(jparams, {"tokens": jnp.asarray(padded),
                                   "lengths": jnp.asarray([28])}, 64,
                         aqua_proj=jproj.p)
    js = dataclasses.replace(js, layers=dataclasses.replace(
        js.layers, page_table=js.layers.page_table.at[:, 0].set(rows[0])
        .at[:, 1].set(rows[1])))
    js = jm.graft_paged(js, jreq, jnp.int32(0), 32)
    jlogits, js = jm.prefill_with_prefix(
        jparams, {"tokens": jnp.asarray(tail_pad),
                  "lengths": jnp.asarray([13])}, js, jnp.int32(1),
        jnp.int32(PREFIX), aqua_proj=jproj.p)

    tm = build_model(tcfg, "cpu")
    tm.enable_paging(PagingSpec(8, 12, kv_dtype=kv_dtype))
    ts = tm.init_decode_state(2, 64)
    proj = tproj.p
    _, treq = tm.prefill(tparams, {"tokens": torch.from_numpy(padded),
                                   "lengths": torch.tensor([28])}, 64,
                         aqua_proj=proj)
    for lane in (0, 1):
        kv.install_table_row(ts.layers, lane, torch.from_numpy(rows[lane]))
    tm.graft_paged(ts, treq, 0, 32, torch.from_numpy(rows[0]))
    tlogits, _ = tm.prefill_with_prefix(
        tparams, {"tokens": torch.from_numpy(tail_pad),
                  "lengths": torch.tensor([13])}, ts, 1, PREFIX,
        aqua_proj=proj, select_q_blk=None, row=torch.from_numpy(rows[1]))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    for i in range(tcfg.num_layers):
        got = kv.paged_lane_view(ts.layers.layer(i))
        want = jkv.paged_lane_view(jax.tree.map(lambda a: a[i], js.layers))
        np.testing.assert_array_equal(got.positions.numpy(),
                                      np.asarray(want.positions))
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want.count))
        # int8: a value may round to the neighbouring step of its scale
        atol = (2 * float(ts.layers.layer(i).k_scale.max().clamp(
            min=ts.layers.layer(i).v_scale.max()))
                if kv_dtype == "int8" else TOL["atol"])
        for f in ("k", "v"):
            np.testing.assert_allclose(getattr(got, f).float().numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=TOL["rtol"], atol=atol)


def test_prefill_with_prefix_reads_no_value_on_the_host(models):
    """The prefix-shared admission's model step on the meta device (the
    plain backend: the kernel wrappers take CPU or CUDA tensors), with an
    int8 pool."""
    tcfg, tparams, tproj = models[3:]
    tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(
        tcfg.attention, backend="aqua-block-sparse-plain"))
    tm = build_model(tcfg, "cpu")
    tm.enable_paging(PagingSpec(8, 12, kv_dtype="int8"))
    state = tm.init_decode_state(2, 64, device=META)
    to_meta = lambda tree: ({k: to_meta(v) for k, v in tree.items()}
                            if isinstance(tree, dict) else tree.to(META))
    params = to_meta(tparams)
    logits, _ = tm.prefill_with_prefix(
        params, {"tokens": torch.zeros(1, 16, dtype=torch.int32,
                                       device=META),
                 "lengths": torch.ones(1, dtype=torch.int32, device=META)},
        state, 1, PREFIX, aqua_proj=tproj.p.to(META), select_q_blk=None,
        row=state.layers.page_table[0, 1])
    assert logits.device == META and logits.shape == (1, tcfg.vocab_size)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _shared_trace(cls, vocab, n=5, seed=5):
    """``n`` prompts of one 16-token prefix and a 4-21-token tail, one
    arriving per step."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, size=(PREFIX,), dtype=np.int32)
    return [cls(uid=i, tokens=np.concatenate([pre, rng.integers(
        0, vocab, size=(int(rng.integers(4, 22)),), dtype=np.int32)]),
        max_new_tokens=6, arrival=float(i)) for i in range(n)]


# name: (AQUA overrides or None for the config's own, backend, serving
# overrides for both packages as (port kwargs, JAX kwargs))
ENGINE_CASES = {
    "paged": ({}, "aqua-block-sparse", {}),
    "int8": ({}, "aqua-block-sparse",
             dict(quant=("int8", "int8"))),
    "hierarchical": ({}, "aqua-block-sparse",
                     dict(sparsity=(0.375, 0.375))),
    "chunked": ({}, "aqua-block-sparse",
                dict(prefill_budget_tokens=(16, 16))),
    "aqua-masked-dense": ({}, "aqua-masked-dense", {}),
    "block-dims-1": (dict(block_dims=1), None, {}),
}


def _serving(kw: dict, port: bool):
    out = dict(SERVE)
    for name, pair in kw.items():
        val = pair[0 if port else 1]
        if name == "quant":
            val = (QuantSpec if port else JaxQuantSpec)(kv_dtype=val)
        elif name == "sparsity":
            val = (SparsitySpec if port else JaxSparsitySpec)(
                page_keep_ratio=val)
        out[name] = val
    cache = (CacheSpec if port else JaxCacheSpec)(page_size=8)
    return (ServingConfig if port else JaxServingConfig)(cache=cache, **out)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_shares_prefixes_like_jax(models, case):
    jcfg, jparams, jproj, tcfg, tparams, tproj = models
    aqua_kw, backend, serve_kw = ENGINE_CASES[case]
    jcfg = dataclasses.replace(jcfg, aqua=dataclasses.replace(jcfg.aqua,
                                                              **aqua_kw))
    tcfg = dataclasses.replace(tcfg, aqua=dataclasses.replace(tcfg.aqua,
                                                              **aqua_kw))
    jeng = JaxEngine(jcfg, jparams, jproj, serving=_serving(serve_kw, False),
                     backend=backend)
    want = jeng.run(_shared_trace(JaxRequest, jcfg.vocab_size))
    eng = ContinuousBatchingEngine(tcfg, tparams, tproj,
                                   serving=_serving(serve_kw, True),
                                   backend=backend, device="cpu")
    got = eng.run(_shared_trace(Request, tcfg.vocab_size))
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid
    pool, jpool = eng.page_pool, jeng.page_pool
    assert pool.prefix_hits == jpool.prefix_hits >= 2
    assert pool.tokens_saved == jpool.tokens_saved \
        == PREFIX * pool.prefix_hits
    assert pool.peak_in_use == jpool.peak_in_use
    plan = eng.dispatch_plan()
    assert plan.prefix_sharing and jeng.dispatch_plan().prefix_sharing
    assert (plan.chunked_prefill, plan.quantization, plan.token_sparsity) \
        == (jeng.dispatch_plan().chunked_prefill,
            jeng.dispatch_plan().quantization,
            jeng.dispatch_plan().token_sparsity)
    if "prefill_budget_tokens" in serve_kw:
        assert eng.stats.chunked_admissions == jeng.stats.chunked_admissions
        assert eng.stats.prefill_chunks == jeng.stats.prefill_chunks > 0
    assert pool.pages_in_use == 0


@pytest.fixture(scope="module")
def dense_models():
    """JAX's tests/test_paged_serving.py model: reduced Qwen3, float32,
    AQUA off, served on the materialized-score backend."""
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), remat=False,
                               dtype="float32", aqua=None)
    tcfg = dataclasses.replace(reduced("qwen3-0.6b"), aqua=None)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return (jcfg, params, tcfg,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


def _dense_pair(dense_models, serving_kw, reqs):
    """Both engines on ``reqs`` (``(uid, tokens, max_new, arrival)``):
    (JAX engine, its outputs, port engine, its outputs)."""
    jcfg, params, tcfg, tparams = dense_models
    jeng = JaxEngine(jcfg, params, None, backend="dense-jnp",
                     serving=JaxServingConfig(**serving_kw(False)))
    eng = ContinuousBatchingEngine(tcfg, tparams, None, backend="dense",
                                   serving=ServingConfig(**serving_kw(True)),
                                   device="cpu")
    make = lambda cls: [cls(uid=u, tokens=t, max_new_tokens=m, arrival=a)
                        for u, t, m, a in reqs]
    return jeng, jeng.run(make(JaxRequest)), eng, eng.run(make(Request))


def test_prefix_extension_registers_longer_chain(dense_models):
    """JAX's tests/test_paged_serving.py regression: a prompt that extends
    a shared prefix by more full pages indexes them too, so a third
    identical prompt shares all three pages."""
    vocab = dense_models[2].vocab_size
    rng = np.random.default_rng(21)
    p = rng.integers(0, vocab, size=(16,), dtype=np.int32)
    q = rng.integers(0, vocab, size=(9,), dtype=np.int32)
    reqs = [(0, p, 10, 0.0), (1, np.concatenate([p, q]), 10, 1.0),
            (2, np.concatenate([p, q]), 10, 2.0)]

    def serving(port):
        cache = (CacheSpec if port else JaxCacheSpec)(page_size=8,
                                                      num_pages=24)
        return dict(SERVE, max_lanes=4, max_new_tokens=6, cache=cache)
    jeng, want, eng, got = _dense_pair(dense_models, serving, reqs)
    assert {u: o.tokens for u, o in got.items()} == \
        {u: o.tokens for u, o in want.items()}
    assert all(len(o.tokens) == 10 for o in got.values())
    # uid 1 shares p's 2 pages, uid 2 the 3-page chain uid 1 indexed
    assert eng.page_pool.prefix_hits == jeng.page_pool.prefix_hits == 2
    assert eng.page_pool.tokens_saved == jeng.page_pool.tokens_saved \
        == 16 + 24


def test_page_aligned_prompt_leaves_one_tail_page(dense_models):
    """A repeated prompt of whole pages shares all its pages but the last:
    at least one tail token must prefill to give the admission's logits
    (JAX's cap, ``(prompt_len - 1) // page_size`` pages)."""
    vocab = dense_models[2].vocab_size
    p = np.random.default_rng(8).integers(0, vocab, size=(24,),
                                          dtype=np.int32)
    reqs = [(0, p, 6, 0.0), (1, p, 6, 1.0)]

    def serving(port):
        cache = (CacheSpec if port else JaxCacheSpec)(page_size=8)
        return dict(SERVE, cache=cache)
    jeng, want, eng, got = _dense_pair(dense_models, serving, reqs)
    assert {u: o.tokens for u, o in got.items()} == \
        {u: o.tokens for u, o in want.items()}
    assert got[0].tokens == got[1].tokens
    assert eng.page_pool.prefix_hits == jeng.page_pool.prefix_hits == 1
    assert eng.page_pool.tokens_saved == jeng.page_pool.tokens_saved == 16


def test_prefix_admission_ignores_stale_recycled_pages(dense_models):
    """JAX's tests/test_paged_serving.py regression: C keeps the shared
    prefix alive, A (one prefix's worth of unshared pages) retires at once
    so its pages, positions 0-15 still in them, return to the free list,
    and B's tail is handed one of them. The prefix read must not take
    those stale positions: tokens equal the contiguous engine's and
    JAX's."""
    vocab = dense_models[2].vocab_size
    rng = np.random.default_rng(42)
    pre = rng.integers(0, vocab, size=(16,), dtype=np.int32)
    c = np.concatenate([pre, rng.integers(0, vocab, size=(4,),
                                          dtype=np.int32)])
    a = rng.integers(0, vocab, size=(16,), dtype=np.int32)
    b = np.concatenate([pre, rng.integers(0, vocab, size=(14,),
                                          dtype=np.int32)])
    reqs = [(0, c, 30, 0.0), (1, a, 1, 0.0), (2, b, 8, 3.0)]

    def serving(port, paged=True):
        cache = ((CacheSpec if port else JaxCacheSpec)(page_size=8,
                                                       num_pages=12)
                 if paged else None)
        return dict(SERVE, max_lanes=2, max_new_tokens=8, cache=cache)
    jeng, want, eng, got = _dense_pair(dense_models, serving, reqs)
    assert eng.page_pool.prefix_hits == jeng.page_pool.prefix_hits == 1
    _, _, _, contiguous = _dense_pair(
        dense_models, lambda port: serving(port, paged=False), reqs)
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens == contiguous[uid].tokens, uid


@pytest.mark.parametrize("policy", ["full", "window", "h2o", "contiguous",
                                    "opted-out"])
def test_dispatch_plan_prefix_sharing_matches_jax(models, policy):
    jcfg, jparams, jproj, tcfg, tparams, tproj = models
    cache = dict(page_size=8, prefix_sharing=policy != "opted-out")
    if policy == "window":
        jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
            jcfg.attention, window=16))
        tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(
            tcfg.attention, window=16))
    if policy == "h2o":
        jcfg = dataclasses.replace(jcfg, aqua=dataclasses.replace(
            jcfg.aqua, h2o_ratio=0.5))
        tcfg = dataclasses.replace(tcfg, aqua=dataclasses.replace(
            tcfg.aqua, h2o_ratio=0.5))
    jplan = JaxEngine(jcfg, jparams, jproj, serving=JaxServingConfig(
        cache=None if policy == "contiguous" else JaxCacheSpec(**cache),
        **SERVE)).dispatch_plan()
    eng = ContinuousBatchingEngine(
        tcfg, tparams, tproj, device="cpu", serving=ServingConfig(
            cache=None if policy == "contiguous" else CacheSpec(**cache),
            **SERVE))
    assert eng.dispatch_plan().prefix_sharing == jplan.prefix_sharing \
        == (policy == "full")
