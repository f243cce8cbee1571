"""int8 KV pools under a sliding window and under H2O, and mixed-precision
hot residents, in the port against the JAX package.

The same inputs, made from numpy seeds, go through the JAX function and
the port's counterpart:

* a trace of lane surgery and decode writes on an int8 pool with hot
  residents (``core/kvcache.py``): grafts that promote each lane's
  freshest page, H2O inserts that evict pages (their scales cleared, their
  residents demoted) and write through to resident pages, a chunk's tail
  write and a lane reset (both demote), write-masked; every field equal
  to JAX's after every operation, exactly (float32 from the same inputs,
  the same roundings; the promotion's mass sums compared exactly too), and
  the dequantized, resident-overlaid lane views likewise;
* the continuous-batching engine's greedy tokens on
  ``aqua-block-sparse`` (JAX: Pallas interpret mode) for int8 pools under
  reduced H2O-Danube-1.8B's window ring (window 16) and reduced
  Qwen3-0.6B with ``h2o_ratio`` 0.5 (tests/test_torch_window_h2o.py
  serves both at once on int8 pools); and for hot residents
  (``hot_resident_fraction`` 0.25) under H2O and with prefix sharing
  (tests/test_torch_quant.py: on the full cache): identical. After each trace the pool's scales, positions,
  ``hot_ids`` and resident copies equal JAX's: positions and ``hot_ids``
  exactly, scales and the float32 resident copies within 1e-5 · |x| +
  1e-5 (the K̂/V activations come out of each package's matmuls in other
  summation orders), the int8 pools within one step;
* the dispatch plan: residents record ``REASON_QUANT_RESIDENCY`` and
  quantization ``"int8-mixed"``, as JAX's plan does;
* the graft, insert and lane-surgery code of these pools runs on the
  meta device, where any host read of a tensor's value raises (what a
  captured admission or decode step needs).
"""
import dataclasses
import functools

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
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, reduced)
from repro_torch.core import kvcache as kv
from repro_torch.core.calibration import AquaProjections
from repro_torch.core.dispatch import (REASON_H2O, REASON_QUANT_GEOMETRY,
                                       REASON_QUANT_RESIDENCY)
from repro_torch.serving import ContinuousBatchingEngine, Request

META = torch.device("meta")
# the engines' float32 K̂/V (and scales) against JAX's: other matmul orders
STATE_RTOL, STATE_ATOL = 1e-5, 1e-5


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# Lane surgery and decode writes on an int8 pool with hot residents
# ---------------------------------------------------------------------------

B, KVH, D, PS, NPL, PAGES, HOT = 3, 2, 8, 4, 4, 12, 2
FIELDS = ("k_pool", "v_pool", "k_scale", "v_scale", "pos_pool", "acc_pool",
          "page_table", "count", "k_hot", "v_hot", "hot_ids")


def _pools(gran):
    jc = jax_kv.init_paged_cache(B, KVH, PAGES, NPL, PS, D, D, jnp.float32,
                                 kv_dtype="int8", scale_granularity=gran,
                                 hot_pages=HOT)
    tc = kv.init_paged_cache(B, KVH, PAGES, NPL, PS, D, D, torch.float32,
                             "cpu", kv_dtype="int8", scale_granularity=gran,
                             hot_pages=HOT)
    return jc, tc


def _assert_same(tc, jc, what, views=True):
    for name in FIELDS:
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      _np(getattr(jc, name)),
                                      err_msg=f"{what}: {name}")
    if not views:
        return
    tv, jv = kv.paged_lane_view(tc), jax_kv.paged_lane_view(jc)
    for name in ("k", "v", "positions"):
        np.testing.assert_array_equal(_np(getattr(tv, name)),
                                      _np(getattr(jv, name)),
                                      err_msg=f"{what}: view {name}")


def _req(rng, n, slots=NPL * PS):
    """A B=1 prefill cache of ``n`` tokens (float32, H2O scores)."""
    k = np.zeros((1, KVH, slots, D), np.float32)
    v = np.zeros((1, KVH, slots, D), np.float32)
    k[0, :, :n] = rng.standard_normal((KVH, n, D)) * 2
    v[0, :, :n] = rng.standard_normal((KVH, n, D))
    pos = np.full((1, slots), -1, np.int32)
    pos[0, :n] = np.arange(n)
    acc = np.zeros((1, KVH, slots), np.float32)
    acc[0, :, :n] = rng.random((KVH, n))
    cnt = np.array([n], np.int32)
    j = jax_kv.AttnCache(k=jnp.asarray(k), v=jnp.asarray(v),
                         positions=jnp.asarray(pos), count=jnp.asarray(cnt),
                         acc_score=jnp.asarray(acc))
    t = kv.AttnCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                     positions=torch.from_numpy(pos),
                     count=torch.from_numpy(cnt),
                     acc_score=torch.from_numpy(acc))
    return j, t


def _set_row(jc, tc, lane, row):
    row = np.asarray(row, np.int32)
    jc = dataclasses.replace(jc, page_table=jc.page_table.at[lane].set(row))
    kv.install_table_row(tc, lane, torch.from_numpy(row))
    return jc


@pytest.mark.parametrize("gran", ["page_head", "page"])
def test_resident_pool_trace_matches_jax(gran):
    """Four grafts (partial last pages; promotion takes the free slots,
    then the least-mass resident; the fourth regrafts lane 0 over its
    resident page), 14 H2O decode steps (write-masked, one lane's page
    unmapped) whose evictions clear scales and demote, a tail write from
    page 1 and a lane reset: every field equal to JAX's after each
    operation, and the dequantized lane views with residents overlaid
    after the surgery and every fifth step."""
    rng = np.random.default_rng(3)
    jc, tc = _pools(gran)
    rows = ([5, 0, 9, 2], [1, 8, 3, 4], [7, 6, 10, -1])
    for lane, (row, n) in enumerate(zip(rows, (13, 15, 10))):
        jc = _set_row(jc, tc, lane, row)
        jreq, treq = _req(rng, n)
        jc = jax_kv.paged_graft(jc, jreq, jnp.int32(lane), n)
        kv.paged_graft(tc, treq, torch.tensor(lane), n, tc.page_table[lane])
        _assert_same(tc, jc, f"graft {lane}")
    # lane 0 again, recycling its resident page 2 (demoted, then the new
    # freshest page 11 promoted)
    jc = _set_row(jc, tc, 0, [5, 0, 11, 2])
    jreq, treq = _req(rng, 11)
    jc = jax_kv.paged_graft(jc, jreq, jnp.int32(0), 11)
    kv.paged_graft(tc, treq, 0, 11, tc.page_table[0])
    _assert_same(tc, jc, "regraft")
    assert (tc.hot_ids >= 0).all()
    evictions = 0
    for step in range(14):
        kw = dict(window=None, h2o=True, recent_len=5)
        jslot, jev = jax_kv.paged_select_slot(jc, **kw)
        slot, ev = kv.paged_select_slot(tc, **kw)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
        evictions += int((ev >= 0).sum())
        grow = 1.0 + 0.2 * step
        k_new = (rng.standard_normal((B, KVH, D)) * grow).astype(np.float32)
        v_new = rng.standard_normal((B, KVH, D)).astype(np.float32)
        m = rng.random(B) < 0.8
        jc = jax_kv.paged_insert(jc, jslot, jnp.asarray(k_new),
                                 jnp.asarray(v_new),
                                 write_mask=jnp.asarray(m), evict_page=jev)
        kv.paged_insert(tc, slot, torch.from_numpy(k_new),
                        torch.from_numpy(v_new),
                        write_mask=torch.from_numpy(m), evict_page=ev)
        w = rng.random((B, KVH, 2, NPL * PS)).astype(np.float32)
        jc = jax_kv.paged_accumulate_h2o(jc, jnp.asarray(w),
                                         write_mask=jnp.asarray(m))
        kv.paged_accumulate_h2o(tc, torch.from_numpy(w),
                                write_mask=torch.from_numpy(m))
        _assert_same(tc, jc, f"step {step}", views=step % 5 == 4)
    assert evictions > 0
    k_tail = (rng.standard_normal((6, KVH, D)) * 3).astype(np.float32)
    v_tail = rng.standard_normal((6, KVH, D)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32) + PS
    jc = jax_kv.paged_write_tail(jc, jnp.int32(1), jnp.asarray(k_tail),
                                 jnp.asarray(v_tail), jnp.asarray(pos), 1,
                                 jnp.int32(PS + 6))
    kv.paged_write_tail(tc, torch.tensor([1]), torch.from_numpy(k_tail),
                        torch.from_numpy(v_tail), torch.from_numpy(pos), 1,
                        PS + 6, tc.page_table[1])
    _assert_same(tc, jc, "tail write")
    jc = jax_kv.paged_reset_lane(jc, jnp.int32(0))
    kv.paged_reset_lane(tc, 0)
    _assert_same(tc, jc, "reset")


def test_resident_pool_code_reads_no_value_on_the_host():
    """Graft (promotion), H2O insert (eviction, demotion, write-through),
    tail write, lane reset and both lane views on the meta device."""
    tc = kv.init_paged_cache(B, KVH, PAGES, NPL, PS, D, D, torch.float32,
                             META, kv_dtype="int8", hot_pages=HOT)
    req = kv.init_attn_cache(1, KVH, NPL * PS, D, D, torch.float32, META,
                             h2o=True)
    lane = torch.ones(1, dtype=torch.int64, device=META)
    kv.install_table_row(tc, lane, torch.zeros(NPL, dtype=torch.int32,
                                               device=META))
    kv.paged_graft(tc, req, lane, 13, tc.page_table[1])
    slot, ev = kv.paged_select_slot(tc, window=4, h2o=True, recent_len=2)
    z = torch.zeros(B, KVH, D, device=META)
    kv.paged_insert(tc, slot, z, z, evict_page=ev,
                    write_mask=torch.ones(B, dtype=torch.bool, device=META))
    t = torch.zeros(6, KVH, D, device=META)
    kv.paged_write_tail(tc, lane, t, t, torch.zeros(6, dtype=torch.int32,
                                                    device=META), 1,
                        torch.ones(1, dtype=torch.int32, device=META),
                        tc.page_table[1])
    kv.paged_reset_lane(tc, lane)
    assert kv.paged_lane_view(tc).k.device == META
    assert kv.paged_lane_pages(tc, tc.page_table[1])[0].device == META


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=8, prompt_bucket=8)
EVICTING = (36, 50, 44)           # past the window (16) and the H2O
                                  # budget (32)
SHORT = (5, 12, 20, 9)


@functools.lru_cache(maxsize=None)
def _models(arch, h2o_ratio):
    kw = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16,
              h2o_ratio=h2o_ratio)
    jcfg = dataclasses.replace(jax_reduced(arch, d_model=128),
                               aqua=JaxAquaConfig(prefill_k_blk=16,
                                                  decode_seq_blk=16, **kw))
    tcfg = dataclasses.replace(reduced(arch, d_model=128),
                               aqua=AquaConfig(**kw))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    return (jcfg, params, JaxProjections(p=jnp.asarray(proj)), tcfg,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            AquaProjections(p=torch.from_numpy(proj)))


def _requests(cls, prompts, prefix=0):
    rng = np.random.default_rng(5)
    pre = np.random.default_rng(6).integers(0, 128, size=(prefix,),
                                            dtype=np.int32)
    return [cls(uid=i, tokens=np.concatenate(
        [pre, rng.integers(0, 128, size=(n,), dtype=np.int32)]),
        max_new_tokens=8, arrival=float(i)) for i, n in enumerate(prompts)]


def _serve_both(arch, h2o_ratio, prompts, hot=0.0, prefix=0):
    """The same trace through the JAX engine and the port's, int8 pools
    of 8-token pages; returns (JAX engine, its outputs, port engine, its
    outputs)."""
    jcfg, params, jproj, tcfg, tparams, tproj = _models(arch, h2o_ratio)
    share = prefix > 0
    jeng = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(
        cache=JaxCacheSpec(page_size=8, prefix_sharing=share),
        quant=JaxQuantSpec(kv_dtype="int8", hot_resident_fraction=hot),
        **SERVE), backend="aqua-block-sparse")
    want = jeng.run(_requests(JaxRequest, prompts, prefix))
    eng = ContinuousBatchingEngine(
        tcfg, tparams, tproj, serving=ServingConfig(
            cache=CacheSpec(page_size=8, prefix_sharing=share),
            quant=QuantSpec(kv_dtype="int8", hot_resident_fraction=hot),
            **SERVE), backend="aqua-block-sparse", device="cpu")
    got = eng.run(_requests(Request, prompts, prefix))
    return jeng, want, eng, got


def _assert_state_close(eng, jeng):
    """The last trace's pool state against JAX's (module docstring)."""
    got, want = eng.last_state.layers, jeng.last_state.layers
    for name in ("pos_pool", "page_table", "hot_ids"):
        if getattr(got, name) is not None:
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          _np(getattr(want, name)), name)
    for name in ("k_scale", "v_scale", "k_hot", "v_hot"):
        if getattr(got, name) is not None:
            np.testing.assert_allclose(_np(getattr(got, name)),
                                       _np(getattr(want, name)),
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=name)
    for name in ("k_pool", "v_pool"):
        diff = np.abs(_np(getattr(got, name)).astype(np.int32)
                      - _np(getattr(want, name)).astype(np.int32))
        assert diff.max() <= 1, name


@pytest.mark.parametrize("arch,h2o_ratio", [
    ("h2o-danube-1.8b", 1.0),        # window ring, wrapped
    ("qwen3-0.6b", 0.5),             # H2O, evicting
])
def test_int8_engine_under_window_and_h2o_matches_jax(arch, h2o_ratio):
    jeng, want, eng, got = _serve_both(arch, h2o_ratio, EVICTING)
    assert eng.eviction == ("h2o" if h2o_ratio < 1 else "ring")
    assert eng.last_state.layers.quantized
    assert eng.dispatch_plan().quantization == "int8"
    for uid, out in want.items():
        assert got[uid].tokens == list(out.tokens), uid
    _assert_state_close(eng, jeng)


@pytest.mark.parametrize("case", ["h2o", "prefix"])
def test_hot_resident_engine_matches_jax(case):
    """``hot_resident_fraction`` 0.25 of the 24-page pool: 6 residents
    (JAX's rounding), promoted at every graft; under H2O evictions demote
    them; with prefix sharing a shared page's resident stays while its
    sharers decode (JAX demotes only the pages a lane clears). The full
    cache's tokens: tests/test_torch_quant.py."""
    h2o_ratio = 0.5 if case == "h2o" else 1.0
    prompts = EVICTING if case == "h2o" else SHORT
    jeng, want, eng, got = _serve_both("qwen3-0.6b", h2o_ratio, prompts,
                                       hot=0.25,
                                       prefix=16 if case == "prefix" else 0)
    num_pages = eng.pool_geometry[0]
    assert eng.hot_pages == max(1, round(0.25 * num_pages))
    assert eng.last_state.layers.hot_ids.shape[-1] == eng.hot_pages
    plan, jplan = eng.dispatch_plan(), jeng.dispatch_plan()
    assert plan.quantization == jplan.quantization == "int8-mixed"
    assert REASON_QUANT_RESIDENCY in plan.reasons
    assert (REASON_H2O in plan.reasons) == (case == "h2o")
    assert (REASON_QUANT_GEOMETRY in plan.reasons) == (case == "h2o")
    assert plan.reasons == jplan.reasons
    if case == "prefix":
        assert eng.page_pool.prefix_hits == jeng.page_pool.prefix_hits > 0
    for uid, out in want.items():
        assert got[uid].tokens == list(out.tokens), uid
    _assert_state_close(eng, jeng)
