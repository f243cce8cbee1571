"""Hierarchical AQUA's stage-1 page selection of the port against the JAX
package: ``participating_pages`` (ties, zero statistics, the recency pin,
pages beyond the tail, unmapped entries), its numpy oracle,
``page_scores``, ``participation_slot_mask`` and ``build_decode_plan``;
full participation equal to the plain paged decode; and the hierarchical
engine's greedy tokens (full precision and int8) against the JAX engine's.

Page indices are compared exactly, page masses at rtol 1e-6 and decode
outputs at atol = rtol = 1e-5 (float32, summation order only).
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
from repro.configs.base import SparsitySpec as JaxSparsitySpec
from repro.core import kvcache as jax_kv
from repro.core import selection as jax_sel
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, SparsitySpec, reduced)
from repro_torch.core import kvcache as kv
from repro_torch.core import selection as sel
from repro_torch.core.calibration import AquaProjections
from repro_torch.kernels import ops
from repro_torch.serving import ContinuousBatchingEngine, poisson_trace

TOL = dict(atol=1e-5, rtol=1e-5)
AQUA_KW = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
TRACE = dict(mean_interarrival=2.0, prompt_lens=(5, 20, 30),
             max_new_tokens=8, vocab_size=128, seed=3)
SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=8, prompt_bucket=8)


def _case(rng, b, npl, p, kvh, ps, ties):
    """A random table (some entries unmapped), counts (some past the
    table, some zero) and accumulated scores — drawn from a few values
    when ``ties`` so that equal page masses are common."""
    table = rng.permutation(p)[:b * npl].reshape(b, npl).astype(np.int32)
    table[rng.random((b, npl)) < 0.2] = -1
    count = rng.integers(0, npl * ps + 1, b).astype(np.int32)
    count[0] = 0
    if ties:
        acc = rng.integers(0, 3, (p, kvh, ps)).astype(np.float32)
    else:
        acc = rng.random((p, kvh, ps)).astype(np.float32)
    return acc, table, count


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("kept,pin", [(3, 2), (5, 1), (8, 2), (2, 3)])
def test_participating_pages_match_jax(ties, kept, pin):
    rng = np.random.default_rng(kept * 10 + pin + int(ties))
    ps, npl = 4, 8
    for trial in range(4):
        acc, table, count = _case(rng, 5, npl, 48, 2, ps, ties)
        kw = dict(page_size=ps, kept_pages=kept, pin_recent_pages=pin)
        want = np.asarray(jax_sel.participating_pages(
            *map(jnp.asarray, (acc, table, count)), **kw))
        got = sel.participating_pages(*map(torch.from_numpy,
                                           (acc, table, count)), **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            sel.reference_participating_pages(acc, table, count, **kw), want)
        # page masses: float32 sums in another order
        np.testing.assert_allclose(
            sel.page_scores(torch.from_numpy(acc),
                            torch.from_numpy(table)).numpy(),
            np.asarray(jax_sel.page_scores(jnp.asarray(acc),
                                           jnp.asarray(table))), rtol=1e-6)
        np.testing.assert_array_equal(
            sel.participation_slot_mask(got, page_size=ps,
                                        num_slots=npl * ps).numpy(),
            np.asarray(jax_sel.participation_slot_mask(
                jnp.asarray(want), page_size=ps, num_slots=npl * ps)))


def test_zero_stats_degrade_to_sink_plus_pinned_tail():
    """The serving path keeps no statistics: every page ties at 0, and the
    earliest pages (lowest-index tie-break) plus the pin win; pages past
    the tail only pad the set, last."""
    npl, ps = 64, 8
    acc = torch.zeros(npl, 2, ps)
    table = torch.arange(npl, dtype=torch.int32)[None].repeat(2, 1)
    count = torch.tensor([npl * ps, 3 * ps + 1], dtype=torch.int32)
    got = sel.participating_pages(acc, table, count, page_size=ps,
                                  kept_pages=8, pin_recent_pages=2)
    np.testing.assert_array_equal(got[0].numpy(),
                                  list(range(6)) + [npl - 2, npl - 1])
    # lane 1's tail is page 3: pages 0-3, then the lowest pages past it
    np.testing.assert_array_equal(got[1].numpy(), list(range(8)))


def test_build_decode_plan_matches_jax():
    rng = np.random.default_rng(0)
    b, h, kvh, d, ps, npl, p = 3, 4, 2, 32, 4, 6, 20
    acc, table, count = _case(rng, b, npl, p, kvh, ps, ties=True)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    jc = jax_kv.init_paged_cache(b, kvh, p, npl, ps, d, d, jnp.float32)
    jc = dataclasses.replace(jc, acc_pool=jnp.asarray(acc),
                             page_table=jnp.asarray(table),
                             count=jnp.asarray(count))
    tc = kv.init_paged_cache(b, kvh, p, npl, ps, d, d, torch.float32, "cpu")
    for name, x in (("acc_pool", acc), ("page_table", table),
                    ("count", count)):
        getattr(tc, name).copy_(torch.from_numpy(x))
    for kept in (None, 3, npl):
        kw = dict(topk_dims=16, block_dims=8, kept_pages=kept,
                  pin_recent_pages=2)
        want = jax_sel.build_decode_plan(jnp.asarray(q), jc, **kw)
        got = sel.build_decode_plan(torch.from_numpy(q), tc, **kw)
        np.testing.assert_array_equal(got.block_idx.numpy(),
                                      np.asarray(want.block_idx))
        assert (got.pages is None) == (want.pages is None) == (kept != 3)
        if got.pages is not None:
            np.testing.assert_array_equal(got.pages.numpy(),
                                          np.asarray(want.pages))


@pytest.mark.parametrize("quant", [False, True])
def test_full_participation_equals_plain_paged_decode(quant):
    """The identity participation table attends exactly what the plain
    paged decode attends."""
    rng = np.random.default_rng(7)
    b, h, kvh, d, ps, npl, p = 3, 4, 2, 32, 8, 4, 12
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    if quant:
        k = torch.from_numpy(rng.integers(-127, 128, (p, kvh, ps, d)
                                          ).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (p, kvh, ps, d)
                                          ).astype(np.int8))
        scales = [torch.from_numpy(rng.uniform(0.01, 0.02, (p, kvh)
                                               ).astype(np.float32))
                  for _ in range(2)]
    else:
        k = torch.from_numpy(rng.standard_normal((p, kvh, ps, d)
                                                 ).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((p, kvh, ps, d)
                                                 ).astype(np.float32))
        scales = [None, None]
    table = torch.from_numpy(rng.permutation(p)[:b * npl].reshape(b, npl)
                             .astype(np.int32))
    lengths = torch.tensor([npl * ps, 13, 1], dtype=torch.int32)
    full = torch.arange(npl, dtype=torch.int32)[None].repeat(b, 1)
    want = ops.aqua_paged_decode(q, k, v, table, lengths, *scales)
    got = ops.aqua_paged_decode(q, k, v, table, lengths, *scales,
                                part_idx=full)
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# The hierarchical engine
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


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_hierarchical_engine_greedy_tokens_match_jax(models, kv_dtype):
    """page_keep_ratio 0.375 of 8 pages keeps 3: the attention sink and
    the two pinned tail pages; lanes of up to 38 tokens drop pages."""
    jcfg, params, jproj, tcfg, tparams, tproj = models
    want = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(
        cache=JaxCacheSpec(page_size=8, prefix_sharing=False),
        quant=JaxQuantSpec(kv_dtype=kv_dtype),
        sparsity=JaxSparsitySpec(page_keep_ratio=0.375), **SERVE),
        backend="aqua-block-sparse")
    want_out = want.run(jax_poisson_trace(6, **TRACE))
    eng = ContinuousBatchingEngine(tcfg, tparams, tproj, serving=ServingConfig(
        cache=CacheSpec(page_size=8, prefix_sharing=False),
        quant=QuantSpec(kv_dtype=kv_dtype),
        sparsity=SparsitySpec(page_keep_ratio=0.375), **SERVE), device="cpu")
    got = eng.run(poisson_trace(6, **TRACE))
    assert eng.kept_pages == want.kept_pages == 3 < eng.pages_per_lane == 8
    for uid, out in want_out.items():
        assert got[uid].tokens == out.tokens, uid
    # dropping pages changes what is served: the full-keep engine differs
    full = ContinuousBatchingEngine(
        tcfg, tparams, tproj, device="cpu", serving=ServingConfig(
            cache=CacheSpec(page_size=8, prefix_sharing=False),
            quant=QuantSpec(kv_dtype=kv_dtype), **SERVE))
    assert full.kept_pages is None
    assert {u: o.tokens for u, o in full.run(poisson_trace(6, **TRACE)
                                             ).items()} != \
        {u: o.tokens for u, o in got.items()}
