"""The port's continuous-batching engine against the JAX package's: the
same Poisson trace at temperature 0 through ``aqua-block-sparse`` must
give identical greedy tokens per request, on the contiguous cache and on
the paged pool (page_size 8, no prefix sharing). Plus the port's own
engine rules (what it refuses, pool queueing, byte accounting)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import AquaConfig, CacheSpec, ServingConfig, reduced
from repro_torch.core.calibration import AquaProjections
from repro_torch.serving import ContinuousBatchingEngine, poisson_trace

AQUA_KW = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
TRACE = dict(mean_interarrival=2.0, prompt_lens=(5, 12, 20),
             max_new_tokens=8, vocab_size=128, seed=3)
SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=8, prompt_bucket=8)


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


def _port_engine(models, cache=None, backend="aqua-block-sparse", **kw):
    _, _, _, tcfg, tparams, tproj = models
    return ContinuousBatchingEngine(
        tcfg, tparams, tproj, serving=ServingConfig(cache=cache, **SERVE),
        backend=backend, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_identical_to_jax_engine(models, paged):
    jcfg, params, jproj = models[:3]
    jcache = JaxCacheSpec(page_size=8, prefix_sharing=False) if paged else None
    want = JaxEngine(jcfg, params, jproj,
                     serving=JaxServingConfig(cache=jcache, **SERVE),
                     backend="aqua-block-sparse").run(
        jax_poisson_trace(6, **TRACE))
    cache = CacheSpec(page_size=8, prefix_sharing=False) if paged else None
    eng = _port_engine(models, cache)
    got = eng.run(poisson_trace(6, **TRACE))
    assert eng.paged == paged
    assert eng.stats.decode_steps > 0
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid
        assert got[uid].finish_reason == out.finish_reason == "length"


def test_small_pool_queues_admissions_with_identical_tokens(models):
    """A pool of 8 pages (of 3 lanes x 8 pages) makes admissions wait for
    retirements; tokens stay those of the contiguous engine."""
    want = _port_engine(models).run(poisson_trace(6, **TRACE))
    eng = _port_engine(models, CacheSpec(page_size=8, num_pages=8,
                                         prefix_sharing=False))
    got = eng.run(poisson_trace(6, **TRACE))
    assert eng.page_pool.peak_in_use <= 8
    assert {u: o.tokens for u, o in got.items()} == \
        {u: o.tokens for u, o in want.items()}


def test_plain_reference_backend_serves_the_same_tokens(models):
    want = _port_engine(models).run(poisson_trace(4, **TRACE))
    got = _port_engine(models, backend="aqua-block-sparse-plain").run(
        poisson_trace(4, **TRACE))
    assert {u: o.tokens for u, o in got.items()} == \
        {u: o.tokens for u, o in want.items()}


def test_plain_reference_backend_serves_the_same_tokens_paged(models):
    cache = CacheSpec(page_size=8, prefix_sharing=False)
    want = _port_engine(models, cache).run(poisson_trace(4, **TRACE))
    got = _port_engine(models, cache, backend="aqua-block-sparse-plain").run(
        poisson_trace(4, **TRACE))
    assert {u: o.tokens for u, o in got.items()} == \
        {u: o.tokens for u, o in want.items()}


def test_cache_bytes_paged_pool_counted_once(models):
    tcfg = models[3]
    att = tcfg.attention
    dk = tcfg.aqua.kept_dims(att.head_dim)
    contiguous = _port_engine(models).cache_bytes()
    per_layer = (3 * att.num_kv_heads * 64 * (dk + att.head_dim) * 4
                 + 3 * 64 * 4 + 3 * 4)
    assert contiguous == tcfg.num_layers * per_layer
    paged = _port_engine(models, CacheSpec(page_size=8, num_pages=12,
                                           prefix_sharing=False))
    # k/v pools, positions, accumulated scores (P, KV, ps), table, count
    per_layer = (12 * att.num_kv_heads * 8 * (dk + att.head_dim) * 4
                 + 12 * 8 * 4 + 12 * att.num_kv_heads * 8 * 4 + 3 * 8 * 4
                 + 3 * 4)
    assert paged.cache_bytes() == tcfg.num_layers * per_layer


def test_engine_refuses_what_is_not_ported(models):
    with pytest.raises(NotImplementedError, match="prefix sharing"):
        _port_engine(models, CacheSpec(page_size=8))
    _, _, _, tcfg, tparams, tproj = models
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(tcfg, tparams, tproj, device="cpu",
                                 serving=ServingConfig(mesh_shape=(2, 2),
                                                       **SERVE))
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(
            dataclasses.replace(tcfg, aqua=AquaConfig(h2o_ratio=0.5,
                                                      **AQUA_KW)),
            tparams, tproj, serving=ServingConfig(**SERVE), device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        _port_engine(models).run([poisson_trace(1, **dict(
            TRACE, prompt_lens=(60,)))[0]])


def test_sampling_is_reproducible_and_in_range(models):
    reqs = lambda: [dataclasses.replace(r, temperature=0.8, top_k=5)
                    for r in poisson_trace(3, **TRACE)]
    a = _port_engine(models, rng_seed=7).run(reqs())
    b = _port_engine(models, rng_seed=7).run(reqs())
    assert {u: o.tokens for u, o in a.items()} == \
        {u: o.tokens for u, o in b.items()}
    assert all(0 <= t < 128 for o in a.values() for t in o.tokens)
