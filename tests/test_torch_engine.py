"""The port's continuous-batching engine against the JAX package's: the
same Poisson trace at temperature 0 through ``aqua-block-sparse`` must
give identical greedy tokens per request, on the contiguous cache and on
the paged pool (page_size 8, no prefix sharing). Plus the port's own
engine rules (what it refuses and what it serves since it was ported,
pool queueing, byte accounting), and the
same for AQUA-Memory kept widths that are not a multiple of 8, ``eos_id``
and ``admission_lookahead``."""
import dataclasses
from types import SimpleNamespace

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
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, reduced)
from repro_torch.core.calibration import AquaProjections
from repro_torch.launch.mesh import run_mesh_threads
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
    # prefix sharing, CacheSpec's default, is served (it was refused before
    # it was ported): a trace of one repeated prompt shares its full pages
    eng = _port_engine(models, CacheSpec(page_size=8))
    assert eng.dispatch_plan().prefix_sharing
    req = poisson_trace(1, **dict(TRACE, prompt_lens=(20,)))[0]
    outs = eng.run([dataclasses.replace(req, uid=u, arrival=float(u))
                    for u in range(3)])
    assert all(len(o.tokens) == 8 for o in outs.values())
    assert eng.page_pool.prefix_hits == 2
    assert eng.page_pool.tokens_saved == 2 * 16
    _, _, _, tcfg, tparams, tproj = models
    # a 2x2 mesh is served (it was refused before meshes were ported):
    # ServingConfig(mesh_shape=(2, 2)) on four ranks (threads here), every
    # rank's greedy tokens the JAX engine's
    jcfg, params, jproj = models[:3]
    mesh_serve = dict(SERVE, max_lanes=4)
    want = JaxEngine(jcfg, params, jproj,
                     serving=JaxServingConfig(**mesh_serve),
                     backend="aqua-block-sparse").run(
        jax_poisson_trace(6, **TRACE))

    def rank(mesh):
        eng = ContinuousBatchingEngine(
            tcfg, params_from_numpy(tparams, "cpu", mesh=mesh), tproj,
            mesh=mesh, backend="aqua-block-sparse",
            serving=ServingConfig(mesh_shape=(2, 2), **mesh_serve))
        assert eng.dispatch_plan().mesh_native
        return {u: o.tokens for u, o in eng.run(
            poisson_trace(6, **TRACE)).items()}
    for got in run_mesh_threads((2, 2), rank, timeout=120):
        assert got == {u: list(o.tokens) for u, o in want.items()}
    # int8 pools under H2O are served (they were refused before they were
    # ported): greedy tokens equal the JAX engine's on an evicting trace
    h2o_trace = dict(TRACE, prompt_lens=(36, 44))
    want = JaxEngine(
        dataclasses.replace(jcfg, aqua=dataclasses.replace(
            jcfg.aqua, h2o_ratio=0.5)), params, jproj,
        serving=JaxServingConfig(
            cache=JaxCacheSpec(page_size=8, prefix_sharing=False),
            quant=JaxQuantSpec(kv_dtype="int8"), **SERVE),
        backend="aqua-block-sparse").run(jax_poisson_trace(4, **h2o_trace))
    eng = ContinuousBatchingEngine(
        dataclasses.replace(tcfg, aqua=AquaConfig(h2o_ratio=0.5, **AQUA_KW)),
        tparams, tproj, device="cpu", backend="aqua-block-sparse",
        serving=ServingConfig(
            cache=CacheSpec(page_size=8, prefix_sharing=False),
            quant=QuantSpec(kv_dtype="int8"), **SERVE))
    got = eng.run(poisson_trace(4, **h2o_trace))
    assert eng.eviction == "h2o" and eng.last_state.layers.quantized
    assert int(eng.last_state.layers.count.max()) > 32   # past the budget
    for uid, out in want.items():
        assert got[uid].tokens == list(out.tokens), uid
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


# ---------------------------------------------------------------------------
# AQUA-Memory kept widths that are not a multiple of 8, stop and admission
# rules
# ---------------------------------------------------------------------------


def _memory_models(s_ratio, block_dims, d_model, k_ratio):
    """Reduced Qwen3 with an AQUA-Memory slice: ``s_ratio`` 0.3 keeps 22
    of 32 dims (``block_dims`` 2; stored as 24), ``s_ratio`` 0.22 keeps
    12 of 16 (``block_dims`` 4; stored as 16)."""
    kw = dict(k_ratio=k_ratio, s_ratio=s_ratio, block_dims=block_dims,
              prefill_q_blk=16)
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b", d_model=d_model),
                               aqua=JaxAquaConfig(prefill_k_blk=16,
                                                  decode_seq_blk=16, **kw))
    tcfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=d_model),
                               aqua=AquaConfig(**kw))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    return (jcfg, params, JaxProjections(p=jnp.asarray(proj)), tcfg,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            AquaProjections(p=torch.from_numpy(proj)))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("s_ratio,block_dims,d_model,k_ratio", [
    (0.3, 2, 128, 0.75), (0.22, 4, 64, 0.5)])
def test_aqua_memory_widths_off_8_match_jax(s_ratio, block_dims, d_model,
                                            k_ratio, paged):
    """Kept widths 22 and 12 (whole blocks, not multiples of 8) serve on
    the block-sparse path with K̂ stored zero-padded to 24 and 16: greedy
    tokens equal the JAX engine's, which stores them unpadded."""
    m = _memory_models(s_ratio, block_dims, d_model, k_ratio)
    tcfg = m[3]
    att = tcfg.attention
    kept = tcfg.aqua.kept_dims(att.head_dim)
    assert kept % block_dims == 0 and kept % 8
    jcache = JaxCacheSpec(page_size=8, prefix_sharing=False) if paged else None
    want = JaxEngine(m[0], m[1], m[2],
                     serving=JaxServingConfig(cache=jcache, **SERVE),
                     backend="aqua-block-sparse").run(
        jax_poisson_trace(6, **TRACE))
    eng = _port_engine(m, CacheSpec(page_size=8, prefix_sharing=False)
                       if paged else None)
    got = eng.run(poisson_trace(6, **TRACE))
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid
    # the stored K̂ is padded to a multiple of 8 with exact zeros
    layers = eng.last_state.layers
    k = layers.k_pool if paged else layers.k
    assert k.shape[-1] == -(-kept // 8) * 8
    assert k[..., :kept].abs().sum() > 0
    assert not k[..., kept:].any()


def test_padded_blocks_are_never_selected():
    """Selection ranks only the real blocks: padding columns that are
    large, or tied with every real block, are never chosen."""
    from repro_torch.core import selection
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    kept, width, bd = 22, 24, 2
    q = torch.from_numpy(rng.standard_normal((2, 4, width)).astype(
        np.float32))
    q[..., kept:] = 100.0                       # would win if ranked
    for kr in (0.5, 0.75, 1.0):
        idx = ops.decode_blocks(q, kr, bd, kept)
        assert idx.shape[-1] == ops.round_k_dims(kept, kr, bd) // bd
        assert int(idx.max()) < kept // bd
        qs = q[:, :, None].expand(2, 4, 16, width)
        pidx, _, _ = ops.prefill_blocks(qs, None, kr, bd, 8, kept)
        assert int(pidx.max()) < kept // bd
    zeros = torch.zeros(1, 2, width)            # every block ties at 0
    assert int(ops.decode_blocks(zeros, 1.0, bd, kept).max()) == \
        kept // bd - 1
    aq = AquaConfig(k_ratio=0.75, s_ratio=0.3, block_dims=bd)
    assert aq.kept_dims(32) == kept
    cache = SimpleNamespace(pages_per_lane=1)
    plan = selection.build_decode_plan(q, cache, topk_dims=aq.topk_dims(32),
                                       block_dims=bd, kept=kept)
    assert int(plan.block_idx.max()) < kept // bd


def test_eos_stops_as_the_jax_engine_does(models):
    """An ``eos_id`` that the greedy trace emits mid-sequence: tokens and
    finish reasons (``eos`` included) equal the JAX engine's."""
    first = _port_engine(models).run(poisson_trace(6, **TRACE))
    eos = first[2].tokens[3]
    serve = dict(SERVE, eos_id=int(eos))
    jcfg, params, jproj, tcfg, tparams, tproj = models
    want = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(**serve),
                     backend="aqua-block-sparse").run(
        jax_poisson_trace(6, **TRACE))
    got = ContinuousBatchingEngine(
        tcfg, tparams, tproj, serving=ServingConfig(**serve),
        backend="aqua-block-sparse", device="cpu").run(
        poisson_trace(6, **TRACE))
    assert any(o.finish_reason == "eos" for o in want.values())
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid
        assert got[uid].finish_reason == out.finish_reason, uid


@pytest.mark.parametrize("lookahead", [1, 4])
def test_admission_lookahead_matches_jax(models, lookahead):
    """An 8-page pool under head-of-line blocking: admission order, and so
    tokens and admission steps, equal the JAX engine's."""
    jcfg, params, jproj, tcfg, tparams, tproj = models
    serve = dict(SERVE, admission_lookahead=lookahead)
    trace = dict(TRACE, prompt_lens=(20, 5, 44, 12))
    want = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(
        cache=JaxCacheSpec(page_size=8, num_pages=8, prefix_sharing=False),
        **serve), backend="aqua-block-sparse").run(
        jax_poisson_trace(6, **trace))
    got = ContinuousBatchingEngine(
        tcfg, tparams, tproj, serving=ServingConfig(
            cache=CacheSpec(page_size=8, num_pages=8, prefix_sharing=False),
            **serve), backend="aqua-block-sparse", device="cpu").run(
        poisson_trace(6, **trace))
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid
        assert got[uid].admitted_at == out.admitted_at, uid
