"""The port's chunked-prefill engine against the JAX package's: the trace
of tests/test_chunked_prefill.py (5 prompts of 20-60 tokens, budget 16,
``prefill_q_blk`` 16) at temperature 0 must give greedy tokens identical
to the JAX chunked engine's *and* to the port's own monolithic engine's,
with the same chunk counts, for AQUA off and ``aqua-block-sparse`` on the
contiguous cache and the paged pool, and on an int8 paged pool. The JAX
engine serves chunk steps on its masked-dense reference; the port runs
the block-sparse chunks through the prefill kernel's ``q_offset`` form
(its plain version on the CPU), AQUA off through the reference step.
Plus the geometry guard, and the refusal without a card.
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
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, reduced)
from repro_torch.core.calibration import AquaProjections
from repro_torch.core.dispatch import REASON_CHUNK_GEOMETRY
from repro_torch.serving import ContinuousBatchingEngine, Request

AQUA_KW = dict(k_ratio=0.5, block_dims=8, prefill_q_blk=16)
SERVE = dict(max_lanes=4, max_seq=96, max_new_tokens=6, prompt_bucket=8)
BUDGET = 16


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), remat=False,
                               dtype="float32")
    tcfg = reduced("qwen3-0.6b")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    return (jcfg, params, JaxProjections(p=jnp.asarray(proj)), tcfg,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            AquaProjections(p=torch.from_numpy(proj)))


def _trace(request_cls, vocab, n=5, seed=3, lo=20, hi=60):
    rng = np.random.default_rng(seed)
    return [request_cls(uid=i, tokens=rng.integers(0, vocab, size=(int(
        rng.integers(lo, hi)),), dtype=np.int32), max_new_tokens=6,
        arrival=float(i) * 0.25) for i in range(n)]


def _port(models, aqua, layout, budget):
    _, _, _, tcfg, tparams, tproj = models
    cache = None if layout == "contiguous" else CacheSpec(
        page_size=8, num_pages=48, prefix_sharing=False)
    quant = QuantSpec(kv_dtype="int8") if layout == "int8" else None
    tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(**AQUA_KW)
                               if aqua else None)
    return ContinuousBatchingEngine(
        tcfg, tparams, tproj if aqua else None,
        serving=ServingConfig(cache=cache, quant=quant,
                              prefill_budget_tokens=budget, **SERVE),
        backend="aqua-block-sparse" if aqua else None, device="cpu")


@pytest.mark.parametrize("aqua,layout", [(False, "contiguous"),
                                         (False, "paged"),
                                         (True, "contiguous"),
                                         (True, "paged"), (True, "int8")])
def test_chunked_engine_tokens_match_jax_and_monolithic(models, aqua, layout):
    jcfg, params, jproj = models[:3]
    jcache = None if layout == "contiguous" else JaxCacheSpec(
        page_size=8, num_pages=48, prefix_sharing=False)
    jquant = JaxQuantSpec(kv_dtype="int8") if layout == "int8" else None
    jeng = JaxEngine(
        dataclasses.replace(jcfg, aqua=JaxAquaConfig(**AQUA_KW)
                            if aqua else None),
        params, jproj if aqua else None,
        serving=JaxServingConfig(cache=jcache, quant=jquant,
                                 prefill_budget_tokens=BUDGET, **SERVE),
        backend="aqua-block-sparse" if aqua else "dense-jnp")
    want = jeng.run(_trace(JaxRequest, jcfg.vocab_size))
    eng = _port(models, aqua, layout, BUDGET)
    assert eng.dispatch_plan().chunked_prefill
    got = eng.run(_trace(Request, jcfg.vocab_size))
    mono = _port(models, aqua, layout, None).run(
        _trace(Request, jcfg.vocab_size))
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens == mono[uid].tokens, uid
    st, jst = eng.stats, jeng.stats
    assert st.chunked_admissions == jst.chunked_admissions == len(want)
    assert st.prefill_chunks == jst.prefill_chunks > st.chunked_admissions
    assert st.decode_steps == jst.decode_steps
    assert st.admissions == len(want)


def test_budget_off_the_q_tile_keeps_monolithic_admission(models):
    """Budget 24 is not a multiple of prefill_q_blk 16: the plan keeps
    monolithic admission, attributed, and tokens stay the same."""
    eng = _port(models, True, "contiguous", 24)
    plan = eng.dispatch_plan()
    assert not plan.chunked_prefill
    assert REASON_CHUNK_GEOMETRY in plan.chunked_reasons
    vocab = models[3].vocab_size
    got = eng.run(_trace(Request, vocab))
    assert eng.stats.chunked_admissions == eng.stats.prefill_chunks == 0
    mono = _port(models, True, "contiguous", None).run(_trace(Request, vocab))
    assert {u: o.tokens for u, o in got.items()} == \
        {u: o.tokens for u, o in mono.items()}


def test_chunked_engine_needs_a_card_by_default(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, _, tcfg, tparams, tproj = models
    with pytest.raises(RuntimeError):
        ContinuousBatchingEngine(
            dataclasses.replace(tcfg, aqua=AquaConfig(**AQUA_KW)), tparams,
            tproj, serving=ServingConfig(prefill_budget_tokens=BUDGET,
                                         **SERVE))
