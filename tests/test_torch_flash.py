"""The port's flash attention and the paths that run it, against the JAX
package: the kernel's plain version against the Pallas flash kernel (run in
interpret mode on the CPU, as tests/test_kernels.py runs it), the ``flash``
backend's valid rows against JAX ``dense-jnp`` with ragged ``lengths``, and
the engine on the configurations that now resolve to flash — AQUA off, and
AQUA with the default per-dim selection (``block_dims`` 1), which the port
refused before — against the JAX engine's greedy tokens.

Tolerance: float32, atol = rtol = 1e-5 — the plain version materializes the
scores and takes one softmax, the Pallas kernel runs an online softmax over
key tiles, so the two differ only in summation order.
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
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core import attention as jax_attn
from repro.core.calibration import AquaProjections as JaxProjections
from repro.kernels import ops as jax_ops
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import AquaConfig, CacheSpec, ServingConfig, reduced
from repro_torch.core import attention as attn
from repro_torch.core.calibration import AquaProjections
from repro_torch.kernels import ops
from repro_torch.serving import ContinuousBatchingEngine, poisson_trace

TOL = dict(atol=1e-5, rtol=1e-5)
TRACE = dict(mean_interarrival=2.0, prompt_lens=(5, 12, 20),
             max_new_tokens=8, vocab_size=128, seed=3)
SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=8, prompt_bucket=8)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (2, 4, 2, 32, 16, True, None),     # GQA group 2, causal
    (1, 4, 4, 32, 32, False, None),    # MHA, non-causal
    (2, 8, 2, 48, 16, True, 10),       # GQA group 4, causal window
    (1, 2, 1, 32, 16, False, 7),       # MQA, window without causal
    # RecurrentGemma's head dim 256 (the CUDA kernel's wide engine) and
    # one KV head, with and without its window
    (2, 4, 1, 32, 256, True, 12),
    (1, 4, 1, 32, 256, True, None),
])
def test_flash_plain_matches_jax(b, h, kv, s, d, causal, window):
    rng = np.random.default_rng(s + d + h)
    q, k, v = _randn(rng, b, h, s, d), _randn(rng, b, kv, s, d), \
        _randn(rng, b, kv, s, d)
    want = np.asarray(jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_blk=16, k_blk=16))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_refuses_a_window_below_one():
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(x, x, x, window=0)


@pytest.mark.parametrize("s,lengths", [(24, (24, 9)), (40, (13, 40))])
def test_flash_backend_valid_rows_match_dense_with_lengths(s, lengths):
    """The deliberate difference from JAX: bucket-padded admissions run
    the flash kernel; every row below its length is the dense result."""
    rng = np.random.default_rng(s)
    b, kvh, g, d = 2, 2, 2, 16
    qq, kk, v = (_randn(rng, b, s, kvh, g, d), _randn(rng, b, s, kvh, d),
                 _randn(rng, b, s, kvh, d))
    lens = np.array(lengths, np.int32)
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b").attention,
                               num_heads=kvh * g, num_kv_heads=kvh,
                               head_dim=d)
    tcfg = dataclasses.replace(reduced("qwen3-0.6b").attention,
                               num_heads=kvh * g, num_kv_heads=kvh,
                               head_dim=d)
    pos = np.arange(s, dtype=np.int32)
    want, _ = jax_attn.get_backend("dense-jnp").prefill(
        *map(jnp.asarray, (qq, kk, v)), cfg=jcfg, aqua=None,
        positions=jnp.asarray(pos), lengths=jnp.asarray(lens), causal=True)
    got, weights = attn.get_backend("flash").prefill(
        *map(torch.from_numpy, (qq, kk, v)), cfg=tcfg, aqua=None,
        positions=torch.from_numpy(pos), lengths=torch.from_numpy(lens),
        causal=True)
    assert weights is None
    valid = (pos[None, :] < lens[:, None])[:, :, None, None, None]
    np.testing.assert_allclose(got.numpy() * valid, np.asarray(want) * valid,
                               **TOL)
    # non-causal calls delegate to the dense reference, lengths and all
    want_nc, _ = jax_attn.get_backend("dense-jnp").prefill(
        *map(jnp.asarray, (qq, kk, v)), cfg=jcfg, aqua=None,
        positions=jnp.asarray(pos), lengths=jnp.asarray(lens), causal=False)
    got_nc, _ = attn.get_backend("flash").prefill(
        *map(torch.from_numpy, (qq, kk, v)), cfg=tcfg, aqua=None,
        positions=torch.from_numpy(pos), lengths=torch.from_numpy(lens),
        causal=False)
    np.testing.assert_allclose(got_nc.numpy(), np.asarray(want_nc), **TOL)


# ---------------------------------------------------------------------------
# The engine on flash: AQUA off, and per-dim AQUA (block_dims 1)
# ---------------------------------------------------------------------------


def _engines(aqua_kw, paged):
    """The JAX and the port engine on one reduced Qwen3 (JAX params carried
    over), AQUA off when ``aqua_kw`` is None."""
    jcfg = jax_reduced("qwen3-0.6b", d_model=128)
    tcfg = reduced("qwen3-0.6b", d_model=128)
    jproj = tproj = None
    if aqua_kw is not None:
        jcfg = dataclasses.replace(jcfg, aqua=JaxAquaConfig(**aqua_kw))
        tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(**aqua_kw))
        att = tcfg.attention
        proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
            (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
        )[0].astype(np.float32)
        jproj = JaxProjections(p=jnp.asarray(proj))
        tproj = AquaProjections(p=torch.from_numpy(proj))
    else:
        jcfg = dataclasses.replace(jcfg, aqua=None)
        tcfg = dataclasses.replace(tcfg, aqua=None)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jcache = JaxCacheSpec(page_size=8, prefix_sharing=False) if paged else None
    tcache = CacheSpec(page_size=8, prefix_sharing=False) if paged else None
    jeng = JaxEngine(jcfg, params, jproj,
                     serving=JaxServingConfig(cache=jcache, **SERVE))
    teng = ContinuousBatchingEngine(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        tproj, serving=ServingConfig(cache=tcache, **SERVE), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("aqua_kw", [None, {}], ids=["aqua-off",
                                                     "block-dims-1"])
def test_engine_greedy_tokens_match_jax(aqua_kw, paged):
    """``AquaConfig()`` (block_dims 1) raised in the port before; now its
    prefill runs flash on the masked q̂ and its decode the masked-dense
    core, as in JAX, and AQUA off runs flash prefill."""
    jeng, teng = _engines(aqua_kw, paged)
    want = jeng.run(jax_poisson_trace(6, **TRACE))
    got = teng.run(poisson_trace(6, **TRACE))
    assert teng.stats.decode_steps > 0
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid


def test_default_aqua_prefill_runs_flash_on_masked_q():
    """Per-dim selection: the block-sparse backend's prefill equals the
    masked-dense reference (JAX aqua-masked-dense) on the same input."""
    cfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=64),
                              aqua=AquaConfig())
    att = cfg.attention
    gen = torch.Generator().manual_seed(0)
    p = attn.init_attention_params(gen, cfg.d_model, att)
    x = torch.randn(2, 20, cfg.d_model, generator=gen)
    proj = torch.linalg.qr(torch.randn(att.num_kv_heads, att.head_dim,
                                       att.head_dim, generator=gen))[0]
    out = {}
    for name in ("aqua-block-sparse", "aqua-masked-dense"):
        a = dataclasses.replace(att, backend=name)
        out[name] = attn.prefill_attention(p, x, a, cfg.aqua, proj)
    torch.testing.assert_close(out["aqua-block-sparse"],
                               out["aqua-masked-dense"], **TOL)
