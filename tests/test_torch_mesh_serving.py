"""Serving policies of the port on a mesh, on the CPU: chunked prefill,
H2O, hierarchical AQUA, pod and one-axis meshes, params placed on the
host, what a mesh refused until it was served (int8 pools with hot
residents, a sliding window, MoE: now held to JAX's mesh engine), and
what the engine still refuses on a mesh (encdec, ssm, hybrid).

The port's ranks run as threads (``launch.mesh.run_mesh_threads``). The
chunked and H2O drives hold JAX's tokens (its single-device engine for
chunked prefill, which JAX's ``test_chunked_token_identity_mesh2x2``
holds equal to its mesh engine; its mesh engine for H2O, as
``test_h2o_equivalence_on_mesh``); the others hold the port's
single-device engine's tokens, which the port's own tests hold to JAX.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import QuantSpec as JaxQuantSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core.calibration import identity_projections as jax_identity
from repro.launch.mesh import make_serving_mesh as jax_serving_mesh
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, SparsitySpec, reduced)
from repro_torch.core.calibration import identity_projections
from repro_torch.launch.mesh import run_mesh_threads
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, Request

TIMEOUT = 120.0
KERNEL = "aqua-block-sparse"


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), remat=False,
                               dtype="float32")
    tcfg = dataclasses.replace(reduced("qwen3-0.6b"), remat=False,
                               dtype="float32")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, params, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _with_aqua(models, **kw):
    jcfg, params, tcfg, tparams = models
    jcfg = dataclasses.replace(jcfg, aqua=JaxAquaConfig(**kw))
    tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(**kw))
    att = tcfg.attention
    return (jcfg, params,
            jax_identity(tcfg.num_layers, att.num_kv_heads, att.head_dim),
            tcfg, tparams,
            identity_projections(tcfg.num_layers, att.num_kv_heads,
                                 att.head_dim, device="cpu"))


def _trace(n, max_new, seed, lo=4, hi=22, gap=1.5):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, tokens=rng.integers(0, 128,
                                            size=(int(rng.integers(lo, hi)),),
                                            dtype=np.int32),
                 max_new_tokens=max_new, arrival=float(i) * gap)
            for i in range(n)]


def _tokens(outs):
    return {u: list(o.tokens) for u, o in outs.items()}


def _serve_mesh(shape, tcfg, tparams, tproj, scfg, trace, backend,
                probe=None):
    """Every rank's (tokens, fallback events, plan, probe(engine)); the
    ranks' tokens are checked equal here (lockstep)."""
    def rank(mesh):
        eng = ContinuousBatchingEngine(
            tcfg, params_from_numpy(tparams, mesh.device, mesh=mesh), tproj,
            serving=scfg, backend=backend, mesh=mesh)
        out = _tokens(eng.run([Request(**r) for r in trace]))
        return (out, eng.mesh_fallback_events(), eng.dispatch_plan(),
                None if probe is None else probe(eng))
    res = run_mesh_threads(shape, rank, timeout=TIMEOUT)
    assert all(r[0] == res[0][0] for r in res)
    return res


def _serve_solo(tcfg, tparams, tproj, scfg, trace, backend):
    eng = ContinuousBatchingEngine(tcfg, tparams, tproj, serving=scfg,
                                   backend=backend, device="cpu")
    return _tokens(eng.run([Request(**r) for r in trace]))


CHUNK_POLICIES = {
    "dense": dict(aqua=None, jax_backend="dense-jnp"),
    KERNEL: dict(aqua=dict(k_ratio=0.5, block_dims=8, prefill_q_blk=16),
                 jax_backend=KERNEL),
}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("policy", sorted(CHUNK_POLICIES))
def test_chunked_prefill_on_2x2_matches_monolithic_and_jax(models, policy,
                                                           layout):
    """Budget 16 under every padded prompt: admissions really chunk on the
    mesh (contiguous: the lane's data rank writes the chunks; paged: every
    data rank writes its pool replica through the lane's row), and the
    tokens equal monolithic admission's on the mesh and JAX's."""
    spec = CHUNK_POLICIES[policy]
    if spec["aqua"] is None:
        jcfg, params, tcfg, tparams = models
        jproj = tproj = None
    else:
        jcfg, params, jproj, tcfg, tparams, tproj = _with_aqua(
            models, **spec["aqua"])
    paged = layout == "paged"
    base = dict(max_lanes=4, max_seq=96, max_new_tokens=6, prompt_bucket=8)
    jscfg = JaxServingConfig(**base, cache=JaxCacheSpec(
        page_size=8, num_pages=48) if paged else None)
    scfg = ServingConfig(**base, cache=CacheSpec(
        page_size=8, num_pages=48) if paged else None)
    trace = _trace(5, 6, seed=3, lo=20, hi=60, gap=0.25)
    want = _tokens(JaxEngine(jcfg, params, jproj, serving=jscfg,
                             backend=spec["jax_backend"]).run(
        [JaxRequest(**r) for r in trace]))
    chunked = dataclasses.replace(scfg, prefill_budget_tokens=16)
    mono = _serve_mesh((2, 2), tcfg, tparams, tproj, scfg, trace, policy)
    res = _serve_mesh((2, 2), tcfg, tparams, tproj, chunked, trace, policy,
                      probe=lambda e: (e.stats.chunked_admissions,
                                       e.stats.prefill_chunks))
    assert res[0][0] == mono[0][0] == want
    plan = res[0][2]
    assert plan.chunked_prefill
    assert plan.mesh_native == (policy == KERNEL)
    assert all(r[1] == () for r in res)
    admissions, chunks = res[0][3]
    assert admissions == len(trace) and chunks > admissions


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_h2o_on_2x2_matches_jax(models, layout):
    """H2O eviction on the mesh: the victim scores sum every rank's KV
    heads; JAX's mesh engine's tokens (contiguous, as
    ``test_h2o_equivalence_on_mesh``; paged against the port's one-device
    paged engine, whose tokens the port's own tests hold to JAX)."""
    jcfg, params, jproj, tcfg, tparams, tproj = _with_aqua(
        models, k_ratio=0.75, h2o_ratio=0.5, block_dims=1)
    base = dict(max_lanes=4, max_seq=64, max_new_tokens=5, prompt_bucket=8)
    trace = _trace(3, 5, seed=1, lo=30, hi=50)
    backend = "aqua-masked-dense"
    if layout == "contiguous":
        want = _tokens(JaxEngine(
            jcfg, params, jproj, serving=JaxServingConfig(**base),
            backend=backend, mesh=jax_serving_mesh((2, 2))).run(
            [JaxRequest(**r) for r in trace]))
        scfg = ServingConfig(**base)
    else:
        scfg = ServingConfig(**base, cache=CacheSpec(page_size=8))
        want = _serve_solo(tcfg, tparams, tproj, scfg, trace, backend)
    res = _serve_mesh((2, 2), tcfg, tparams, tproj, scfg, trace, backend,
                      probe=lambda e: e.eviction)
    assert res[0][0] == want
    assert res[0][3] == "h2o"


def test_hierarchical_on_2x2_matches_one_device(models):
    """Hierarchical AQUA (half the pages participate) through the paged
    kernel path on the mesh: the page ranking sums every rank's heads, and
    the tokens equal the port's one-device hierarchical engine's."""
    _, _, _, tcfg, tparams, tproj = _with_aqua(models, k_ratio=0.5,
                                               block_dims=8)
    scfg = ServingConfig(max_lanes=4, max_seq=64, max_new_tokens=8,
                         prompt_bucket=8,
                         cache=CacheSpec(page_size=8, prefix_sharing=False),
                         sparsity=SparsitySpec(page_keep_ratio=0.5,
                                               pin_recent_pages=1))
    trace = _trace(4, 8, seed=4, lo=30, hi=50)
    want = _serve_solo(tcfg, tparams, tproj, scfg, trace, KERNEL)
    res = _serve_mesh((2, 2), tcfg, tparams, tproj, scfg, trace, KERNEL,
                      probe=lambda e: e.kept_pages)
    assert res[0][0] == want
    assert res[0][2].token_sparsity == "hierarchical" and res[0][2].mesh_native
    assert res[0][3] is not None
    assert all(r[1] == () for r in res)


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 1), (1, 2)])
def test_pod_and_one_axis_meshes_match_one_device(models, shape):
    """A pod x data x model mesh (lanes over pod x data), a data-only mesh
    and a model-only mesh serve the paged kernel path with the one-device
    engine's tokens."""
    _, _, _, tcfg, tparams, tproj = _with_aqua(models, k_ratio=0.5,
                                               block_dims=8)
    scfg = ServingConfig(max_lanes=4, max_seq=64, max_new_tokens=5,
                         prompt_bucket=8, cache=CacheSpec(page_size=8))
    trace = _trace(4, 5, seed=7)
    want = _serve_solo(tcfg, tparams, tproj, scfg, trace, KERNEL)
    res = _serve_mesh(shape, tcfg, tparams, tproj, scfg, trace, KERNEL)
    assert res[0][0] == want
    assert all(r[1] == () and r[2].mesh_native for r in res)


def test_blocks_placed_on_the_host_serve_the_same(models):
    """Params placed by ``params_from_numpy(mesh=)`` (each rank's blocks
    cut on the host before they reach the device), from numpy arrays and
    from host tensors alike, serve as the whole params do on one device;
    whole params are refused on a mesh (placement has one path)."""
    jcfg, params, _, tcfg, tparams, tproj = _with_aqua(models, k_ratio=0.5,
                                                       block_dims=8)
    np_params = jax.tree.map(np.asarray, params)
    scfg = ServingConfig(max_lanes=4, max_seq=64, max_new_tokens=4,
                         prompt_bucket=8)
    trace = _trace(3, 4, seed=9)
    want = _tokens(ContinuousBatchingEngine(
        tcfg, tparams, tproj, serving=scfg, backend=KERNEL,
        device="cpu").run([Request(**r) for r in trace]))

    def rank(mesh):
        with pytest.raises(ValueError, match="block"):
            ContinuousBatchingEngine(tcfg, tparams, tproj, serving=scfg,
                                     backend=KERNEL, mesh=mesh)
        out = []
        for tree in (np_params, tparams):
            p = params_from_numpy(tree, "cpu", mesh=mesh)
            eng = ContinuousBatchingEngine(tcfg, p, tproj, serving=scfg,
                                           backend=KERNEL, mesh=mesh)
            out.append(_tokens(eng.run([Request(**r) for r in trace])))
        return out
    for from_numpy, from_tensors in run_mesh_threads((2, 2), rank,
                                                     timeout=TIMEOUT):
        assert from_numpy == from_tensors == want


def _refusal(cfg, params, scfg):
    def rank(mesh):
        with pytest.raises(NotImplementedError) as ei:
            ContinuousBatchingEngine(cfg, params, None, serving=scfg,
                                     mesh=mesh)
        return str(ei.value)
    return run_mesh_threads((1, 2), rank, timeout=TIMEOUT)[0]


def _served_like_jax(arch, scfg, jscfg):
    """A short trace of ``arch`` (reduced, float32, AQUA through the
    kernel backend) on a 1x2 mesh: every rank's tokens and plan against
    the JAX mesh engine's on the same params."""
    jcfg = dataclasses.replace(jax_reduced(arch), remat=False,
                               dtype="float32",
                               aqua=JaxAquaConfig(k_ratio=0.5, block_dims=8))
    tcfg = dataclasses.replace(reduced(arch), remat=False, dtype="float32",
                               aqua=AquaConfig(k_ratio=0.5, block_dims=8))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    a = tcfg.attention
    trace = _trace(3, 4, seed=11, lo=18, hi=28)
    jeng = JaxEngine(jcfg, params, jax_identity(
        tcfg.num_layers, a.num_kv_heads, a.head_dim), serving=jscfg,
        backend=KERNEL, mesh=jax_serving_mesh((1, 2)))
    want = _tokens(jeng.run([JaxRequest(**r) for r in trace]))
    res = _serve_mesh((1, 2), tcfg, tparams, identity_projections(
        tcfg.num_layers, a.num_kv_heads, a.head_dim, device="cpu"), scfg,
        trace, KERNEL)
    assert res[0][0] == want
    assert all(dataclasses.asdict(r[2]) == dataclasses.asdict(
        jeng.dispatch_plan()) for r in res)
    assert all(r[1] == jeng.mesh_fallback_events() for r in res)


@pytest.mark.parametrize("case,words", [
    ("int8", "int8 KV pools"),
    ("window", "sliding-window"),
    ("moe", "'moe' family"),
    ("encdec", "'encdec' family"),
    ("ssm", "'ssm' family"),
    ("hybrid", "'hybrid' family"),
])
def test_mesh_refuses_what_it_does_not_serve_yet(models, case, words):
    """What a mesh refused until it was served: int8 KV pools with hot
    residents, Danube's sliding window and the MoE family now serve on a
    1x2 mesh with the JAX mesh engine's tokens. The families whose decode
    state carries more than the slot cache (encdec, ssm, hybrid) are still
    refused, by name."""
    base = dict(max_lanes=2, max_seq=32, max_new_tokens=4, prompt_bucket=8)
    if case in ("int8", "window", "moe"):
        arch = {"int8": "qwen3-0.6b", "window": "h2o-danube-1.8b",
                "moe": "olmoe-1b-7b"}[case]
        quant = dict(kv_dtype="int8", hot_resident_fraction=0.5) \
            if case == "int8" else None
        _served_like_jax(
            arch, ServingConfig(**base, cache=CacheSpec(page_size=8),
                                quant=QuantSpec(**(quant or {}))),
            JaxServingConfig(**base, cache=JaxCacheSpec(page_size=8),
                             quant=JaxQuantSpec(**(quant or {}))))
        return
    arch = {"encdec": "whisper-tiny", "ssm": "mamba2-370m",
            "hybrid": "recurrentgemma-9b"}[case]
    tcfg = dataclasses.replace(reduced(arch), dtype="float32")
    tparams = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert words in _refusal(tcfg, tparams, ServingConfig(max_lanes=2,
                                                          max_seq=32))


def test_mesh_shape_must_match_the_mesh_and_needs_ranks(models):
    """``ServingConfig.mesh_shape`` names the mesh the engine serves on: a
    mesh of another shape raises; without a mesh and outside ``torchrun``
    (no RANK) the engine cannot make one and says how to start ranks."""
    _, _, tcfg, tparams = models

    def rank(mesh):
        with pytest.raises(ValueError, match="mesh_shape"):
            ContinuousBatchingEngine(
                tcfg, tparams, None, mesh=mesh, serving=ServingConfig(
                    max_lanes=2, max_seq=32, mesh_shape=(2, 2)))
        return True
    assert all(run_mesh_threads((1, 2), rank, timeout=TIMEOUT))
    with pytest.raises(RuntimeError, match="ranks"):
        ContinuousBatchingEngine(tcfg, tparams, None, device="cpu",
                                 serving=ServingConfig(max_lanes=2,
                                                       max_seq=32,
                                                       mesh_shape=(2, 2)))
