"""The port's continuous-batching engine on a data x model mesh against the
JAX package's engine on its 8 forced CPU devices (``tests/conftest.py``).

The port's ranks run as threads of this process, each with its own mesh
over gloo and one ``HashStore`` (``launch.mesh.run_mesh_threads``): no
process is spawned, and a rank's failure or a hang fails the test within
the collectives' timeout. Both sides serve ``reduced("qwen3-0.6b")`` in
float32 on the same params. Each case holds every rank's outputs equal
(the ranks run in lockstep) and to JAX's tokens where JAX's own mesh tests
hold token identity (``tests/test_sharded_serving.py``,
``tests/test_mesh_kernels.py``); MQA and temperature > 0 are held, as in
JAX, to placement independence on the same mesh. JAX's tokens are
computed once per module.
"""
import dataclasses
import logging

import jax
import numpy as np
import pytest

from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core import dispatch as jax_dispatch
from repro.core.calibration import identity_projections as jax_identity
from repro.launch.mesh import make_serving_mesh as jax_serving_mesh
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, ServingConfig,
                                 reduced)
from repro_torch.core import dispatch
from repro_torch.core.calibration import identity_projections
from repro_torch.launch.mesh import run_mesh_threads
from repro_torch.serving import ContinuousBatchingEngine, Request
from repro_torch.serving.scheduler import LaneScheduler

KERNEL = "aqua-block-sparse"
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params): reduced Qwen3 in
    float32, the same weights."""
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), remat=False,
                               dtype="float32")
    tcfg = dataclasses.replace(reduced("qwen3-0.6b"), remat=False,
                               dtype="float32")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, params, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _aqua(models, k_ratio=0.5, block_dims=8, h2o=1.0):
    jcfg, params, tcfg, tparams = models
    kw = dict(k_ratio=k_ratio, block_dims=block_dims, h2o_ratio=h2o)
    jcfg = dataclasses.replace(jcfg, aqua=JaxAquaConfig(**kw))
    tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(**kw))
    att = tcfg.attention
    jproj = jax_identity(tcfg.num_layers, att.num_kv_heads, att.head_dim)
    tproj = identity_projections(tcfg.num_layers, att.num_kv_heads,
                                 att.head_dim, device="cpu")
    return jcfg, params, jproj, tcfg, tparams, tproj


def _trace(num, max_new, seed, vocab=128):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, tokens=rng.integers(0, vocab,
                                            size=(int(rng.integers(4, 22)),),
                                            dtype=np.int32),
                 max_new_tokens=max_new, arrival=float(i) * 1.5)
            for i in range(num)]


def _prefix_trace(seed=6, vocab=128):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, size=(8,), dtype=np.int32)
    return [dict(uid=i, tokens=np.concatenate(
        [pre, rng.integers(0, vocab, size=(4 + i,), dtype=np.int32)]),
                 max_new_tokens=5, arrival=float(i) * 1.5)
            for i in range(4)]


def _jax_run(jcfg, params, jproj, scfg, trace, backend, mesh_shape=None):
    mesh = None if mesh_shape is None else jax_serving_mesh(mesh_shape)
    eng = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(**scfg),
                    backend=backend, mesh=mesh)
    outs = eng.run([JaxRequest(**r) for r in trace])
    if mesh is not None:
        assert eng.mesh_fallback_events() == ()
    return {u: list(o.tokens) for u, o in outs.items()}


def _place(tparams, mesh):
    """The rank's blocks of ``tparams``, cut on the host."""
    return params_from_numpy(tparams, mesh.device, mesh=mesh)


def _port_run(shape, tcfg, tparams, tproj, scfg, trace, backend, probe=None):
    """Serve ``trace`` on every rank of a ``shape`` mesh (threads); returns
    each rank's (tokens by uid, fallback events, plan, probe(engine))."""
    def rank(mesh):
        eng = ContinuousBatchingEngine(tcfg, _place(tparams, mesh), tproj,
                                       serving=ServingConfig(**scfg),
                                       backend=backend, mesh=mesh)
        outs = eng.run([Request(**r) for r in trace])
        return ({u: list(o.tokens) for u, o in outs.items()},
                eng.mesh_fallback_events(), eng.dispatch_plan(),
                None if probe is None else probe(eng))
    return run_mesh_threads(shape, rank, timeout=TIMEOUT)


def _lockstep(results):
    """Every rank's tokens are the same; returns them."""
    first = results[0][0]
    for r in results[1:]:
        assert r[0] == first
    return first


SCFG = dict(max_lanes=4, max_seq=64, max_new_tokens=6, prompt_bucket=8)
PAGED = dict(SCFG, cache=CacheSpec(page_size=8, num_pages=32))
JAX_PAGED = dict(SCFG, cache=JaxCacheSpec(page_size=8, num_pages=32))


@pytest.mark.parametrize("policy", ["dense", "aqua-masked-dense"])
def test_staggered_traffic_on_4x2_matches_jax(models, policy):
    """JAX's ``test_staggered_equivalence_on_8_device_mesh``: staggered
    arrivals on a 4x2 mesh, the port's tokens equal the JAX mesh
    engine's."""
    jcfg, params, tcfg, tparams = models
    jproj = tproj = None
    if policy == "aqua-masked-dense":
        jcfg, params, jproj, tcfg, tparams, tproj = _aqua(
            models, k_ratio=0.75, block_dims=1)
    trace = _trace(4, 6, seed=0)
    want = _jax_run(jcfg, params, jproj, SCFG, trace,
                    "dense-jnp" if policy == "dense" else policy, (4, 2))
    res = _port_run((4, 2), tcfg, tparams, tproj, SCFG, trace, policy,
                    probe=lambda e: e.stats.mean_occupancy)
    assert _lockstep(res) == want
    assert res[0][3] > 1.0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_kernel_path_on_2x2_matches_jax(models, layout):
    """The block-sparse kernels (their plain versions here) on shard-local
    shapes: a mesh-native plan, no fallback, JAX's mesh engine's tokens;
    each rank holds its lanes (4 / 2) and KV heads (2 / 2) with the slot
    axis whole, and a paged pool whole over data."""
    jcfg, params, jproj, tcfg, tparams, tproj = _aqua(models)
    trace = _trace(4, 6, seed=5)
    paged = layout == "paged"
    want = _jax_run(jcfg, params, jproj, JAX_PAGED if paged else SCFG,
                    trace, KERNEL, (2, 2))

    def layout_of(eng):
        st = eng.last_state.layers
        return (tuple(st.k_pool.shape), tuple(st.page_table.shape)) \
            if paged else tuple(st.k.shape)
    res = _port_run((2, 2), tcfg, tparams, tproj, PAGED if paged else SCFG,
                    trace, KERNEL, probe=layout_of)
    assert _lockstep(res) == want
    assert all(r[1] == () for r in res)
    assert all(r[2].mesh_native for r in res)
    L, S = tcfg.num_layers, SCFG["max_seq"]
    if paged:
        assert res[0][3] == ((L, 32, 1, 8, 16), (L, 2, 8))
    else:
        assert res[0][3] == (L, 2, 1, S, 16)


def test_prefix_shared_lanes_on_2x2_match_jax(models):
    """Prefix-shared admissions on the mesh (every data rank writes its
    replica of the pool, the owner installs the lane's row) decode
    through the kernel path with JAX's tokens."""
    jcfg, params, jproj, tcfg, tparams, tproj = _aqua(models)
    trace = _prefix_trace()
    want = _jax_run(jcfg, params, jproj, JAX_PAGED, trace, KERNEL, (2, 2))
    res = _port_run((2, 2), tcfg, tparams, tproj, PAGED, trace, KERNEL,
                    probe=lambda e: e.page_pool.prefix_hits)
    assert _lockstep(res) == want
    assert all(r[1] == () for r in res)
    assert res[0][2].mesh_native and res[0][2].prefix_sharing
    assert all(r[3] >= 1 for r in res)


def test_mqa_serves_the_kernels_placement_independently(models):
    """MQA (one KV head): the head axis replicates, the query groups and
    head_dim shard over ``model`` (k and v all-gathered after the
    projection), lanes over data; the plan is mesh-native, nothing falls
    back, the cache keeps the one head whole, and each request served
    alone on the same mesh gives the same tokens (JAX's
    ``test_mqa_kernel_under_mesh``)."""
    jcfg, params, _, tcfg, _, _ = _aqua(models)
    jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
        jcfg.attention, num_kv_heads=1))
    tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(
        tcfg.attention, num_kv_heads=1))
    mparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, mparams), "cpu")
    tproj = identity_projections(tcfg.num_layers, 1,
                                 tcfg.attention.head_dim, device="cpu")
    scfg = dict(SCFG, max_new_tokens=4)
    trace = _trace(3, 4, seed=3)

    def rank(mesh):
        def serve(reqs):
            eng = ContinuousBatchingEngine(tcfg, _place(tparams, mesh), tproj,
                                           serving=ServingConfig(**scfg),
                                           backend=KERNEL, mesh=mesh)
            outs = eng.run([Request(**r) for r in reqs])
            return eng, {u: list(o.tokens) for u, o in outs.items()}
        eng, batched = serve(trace)
        solo = {}
        for r in trace:
            solo.update(serve([dict(r, arrival=0.0)])[1])
        return (batched, eng.mesh_fallback_events(), eng.dispatch_plan(),
                (solo, tuple(eng.last_state.layers.k.shape),
                 eng.layout.heads, eng.layout.gather_kv))
    res = run_mesh_threads((2, 2), rank, timeout=TIMEOUT)
    batched = _lockstep(res)
    solo, k_shape, heads, gather = res[0][3]
    assert batched == solo
    assert all(r[1] == () and r[2].mesh_native for r in res)
    assert (heads, gather) == ("group", True)
    assert k_shape == (tcfg.num_layers, 2, 1, SCFG["max_seq"], 16)


def test_temperature_sampling_is_placement_independent(models):
    """temperature > 0 on the mesh: the noise is seeded per (serve,
    request, token), so a request samples the same tokens beside
    co-tenants and alone on the same mesh (JAX's
    ``test_sampling_is_lane_placement_independent_on_mesh``)."""
    _, _, tcfg, tparams = models
    scfg = dict(SCFG, max_new_tokens=5)
    trace = [dict(r, temperature=1.0) for r in _trace(2, 5, seed=2)]

    def rank(mesh):
        def serve(reqs):
            eng = ContinuousBatchingEngine(tcfg, _place(tparams, mesh), None,
                                           serving=ServingConfig(**scfg),
                                           backend="dense", mesh=mesh)
            return {u: list(o.tokens) for u, o in eng.run(
                [Request(**r) for r in reqs]).items()}
        batched = serve(trace)
        solo = {}
        for r in trace:
            solo.update(serve([dict(r, arrival=0.0)]))
        return batched, (), None, solo
    res = run_mesh_threads((4, 2), rank, timeout=TIMEOUT)
    assert _lockstep(res) == res[0][3]


@pytest.mark.parametrize("case", ["batch", "paged_batch", "page_geometry"])
def test_nondivisible_geometry_routes_to_the_reference(models, caplog, case):
    """Three lanes on two data shards (contiguous and paged), and 4-token
    pages: the plan names JAX's reason (equal to JAX's plan), each rank's
    engine records one decode fallback with it and warns once, the B=1
    admissions keep the prefill kernel, and every lane is served."""
    jcfg, params, jproj, tcfg, tparams, tproj = _aqua(models)
    scfg = dict(SCFG, max_new_tokens=4)
    jscfg = dict(scfg)
    if case == "batch":
        scfg["max_lanes"] = jscfg["max_lanes"] = 3
    elif case == "paged_batch":
        scfg.update(max_lanes=3, cache=CacheSpec(page_size=8, num_pages=24))
        jscfg.update(max_lanes=3,
                     cache=JaxCacheSpec(page_size=8, num_pages=24))
    else:
        scfg["cache"] = CacheSpec(page_size=4, num_pages=64)
        jscfg["cache"] = JaxCacheSpec(page_size=4, num_pages=64)
    reason = (dispatch.REASON_PAGE_GEOMETRY if case == "page_geometry"
              else dispatch.REASON_NONDIVISIBLE_MESH)
    jplan = jax_dispatch.resolve_dispatch_plan(
        attention=dataclasses.replace(jcfg.attention, backend=KERNEL),
        aqua=jcfg.aqua, serving=JaxServingConfig(**jscfg),
        mesh=jax_serving_mesh((2, 2)),
        prefix_sharing=case != "batch")
    trace = _trace(3, 4, seed=8)
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.attention"):
        res = _port_run((2, 2), tcfg, tparams, tproj, scfg, trace, KERNEL)
    _lockstep(res)
    for toks, events, plan, _ in res:
        assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
        assert plan.reasons == (reason,)
        assert events == ((KERNEL, "decode", reason),)
        assert all(len(t) == 4 for t in toks.values())
    warns = [r for r in caplog.records if "falling back" in r.message]
    assert len(warns) == 4           # once per rank's engine
    assert all("decode" in w.getMessage() and KERNEL in w.getMessage()
               for w in warns)


def test_lane_order_interleaves_across_data_shards(models):
    """Eight lanes on a data=4 mesh: assignment prefers 0, 2, 4, 6, then
    1, 3, 5, 7 (JAX's ``test_lane_assignment_interleaves_across_data_
    shards``); each rank holds its two lanes."""
    _, _, tcfg, tparams = models

    def rank(mesh):
        eng = ContinuousBatchingEngine(
            tcfg, _place(tparams, mesh), None, serving=ServingConfig(
                max_lanes=8, max_seq=32, max_new_tokens=2), mesh=mesh)
        return eng._lane_order, eng._lane_lo, eng._local_lanes
    res = run_mesh_threads((4, 2), rank, timeout=TIMEOUT)
    assert all(r[0] == [0, 2, 4, 6, 1, 3, 5, 7] for r in res)
    assert [r[1] for r in res] == [0, 0, 2, 2, 4, 4, 6, 6]
    sched = LaneScheduler(8, lane_order=res[0][0])
    lanes = [sched.assign(Request(uid=i, tokens=np.zeros((2,), np.int32)))
             for i in range(4)]
    assert lanes == [0, 2, 4, 6]
    with pytest.raises(AssertionError):
        LaneScheduler(4, lane_order=[0, 1, 1, 2])
