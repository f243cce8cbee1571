"""Cache policies of the port on a data x model mesh, on the CPU: int8
pools at both scale granularities, hierarchical AQUA over int8 pools, hot
residents, Danube's sliding window on bf16 and int8 pools, and hot
residents under H2O eviction.

The port's ranks run as threads (``launch.mesh.run_mesh_threads``). Each
case serves the same float32 params (``params_from_numpy``) on a 2x2 mesh
and holds every rank's greedy tokens to the JAX package's mesh engine on
2x2 of the forced host devices (``tests/conftest.py``), the port's
``dispatch_plan()`` to the JAX engine's field for field, and its mesh
fallback events to JAX's. The int8 scale updates are also held bit for
bit to one device's at the kvcache level.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import reduced as jax_reduced
from repro.core.calibration import identity_projections as jax_identity
from repro.launch.mesh import make_serving_mesh as jax_serving_mesh
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as port_base
from repro_torch.configs import reduced
from repro_torch.core import dispatch
from repro_torch.core import kvcache as kvc
from repro_torch.core.calibration import identity_projections
from repro_torch.distributed.layout import MeshLayout
from repro_torch.launch.mesh import run_mesh_threads
from repro_torch.serving import ContinuousBatchingEngine, Request

TIMEOUT = 120.0
KERNEL = "aqua-block-sparse"
SCFG = dict(max_lanes=4, max_seq=64, max_new_tokens=6, prompt_bucket=8)
AQUA = dict(k_ratio=0.5, block_dims=8, prefill_q_blk=16)

# case -> (arch, aqua, cache, quant, sparsity, prompt lengths)
CASES = {
    "int8_page_head": ("qwen3-0.6b", AQUA, dict(page_size=8),
                       dict(kv_dtype="int8"), None, (20, 40)),
    "int8_page": ("qwen3-0.6b", AQUA, dict(page_size=8),
                  dict(kv_dtype="int8", scale_granularity="page"), None,
                  (20, 40)),
    "hier_int8": ("qwen3-0.6b", AQUA,
                  dict(page_size=8, prefix_sharing=False),
                  dict(kv_dtype="int8"),
                  dict(page_keep_ratio=0.5, pin_recent_pages=1), (20, 40)),
    "hot_int8": ("qwen3-0.6b", AQUA, dict(page_size=8),
                 dict(kv_dtype="int8", hot_resident_fraction=0.5), None,
                 (20, 40)),
    "window_paged": ("h2o-danube-1.8b", AQUA, dict(page_size=8), None,
                     None, (20, 40)),
    "window_contiguous": ("h2o-danube-1.8b", AQUA, None, None, None,
                          (20, 40)),
    "window_int8": ("h2o-danube-1.8b", AQUA, dict(page_size=8),
                    dict(kv_dtype="int8", scale_granularity="page"), None,
                    (20, 40)),
    "h2o_hot_int8": ("qwen3-0.6b",
                     dict(k_ratio=0.75, h2o_ratio=0.5, block_dims=1),
                     dict(page_size=8),
                     dict(kv_dtype="int8", hot_resident_fraction=0.5), None,
                     (30, 50)),
}


@pytest.fixture(scope="module")
def archs():
    """arch -> (JAX cfg, JAX params, port cfg, port params), float32, the
    same weights; built once per module."""
    out = {}
    for arch in ("qwen3-0.6b", "h2o-danube-1.8b"):
        jcfg = dataclasses.replace(jax_reduced(arch), remat=False,
                                   dtype="float32")
        tcfg = dataclasses.replace(reduced(arch), remat=False,
                                   dtype="float32")
        params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        out[arch] = (jcfg, params, tcfg, params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    return out


def _serving(base, cache, quant, sparsity):
    kw = dict(SCFG)
    if cache is not None:
        kw["cache"] = base.CacheSpec(**cache)
    if quant is not None:
        kw["quant"] = base.QuantSpec(**quant)
    if sparsity is not None:
        kw["sparsity"] = base.SparsitySpec(**sparsity)
    return base.ServingConfig(**kw)


def _trace(lens, seed=1, n=4):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, tokens=rng.integers(
        0, 128, size=(int(rng.integers(*lens)),), dtype=np.int32),
                 max_new_tokens=SCFG["max_new_tokens"], arrival=float(i))
            for i in range(n)]


def _state(eng):
    st = eng.last_state.layers
    return {f.name: getattr(st, f.name).clone()
            for f in dataclasses.fields(st)
            if getattr(st, f.name) is not None}


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_on_2x2_matches_jax_mesh_engine(archs, case):
    arch, aqua, cache, quant, sparsity, lens = CASES[case]
    jcfg, params, tcfg, tparams = archs[arch]
    jcfg = dataclasses.replace(jcfg, aqua=jax_base.AquaConfig(**aqua))
    tcfg = dataclasses.replace(tcfg, aqua=port_base.AquaConfig(**aqua))
    a = tcfg.attention
    trace = _trace(lens)
    jeng = JaxEngine(jcfg, params,
                     jax_identity(tcfg.num_layers, a.num_kv_heads,
                                  a.head_dim),
                     serving=_serving(jax_base, cache, quant, sparsity),
                     backend=KERNEL, mesh=jax_serving_mesh((2, 2)))
    want = {u: list(o.tokens) for u, o in jeng.run(
        [JaxRequest(**r) for r in trace]).items()}
    tproj = identity_projections(tcfg.num_layers, a.num_kv_heads,
                                 a.head_dim, device="cpu")
    scfg = _serving(port_base, cache, quant, sparsity)

    def rank(mesh):
        eng = ContinuousBatchingEngine(
            tcfg, params_from_numpy(tparams, mesh.device, mesh=mesh), tproj,
            serving=scfg, backend=KERNEL, mesh=mesh)
        out = {u: list(o.tokens) for u, o in eng.run(
            [Request(**r) for r in trace]).items()}
        return (out, eng.mesh_fallback_events(), eng.dispatch_plan(),
                (mesh.axis_index("data"), _state(eng)))
    res = run_mesh_threads((2, 2), rank, timeout=TIMEOUT)
    assert all(r[0] == want for r in res)
    jplan = jeng.dispatch_plan()
    assert all(dataclasses.asdict(r[2]) == dataclasses.asdict(jplan)
               for r in res)
    assert all(r[1] == jeng.mesh_fallback_events() for r in res)
    plan = res[0][2]
    if quant is not None:
        assert plan.quantization == jplan.quantization != "none"
    if case in ("int8_page_head", "int8_page", "hier_int8"):
        # int8 without residents: the paged int8 kernel on shard-local
        # shapes, nothing falls back
        assert plan.mesh_native and res[0][1] == ()
    if case == "hier_int8":
        assert plan.token_sparsity == "hierarchical"
    if "hot" in case:
        assert dispatch.REASON_QUANT_RESIDENCY in plan.reasons
    if case.startswith("window"):
        assert dispatch.REASON_WINDOW in plan.reasons
    # model peers (same data index) hold one scale per page alike, and
    # every rank holds the same resident set
    states = {r[3][0]: [] for r in res}
    for r in res:
        states[r[3][0]].append(r[3][1])
    for peers in states.values():
        if quant is not None and quant.get("scale_granularity") == "page":
            assert torch.equal(peers[0]["k_scale"], peers[1]["k_scale"])
            assert torch.equal(peers[0]["v_scale"], peers[1]["v_scale"])
        if "hot_ids" in peers[0]:
            assert torch.equal(peers[0]["hot_ids"], peers[1]["hot_ids"])
    if "hot_ids" in res[0][3][1]:
        ids = [r[3][1]["hot_ids"] for r in res]
        assert all(torch.equal(i, ids[0]) for i in ids)
        assert (ids[0] >= 0).any()


def _pool_trace(cache, row_a, row_b, k, v, tp=None):
    """Admit two lanes (a graft of 12 and of 6 tokens), then three decode
    inserts; returns the cache."""
    req = kvc.init_attn_cache(1, k.shape[2], 16, k.shape[3], v.shape[3],
                              torch.float32, "cpu")
    for lane, row, n in ((0, row_a, 12), (1, row_b, 6)):
        req.k[0, :, :n] = k[lane, :n].transpose(0, 1)
        req.v[0, :, :n] = v[lane, :n].transpose(0, 1)
        req.positions[0, :n] = torch.arange(n, dtype=torch.int32)
        req.count[0] = n
        kvc.install_table_row(cache, lane, row)
        kvc.paged_graft(cache, req, lane, n, row, tp)
    for step in range(3):
        slot = cache.count.clone()
        # growing magnitudes: every insert grows its page's scale
        kvc.paged_insert(cache, slot, k[:, 12 + step] * (2.0 + step),
                         v[:, 12 + step] * (3.0 + step), tp=tp)
    return cache


def test_one_scale_per_page_grows_alike_on_every_rank(archs):
    """int8 pools with one scale per page on a 1x2 mesh (one KV head a
    rank): admission scales and decode's running scales take the amax over
    both ranks' heads, so each rank's ints are one device's ints of its
    head, and its scales one device's, bit for bit. With a scale per page
    and head no collective runs and the same holds."""
    tcfg = archs["qwen3-0.6b"][2]
    gen = torch.Generator().manual_seed(3)
    k = torch.randn(2, 16, 2, 8, generator=gen)
    v = torch.randn(2, 16, 2, 8, generator=gen)
    # head 1 runs larger, so the page amax is the other rank's head
    k[:, :, 1] *= 4.0
    row_a = torch.tensor([3, 5, -1, -1], dtype=torch.int32)
    row_b = torch.tensor([1, -1, -1, -1], dtype=torch.int32)
    for gran in ("page", "page_head"):
        def fresh(kv_heads):
            return kvc.init_paged_cache(
                2, kv_heads, 8, 4, 8, 8, 8, torch.float32, "cpu",
                kv_dtype="int8", scale_granularity=gran)
        whole = _pool_trace(fresh(2), row_a, row_b, k, v)

        def rank(mesh):
            tp = MeshLayout.build(tcfg, mesh)
            tp.scale_per_page = gran == "page"
            h = mesh.axis_index("model")
            got = _pool_trace(fresh(1), row_a, row_b, k[:, :, h:h + 1],
                              v[:, :, h:h + 1], tp)
            return h, got
        for h, got in run_mesh_threads((1, 2), rank, timeout=TIMEOUT):
            assert torch.equal(got.k_pool, whole.k_pool[:, h:h + 1])
            assert torch.equal(got.v_pool, whole.v_pool[:, h:h + 1])
            sl = slice(None) if gran == "page" else slice(h, h + 1)
            assert torch.equal(got.k_scale, whole.k_scale[:, sl])
            assert torch.equal(got.v_scale, whole.v_scale[:, sl])
