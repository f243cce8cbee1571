"""The port's mesh rules against the JAX package's, on the CPU.

* Sharding rules: ``param_pspec`` and ``decode_state_pspec`` of every
  param and decode-state leaf of every registered config at full width
  (shapes only: the port's on the meta device, JAX's through
  ``jax.eval_shape``) equal JAX's on the (2, 2), (4, 2), (2, 2, 2),
  (16, 16) and (2, 16, 16) meshes (JAX's side on an ``AbstractMesh``, as
  ``tests/test_sharding_rules.py`` builds it); the smaller rules too.
* Dispatch plans: field for field against JAX's ``resolve_dispatch_plan``
  on a mesh, over backends x layouts x ``block_dims`` x batch x page size.
* Placement: a mesh's blocks reassemble bitwise; ``params_from_numpy``
  with a mesh cuts on the host; the collectives; the thread runner
  re-raises a rank's failure and times out a stuck rank.
"""
import dataclasses
import itertools
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import runtime_flags
from repro.configs import get_config as jax_get_config
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import AttentionConfig as JaxAttentionConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.configs.base import SparsitySpec as JaxSparsitySpec
from repro.core import dispatch as jax_dispatch
from repro.distributed import sharding as jsh
from repro.launch.mesh import parse_mesh_spec as jax_parse_mesh_spec
from repro.models import build_model as jax_build_model
from repro.models.base import PagingSpec as JaxPagingSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (ALL_ARCHS, AquaConfig, AttentionConfig,
                                 CacheSpec, ServingConfig, SparsitySpec,
                                 get_config, reduced)
from repro_torch.core import dispatch
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as dsh
from repro_torch.distributed.layout import param_shapes
from repro_torch.launch.mesh import (make_local_mesh, parse_mesh_spec,
                                     run_mesh_threads)
from repro_torch.models import build_model
from repro_torch.models.base import PagingSpec


def _abstract_mesh(axes):
    try:
        return AbstractMesh(tuple(axes))
    except TypeError:
        return AbstractMesh(tuple(s for _, s in axes),
                            tuple(n for n, _ in axes))


MESHES = {
    "2x2": (("data", 2), ("model", 2)),
    "4x2": (("data", 4), ("model", 2)),
    "2x2x2": (("pod", 2), ("data", 2), ("model", 2)),
    "16x16": (("data", 16), ("model", 16)),
    "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
}


def _pair(name):
    axes = MESHES[name]
    return dict(axes), _abstract_mesh(axes)


def _canon(spec):
    """A spec with one-name tuples written as the name (JAX's
    ``PartitionSpec`` stores ("data",) as "data")."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jax_leaves(tree):
    return [(jsh.path_str(p), tuple(x.shape)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _port_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _port_leaves(v, path + (str(i),))]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _port_leaves(getattr(tree, f.name),
                                         path + (f.name,))]
    if tree is None:
        return []
    return [("/".join(path), tuple(tree.shape))]


@pytest.fixture(scope="module")
def param_trees():
    """{arch: (JAX leaves, port leaves)} at full width, shapes only."""
    out = {}
    for arch in ALL_ARCHS:
        jcfg = jax_get_config(arch)
        jtree = jax.eval_shape(
            lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
        out[arch] = (_jax_leaves(jtree),
                     _port_leaves(param_shapes(get_config(arch))))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_pspec_equals_jax_for_every_leaf(param_trees, mesh):
    port_mesh, jax_mesh = _pair(mesh)
    for arch, (jleaves, pleaves) in param_trees.items():
        assert sorted(jleaves) == sorted(pleaves), arch
        for path, shape in pleaves:
            want = jsh.param_pspec(tuple(jax.tree_util.DictKey(k)
                                         for k in path.split("/")),
                                   shape, jax_mesh)
            got = dsh.param_pspec(path, shape, port_mesh)
            assert _canon(got) == _canon(want), (arch, path, shape)


def _state_models(arch):
    """(JAX model, port model) pairs whose decode states hold every leaf
    kind of the arch: contiguous, and for the paged families paged with
    int8 pools and hot residents (page scales, hot overlay)."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    pairs = [(jax_build_model(jcfg), build_model(tcfg, "cpu"))]
    if jcfg.family in ("dense", "moe", "vlm"):
        jm, tm = jax_build_model(jcfg), build_model(tcfg, "cpu")
        jm.enable_paging(JaxPagingSpec(16, 32, kv_dtype="int8",
                                       hot_pages=4))
        tm.enable_paging(PagingSpec(16, 32, kv_dtype="int8", hot_pages=4))
        pairs.append((jm, tm))
    return pairs


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 8])
def test_decode_state_pspec_equals_jax_for_every_leaf(mesh, batch):
    """Leaf by leaf (by name and shape), with the kv / batch flags JAX's
    ``make_state_shardings`` derives, at both ``slot_absorb`` settings:
    the port serves ``slot_absorb=False``, JAX's kernel-native layout."""
    port_mesh, jax_mesh = _pair(mesh)
    max_seq = 64
    for arch in ALL_ARCHS:
        for jm, tm in _state_models(arch):
            jstate = jax.eval_shape(
                lambda: jm.init_decode_state(batch, max_seq))
            jleaves = {(p.split("/")[-1], s) for p, s in _jax_leaves(jstate)}
            pstate = tm.init_decode_state(batch, max_seq, device="meta")
            pleaves = {(p.split("/")[-1], s) for p, s in
                       _port_leaves(pstate)}
            # a leaf of the port is JAX's, or (the hybrid, whose state the
            # port stacks where JAX keeps a list per layer) JAX's stacked
            # on a leading layer axis; the port allocates no H2O scores
            # for a cache without H2O
            stacked = {(n, s) for n, s in pleaves if (n, s) not in jleaves}
            assert all((n, s[1:]) in jleaves for n, s in stacked), arch
            assert ({n for n, _ in jleaves}
                    - {n for n, _ in pleaves}) <= {"acc_score"}, arch
            att = tm.cfg.attention
            kvh = att.num_kv_heads if att is not None else 0
            kv_ok, b_ok = dsh.state_shardable(port_mesh, kv_heads=kvh,
                                              batch=batch)
            model = jax_mesh.shape.get("model", 1)
            assert kv_ok == (kvh > 0 and kvh % model == 0)
            assert b_ok == (batch % jsh._axis_size(
                jax_mesh, jsh.data_axes(jax_mesh)) == 0)
            for (name, shape), absorb in itertools.product(
                    sorted(pleaves), (False, True)):
                kw = dict(kv_shardable=kv_ok, batch_shardable=b_ok,
                          slot_absorb=absorb)
                lead = (None,) if (name, shape) in stacked else ()
                want = jsh.decode_state_pspec(
                    (jax.tree_util.GetAttrKey(name),), shape[len(lead):],
                    jax_mesh, **kw)
                got = dsh.decode_state_pspec(name, shape, port_mesh, **kw)
                assert _canon(got) == _canon(lead + tuple(want)), \
                    (arch, name, shape, absorb)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_lane_and_page_rank_rules_equal_jax(mesh):
    port_mesh, jax_mesh = _pair(mesh)
    for n in (1, 2, 3, 4, 8, 16, 32, 64):
        assert _canon(dsh.lane_pspec(port_mesh, n)) == \
            _canon(jsh.lane_pspec(jax_mesh, n))
        assert _canon(dsh.page_rank_pspec(port_mesh, n)) == \
            _canon(jsh.page_rank_pspec(jax_mesh, n))
        assert _canon(dsh.batch_pspec(port_mesh, (n, 7))) == \
            _canon(jsh.batch_pspec(jax_mesh, (n, 7)))
    assert dsh.data_axes(port_mesh) == jsh.data_axes(jax_mesh)
    for spec, shape in [(("data", "model"), (4, 6)),
                        ((("pod", "data"), None), (8, 3)),
                        (("model", None, "data"), (32, 2, 16)),
                        (("nope",), (4,))]:
        assert _canon(dsh.sanitize(spec, shape, port_mesh)) == _canon(
            jsh.sanitize(jax.sharding.PartitionSpec(*spec), shape,
                         jax_mesh))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_kernel_shardable_equals_jax(mesh):
    port_mesh, jax_mesh = _pair(mesh)
    for kvh, k_ratio, bd, batch, ps in itertools.product(
            (1, 2, 8), (0.5, 0.75, 0.9), (1, 8), (None, 1, 3, 4, 8, 32),
            (None, 4, 8, 64)):
        jatt = JaxAttentionConfig(num_heads=8, num_kv_heads=kvh,
                                  head_dim=64)
        att = AttentionConfig(num_heads=8, num_kv_heads=kvh, head_dim=64)
        for aq in (None, "on"):
            ja = None if aq is None else JaxAquaConfig(k_ratio=k_ratio,
                                                       block_dims=bd)
            pa = None if aq is None else AquaConfig(k_ratio=k_ratio,
                                                    block_dims=bd)
            assert dsh.kernel_shardable(port_mesh, att, pa, batch=batch,
                                        page_size=ps) == \
                jsh.kernel_shardable(jax_mesh, jatt, ja, batch=batch,
                                     page_size=ps)
    assert dsh.KERNEL_PAGE_MULTIPLE == jsh.KERNEL_PAGE_MULTIPLE
    assert not dsh.kernel_shardable(None, att)


@pytest.mark.parametrize("spec", ["", "1x1", "1", "4", "2x2", "4x2",
                                  "2x2x2", "2x16x16"])
def test_parse_mesh_spec_equals_jax(spec):
    assert parse_mesh_spec(spec) == jax_parse_mesh_spec(spec)


def test_parse_mesh_spec_refuses_four_dims():
    with pytest.raises(ValueError):
        parse_mesh_spec("2x2x2x2")


# ---------------------------------------------------------------------------
# Dispatch plans on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_kernels_preferred(monkeypatch):
    """JAX resolves ``auto`` and AQUA-off backends as on its chip, where
    it prefers the Pallas kernels; the port always resolves so."""
    monkeypatch.setattr(runtime_flags, "PALLAS_OVERRIDE", True)


@pytest.mark.parametrize("mesh", ["2x2", "4x2", "2x2x2"])
@pytest.mark.parametrize("backend", ["aqua-block-sparse", "aqua-masked-dense",
                                     "flash", "aqua-off"])
def test_dispatch_plan_on_a_mesh_matches_jax(jax_kernels_preferred, mesh,
                                            backend):
    """Every field, reason strings included and in JAX's order, over
    block_dims 1 / 8, contiguous / paged / hierarchical, batch (None:
    max_lanes) 1 / 3 / 4 / 8, page sizes 4 / 8 / 16, H2O on and off."""
    port_mesh, jax_mesh = _pair(mesh)
    on = backend != "aqua-off"
    be = "aqua-block-sparse" if backend == "aqua-off" else backend
    for bd, layout, batch, ps, h2o in itertools.product(
            (1, 8), ("contiguous", "paged", "hier"), (None, 1, 3, 4, 8),
            (4, 8, 16), (1.0, 0.5)):
        if layout == "contiguous" and ps != 8:
            continue

        def serving(cache, sparsity, serving_cls):
            return serving_cls(
                max_lanes=4, max_seq=64, prompt_bucket=8,
                cache=None if layout == "contiguous" else cache(
                    page_size=ps, prefix_sharing=False),
                sparsity=(sparsity(page_keep_ratio=0.5)
                          if layout == "hier" else None))
        aqua_kw = dict(k_ratio=0.5, block_dims=bd, h2o_ratio=h2o)
        jplan = jax_dispatch.resolve_dispatch_plan(
            attention=JaxAttentionConfig(num_heads=4, num_kv_heads=2,
                                         head_dim=32, backend=be),
            aqua=JaxAquaConfig(**aqua_kw) if on else None,
            serving=serving(JaxCacheSpec, JaxSparsitySpec, JaxServingConfig),
            mesh=jax_mesh, batch=batch)
        plan = dispatch.resolve_dispatch_plan(
            attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                      head_dim=32, backend=be),
            aqua=AquaConfig(**aqua_kw) if on else None,
            serving=serving(CacheSpec, SparsitySpec, ServingConfig),
            mesh=port_mesh, batch=batch)
        assert dataclasses.asdict(plan) == dataclasses.asdict(jplan), \
            (bd, layout, batch, ps, h2o)


def test_reason_constants_keep_jax_order():
    names = [n for n in vars(jax_dispatch) if n.startswith("REASON_")]
    assert [n for n in vars(dispatch) if n.startswith("REASON_")] == names
    for n in names:
        assert getattr(dispatch, n) == getattr(jax_dispatch, n), n


# ---------------------------------------------------------------------------
# Placement and collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 2, 2)])
def test_blocks_reassemble_bitwise(shape):
    """Every leaf of the reduced Qwen3's params, cut to each rank's block
    by ``param_pspec`` (torch and numpy alike), gathers back to the whole
    tensor bit for bit; ``params_from_numpy(mesh=)`` places the same
    blocks."""
    params = build_model(reduced("qwen3-0.6b"), "cpu").init(torch.Generator().manual_seed(3))
    flat = _port_leaves(params)

    def leaf(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return tree

    def rank(mesh):
        np_tree = jax.tree.map(lambda t: t.numpy(), params)
        placed = params_from_numpy(np_tree, "cpu", mesh=mesh)
        ok = []
        for path, shp in flat:
            full = leaf(params, path)
            spec = dsh.param_pspec(path, shp, mesh)
            block = dsh.shard(full, spec, mesh)
            assert block.is_contiguous()
            assert torch.equal(leaf(placed, path), block), path
            assert np.array_equal(dsh.shard(full.numpy(), spec, mesh),
                                  block.numpy())
            ok.append(torch.equal(dsh.unshard(block, spec, mesh), full))
        return all(ok), mesh.coord
    results = run_mesh_threads(shape, rank, timeout=60)
    assert all(r[0] for r in results)
    assert len({tuple(r[1].items()) for r in results}) == len(results)


def test_collectives_over_each_axis():
    def rank(mesh):
        t = torch.full((2,), float(mesh.rank), dtype=torch.float32)
        s = collectives.all_reduce(t.clone(), mesh, "model")
        mx = collectives.all_reduce(t.clone(), mesh, ("pod", "data"), "max")
        g = collectives.all_gather(torch.tensor([mesh.rank]), mesh,
                                   ("pod", "data"))
        b = collectives.all_reduce(t.clone().bfloat16(), mesh, "model")
        return s.tolist(), mx.tolist(), g.tolist(), b.float().tolist()
    out = run_mesh_threads((2, 2, 2), rank, timeout=60)
    for r, (s, mx, g, b) in enumerate(out):
        model_peer = r ^ 1
        assert s == [float(r + model_peer)] * 2 == b
        assert mx == [float(4 + 2 + (r & 1))] * 2
        assert g == [(r & 1) + 2 * i for i in range(4)]


def test_local_mesh_has_no_group():
    mesh = make_local_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group("model") is None and mesh.data_size() == 1
    t = torch.ones(3)
    assert collectives.all_reduce(t, mesh, "model") is t
    assert collectives.all_gather(t, mesh, "data") is t


def test_a_failed_rank_fails_the_run_at_once():
    def rank(mesh):
        if mesh.rank == 2:
            raise RuntimeError("rank 2 broke")
        collectives.all_reduce(torch.ones(1), mesh, "data")
        return mesh.rank
    with pytest.raises(RuntimeError, match="rank 2 broke"):
        run_mesh_threads((2, 2), rank, timeout=30)


def test_a_stuck_rank_times_out():
    release = threading.Event()

    def rank(mesh):
        if mesh.rank == 0:
            release.wait(10)
        return mesh.rank
    try:
        with pytest.raises(TimeoutError, match=r"\[0\]"):
            run_mesh_threads((2, 1), rank, timeout=0.5)
    finally:
        release.set()
