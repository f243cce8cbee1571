"""The ``moe`` and ``vlm`` families of the port on a mesh, on the CPU:
OLMoE and Qwen2-MoE (reduced) expert-parallel on 2x2, the expert-ff route
on a 1x4 mesh whose ``model`` axis does not divide the experts, the global
routing block of a decode step on a 4x1 data-only mesh, Pixtral with
patches on 2x2, and the launcher serving OLMoE on a 2x2 mesh.

The port's ranks run as threads (``launch.mesh.run_mesh_threads``); each
case holds every rank's greedy float32 tokens to the JAX package's mesh
engine on the forced host devices (``tests/conftest.py``) over the same
params (``params_from_numpy``), its ``dispatch_plan()`` to the JAX
engine's and its fallback events to JAX's (none).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

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
from repro_torch.core.calibration import identity_projections
from repro_torch.launch.mesh import run_mesh_threads
from repro_torch.models import moe as moe_lib
from repro_torch.serving import ContinuousBatchingEngine, Request

TIMEOUT = 120.0
KERNEL = "aqua-block-sparse"
SCFG = dict(max_lanes=4, max_seq=64, max_new_tokens=6, prompt_bucket=8)
AQUA = dict(k_ratio=0.5, block_dims=8, prefill_q_blk=16)


def _moe(**kw):
    def edit(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                **kw))
    return edit


def _models(arch, edit=None):
    """(JAX cfg, JAX params, port cfg, port params, JAX projections, port
    projections): float32 with AQUA, the same weights."""
    jcfg = dataclasses.replace(jax_reduced(arch), remat=False,
                               dtype="float32",
                               aqua=jax_base.AquaConfig(**AQUA))
    tcfg = dataclasses.replace(reduced(arch), remat=False, dtype="float32",
                               aqua=port_base.AquaConfig(**AQUA))
    if edit is not None:
        jcfg, tcfg = edit(jcfg), edit(tcfg)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    a = tcfg.attention
    return (jcfg, params, tcfg,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            jax_identity(tcfg.num_layers, a.num_kv_heads, a.head_dim),
            identity_projections(tcfg.num_layers, a.num_kv_heads,
                                 a.head_dim, device="cpu"))


def _trace(n, seed=1, lo=20, hi=40, extra=None):
    rng = np.random.default_rng(seed)
    out = [dict(uid=i, tokens=rng.integers(
        0, 128, size=(int(rng.integers(lo, hi)),), dtype=np.int32),
                max_new_tokens=SCFG["max_new_tokens"], arrival=float(i))
           for i in range(n)]
    for r in out:
        if extra is not None:
            r["extra_inputs"] = extra
    return out


def _serve(models, shape, trace, lanes=4, probe=None, tape=False):
    """JAX's mesh engine and the port's ranks on ``shape``, paged (8-token
    pages): asserts tokens, plans and fallback events equal; returns each
    rank's (tokens, events, plan, probe(engine), routing tape)."""
    jcfg, params, tcfg, tparams, jproj, tproj = models
    scfg = dict(SCFG, max_lanes=lanes)
    jeng = JaxEngine(jcfg, params, jproj, serving=jax_base.ServingConfig(
        **scfg, cache=jax_base.CacheSpec(page_size=8)), backend=KERNEL,
        mesh=jax_serving_mesh(shape))
    want = {u: list(o.tokens) for u, o in jeng.run(
        [JaxRequest(**r) for r in trace]).items()}
    serving = port_base.ServingConfig(
        **scfg, cache=port_base.CacheSpec(page_size=8))

    def rank(mesh):
        eng = ContinuousBatchingEngine(
            tcfg, params_from_numpy(tparams, mesh.device, mesh=mesh), tproj,
            serving=serving, backend=KERNEL, mesh=mesh)
        rt = None
        if tape:
            rt = moe_lib.RoutingTape(tcfg, eng.params["layers"]["ffn"][
                "router"], lanes=lanes, rows=64, mesh=mesh)
            rt.install("record")
        out = {u: list(o.tokens) for u, o in eng.run(
            [Request(**r) for r in trace]).items()}
        if rt is not None:
            rt.remove()
        return (out, eng.mesh_fallback_events(), eng.dispatch_plan(),
                None if probe is None else probe(eng), rt)
    res = run_mesh_threads(shape, rank, timeout=TIMEOUT)
    assert all(r[0] == want for r in res)
    jplan = jeng.dispatch_plan()
    assert all(dataclasses.asdict(r[2]) == dataclasses.asdict(jplan)
               for r in res)
    assert all(r[1] == jeng.mesh_fallback_events() == () for r in res)
    return res


def _moe_layout(eng):
    lay = eng.layout
    return (lay.experts, lay.expert_block, lay.w2_rows, lay.router_cols,
            lay.shared_tp, tuple(eng.params["layers"]["ffn"]["w1"].shape))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_expert_parallel_on_2x2_matches_jax(arch):
    """8 experts over model 2: each rank holds 4 experts' w1/w3 and half of
    every expert's w2 rows (f), the router's 4 columns; Qwen2-MoE's shared
    experts are row-parallel."""
    models = _models(arch)
    res = _serve(models, (2, 2), _trace(4), probe=_moe_layout)
    m = models[2].moe
    for r in res:
        experts, block, w2_rows, router, shared, w1 = r[3]
        assert experts == "ep" and block[1] == m.num_experts // 2
        assert w2_rows[1] == m.expert_ff // 2 and router[1] == 4
        assert shared == (m.num_shared > 0)
        assert w1 == (2, 4, 64, 64)
    assert res[0][2].mesh_native


def test_moe_expert_ff_route_where_model_does_not_divide_experts():
    """6 experts on a 1x4 mesh: the experts shard their hidden dim
    (expert-ff tensor parallelism), the router replicates."""
    models = _models("qwen2-moe-a2.7b", _moe(num_experts=6))
    res = _serve(models, (1, 4), _trace(4), probe=_moe_layout)
    for r in res:
        experts, block, w2_rows, router, _, w1 = r[3]
        assert (experts, block, router) == ("ff", None, None)
        assert w2_rows[1] == 16 and w1 == (2, 6, 64, 16)


def test_decode_routes_every_lane_as_one_block():
    """Eight lanes on a 4x1 data-only mesh (two a rank), capacity factor
    1.0: a decode step routes all eight lanes as one block, as one device
    does (capacity 3 a block of 8), and that block drops choices, where a
    rank routing its own two lanes (capacity 2) never could. The tokens are
    JAX's."""
    edit = _moe(capacity_factor=1.0)
    models = _models("qwen2-moe-a2.7b", edit)
    tcfg = models[2]
    assert moe_lib.capacity(tcfg, 2) >= 2 * 1      # per-rank: no drop
    res = _serve(models, (4, 1), _trace(8, seed=2), lanes=8, tape=True)
    for r in res:
        tape = r[4]
        steps = int(tape.calls[1])
        assert steps > 0
        kept = tape.kept[True][:steps * tcfg.num_layers]
        # every slot routed the whole batch of 8 lanes
        assert (tape.n[True][:steps * tcfg.num_layers] == 8).all()
        assert not bool(kept.all())                # the global block drops
    # every rank recorded the same routing
    first = res[0][4]
    for r in res[1:]:
        assert bool((r[4].topi[True] == first.topi[True]).all())
        assert bool((r[4].kept[True] == first.kept[True]).all())


def test_pixtral_with_patches_on_2x2_matches_jax():
    """Pixtral's patch embeddings (``patch_proj`` shards d_model over
    ``model``; the projected patches all-gathered before the splice) over
    the first positions of every prompt."""
    models = _models("pixtral-12b")
    n, dim = models[2].frontend.num_embeds, models[2].frontend.embed_dim
    patches = np.random.default_rng(0).standard_normal(
        (1, n, dim)).astype(np.float32)
    res = _serve(models, (2, 2), _trace(4, extra={"patches": patches}),
                 probe=lambda e: (e.layout.patch_cols,
                                  tuple(e.params["patch_proj"]["w"].shape)))
    assert all(r[3] == (True, (dim, models[2].d_model // 2)) for r in res)
    assert res[0][2].mesh_native


@pytest.mark.parametrize("extra,words", [
    ([], "token-identical to the single-device contiguous reference"),
    (["--page-size", "8", "--kv-dtype", "int8", "--expect-kernel-mesh"],
     "served the kernels on shard-local shapes of the mesh"),
])
def test_launcher_serves_olmoe_on_a_2x2_mesh(extra, words):
    """``launch.serve --arch olmoe-1b-7b --reduced --device cpu --mesh 2x2
    --verify`` spawns four ranks and holds every token to the single-device
    engine; on int8 pools the plan is mesh-native (``--expect-kernel-mesh``)
    and no kernel falls back."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--mesh", "2x2", "--block-dims", "8", "--requests", "4",
            "--steps", "8", "--verify", *extra]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *argv], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mesh 2x2 (data, model) over 4 ranks, collectives over gloo" \
        in proc.stdout
    assert "mesh-native True" in proc.stdout
    assert words in proc.stdout
    assert "[serve] verify: all 4 requests token-identical" in proc.stdout
