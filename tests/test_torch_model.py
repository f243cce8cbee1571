"""Dense model, attention helpers and KV caches of the port against the JAX
package, with the JAX params carried over by ``bridge.params_from_numpy``.

Tolerance: float32 logits within atol = 1e-4 (rtol 1e-4) — the same
arithmetic in another summation order through two layers and the
unembedding (observed differences are a few 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.core import attention as jax_attn
from repro.core import kvcache as jax_kv
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import AquaConfig, reduced
from repro_torch.core import attention as attn
from repro_torch.core import kvcache as kv
from repro_torch.models import build_model

TOL = dict(atol=1e-4, rtol=1e-4)
AQUA_KW = dict(k_ratio=0.75, prefill_q_blk=16)
BACKENDS = {  # port backend -> (JAX backend, block_dims or None = AQUA off)
    "dense": ("dense-jnp", None),
    "aqua-masked-dense": ("aqua-masked-dense", 8),
    "aqua-block-sparse": ("aqua-block-sparse", 8),
}


def _pair(arch, backend):
    jax_backend, bd = BACKENDS[backend]
    jcfg, tcfg = jax_reduced(arch, d_model=128), reduced(arch, d_model=128)
    jcfg = dataclasses.replace(
        jcfg, aqua=None if bd is None else JaxAquaConfig(
            block_dims=bd, prefill_k_blk=16, decode_seq_blk=16, **AQUA_KW),
        attention=dataclasses.replace(jcfg.attention, backend=jax_backend))
    tcfg = dataclasses.replace(
        tcfg, aqua=None if bd is None else AquaConfig(block_dims=bd,
                                                      **AQUA_KW),
        attention=dataclasses.replace(tcfg.attention, backend=backend))
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    proj = None
    if bd is not None:
        att = tcfg.attention
        proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
            (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
        )[0].astype(np.float32)
    return jm, params, tm, tparams, proj


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3.1-8b"])
def test_logits_match_jax(arch, backend):
    jm, params, tm, tparams, proj = _pair(arch, backend)
    jp = None if proj is None else jnp.asarray(proj)
    tp = None if proj is None else torch.from_numpy(proj)
    toks = np.random.default_rng(2).integers(0, 128, (2, 20)).astype(np.int32)
    forward = jax.jit(lambda p, b, pr: jm.forward(p, b, aqua_proj=pr))
    prefill = jax.jit(lambda p, b, pr: jm.prefill(p, b, 32, aqua_proj=pr))
    step = jax.jit(lambda p, s, t, pr: jm.decode_step(p, s, t, aqua_proj=pr))
    with torch.no_grad():
        want = np.asarray(forward(params, {"tokens": jnp.asarray(toks)}, jp))
        got = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                         aqua_proj=tp).numpy()
        np.testing.assert_allclose(got, want, **TOL)

        lengths = np.array([20, 11], np.int32)
        lj, sj = prefill(params, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.asarray(lengths)}, jp)
        lt, st = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                      "lengths": torch.from_numpy(lengths)},
                            32, aqua_proj=tp)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for _ in range(8):
            tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
            lj, sj = step(params, sj, jnp.asarray(tok), jp)
            lt, st = tm.decode_step(tparams, st, torch.from_numpy(tok),
                                    aqua_proj=tp)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_array_equal(st.layers.positions.numpy(),
                                  np.asarray(sj.layers.positions))
    np.testing.assert_array_equal(st.layers.count.numpy(),
                                  np.asarray(sj.layers.count))


def test_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 2, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12]], np.int32)
    np.testing.assert_allclose(
        attn.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jax_attn.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        attn.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jax_attn.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5)


def test_resolve_backend_rules():
    """As the JAX package resolves where it prefers its kernels: ``auto``
    is the block-sparse kernels with AQUA on and flash with it off; dense
    is never chosen automatically."""
    aq = AquaConfig(block_dims=8)
    assert attn.resolve_backend("auto", aq).name == "aqua-block-sparse"
    assert attn.resolve_backend("auto", None).name == "flash"
    assert attn.resolve_backend("aqua-block-sparse", None).name == "flash"
    assert attn.resolve_backend("aqua-masked-dense", aq).name == \
        "aqua-masked-dense"
    assert attn.resolve_backend("flash", aq).name == "flash"
    assert attn.get_backend("aqua-block-sparse").per_dim.name == "flash"
    with pytest.raises(KeyError):
        attn.resolve_backend("flash-plain", aq)


def _insert_trace(rng, steps, b, kvh, d):
    """Per step: k, v (B, KV, D) and a write mask."""
    return [(rng.standard_normal((b, kvh, d)).astype(np.float32),
             rng.standard_normal((b, kvh, d)).astype(np.float32),
             rng.random(b) < 0.7) for _ in range(steps)]


def test_cache_inserts_match_jax_slot_for_slot():
    """Contiguous and paged inserts (write-masked) equal the JAX caches;
    the paged lane view equals the contiguous cache."""
    b, kvh, d, ps, npl = 3, 2, 8, 4, 4
    slots = ps * npl
    rng = np.random.default_rng(3)
    table = np.array([[5, 0, 9, -1], [1, 2, 3, 4], [7, -1, -1, -1]], np.int32)
    jc = jax_kv.init_attn_cache(b, kvh, slots, d, d, jnp.float32)
    jp = jax_kv.init_paged_cache(b, kvh, 10, npl, ps, d, d, jnp.float32)
    jp = dataclasses.replace(jp, page_table=jnp.asarray(table))
    tc = kv.init_attn_cache(b, kvh, slots, d, d, torch.float32, "cpu")
    tpc = kv.init_paged_cache(b, kvh, 10, npl, ps, d, d, torch.float32, "cpu")
    tpc.page_table.copy_(torch.from_numpy(table))
    for k_new, v_new, m in _insert_trace(rng, 14, b, kvh, d):
        jm = jnp.asarray(m)
        jc = jax_kv.insert(jc, jax_kv.select_slot(jc, window=None, h2o=False,
                                                  recent_len=0),
                           jnp.asarray(k_new), jnp.asarray(v_new),
                           write_mask=jm)
        jslot, _ = jax_kv.paged_select_slot(jp, window=None, h2o=False,
                                            recent_len=0)
        jp = jax_kv.paged_insert(jp, jslot, jnp.asarray(k_new),
                                 jnp.asarray(v_new), write_mask=jm)
        tk, tv, tm = map(torch.from_numpy, (k_new, v_new, m))
        kv.insert(tc, kv.select_slot(tc), tk, tv, write_mask=tm)
        kv.paged_insert(tpc, kv.paged_select_slot(tpc)[0], tk, tv,
                        write_mask=tm)
    for name in ("k", "v", "positions", "count"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    for name in ("k_pool", "v_pool", "pos_pool", "count"):
        np.testing.assert_array_equal(getattr(tpc, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    view, jview = kv.paged_lane_view(tpc), jax_kv.paged_lane_view(jp)
    for name in ("k", "v", "positions"):
        np.testing.assert_array_equal(getattr(view, name).numpy(),
                                      np.asarray(getattr(jview, name)))


def test_paged_graft_and_reset_match_jax():
    b, kvh, d, ps, npl = 2, 2, 8, 4, 4
    rng = np.random.default_rng(4)
    req_k = rng.standard_normal((1, kvh, ps * npl, d)).astype(np.float32)
    req_v = rng.standard_normal((1, kvh, ps * npl, d)).astype(np.float32)
    pos = np.where(np.arange(ps * npl) < 10, np.arange(ps * npl), -1)[None]
    table = np.array([[3, 6, 1, -1], [0, 2, -1, -1]], np.int32)
    jreq = jax_kv.AttnCache(k=jnp.asarray(req_k), v=jnp.asarray(req_v),
                            positions=jnp.asarray(pos, jnp.int32),
                            count=jnp.asarray([9], jnp.int32),
                            acc_score=jnp.zeros((1, kvh, ps * npl)))
    treq = kv.AttnCache(k=torch.from_numpy(req_k), v=torch.from_numpy(req_v),
                        positions=torch.from_numpy(pos.astype(np.int32)),
                        count=torch.tensor([9], dtype=torch.int32))
    jp = jax_kv.init_paged_cache(b, kvh, 8, npl, ps, d, d, jnp.float32)
    jp = dataclasses.replace(jp, page_table=jnp.asarray(table),
                             pos_pool=jnp.full((8, ps), 5, jnp.int32))
    tpc = kv.init_paged_cache(b, kvh, 8, npl, ps, d, d, torch.float32, "cpu")
    tpc.page_table.copy_(torch.from_numpy(table))
    tpc.pos_pool.fill_(5)       # a previous tenant's stale positions
    jp = jax_kv.paged_graft(jp, jreq, 0, 12)
    kv.paged_graft(tpc, treq, 0, 12, tpc.page_table[0])
    for name in ("k_pool", "v_pool", "pos_pool", "count"):
        np.testing.assert_array_equal(getattr(tpc, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    jp = jax_kv.paged_reset_lane(jp, 1)
    kv.paged_reset_lane(tpc, 1)
    for name in ("pos_pool", "page_table", "count"):
        np.testing.assert_array_equal(getattr(tpc, name).numpy(),
                                      np.asarray(getattr(jp, name)))


def test_tree_bytes_counts_every_cache_tensor():
    c = kv.init_paged_cache(4, 2, 10, 3, 8, 16, 16, torch.bfloat16, "meta",
                            num_layers=2)
    # per layer: k/v pools, positions, accumulated scores, table, count
    want = 2 * (2 * 10 * 2 * 8 * 16 * 2 + 10 * 8 * 4 + 10 * 2 * 8 * 4
                + 4 * 3 * 4 + 4 * 4)
    assert kv.tree_bytes(c) == want
