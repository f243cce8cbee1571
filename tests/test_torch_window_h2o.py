"""Sliding windows and H2O eviction in the port, against the JAX package.

The same inputs, made from numpy seeds, go through the JAX function and
the port's counterpart:

* the slot policies of ``core/kvcache.py`` (ring, H2O, window + H2O;
  contiguous and page-granular), exactly: the same slots, victims,
  positions, counts and accumulated scores (float32 sums of the same
  terms in the same order), and ``paged_select_slot`` against the numpy
  oracle ``h2o.reference_victim_page`` too;
* ``build_cache_from_prefill``'s ring and H2O branches (float32, 1e-5:
  the attention mass is summed in another order);
* the window form of the block-sparse prefill (plain version) against
  JAX's Pallas kernel in interpret mode, with ``q_offset`` and
  ``kc_part`` (float32, 1e-5: one softmax against an online softmax);
* the continuous-batching engine's greedy tokens on ``aqua-block-sparse``
  for reduced H2O-Danube-1.8B (window 16), reduced Qwen3-0.6B with
  ``h2o_ratio`` 0.5, and both at once, contiguous and paged: identical;
* ``dispatch_plan()`` against ``resolve_dispatch_plan(mesh=None)``, and a
  Danube bridge round trip (logits within 1e-4, as
  tests/test_torch_model.py holds the model's logits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime_flags
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import QuantSpec as JaxQuantSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core import attention as jax_attn
from repro.core import dispatch as jax_dispatch
from repro.core import h2o as jax_h2o
from repro.core import kvcache as jax_kv
from repro.core.aqua import chunk_topk_block_indices as jax_chunk_topk
from repro.core.calibration import AquaProjections as JaxProjections
from repro.kernels import ops as jax_ops
from repro.kernels.aqua_prefill import aqua_prefill_attention as jax_prefill
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, get_config, reduced)
from repro_torch.core import attention as attn
from repro_torch.core import h2o
from repro_torch.core import kvcache as kv
from repro_torch.core.calibration import AquaProjections
from repro_torch.core.dispatch import REASON_H2O, REASON_WINDOW
from repro_torch.kernels import aqua_prefill as pk
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, Request

TOL = dict(atol=1e-5, rtol=1e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Slot policies
# ---------------------------------------------------------------------------

# (window, h2o): ring, H2O, and the combined stale-first policy
POLICIES = [(6, False), (None, True), (6, True)]


def _steps(rng, steps, b, kvh, g, d, slots):
    """Per step: k/v tokens, a write mask, and attention weights over the
    slots (a softmax of random scores, so the H2O mass is realistic)."""
    for _ in range(steps):
        w = rng.standard_normal((b, kvh, g, slots)).astype(np.float32)
        w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
        yield (_randn(rng, b, kvh, d), _randn(rng, b, kvh, d),
               rng.random(b) < 0.8, w.astype(np.float32))


@pytest.mark.parametrize("window,use_h2o", POLICIES)
def test_contiguous_slot_policies_match_jax(window, use_h2o):
    """select_slot / insert / accumulate_h2o over 40 steps of a 16-slot
    cache (full after 16, then ring wrap or eviction), write-masked."""
    b, kvh, g, d, slots, recent = 3, 2, 2, 8, 16, 4
    rng = np.random.default_rng(7 + (window or 0) + use_h2o)
    jc = jax_kv.init_attn_cache(b, kvh, slots, d, d, jnp.float32)
    tc = kv.init_attn_cache(b, kvh, slots, d, d, torch.float32, "cpu",
                            h2o=True)
    for k_new, v_new, m, w in _steps(rng, 40, b, kvh, g, d, slots):
        kw = dict(window=window, h2o=use_h2o, recent_len=recent)
        jslot = jax_kv.select_slot(jc, **kw)
        slot = kv.select_slot(tc, **kw)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        jc = jax_kv.insert(jc, jslot, jnp.asarray(k_new), jnp.asarray(v_new),
                           write_mask=jnp.asarray(m))
        kv.insert(tc, slot, _t(k_new), _t(v_new), write_mask=_t(m))
        if use_h2o:
            jc = jax_kv.accumulate_h2o(jc, jnp.asarray(w),
                                       write_mask=jnp.asarray(m))
            kv.accumulate_h2o(tc, _t(w), write_mask=_t(m))
        np.testing.assert_array_equal(
            kv.valid_mask(tc, window=window).numpy(),
            np.asarray(jax_kv.valid_mask(jc, window=window)))
    for name in ("k", "v", "positions", "count", "acc_score"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)


@pytest.mark.parametrize("window,use_h2o", POLICIES)
def test_paged_slot_policies_match_jax_and_oracle(window, use_h2o):
    """paged_select_slot / paged_insert (evicting whole pages) /
    paged_accumulate_h2o over 40 steps of 4 pages of 4 slots per lane,
    one lane with an unmapped page, write-masked; each victim page also
    equals the numpy oracle's."""
    b, kvh, g, d, ps, npl, recent = 3, 2, 2, 8, 4, 4, 5
    slots = ps * npl
    rng = np.random.default_rng(11 + (window or 0) + use_h2o)
    table = np.array([[5, 0, 9, 2], [1, 8, 3, 4], [7, 6, 10, -1]], np.int32)
    jp = jax_kv.init_paged_cache(b, kvh, 11, npl, ps, d, d, jnp.float32)
    jp = dataclasses.replace(jp, page_table=jnp.asarray(table))
    tp = kv.init_paged_cache(b, kvh, 11, npl, ps, d, d, torch.float32, "cpu")
    tp.page_table.copy_(_t(table))
    evictions = 0
    for k_new, v_new, m, w in _steps(rng, 40, b, kvh, g, d, slots):
        kw = dict(window=window, h2o=use_h2o, recent_len=recent)
        jslot, jev = jax_kv.paged_select_slot(jp, **kw)
        slot, ev = kv.paged_select_slot(tp, **kw)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        assert (ev is None) == (jev is None)
        if ev is not None:
            np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
            pos = kv.gather_positions(tp).numpy()
            view = kv.paged_lane_view(dataclasses.replace(
                tp, k_pool=tp.acc_pool[..., None],
                v_pool=tp.acc_pool[..., None]))
            for lane in range(b):
                oracle = h2o.reference_victim_page(
                    pos[lane], view.k[lane, ..., 0].numpy(),
                    int(tp.count[lane]), page_size=ps, recent_len=recent,
                    window=window)
                assert oracle == int(ev[lane]), (lane, oracle, ev)
                assert oracle == jax_h2o.reference_victim_page(
                    pos[lane], view.k[lane, ..., 0].numpy(),
                    int(tp.count[lane]), page_size=ps, recent_len=recent,
                    window=window)
            evictions += int((ev >= 0).sum())
        jp = jax_kv.paged_insert(jp, jslot, jnp.asarray(k_new),
                                 jnp.asarray(v_new),
                                 write_mask=jnp.asarray(m), evict_page=jev)
        kv.paged_insert(tp, slot, _t(k_new), _t(v_new), write_mask=_t(m),
                        evict_page=ev)
        if use_h2o:
            jp = jax_kv.paged_accumulate_h2o(jp, jnp.asarray(w),
                                             write_mask=jnp.asarray(m))
            kv.paged_accumulate_h2o(tp, _t(w), write_mask=_t(m))
    if use_h2o:
        assert evictions > 0
    np.testing.assert_array_equal(kv.gather_positions(tp).numpy(),
                                  np.asarray(jax_kv.gather_positions(jp)))
    for name in ("k_pool", "v_pool", "pos_pool", "acc_pool", "count"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)


def test_paged_writes_take_no_host_sync_on_masks():
    """The per-step policy functions never read a tensor on the host (no
    boolean-mask indexing, no ``nonzero``, no ``.item()``): they run on
    the meta device, where any host read raises."""
    b, kvh, d, ps, npl = 2, 2, 8, 4, 4
    tp = kv.init_paged_cache(b, kvh, 6, npl, ps, d, d, torch.float32, "meta")
    slot, ev = kv.paged_select_slot(tp, window=None, h2o=True, recent_len=2)
    kv.paged_insert(tp, slot, torch.zeros(b, kvh, d, device="meta"),
                    torch.zeros(b, kvh, d, device="meta"),
                    write_mask=torch.ones(b, dtype=torch.bool, device="meta"),
                    evict_page=ev)
    kv.paged_accumulate_h2o(tp, torch.zeros(b, kvh, 2, npl * ps,
                                            device="meta"),
                            write_mask=torch.ones(b, dtype=torch.bool,
                                                  device="meta"))
    tc = kv.init_attn_cache(b, kvh, 8, d, d, torch.float32, "meta", h2o=True)
    kv.insert(tc, kv.select_slot(tc, window=4, h2o=True, recent_len=2),
              torch.zeros(b, kvh, d, device="meta"),
              torch.zeros(b, kvh, d, device="meta"),
              write_mask=torch.ones(b, dtype=torch.bool, device="meta"))


def test_cache_slots_and_h2o_oracles_match_jax():
    for args in ((64, None, None), (64, 16, None), (64, None, 32),
                 (64, 16, 8), (4096, 4096, None)):
        assert kv.cache_slots(*args) == jax_kv.cache_slots(*args)
    for ratio in (1.0, 0.5, 0.01):
        aq = AquaConfig(h2o_ratio=ratio)
        assert h2o.h2o_budget(aq, 64) == jax_h2o.h2o_budget(
            JaxAquaConfig(h2o_ratio=ratio), 64)
    w = np.random.default_rng(2).random((20, 20)).astype(np.float32)
    np.testing.assert_array_equal(
        h2o.reference_keep_set(w, 8, 0.5),
        np.asarray(jax_h2o.reference_keep_set(jnp.asarray(w), 8, 0.5)))
    # a full 8-slot cache: the victim of the next insert
    rng = np.random.default_rng(3)
    acc = rng.random((2, 2, 8)).astype(np.float32)
    pos = np.stack([rng.permutation(8), rng.permutation(8) + 3]).astype(
        np.int32)
    cnt = np.array([8, 11], np.int32)
    jc = dataclasses.replace(
        jax_kv.init_attn_cache(2, 2, 8, 4, 4, jnp.float32),
        positions=jnp.asarray(pos), count=jnp.asarray(cnt),
        acc_score=jnp.asarray(acc))
    tc = kv.init_attn_cache(2, 2, 8, 4, 4, torch.float32, "cpu", h2o=True)
    tc.positions.copy_(_t(pos))
    tc.count.copy_(_t(cnt))
    tc.acc_score.copy_(_t(acc))
    aq = dict(h2o_ratio=0.5, h2o_recent_frac=0.25)
    np.testing.assert_array_equal(
        h2o.eviction_step(tc, AquaConfig(**aq)).numpy(),
        np.asarray(jax_h2o.eviction_step(jc, JaxAquaConfig(**aq))))


# ---------------------------------------------------------------------------
# Prefill -> cache handoff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,h2o_ratio,s", [
    ("h2o-danube-1.8b", 1.0, 40),    # ring: 40 tokens in 16 slots
    ("qwen3-0.6b", 0.5, 40),         # H2O: 16 of 40 by mass + 8 recents
    ("h2o-danube-1.8b", 0.5, 40),    # both: 8 slots, windowed mass
    ("qwen3-0.6b", 0.5, 12),         # H2O budget not reached
])
def test_build_cache_from_prefill_matches_jax(arch, h2o_ratio, s):
    max_seq = 32
    jcfg = jax_reduced(arch, d_model=64)
    tcfg = reduced(arch, d_model=64)
    att = tcfg.attention
    aq = dict(k_ratio=0.5, block_dims=8, h2o_ratio=h2o_ratio)
    jaq, taq = JaxAquaConfig(**aq), AquaConfig(**aq)
    rng = np.random.default_rng(s)
    params = jax_attn.init_attention_params(jax.random.PRNGKey(1),
                                            jcfg.d_model, jcfg.attention,
                                            jnp.float32)
    proj = np.linalg.qr(rng.standard_normal(
        (att.num_kv_heads, att.head_dim, att.head_dim)))[0].astype(np.float32)
    x = _randn(rng, 2, s, tcfg.d_model)
    want = jax_attn.build_cache_from_prefill(
        params, jnp.asarray(x), jcfg.attention, jaq, jnp.asarray(proj),
        max_seq)
    _, aux = attn.prefill_attention(
        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), _t(x),
        att, taq, _t(proj), return_aux=True)
    got = attn.build_cache_from_prefill(
        aux["k_cache"], aux["v"], max_seq, window=att.window, aqua=taq,
        q_hat=aux["q_hat"], head_dim=att.head_dim)
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL)
    if h2o_ratio < 1:
        np.testing.assert_allclose(got.acc_score.numpy(),
                                   np.asarray(want.acc_score), **TOL)
    else:   # no H2O statistic kept: JAX's stays zero
        assert got.acc_score is None and not np.asarray(want.acc_score).any()


def test_build_cache_refuses_ragged_rows_under_a_window():
    z = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="ragged"):
        attn.build_cache_from_prefill(z, z, 16, torch.tensor([5]), window=4)


# ---------------------------------------------------------------------------
# The window form of the prefill kernel (plain version) against Pallas
# ---------------------------------------------------------------------------


def _jax_prefill_call(q, k, v, lengths, kc_part, *, q_offset, q_blk, k_blk,
                      window, k_ratio=0.5, bd=8):
    """JAX's ``aqua_prefill_attention`` (``_kernel``, or ``_part_kernel``
    with ``kc_part``) with ``window``, from head-major inputs, and the
    selection it used."""
    b, h, t, d = q.shape
    nqc, nb = t // q_blk, d // bd
    qj = jnp.asarray(q)
    local = jnp.clip(jnp.asarray(lengths) - q_offset, 0, t)
    block_idx = jax_chunk_topk(qj, jax_ops.round_k_dims(d, k_ratio, bd), bd,
                               q_blk, local)
    qb = qj.reshape(b, h, nqc, q_blk, nb, bd).transpose(0, 1, 2, 4, 3, 5)
    q_sel = jnp.take_along_axis(qb, block_idx[..., None, None], axis=3)
    out = jax_prefill(q_sel, jax_ops.to_dim_major_blocks(jnp.asarray(k), bd),
                      jnp.asarray(v), block_idx, jnp.asarray(lengths),
                      None if kc_part is None else jnp.asarray(kc_part),
                      block_dims=bd, q_blk=q_blk, k_blk=k_blk, causal=True,
                      window=window, q_offset=q_offset)
    return np.asarray(out), torch.from_numpy(np.array(block_idx))


@pytest.mark.parametrize("window", [1, 8, 20, 100])
def test_windowed_prefill_matches_jax(window):
    """Monolithic: ``ops.aqua_prefill`` against JAX's, ragged lengths."""
    rng = np.random.default_rng(window)
    b, h, kvh, s, d = 2, 4, 2, 48, 32
    q, k, v = _randn(rng, b, h, s, d), _randn(rng, b, kvh, s, d), \
        _randn(rng, b, kvh, s, d)
    lengths = np.array([s, 37], np.int32)
    want = np.asarray(jax_ops.aqua_prefill(
        q, k, v, lengths, k_ratio=0.5, block_dims=8, q_blk=16, k_blk=16,
        window=window, scale=0.2))
    got = ops.aqua_prefill(_t(q), _t(k), _t(v), _t(lengths), k_ratio=0.5,
                           block_dims=8, q_blk=16, window=window,
                           scale=0.2).numpy()
    valid = (np.arange(s)[None, :] < lengths[:, None])[:, None, :, None]
    np.testing.assert_allclose(got * valid, want * valid, **TOL)


@pytest.mark.parametrize("q_offset,window,part", [
    (0, 12, False), (128, 12, False), (128, 70, False), (64, 100, True),
    (192, 150, True)])
def test_windowed_prefill_q_offset_and_kc_part_match_jax(q_offset, window,
                                                         part):
    """The chunk form (rows [q_offset, q_offset + 64) of a 256-key
    stripe) and the participating-chunk walk under a window."""
    rng = np.random.default_rng(q_offset + window)
    b, h, kvh, s, d, q_blk, k_blk, t = 2, 4, 2, 256, 32, 16, 64, 64
    q = _randn(rng, b, h, t, d)
    k, v = _randn(rng, b, kvh, s, d), _randn(rng, b, kvh, s, d)
    lengths = np.array([s, q_offset + 53], np.int32)
    table = None
    if part:       # two of the four key chunks per q-tile
        table = np.stack([np.stack([np.sort(rng.choice(s // k_blk, 2,
                                                       replace=False))
                                    for _ in range(t // q_blk)])
                          for _ in range(b)]).astype(np.int32)
    want, block_idx = _jax_prefill_call(q, k, v, lengths, table,
                                        q_offset=q_offset, q_blk=q_blk,
                                        k_blk=k_blk, window=window)
    got = pk.aqua_prefill_attention(
        _t(q), _t(k), _t(v), block_idx, _t(lengths), block_dims=8,
        q_blk=q_blk, causal=True, scale=d ** -0.5, q_offset=q_offset,
        kc_part=None if table is None else _t(table), k_blk=k_blk,
        window=window).numpy()
    pos = q_offset + np.arange(t)
    valid = (pos[None, :] < lengths[:, None])[:, None, :, None]
    if part:   # rows whose tile drops every key in their band: don't-care
        qpos = pos[None, :, None]
        kpos = np.arange(s)[None, None, :]
        tiles = np.zeros((b, t // q_blk, s // k_blk), bool)
        np.put_along_axis(tiles, table, True, axis=-1)
        seen = tiles[:, np.arange(t) // q_blk][..., np.arange(s) // k_blk] \
            & (kpos <= qpos) & (kpos > qpos - window) \
            & (kpos < lengths[:, None, None])
        valid = valid & seen.any(-1)[:, None, :, None]
        assert valid.sum() > valid.size // 4
    np.testing.assert_allclose(got * valid, want * valid, **TOL)


def test_prefill_wrapper_refuses_a_window_below_one():
    z = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="window"):
        pk.aqua_prefill_attention(z, z, z, torch.zeros(1, 1, 1, 1,
                                                       dtype=torch.int32),
                                  torch.tensor([8], dtype=torch.int32),
                                  q_blk=8, window=0)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=8, prompt_bucket=8)
PROMPTS = (10, 36, 50, 20, 44)   # past the window (16), past the H2O
                                 # budget (32), and short ones


def _models(arch, h2o_ratio):
    kw = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16,
              h2o_ratio=h2o_ratio)
    jcfg = dataclasses.replace(jax_reduced(arch, d_model=128),
                               aqua=JaxAquaConfig(prefill_k_blk=16,
                                                  decode_seq_blk=16, **kw))
    tcfg = dataclasses.replace(reduced(arch, d_model=128),
                               aqua=AquaConfig(**kw))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    return (jcfg, params, JaxProjections(p=jnp.asarray(proj)), tcfg,
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
            AquaProjections(p=torch.from_numpy(proj)))


def _requests(cls):
    rng = np.random.default_rng(5)
    return [cls(uid=i, tokens=rng.integers(0, 128, size=(n,), dtype=np.int32),
                max_new_tokens=8, arrival=float(i))
            for i, n in enumerate(PROMPTS)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch,h2o_ratio", [
    ("h2o-danube-1.8b", 1.0),        # window ring
    ("qwen3-0.6b", 0.5),             # H2O
    ("h2o-danube-1.8b", 0.5),        # H2O + window
])
def test_engine_greedy_tokens_match_jax(arch, h2o_ratio, paged):
    jcfg, params, jproj, tcfg, tparams, tproj = _models(arch, h2o_ratio)
    jcache = JaxCacheSpec(page_size=8, prefix_sharing=False) if paged \
        else None
    want = JaxEngine(jcfg, params, jproj,
                     serving=JaxServingConfig(cache=jcache, **SERVE),
                     backend="aqua-block-sparse").run(_requests(JaxRequest))
    cache = CacheSpec(page_size=8, prefix_sharing=False) if paged else None
    eng = ContinuousBatchingEngine(tcfg, tparams, tproj,
                                   serving=ServingConfig(cache=cache, **SERVE),
                                   backend="aqua-block-sparse", device="cpu")
    got = eng.run(_requests(Request))
    assert eng.stats.decode_steps > 0
    assert eng.eviction == ("h2o" if h2o_ratio < 1 else "ring")
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid
    if paged:       # every admission reserved its lane's whole stripe
        assert eng.page_pool.peak_in_use == min(
            3, len(PROMPTS)) * eng.pages_per_lane


@pytest.mark.parametrize("arch,h2o_ratio", [("h2o-danube-1.8b", 1.0),
                                            ("qwen3-0.6b", 0.5),
                                            ("h2o-danube-1.8b", 0.5)])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "hier"])
def test_dispatch_plan_matches_jax(monkeypatch, arch, h2o_ratio, layout):
    """Window and H2O vetoes, chunked and token-sparsity reasons included
    (a prefill budget and hierarchical pages are asked for)."""
    monkeypatch.setattr(runtime_flags, "PALLAS_OVERRIDE", True)
    from repro.configs.base import SparsitySpec as JaxSparsitySpec
    from repro_torch.configs import SparsitySpec
    jcfg, _, _, tcfg, _, _ = _models(arch, h2o_ratio)

    def serving(cache_cls, sparsity_cls, serving_cls):
        return serving_cls(
            max_lanes=3, max_seq=64, prompt_bucket=8,
            prefill_budget_tokens=16,
            cache=(None if layout == "contiguous" else
                   cache_cls(page_size=8, prefix_sharing=False)),
            sparsity=(sparsity_cls(page_keep_ratio=0.5)
                      if layout == "hier" else None))
    jplan = jax_dispatch.resolve_dispatch_plan(
        attention=dataclasses.replace(jcfg.attention,
                                      backend="aqua-block-sparse"),
        aqua=jcfg.aqua, serving=serving(JaxCacheSpec, JaxSparsitySpec,
                                        JaxServingConfig), mesh=None)
    eng = ContinuousBatchingEngine(
        tcfg, build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0)),
        AquaProjections(p=torch.eye(tcfg.attention.head_dim).expand(
            tcfg.num_layers, tcfg.attention.num_kv_heads, -1, -1)),
        serving=serving(CacheSpec, SparsitySpec, ServingConfig),
        backend="aqua-block-sparse", device="cpu")
    plan = eng.dispatch_plan()
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert not plan.chunked_prefill and plan.token_sparsity == "none"
    assert (REASON_WINDOW in plan.reasons) == (tcfg.attention.window
                                               is not None)
    assert (REASON_H2O in plan.reasons) == (h2o_ratio < 1)


def test_engine_refuses_what_window_and_h2o_do_not_serve():
    jcfg, params, jproj, tcfg, tparams, tproj = _models("h2o-danube-1.8b",
                                                        0.5)
    paged = dict(SERVE, cache=CacheSpec(page_size=8, prefix_sharing=False))
    # int8 pools are served under a window ring and H2O at once (they were
    # refused before they were ported): greedy tokens equal the JAX
    # engine's
    want = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(
        cache=JaxCacheSpec(page_size=8, prefix_sharing=False),
        quant=JaxQuantSpec(kv_dtype="int8"), **SERVE),
        backend="aqua-block-sparse").run(_requests(JaxRequest)[:3])
    eng = ContinuousBatchingEngine(tcfg, tparams, tproj, device="cpu",
                                   backend="aqua-block-sparse",
                                   serving=ServingConfig(
                                       quant=QuantSpec(kv_dtype="int8"),
                                       **paged))
    got = eng.run(_requests(Request)[:3])
    assert eng.eviction == "h2o" and eng.last_state.layers.quantized
    for uid, out in want.items():
        assert got[uid].tokens == out.tokens, uid
    _, _, _, tcfg, tparams, tproj = _models("h2o-danube-1.8b", 1.0)
    with pytest.raises(ValueError, match="contradicts"):
        ContinuousBatchingEngine(tcfg, tparams, tproj, device="cpu",
                                 serving=ServingConfig(**dict(
                                     paged, cache=CacheSpec(
                                         page_size=8, prefix_sharing=False,
                                         eviction="h2o"))))
    with pytest.raises(ValueError, match="multiple of page_size"):
        ContinuousBatchingEngine(tcfg, tparams, tproj, device="cpu",
                                 serving=ServingConfig(**dict(
                                     paged, max_seq=96, cache=CacheSpec(
                                         page_size=32, prefix_sharing=False)
                                 )))


# ---------------------------------------------------------------------------
# H2O-Danube-1.8B: config and bridge
# ---------------------------------------------------------------------------


def test_danube_config_matches_jax():
    want, got = jax_get_config("h2o-danube-1.8b"), get_config(
        "h2o-danube-1.8b")
    for f in ("num_layers", "d_model", "d_ff", "vocab_size",
              "tie_embeddings", "norm_eps"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("num_heads", "num_kv_heads", "head_dim", "kind", "window",
              "rope_theta", "qk_norm"):
        assert getattr(got.attention, f) == getattr(want.attention, f), f
    assert reduced("h2o-danube-1.8b").attention.window == 16


def test_danube_bridge_round_trip():
    """The JAX package's untied Danube params carry across unchanged
    (``unembed`` included) and give the same logits."""
    jcfg = jax_reduced("h2o-danube-1.8b", d_model=64)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    tcfg = reduced("h2o-danube-1.8b", d_model=64)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    assert "unembed" in tparams and not tcfg.tie_embeddings
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        t = tparams
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    toks = np.random.default_rng(0).integers(0, 128, (2, 40), np.int32)
    want = np.asarray(jax_build_model(jcfg).forward(
        params, {"tokens": jnp.asarray(toks)}))
    got = build_model(tcfg, "cpu").forward(tparams, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
