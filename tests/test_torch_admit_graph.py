"""What the captured admissions (``serving/admit_graph.py``) rely on, on the
CPU, at the reduced widths of ``tests/test_torch_step_graph.py``:

(a) the admission an ``AdmitGraph`` captures (``admit_graph.admission``:
    page-table row install, ``prefill``, ``graft_paged``; or
    ``prefill_into``) runs on a meta-device state with the lane, length
    and row as device tensors: no op reads a tensor's value on the host,
    which a CUDA graph could not capture;
(b) the sync-free lane surgery (``paged_graft``, ``paged_write_tail``,
    ``paged_reset_lane``, ``insert_lane``, ``install_table_row``) with a
    device ``lane`` equals the boolean-mask versions it replaced, bit for
    bit: full-precision and int8 pools at both scale granularities, an
    H2O prefill's ``acc_score``, partly and wholly unmapped rows (a graft
    into no mapped page leaves the pool as it was);
(c) the float32 unembedding made once (``layers.with_unembedding``) gives
    the per-call cast's logits bit for bit, tied and untied, reuses a
    float32 table and leaves the caller's params as they were;
(d) the port engine, whose admissions now run that captured code (on the
    CPU eagerly), still serves the JAX engine's greedy tokens on the
    paged and contiguous parity drives, over buckets admitted in mixed
    order and two serves;
(e) ``AdmitGraph`` refuses a CPU state.

``tests/test_torch_gpu.py`` holds replayed admissions to eager ones on the
card, bit for bit.
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
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, reduced)
from repro_torch.core import attention as attn
from repro_torch.core import kvcache as kv
from repro_torch.core.calibration import AquaProjections
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.base import DecodeState
from repro_torch.serving import ContinuousBatchingEngine, Request
from repro_torch.serving.admit_graph import AdmitGraph, admission

from repro_torch.data.corpus import request_frontend_inputs
from test_torch_step_graph import assert_bitwise, drive_engine

META = torch.device("meta")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- (a) ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def flash_plain():
    """The flash backend over the kernel's plain version (the meta device
    reaches no kernel wrapper), registered for this module's tests and
    taken out after them (other modules hold that no such backend
    exists)."""
    assert "flash-plain" not in attn.available_backends()
    attn.register_backend(attn._flash_backend("flash-plain",
                                              flash_attention_plain))
    yield "flash-plain"
    del attn._BACKENDS["flash-plain"]


@pytest.mark.parametrize("name", ["paged", "contiguous", "flash_paged",
                                  "int8_paged", "hier_paged",
                                  "hier_int8_paged", "aqua_memory_paged",
                                  "hot_int8_paged", "olmoe-1b-7b",
                                  "qwen2-moe-a2.7b", "pixtral-12b"])
@pytest.mark.parametrize("bucket", [8, 24])
def test_admission_reads_no_value_on_the_host(name, bucket, flash_plain):
    """(a) The captured admission, on the meta device, where any host read
    of a tensor's value raises (boolean-mask indexing, ``nonzero``,
    ``.item()``). The plain backends: the kernel wrappers take CPU or
    CUDA tensors only. A VLM's admission splices its patches."""
    backend = flash_plain if name == "flash_paged" else \
        "aqua-block-sparse-plain"
    eng, _ = drive_engine(name, backend=backend)
    lanes, max_seq = eng.scfg.max_lanes, eng.scfg.max_seq
    state = eng.model.init_decode_state(lanes, max_seq, device=META)
    row = None
    if eng.paged:
        row = torch.full((state.layers.pages_per_lane,), -1,
                         dtype=torch.int32, device=META)
    logits = admission(
        eng.model, _to(eng.params, META), state,
        None if eng.proj is None else eng.proj.to(META), max_seq,
        torch.zeros(1, bucket, dtype=torch.int32, device=META),
        torch.ones(1, dtype=torch.int32, device=META),
        torch.ones(1, dtype=torch.int64, device=META), row,
        extra={k: torch.from_numpy(v).to(META) for k, v in (
            request_frontend_inputs(eng.cfg) or {}).items()})
    assert logits.device == META
    assert logits.shape == (1, eng.cfg.vocab_size)
    assert isinstance(state.layers, kv.PagedAttnCache) == eng.paged
    if eng.paged:
        assert state.layers.quantized == ("int8" in name)


def test_lane_surgery_reads_no_value_on_the_host():
    """(a) The chunk steps' tail writer and the lane reset (eager today,
    the next graphs' preconditions) on the meta device too, int8 pools
    with a device lane and count."""
    cache = kv.init_paged_cache(3, 2, 12, 4, 4, 8, 8, torch.float32, META,
                                kv_dtype="int8")
    lane = torch.ones(1, dtype=torch.int64, device=META)
    kv.paged_write_tail(cache, lane, torch.zeros(6, 2, 8, device=META),
                        torch.zeros(6, 2, 8, device=META),
                        torch.zeros(6, dtype=torch.int32, device=META), 1,
                        torch.ones((), dtype=torch.int32, device=META),
                        cache.page_table[1])
    kv.paged_reset_lane(cache, lane)
    kv.install_table_row(cache, lane, torch.zeros(4, dtype=torch.int32,
                                                  device=META))
    assert cache.k_pool.device == META


# -- (b) ---------------------------------------------------------------------

def _masked_graft(cache, req, lane, num_slots):
    """``paged_graft`` before it became sync-free (boolean-mask indexing)."""
    ps = cache.page_size
    tbl = cache.page_table[lane].long()
    mapped = tbl[tbl >= 0]
    cache.pos_pool[mapped] = -1
    cache.acc_pool[mapped] = 0.0
    idx = torch.arange(num_slots)
    entry = tbl[idx // ps]
    ok = entry >= 0
    phys, off, src = entry[ok], (idx % ps)[ok], idx[ok]
    k_tok = req.k[0][:, :num_slots].transpose(0, 1)
    v_tok = req.v[0][:, :num_slots].transpose(0, 1)
    if cache.quantized:
        for pool, scale, tok in ((cache.k_pool, cache.k_scale, k_tok),
                                 (cache.v_pool, cache.v_scale, v_tok)):
            scale[mapped] = 0.0
            pg = kv._page_scales(tok, ps, scale.shape[1])
            pg_tbl = tbl[:pg.shape[0]]
            scale[pg_tbl[pg_tbl >= 0]] = pg[pg_tbl >= 0]
            pool[phys, :, off] = kv.quantize_tokens(tok[src], pg[src // ps])
    else:
        cache.k_pool[phys, :, off] = k_tok[src].to(cache.k_pool.dtype)
        cache.v_pool[phys, :, off] = v_tok[src].to(cache.v_pool.dtype)
    cache.pos_pool[phys, off] = req.positions[0, src]
    if req.acc_score is not None:
        cache.acc_pool[phys, :, off] = req.acc_score[0][:, src].transpose(
            0, 1)
    cache.count[lane] = req.count[0]


def _masked_write_tail(cache, lane, k_tail, v_tail, positions, start_page,
                       new_count):
    """``paged_write_tail`` before it became sync-free."""
    ps = cache.page_size
    tbl = cache.page_table[lane].long()
    npl = tbl.shape[0]
    private = (torch.arange(npl) >= start_page) & (tbl >= 0)
    clear = tbl[private]
    cache.pos_pool[clear] = -1
    cache.acc_pool[clear] = 0.0
    t = min(k_tail.shape[0], cache.num_slots - start_page * ps)
    idx = start_page * ps + torch.arange(t)
    entry = tbl[idx // ps]
    ok = entry >= 0
    phys, off, src = entry[ok], (idx % ps)[ok], torch.nonzero(ok)[:, 0]
    if cache.quantized:
        for pool, scale, tok in ((cache.k_pool, cache.k_scale, k_tail),
                                 (cache.v_pool, cache.v_scale, v_tail)):
            scale[clear] = 0.0
            pg = kv._page_scales(tok[:t], ps, scale.shape[1])
            pg_tbl = tbl[start_page:start_page + pg.shape[0]]
            scale[pg_tbl[pg_tbl >= 0]] = pg[pg_tbl >= 0]
            pool[phys, :, off] = kv.quantize_tokens(tok[src], pg[src // ps])
    else:
        cache.k_pool[phys, :, off] = k_tail[src].to(cache.k_pool.dtype)
        cache.v_pool[phys, :, off] = v_tail[src].to(cache.v_pool.dtype)
    cache.pos_pool[phys, off] = positions[src].to(torch.int32)
    cache.count[lane] = new_count


def _masked_reset_lane(cache, lane):
    """``paged_reset_lane`` before it became sync-free."""
    tbl = cache.page_table[lane].long()
    mapped = tbl[tbl >= 0]
    cache.pos_pool[mapped] = -1
    cache.acc_pool[mapped] = 0.0
    if cache.quantized:
        cache.k_scale[mapped] = 0.0
        cache.v_scale[mapped] = 0.0
    cache.page_table[lane] = -1
    cache.count[lane] = 0


POOLS = {"bf16": dict(kv_dtype="bf16"),
         "int8_page_head": dict(kv_dtype="int8",
                                scale_granularity="page_head"),
         "int8_page": dict(kv_dtype="int8", scale_granularity="page")}
# lane 1's page-table row: every page mapped, some, none
ROWS = {"mapped": [7, 2, 11, 4], "partly": [5, -1, 9, -1],
        "none": [-1, -1, -1, -1]}
LANES, KVH, D, PAGES, NPL, PS = 3, 2, 8, 12, 4, 4


def _twin_caches(pool: str, row: str, seed: int = 0):
    """Two identical caches whose pools hold a previous tenant's random
    state (positions, scores, scales, values), lane 1 mapped by ``row``
    and lanes 0 and 2 by other pages."""
    rng = np.random.default_rng(seed)
    kw = POOLS[pool]
    dtype = torch.bfloat16 if pool == "bf16" else torch.float32
    c = kv.init_paged_cache(LANES, KVH, PAGES, NPL, PS, D, D, dtype, "cpu",
                            **kw)
    if c.quantized:
        for t in (c.k_pool, c.v_pool):
            t.copy_(torch.from_numpy(rng.integers(-127, 128, t.shape)))
        for t in (c.k_scale, c.v_scale):
            t.copy_(torch.from_numpy(rng.random(t.shape) + 0.1))
    else:
        for t in (c.k_pool, c.v_pool):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape)))
    c.pos_pool.copy_(torch.from_numpy(rng.integers(-1, 40, c.pos_pool.shape)))
    c.acc_pool.copy_(torch.from_numpy(rng.random(c.acc_pool.shape)))
    c.page_table.copy_(torch.tensor([[0, 1, 3, -1], ROWS[row],
                                     [6, 8, 10, -1]], dtype=torch.int32))
    c.count.copy_(torch.tensor([5, 9, 13], dtype=torch.int32))
    twin = kv.PagedAttnCache(**{f.name: (None if getattr(c, f.name) is None
                                         else getattr(c, f.name).clone())
                                for f in dataclasses.fields(c)})
    return c, twin


def _fields(cache) -> dict:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if getattr(cache, f.name) is not None}


def _prefill_cache(num: int, length: int, h2o: bool, dtype, seed: int = 1):
    """A B=1 contiguous prefill cache of ``num`` slots, valid ``length``."""
    rng = np.random.default_rng(seed)
    req = kv.init_attn_cache(1, KVH, num, D, D, dtype, "cpu", h2o=h2o)
    req.k.copy_(torch.from_numpy(rng.standard_normal(req.k.shape) * 3))
    req.v.copy_(torch.from_numpy(rng.standard_normal(req.v.shape)))
    req.positions[0, :length] = torch.arange(length, dtype=torch.int32)
    req.count.fill_(length)
    if h2o:
        req.acc_score.copy_(torch.from_numpy(rng.random(req.acc_score.shape)))
    return req


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("h2o", [False, True])
def test_graft_equals_the_masked_graft(pool, row, h2o):
    """(b) A 13-slot graft (a partial last page) into lane 1, lane as a
    device tensor; with no page mapped the pool keeps every bit."""
    got, want = _twin_caches(pool, row)
    before = {k: t.clone() for k, t in _fields(got).items()}
    req = _prefill_cache(16, 11, h2o, got.k_pool.dtype
                         if not got.quantized else torch.float32)
    kv.paged_graft(got, req, torch.tensor(1), 13, got.page_table[1])
    _masked_graft(want, req, 1, 13)
    assert_bitwise(_fields(got), _fields(want))
    if row == "none":
        after = _fields(got)
        assert_bitwise({k: t for k, t in after.items() if k != "count"},
                       {k: t for k, t in before.items() if k != "count"})
    else:
        assert not torch.equal(got.pos_pool, before["pos_pool"])


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("start_page", [0, 1])
def test_write_tail_equals_the_masked_write_tail(pool, row, start_page):
    """(b) A 6-token chunk from a page-aligned cursor, lane and count as
    device tensors (the count as the chunk step computes it)."""
    got, want = _twin_caches(pool, row, seed=2)
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.standard_normal((6, KVH, D)) * 2).float()
    v = torch.from_numpy(rng.standard_normal((6, KVH, D))).float()
    if not got.quantized:
        k, v = k.to(got.k_pool.dtype), v.to(got.v_pool.dtype)
    pos = torch.arange(6, dtype=torch.int32) + start_page * PS
    count = start_page * PS + torch.tensor([5], dtype=torch.int32)[0]
    kv.paged_write_tail(got, torch.tensor([1]), k, v, pos, start_page, count,
                        got.page_table[1])
    _masked_write_tail(want, 1, k, v, pos, start_page, count)
    assert_bitwise(_fields(got), _fields(want))


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("pool", list(POOLS))
def test_reset_lane_equals_the_masked_reset(pool, row):
    """(b) Lane 1 back to empty, lane as an int and as a device tensor."""
    for lane in (1, torch.tensor(1)):
        got, want = _twin_caches(pool, row, seed=4)
        kv.paged_reset_lane(got, lane)
        _masked_reset_lane(want, 1)
        assert_bitwise(_fields(got), _fields(want))


@pytest.mark.parametrize("h2o", [False, True])
def test_insert_lane_with_a_device_lane_equals_the_row_copy(h2o):
    """(b) ``insert_lane`` (the contiguous admission's graft) with a device
    lane writes what ``dst[:, lane] = src[:, 0]`` wrote, into a state
    holding other lanes' data; ``install_table_row`` likewise."""
    rng = np.random.default_rng(5)
    model = build_model(reduced("qwen3-0.6b", d_model=128), "cpu")

    def filled():
        c = kv.init_attn_cache(3, KVH, 16, D, D, torch.float32, "cpu",
                               num_layers=2, h2o=h2o)
        for t in _fields(c).values():
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape) * 9))
        return c
    state, req = filled(), filled()
    req = kv.AttnCache(**{k: t[:, :1].clone()
                          for k, t in _fields(req).items()})
    twin = kv.AttnCache(**{k: t.clone() for k, t in _fields(state).items()})
    model.insert_lane(DecodeState(layers=state), DecodeState(layers=req),
                      torch.tensor([2]))
    for k, t in _fields(twin).items():
        t[:, 2] = getattr(req, k)[:, 0]
    assert_bitwise(_fields(state), _fields(twin))
    got, want = _twin_caches("bf16", "partly")
    table = torch.stack([got.page_table] * 2)
    got.page_table, want.page_table = table, table.clone()
    row = torch.tensor([3, 4, -1, -1], dtype=torch.int32)
    kv.install_table_row(got, torch.tensor(0), row)
    want.page_table[:, 0] = row
    assert torch.equal(got.page_table, want.page_table)


# -- (c) ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [True, False])
def test_unembedding_made_once_equals_the_per_call_cast(tied, dtype):
    """(c) Prefill and decode logits with the float32 matrix made once
    equal those of the per-call cast, bit for bit; a float32 table is the
    matrix itself (no second copy); the caller's dict is left as it was
    and a second call returns the same dict."""
    cfg = dataclasses.replace(reduced("qwen3-0.6b", d_model=128),
                              tie_embeddings=tied, dtype=dtype,
                              param_dtype=dtype)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    keys = set(params)
    once = L.with_unembedding(params, tied)
    assert set(params) == keys and L.UNEMBED_F32 not in params
    assert L.with_unembedding(once, tied) is once
    table = params["embed" if tied else "unembed"]["table"]
    w = once[L.UNEMBED_F32]
    assert w.dtype == torch.float32 and w.is_contiguous()
    assert w.shape == (cfg.vocab_size, cfg.d_model)
    if dtype == "float32":
        assert w is table
    else:
        assert w.data_ptr() != table.data_ptr()
    assert all(once[k] is params[k] for k in keys)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    batch = {"tokens": toks, "lengths": torch.tensor([12, 7],
                                                     dtype=torch.int32)}
    got, gs = model.prefill(once, batch, 32)
    want, ws = model.prefill(params, batch, 32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    step = torch.tensor([3, 5], dtype=torch.int32)
    got = model.decode_step(once, gs, step)[0]
    want = model.decode_step(params, ws, step)[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_engines_make_the_matrix_once():
    """(c) Both engines hold params with the float32 matrix; an engine
    built on another engine's params reuses it."""
    eng, _ = drive_engine("flash_paged")          # AQUA off
    w = eng.params[L.UNEMBED_F32]
    again = ContinuousBatchingEngine(eng.cfg, eng.params, None,
                                     serving=eng.scfg, backend="dense",
                                     device="cpu")
    assert again.params is eng.params
    from repro_torch.serving import ServeEngine
    rect = ServeEngine(eng.cfg, eng.params, None, max_seq=64,
                       backend="dense", device="cpu")
    assert rect.params[L.UNEMBED_F32] is w


# -- (d) ---------------------------------------------------------------------

AQUA_KW = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=6, prompt_bucket=8)
# five buckets (8 to 40 tokens) arriving out of size order; lanes reused
PROMPTS = (20, 5, 36, 12, 30, 9, 40)


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


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 128, size=(n,), dtype=np.int32) for n in PROMPTS]


@pytest.mark.parametrize("layout", ["contiguous", "paged", "int8"])
def test_greedy_tokens_equal_the_jax_engine_over_two_serves(models, layout):
    """(d) Seven requests over five buckets, arriving out of size order
    through three lanes (lane reuse), served twice by one port engine:
    both serves give the JAX engine's greedy tokens."""
    jcfg, params, jproj, tcfg, tparams, tproj = models
    jcache = tcache = None
    jquant, tquant = JaxQuantSpec(), QuantSpec()
    if layout != "contiguous":
        jcache = JaxCacheSpec(page_size=8, prefix_sharing=False)
        tcache = CacheSpec(page_size=8, prefix_sharing=False)
    if layout == "int8":
        jquant, tquant = JaxQuantSpec(kv_dtype="int8"), QuantSpec(
            kv_dtype="int8")
    want = JaxEngine(jcfg, params, jproj, serving=JaxServingConfig(
        cache=jcache, quant=jquant, **SERVE),
        backend="aqua-block-sparse").run(
        [JaxRequest(uid=i, tokens=p, arrival=float(i))
         for i, p in enumerate(_prompts())])
    eng = ContinuousBatchingEngine(
        tcfg, tparams, tproj, serving=ServingConfig(cache=tcache,
                                                    quant=tquant, **SERVE),
        backend="aqua-block-sparse", device="cpu")
    for _ in range(2):
        got = eng.run([Request(uid=i, tokens=p, arrival=float(i))
                       for i, p in enumerate(_prompts())])
        assert {u: o.tokens for u, o in got.items()} == \
            {u: o.tokens for u, o in want.items()}
    assert eng.admit_graphs == {}          # the CPU admits eagerly
    acc = eng.graph_accounting()
    assert acc["admit_graphs"] == 0 and acc["step_pool_bytes"] is None


# -- (e) ---------------------------------------------------------------------

def test_admit_graph_refuses_a_cpu_state():
    """(e) On the CPU the engine admits eagerly and captures nothing; an
    AdmitGraph over a CPU state raises."""
    eng, reqs = drive_engine("paged")
    eng.run(reqs())
    assert eng.admit_graphs == {}
    with pytest.raises(ValueError, match="CUDA graph"):
        AdmitGraph(eng.model, eng.params, eng.last_state, eng.proj,
                   bucket=8, max_seq=eng.scfg.max_seq)
