"""What the captured decode step (``serving/step_graph.py``) relies on, on
the CPU, over the serving configurations of ``chip_smoke.py``'s drives
at a reduced width (2 layers, d_model 128; Danube's window 16):

(a) ``decode_step`` runs on a meta-device state: no op reads a tensor's
    value on the host, which a CUDA graph could not capture;
(b) a step with the write mask all False (the graph's warm-up and capture)
    leaves every state tensor as it was, bit for bit, after real
    admissions and decode steps;
(c) a whole ``serve()`` (monolithic, chunked, int8, window and H2O
    admissions, retirements, lane reuse) writes the state in place: every
    tensor keeps its storage, and a second ``serve()`` empties the same
    tensors (``kvcache.reset_cache``: what a fresh state holds) and
    serves the same tokens;
(d) the sync-free int8 ``paged_insert`` equals the boolean-mask insert it
    replaced, bit for bit, with rows masked off, rows whose page is
    unmapped, and steps where no row writes;
(e) ``StepGraph`` refuses a CPU state.

``tests/test_torch_gpu.py`` holds the replayed graph to eager
``decode_step`` on the card, bit for bit, with these configurations.
``prefix_paged`` adds prefix sharing to them: its prompts share a
16-token prefix, so lanes' page tables map the same physical pages.
``olmoe-1b-7b`` and ``qwen2-moe-a2.7b`` add the MoE family's routed
experts (top-k, one-hot capacity slots by cumulative sum, static
capacities) to the step. ``pixtral-12b`` (paged) and ``whisper-tiny``
(contiguous: the decoder's learned positions and cross-attention over the
lanes' cross K/V in ``DecodeState.extra``) add the frontend families:
every request carries its stub frontend inputs. ``mamba2-370m`` (no
attention: the SSD state and conv windows, frozen per lane by
``LM.freeze_rows``) and ``recurrentgemma-9b`` (4 layers: RG-LRU states
beside a window ring) add the recurrent families, contiguous.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import (AquaConfig, CacheSpec, QuantSpec,
                                 ServingConfig, SparsitySpec, reduced)
from repro_torch.core import kvcache as kv
from repro_torch.core.calibration import AquaProjections
from repro_torch.data.corpus import request_frontend_inputs
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, Request
from repro_torch.serving.step_graph import StepGraph

AQUA = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
PAGED = CacheSpec(page_size=8, prefix_sharing=False)
SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=8, prompt_bucket=8)
SHORT = (5, 12, 20, 30, 9)
LONG = (20, 36, 44, 30, 26)        # 3-6 of 8 pages: 2 participate
EVICTING = (10, 36, 50, 20, 44)    # past the window (16) and the H2O
                                   # budget (32), and short ones
# name: (arch, AQUA overrides or None for AQUA off, serving overrides,
# prompt lengths), one per drive of chip_smoke.py
DRIVES = {
    "paged": ("qwen3-0.6b", {}, dict(cache=PAGED), SHORT),
    "contiguous": ("qwen3-0.6b", {}, {}, SHORT),
    "flash_paged": ("qwen3-0.6b", None, dict(cache=PAGED), SHORT),
    "int8_paged": ("qwen3-0.6b", {},
                   dict(cache=PAGED, quant=QuantSpec(kv_dtype="int8")),
                   SHORT),
    "hier_paged": ("qwen3-0.6b", {},
                   dict(cache=PAGED,
                        sparsity=SparsitySpec(page_keep_ratio=0.25)), LONG),
    "hier_int8_paged": ("qwen3-0.6b", {},
                        dict(cache=PAGED, quant=QuantSpec(kv_dtype="int8"),
                             sparsity=SparsitySpec(page_keep_ratio=0.25)),
                        LONG),
    "chunked_paged": ("qwen3-0.6b", {},
                      dict(cache=PAGED, prefill_budget_tokens=16), LONG),
    "swa_paged": ("h2o-danube-1.8b", {}, dict(cache=PAGED), EVICTING),
    "h2o_paged": ("qwen3-0.6b", dict(h2o_ratio=0.5), dict(cache=PAGED),
                  EVICTING),
    "aqua_memory_paged": ("qwen3-0.6b", dict(s_ratio=0.3, block_dims=2),
                          dict(cache=PAGED), SHORT),
    # prefix sharing on (CacheSpec's default): every prompt starts with
    # one 16-token prefix (SHARED_PREFIX), so later admissions map its
    # two pages and prefill only their tails
    "prefix_paged": ("qwen3-0.6b", {}, dict(cache=CacheSpec(page_size=8)),
                     SHORT),
    # int8 pools under the window ring and under H2O, and hot residents
    # (a quarter of the pool also in full precision)
    "int8_swa_paged": ("h2o-danube-1.8b", {},
                       dict(cache=PAGED, quant=QuantSpec(kv_dtype="int8")),
                       EVICTING),
    "int8_h2o_paged": ("qwen3-0.6b", dict(h2o_ratio=0.5),
                       dict(cache=PAGED, quant=QuantSpec(kv_dtype="int8")),
                       EVICTING),
    "hot_int8_paged": ("qwen3-0.6b", {},
                       dict(cache=PAGED, quant=QuantSpec(
                           kv_dtype="int8", hot_resident_fraction=0.25)),
                       SHORT),
    # the MoE family: routed experts (Qwen2-MoE also a shared expert)
    "olmoe-1b-7b": ("olmoe-1b-7b", {}, dict(cache=PAGED), SHORT),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}, dict(cache=PAGED), SHORT),
    # the frontend families: a VLM's patches spliced at prefill (paged),
    # the encoder-decoder's frames (contiguous, exact-length admissions)
    "pixtral-12b": ("pixtral-12b", {}, dict(cache=PAGED), SHORT),
    "whisper-tiny": ("whisper-tiny", {}, {}, SHORT),
    # the recurrent families (contiguous, exact-length admissions): Mamba-2
    # without AQUA (its SSD state and conv windows), and the hybrid at 4
    # layers (recurrent, recurrent, attention, recurrent: its RG-LRU
    # states beside a window ring of 16, past which EVICTING's prompts run)
    "mamba2-370m": ("mamba2-370m", None, {}, SHORT),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, {}, EVICTING),
}
#: a common prompt prefix by drive (tokens)
SHARED_PREFIX = {"prefix_paged": 16}
#: depth by drive where the reduced default (2 layers) would leave out a
#: layer kind
LAYERS = {"recurrentgemma-9b": 4}


def drive_engine(name, device="cpu", dtype=None, backend=None):
    """The reduced engine of drive ``name`` (random weights and orthogonal
    projections from seeds; ``dtype`` e.g. "bfloat16" for model and
    params) and a function giving its requests: arriving one a step, or
    with ``at_once`` the first ``max_lanes`` of them at step 0; each with
    its stub frontend inputs where the config has a frontend."""
    arch, aqua_kw, serve_kw, prompts = DRIVES[name]
    cfg = reduced(arch, d_model=128, layers=LAYERS.get(name, 2))
    cfg = dataclasses.replace(
        cfg, aqua=None if aqua_kw is None else AquaConfig(**{**AQUA,
                                                             **aqua_kw}))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    proj = None
    if aqua_kw is not None:
        att = cfg.attention
        # one projection per attention layer (a hybrid's are fewer)
        n = getattr(model, "num_attn_layers", cfg.num_layers)
        p = np.linalg.qr(np.random.default_rng(1).standard_normal(
            (n, att.num_kv_heads, att.head_dim, att.head_dim))
        )[0].astype(np.float32)
        proj = AquaProjections(p=torch.from_numpy(p).to(device))
    eng = ContinuousBatchingEngine(
        cfg, params, proj, serving=ServingConfig(**SERVE, **serve_kw),
        backend=backend, device=device)

    def requests(at_once=False):
        rng = np.random.default_rng(5)
        pre = np.random.default_rng(6).integers(
            0, cfg.vocab_size, size=(SHARED_PREFIX.get(name, 0),),
            dtype=np.int32)
        reqs = [Request(uid=i, tokens=np.concatenate([pre, rng.integers(
            0, cfg.vocab_size, size=(n,), dtype=np.int32)]),
                        max_new_tokens=8, arrival=0.0 if at_once else float(i),
                        extra_inputs=request_frontend_inputs(cfg, i))
                for i, n in enumerate(prompts)]
        return reqs[:SERVE["max_lanes"]] if at_once else reqs
    return eng, requests


def serve_until(eng, reqs, steps: int) -> None:
    """Serve ``reqs`` until ``steps`` decode steps have run, then stop."""
    events = eng.serve(reqs)
    for _ in events:
        if eng.stats.decode_steps >= steps:
            break
    events.close()


def state_tensors(state) -> dict:
    """The decode state's tensors by field name (a hybrid's nested stacks
    as "attn.k", "rec.state", ...)."""
    def walk(cache, prefix):
        out = {}
        for f in dataclasses.fields(cache):
            t = getattr(cache, f.name)
            if dataclasses.is_dataclass(t):
                out.update(walk(t, f"{prefix}{f.name}."))
            elif t is not None:
                out[prefix + f.name] = t
        return out
    return walk(state.layers, "")


def clone_state(state):
    """A twin of a decode state: every cache tensor cloned (nested stacks
    too), the extras shared."""
    def clone(cache):
        return type(cache)(**{
            f.name: (clone(t) if dataclasses.is_dataclass(t)
                     else None if t is None else t.clone())
            for f in dataclasses.fields(cache)
            for t in (getattr(cache, f.name),)})
    return dataclasses.replace(state, layers=clone(state.layers))


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16}


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits: floats viewed as integers of their width, so that
    equality is bitwise (-0.0 differs from 0.0, NaN equals its bits)."""
    return t.view(_BITS[t.dtype]) if t.dtype in _BITS else t


def assert_bitwise(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(bits(got[name]), bits(t)), name


@pytest.mark.parametrize("name", DRIVES)
def test_decode_step_reads_no_value_on_the_host(name):
    """(a) The whole decode step on the meta device, where any host read of
    a tensor's value raises (boolean-mask indexing, ``nonzero``,
    ``.item()``). The plain backends: the kernel wrappers take CPU or CUDA
    tensors only."""
    eng, _ = drive_engine(name, backend="aqua-block-sparse-plain")
    lanes, meta = eng.scfg.max_lanes, torch.device("meta")

    def to_meta(tree):
        if isinstance(tree, dict):
            return {k: to_meta(v) for k, v in tree.items()}
        if isinstance(tree, list):            # a hybrid's per-layer params
            return [to_meta(v) for v in tree]
        return tree.to(meta)
    state = eng.model.init_decode_state(lanes, eng.scfg.max_seq,
                                        device=meta)
    logits, _ = eng.model.decode_step(
        to_meta(eng.params), state,
        torch.zeros(lanes, dtype=torch.int32, device=meta),
        aqua_proj=None if eng.proj is None else eng.proj.to(meta),
        write_mask=torch.ones(lanes, dtype=torch.bool, device=meta))
    assert logits.device == meta
    assert logits.shape == (lanes, eng.cfg.vocab_size)
    assert isinstance(state.layers, kv.PagedAttnCache) == eng.paged
    if eng.paged:
        assert state.layers.quantized == ("int8" in name)


@pytest.mark.parametrize("name", DRIVES)
def test_step_that_writes_no_lane_leaves_the_state_unchanged(name):
    """(b) After real admissions and three decode steps (H2O lanes already
    evicting, window rings wrapped, chunked lanes mid-prefill), one decode
    step with the write mask all False changes no bit of the state."""
    eng, reqs = drive_engine(name)
    serve_until(eng, reqs(at_once=True), steps=3)
    state = eng.last_state
    assert int(state.layers.count.max()) > 0
    before = {k: t.clone() for k, t in state_tensors(state).items()}
    lanes = eng.scfg.max_lanes
    logits, _ = eng.model.decode_step(
        eng.params, state, torch.arange(1, lanes + 1, dtype=torch.int32),
        aqua_proj=eng.proj, write_mask=torch.zeros(lanes, dtype=torch.bool))
    assert torch.isfinite(logits).all()
    assert_bitwise(state_tensors(state), before)


@pytest.mark.parametrize("name", DRIVES)
def test_serve_writes_the_state_in_place(name):
    """(c) Five requests through three lanes: every state tensor keeps its
    storage through the serve; ``reset_cache`` gives what a fresh state
    holds; a second serve on the same tensors gives the same tokens."""
    eng, reqs = drive_engine(name)
    ptrs, first = None, {}
    for ev in eng.serve(reqs()):
        if ptrs is None:
            state = eng.last_state
            ptrs = {k: t.data_ptr() for k, t in state_tensors(state).items()}
        first.setdefault(ev.uid, []).append(ev.token)
    st = eng.stats
    assert st.requests_finished == 5 and st.decode_steps > 0
    if name == "chunked_paged":
        assert st.chunked_admissions > 0
    if name in ("swa_paged", "h2o_paged", "int8_swa_paged",
                "int8_h2o_paged", "recurrentgemma-9b"):
        assert eng.eviction == ("h2o" if "h2o" in name else "ring")
    if name in SHARED_PREFIX:
        assert eng.page_pool.prefix_hits == 4
    assert eng.last_state is state
    assert {k: t.data_ptr()
            for k, t in state_tensors(state).items()} == ptrs
    kv.reset_cache(state.layers)
    fresh = eng.model.init_decode_state(eng.scfg.max_lanes, eng.scfg.max_seq)
    assert_bitwise(state_tensors(state), state_tensors(fresh))
    second = eng.run(reqs())
    assert eng.last_state is state
    assert {k: t.data_ptr()
            for k, t in state_tensors(state).items()} == ptrs
    assert {u: o.tokens for u, o in second.items()} == first


def _masked_int8_insert(cache, slot, k_new, v_new, write_mask):
    """The int8 ``paged_insert`` before it became sync-free: it selects
    the writing rows by boolean-mask indexing (a host sync) and
    requantizes only their pages."""
    b, ps = cache.page_table.shape[0], cache.page_size
    entry = cache.page_table[torch.arange(b), (slot // ps).long()]
    ok = (entry >= 0) & write_mask
    phys, off = entry[ok].long(), (slot % ps)[ok].long()
    for pool, scale, new in ((cache.k_pool, cache.k_scale, k_new),
                             (cache.v_pool, cache.v_scale, v_new)):
        x = new[ok].float()
        amax = x.abs().amax(dim=-1)
        if scale.shape[1] == 1:
            amax = amax.amax(dim=-1, keepdim=True)
        s_old = scale[phys]
        s_cand = torch.maximum(s_old, amax / kv.QUANT_MAX)
        ratio = torch.where(s_cand > 0.0, s_old / s_cand,
                            torch.ones_like(s_old))
        page = pool[phys].float()
        pool[phys] = torch.round(page * ratio[:, :, None, None]).clamp(
            -kv.QUANT_MAX, kv.QUANT_MAX).to(pool.dtype)
        pool[phys, :, off] = kv.quantize_tokens(x, s_cand)
        scale[phys] = s_cand
    cache.pos_pool[phys, off] = cache.count[ok]
    cache.acc_pool[phys, :, off] = 0.0
    cache.count += write_mask.to(torch.int32)


@pytest.mark.parametrize("gran", ["page_head", "page"])
@pytest.mark.parametrize("case", ["masked", "unmapped", "all_off", "mixed"])
def test_int8_insert_equals_the_masked_insert(case, gran):
    """(d) 20 steps of growing magnitudes (pages requantize as their
    running scales grow) through both inserts on twin caches; every field
    equal bit for bit after every step. ``masked``: random lanes off;
    ``unmapped``: every lane writes, some slots' pages are unmapped;
    ``all_off``: every other step no lane writes; ``mixed``: all three."""
    b, kvh, d, ps, npl = 4, 2, 8, 4, 4
    rng = np.random.default_rng(9)
    table = torch.tensor([[5, 0, 9, -1], [1, 2, 3, 4], [7, -1, -1, -1],
                          [6, 8, -1, 10]], dtype=torch.int32)
    if case == "masked":
        table = torch.tensor([[5, 0, 9, 11], [1, 2, 3, 4], [7, 12, 13, 14],
                              [6, 8, 15, 10]], dtype=torch.int32)
    caches = []
    for _ in range(2):
        c = kv.init_paged_cache(b, kvh, 16, npl, ps, d, d, torch.float32,
                                "cpu", kv_dtype="int8",
                                scale_granularity=gran)
        c.page_table.copy_(table)
        caches.append(c)
    got, want = caches
    for step in range(20):
        grow = 1.0 + 0.4 * step
        k_new = torch.from_numpy(rng.standard_normal((b, kvh, d)) * grow
                                 ).float()
        v_new = torch.from_numpy(rng.standard_normal((b, kvh, d)) * grow
                                 ).float()
        mask = torch.ones(b, dtype=torch.bool)
        if case in ("masked", "mixed"):
            mask = torch.from_numpy(rng.random(b) < 0.6)
        if case in ("all_off", "mixed") and step % 2:
            mask = torch.zeros(b, dtype=torch.bool)
        slot = kv.paged_select_slot(got)[0]
        kv.paged_insert(got, slot, k_new, v_new, write_mask=mask)
        _masked_int8_insert(want, slot, k_new, v_new, mask)
        assert_bitwise({f: getattr(got, f) for f in ("k_pool", "v_pool",
                                                     "k_scale", "v_scale",
                                                     "pos_pool", "acc_pool",
                                                     "count")},
                       {f: getattr(want, f) for f in ("k_pool", "v_pool",
                                                      "k_scale", "v_scale",
                                                      "pos_pool", "acc_pool",
                                                      "count")})
    assert got.k_pool.abs().max() > 0 and (got.k_scale > 0).any()


def test_step_graph_refuses_a_cpu_state():
    """(e) On the CPU the engine decodes eagerly and has no step graph;
    a StepGraph over a CPU state raises."""
    eng, reqs = drive_engine("paged")
    eng.run(reqs())
    assert eng.step_graph is None
    with pytest.raises(ValueError, match="CUDA graph"):
        StepGraph(eng.model, eng.params, eng.last_state,
                  aqua_proj=eng.proj)
