"""The recurrent families in the port — Mamba-2-370M (``ssm``:
``models/mamba2.py``, no attention, no AQUA) and RecurrentGemma-9B
(``hybrid``: ``models/rglru.py``, RG-LRU blocks beside local attention
with AQUA) — against the JAX package, float32, inputs from numpy seeds
and weights carried by ``bridge.params_from_numpy``:

* the configs (fields, ``subquadratic``, ``validate``'s ssm and hybrid
  rules, the reductions);
* the building blocks at 1e-5 (atol and rtol; float32 sums in another
  order, the log-depth scans combine in another tree): ``ssd_chunked`` at
  chunk and length pairs that pad, with one, two and four groups;
  ``ssd_step``; ``rglru_scan`` with and without ``h0``; ``rglru_step``;
  the conv tails that decode starts from;
* the models at 1e-4 (as the other model tests): ``forward`` logits,
  ``prefill`` and 4 ``decode_step``s, the decode state layer by layer in
  JAX's order; the hybrid at 4 layers (recurrent, recurrent, attention,
  recurrent) with AQUA on ``aqua-block-sparse`` (JAX: Pallas in interpret
  mode) over prompts past its reduced window of 16;
* the hybrid's calibrated projections (top-k subspaces within 1e-3);
* the continuous-batching engines' greedy tokens equal the JAX engine's:
  JAX's own setting (``tests/test_scheduler.py``: 2 lanes, 3 requests of
  4/6/8 tokens, the reduced configs of 2 layers), and the 4-layer hybrid
  with AQUA over prompts past the window;
* ``ServeEngine.generate`` against JAX's, and its refusal of ``lengths``;
* a masked decode step leaves the idle lanes' state bit for bit;
* JAX's refusals: a paged cache, and a prefill budget the plan refuses
  with ``REASON_FAMILY_SURGERY``.

One JAX model per family per module (module-scoped fixtures).
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
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core import calibration as jax_cal
from repro.core import dispatch as jax_dispatch
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as jax_mamba2
from repro.models import rglru as jax_rglru
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import FLOAT32_PARAMS, params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, ServingConfig,
                                 get_config, reduced)
from repro_torch.core import calibration as cal
from repro_torch.core import dispatch
from repro_torch.core.calibration import AquaProjections
from repro_torch.data.corpus import calibration_batches
from repro_torch.models import build_model
from repro_torch.models import mamba2, rglru
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeEngine)

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
TOL = dict(atol=1e-4, rtol=1e-4)
TIGHT = dict(atol=1e-5, rtol=1e-5)
AQUA = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
MAX_SEQ = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side of these small shapes on one thread (the suite
    runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _configs(name):
    """(JAX config, port config): the hybrid at 4 layers and d_model 128
    (head dim 32: AQUA keeps 3 of 4 dim-blocks) with AQUA on the
    block-sparse backend; Mamba-2 as reduced, no AQUA."""
    if name == "mamba2-370m":
        return (dataclasses.replace(jax_reduced(name), remat=False),
                reduced(name))
    jcfg = dataclasses.replace(
        jax_reduced(name, layers=4, d_model=128), remat=False,
        aqua=JaxAquaConfig(prefill_k_blk=16, decode_seq_blk=16, **AQUA))
    jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
        jcfg.attention, backend="aqua-block-sparse"))
    tcfg = reduced(name, layers=4, d_model=128)
    tcfg = dataclasses.replace(
        tcfg, aqua=AquaConfig(**AQUA), attention=dataclasses.replace(
            tcfg.attention, backend="aqua-block-sparse"))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, params, config, port model, params, config,
    projections — the hybrid's per attention layer, or None)."""
    name = request.param
    jcfg, tcfg = _configs(name)
    jm = jax_build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    proj = None
    if name == "recurrentgemma-9b":
        att = tcfg.attention
        proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
            (jm.num_attn_layers, att.num_kv_heads, att.head_dim,
             att.head_dim)))[0].astype(np.float32)
    return dict(name=name, jm=jm, params=params, jcfg=jcfg,
                tm=build_model(tcfg, "cpu"),
                tparams=params_from_numpy(_np(params), "cpu"), tcfg=tcfg,
                proj=proj)


def _projs(pair):
    if pair["proj"] is None:
        return None, None
    return jnp.asarray(pair["proj"]), _t(pair["proj"])


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_jax(name):
    """Every field both packages define equal, published and reduced
    (``ssm`` and ``rglru`` too), ``subquadratic`` and ``validate``'s
    rules as JAX's."""
    for jcfg, tcfg in ((jax_get_config(name), get_config(name)),
                       (jax_reduced(name), reduced(name)),
                       (jax_reduced(name, layers=4, d_model=128),
                        reduced(name, layers=4, d_model=128))):
        for f in dataclasses.fields(tcfg):
            if f.name in ("attention", "frontend", "aqua", "moe"):
                continue
            want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f.name
        assert (tcfg.attention is None) == (jcfg.attention is None)
        if tcfg.attention is not None:
            for f in dataclasses.fields(tcfg.attention):
                if f.name != "backend":
                    assert getattr(tcfg.attention, f.name) == getattr(
                        jcfg.attention, f.name), f.name
        assert tcfg.subquadratic and jcfg.subquadratic
    cfg = get_config(name)
    if name == "mamba2-370m":
        assert cfg.attention is None and cfg.ssm.chunk_size == 256
        assert (reduced(name).ssm.state_dim, reduced(name).ssm.chunk_size
                ) == (16, 8)
        # attention may be None only for the ssm family
        bad = dataclasses.replace(cfg, family="dense")
    else:
        assert (cfg.num_layers, cfg.attention.head_dim, cfg.attention.window,
                cfg.act) == (38, 256, 2048, "gelu")
        assert reduced(name).attention.window == 16
        bad = dataclasses.replace(cfg, rglru=None)
    for c in (bad, dataclasses.replace(jax_get_config(name), **(
            dict(family="dense") if name == "mamba2-370m"
            else dict(rglru=None)))):
        with pytest.raises(AssertionError):
            c.validate()
    assert not get_config("qwen3-0.6b").subquadratic
    assert get_config("h2o-danube-1.8b").subquadratic == jax_get_config(
        "h2o-danube-1.8b").subquadratic


# -- building blocks -----------------------------------------------------------

@pytest.mark.parametrize("s,chunk,groups", [(13, 8, 1), (16, 8, 2),
                                            (21, 4, 4), (3, 8, 2)])
def test_ssd_chunked_matches_jax(s, chunk, groups):
    """Chunk and length pairs that pad (13 / 8, 21 / 4, 3 / 8) and one that
    does not; one, two and four groups over 4 heads."""
    rng = np.random.default_rng(s * 10 + groups)
    b, h, p, n = 2, 4, 8, 6
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, groups, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, groups, n)).astype(np.float32)
    d_skip = rng.standard_normal(h).astype(np.float32)
    args = (x, dt, a_log, bb, cc, d_skip)
    y_j, st_j = jax.jit(jax_mamba2.ssd_chunked, static_argnums=6)(
        *map(jnp.asarray, args), chunk)
    y_t, st_t = mamba2.ssd_chunked(*map(_t, args), chunk)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TIGHT)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **TIGHT)
    # the chunked form against a step-by-step recurrence
    state = torch.zeros(b, h, p, n)
    for i in range(s):
        y_i, state = mamba2.ssd_step(state, _t(x[:, i]), _t(dt[:, i]),
                                     _t(a_log), _t(bb[:, i]), _t(cc[:, i]),
                                     _t(d_skip))
        np.testing.assert_allclose(y_i.numpy(), y_t[:, i].numpy(), **TIGHT)
    np.testing.assert_allclose(state.numpy(), st_t.numpy(), **TIGHT)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(2)
    b, h, p, n, g = 3, 4, 8, 6, 2
    args = (rng.standard_normal((b, h, p, n)), rng.standard_normal((b, h, p)),
            np.abs(rng.standard_normal((b, h))),
            -np.abs(rng.standard_normal(h)), rng.standard_normal((b, g, n)),
            rng.standard_normal((b, g, n)), rng.standard_normal(h))
    args = [a.astype(np.float32) for a in args]
    y_j, st_j = jax.jit(jax_mamba2.ssd_step)(*map(jnp.asarray, args))
    y_t, st_t = mamba2.ssd_step(*map(_t, args))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TIGHT)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **TIGHT)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_and_step_match_jax(with_h0):
    rng = np.random.default_rng(3)
    b, s, w = 2, 37, 16
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    r, i_g = (1 / (1 + np.exp(-rng.standard_normal((b, s, w))))
              .astype(np.float32) for _ in range(2))
    lam = rng.standard_normal(w).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    h_j, last_j = jax.jit(jax_rglru.rglru_scan)(
        *map(jnp.asarray, (x, r, i_g, lam)),
        None if h0 is None else jnp.asarray(h0))
    h_t, last_t = rglru.rglru_scan(*map(_t, (x, r, i_g, lam)),
                                   None if h0 is None else _t(h0))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TIGHT)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), **TIGHT)
    # the scan against the step, from h0 or zero
    h = torch.zeros(b, w) if h0 is None else _t(h0)
    for i in range(s):
        h, _ = rglru.rglru_step(_t(x[:, i]), _t(r[:, i]), _t(i_g[:, i]),
                                _t(lam), h)
        np.testing.assert_allclose(h_t[:, i].numpy(), h.numpy(), **TIGHT)
    np.testing.assert_allclose(
        rglru.rglru_step(*map(_t, (x[:, 0], r[:, 0], i_g[:, 0], lam)),
                         _t(x[:, 1]))[0].numpy(),
        np.asarray(jax.jit(jax_rglru.rglru_step)(*map(jnp.asarray, (
            x[:, 0], r[:, 0], i_g[:, 0], lam, x[:, 1])))[0]), **TIGHT)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_linear_scan_is_the_recurrence(n):
    """The log-depth scan equals h_t = a_t h_{t-1} + b_t step by step, and
    its first output is the running product of a."""
    rng = np.random.default_rng(n)
    a = _t(rng.uniform(0.2, 1.0, (2, n, 3)).astype(np.float32))
    b = _t(rng.standard_normal((2, n, 3)).astype(np.float32))
    a_s, h = mamba2.linear_scan(a, b, 1)
    run, prod = torch.zeros(2, 3), torch.ones(2, 3)
    for i in range(n):
        run = a[:, i] * run + b[:, i]
        prod = prod * a[:, i]
        np.testing.assert_allclose(h[:, i].numpy(), run.numpy(), **TIGHT)
        np.testing.assert_allclose(a_s[:, i].numpy(), prod.numpy(), **TIGHT)


def test_conv_tails_match_jax(pair):
    """The blocks over a sequence: outputs, the raw conv tail that decode
    starts from, and the final state, against JAX's."""
    rng = np.random.default_rng(5)
    jcfg, tcfg = pair["jcfg"], pair["tcfg"]
    x = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    if pair["name"] == "mamba2-370m":
        p_j = jax.tree.map(lambda a: a[0], pair["params"]["layers"])
        y_j, (tail_j, st_j) = jax.jit(pair["jm"]._block_seq)(
            p_j, jnp.asarray(x))
        p_t = {k: v[0] for k, v in pair["tparams"]["layers"].items()}
        y_t, (tail_t, st_t) = pair["tm"]._block_seq(p_t, _t(x))
    else:
        y_j, (tail_j, st_j) = jax.jit(
            lambda p, x: jax_rglru.recurrent_block_forward(jcfg, p, x))(
                pair["params"]["layers"][0], jnp.asarray(x))
        y_t, (tail_t, st_t) = rglru.recurrent_block_forward(
            tcfg, pair["tparams"]["layers"][0], _t(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(tail_t.numpy(), np.asarray(tail_j), **TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **TOL)
    assert tail_t.shape[1] == (tcfg.ssm or tcfg.rglru).conv_width - 1


def test_bridge_carries_the_recurrent_trees(pair):
    """``params_from_numpy`` gives the port's own init tree (Mamba-2's
    stacked blocks, the hybrid's list of per-layer dicts), values equal to
    JAX's; cast to bf16, the ``FLOAT32_PARAMS`` stay float32, as JAX draws
    them."""
    own = pair["tm"].init(torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape), str(t.dtype)
    assert shapes(pair["tparams"]) == shapes(own)
    for path, leaf in jax.tree_util.tree_leaves_with_path(pair["params"]):
        t = pair["tparams"]
        for k in path:
            t = t[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    bf = params_from_numpy(_np(pair["params"]), "cpu", dtype=torch.bfloat16)
    names = (("a_log", "dt_bias", "d_skip") if pair["name"] == "mamba2-370m"
             else ("wr", "wi", "lam"))
    layer = bf["layers"] if pair["name"] == "mamba2-370m" else \
        bf["layers"][0]
    assert all(layer[k].dtype == torch.float32 for k in names)
    assert set(names) <= set(FLOAT32_PARAMS)
    assert layer["conv_w"].dtype == torch.bfloat16
    bf_own = type(pair["tm"])(dataclasses.replace(
        pair["tcfg"], param_dtype="bfloat16"), "cpu").init(
            torch.Generator().manual_seed(0))
    own_layer = bf_own["layers"] if pair["name"] == "mamba2-370m" else \
        bf_own["layers"][0]
    assert all(own_layer[k].dtype == torch.float32 for k in names)


# -- models --------------------------------------------------------------------

def _state_layers(pair, state):
    """The port's decode state as JAX's per-layer list: Mamba-2's stacked
    SSMCache by layer, the hybrid's two stacks in model order."""
    tm = pair["tm"]
    if pair["name"] == "mamba2-370m":
        return [state.layers.layer(i) for i in range(tm.cfg.num_layers)]
    return [state.layers.attn.layer(tm.stack_index(i)) if kind == "attention"
            else state.layers.rec.layer(tm.stack_index(i))
            for i, kind in enumerate(tm.kinds)]


def _jax_layers(pair, state):
    if pair["name"] == "mamba2-370m":
        n = pair["jcfg"].num_layers
        return [jax.tree.map(lambda a, i=i: a[i], state.layers)
                for i in range(n)]
    return list(state.layers)


def _assert_states(pair, st, sj):
    for mine, theirs in zip(_state_layers(pair, st), _jax_layers(pair, sj),
                            strict=True):
        for f in dataclasses.fields(mine):
            got = getattr(mine, f.name)
            want = getattr(theirs, f.name, None)
            if got is None or want is None:
                continue
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       **TOL, err_msg=f.name)


def test_model_logits_equal_jax(pair):
    """``forward``, ``prefill`` (the hybrid's 20-token prompts past its
    window of 16) and 4 greedy decode steps, logits within TOL, the decode
    state layer by layer."""
    jm, tm, jcfg = pair["jm"], pair["tm"], pair["jcfg"]
    params, tparams = pair["params"], pair["tparams"]
    jp, tp = _projs(pair)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    with torch.no_grad():
        want = jax.jit(lambda p, t, pr: jm.forward(p, {"tokens": t},
                                                   aqua_proj=pr))(
            params, jnp.asarray(toks), jp)
        got = tm.forward(tparams, {"tokens": _t(toks)}, aqua_proj=tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        lj, sj = jax.jit(lambda p, t, pr: jm.prefill(
            p, {"tokens": t}, MAX_SEQ, aqua_proj=pr))(
                params, jnp.asarray(toks), jp)
        lt, st = tm.prefill(tparams, {"tokens": _t(toks)}, MAX_SEQ,
                            aqua_proj=tp)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        _assert_states(pair, st, sj)
        step = jax.jit(lambda p, s, t, pr: jm.decode_step(p, s, t,
                                                          aqua_proj=pr))
        for _ in range(4):
            tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
            lj, sj = step(params, sj, jnp.asarray(tok), jp)
            lt, st = tm.decode_step(tparams, st, _t(tok), aqua_proj=tp)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        _assert_states(pair, st, sj)
        assert int(st.layers.count.max()) == 24


def test_hybrid_calibration_projections_match_jax(pair):
    """The hybrid captures only its attention layers: the same batches
    through both packages' capture and ``calibrate`` give one projection
    per attention layer, the port's top-k directions in JAX's top-k
    subspace. Mamba-2 captures nothing (and JAX's launcher calibrates
    neither family)."""
    jm, tm, tcfg = pair["jm"], pair["tm"], pair["tcfg"]
    if pair["name"] == "mamba2-370m":
        out = tm.forward(pair["tparams"], {"tokens": torch.zeros(
            1, 4, dtype=torch.int32)}, capture=True)
        assert out[1]["qk"] == []
        return
    batches = list(calibration_batches(tcfg.vocab_size, num_batches=1,
                                       batch=2, seq=24))
    capture = jax.jit(lambda p, b: jm.forward(p, b, capture=True)[1])
    want = np.asarray(jax_cal.calibrate(
        lambda p, b: capture(p, {k: jnp.asarray(v) for k, v in b.items()}),
        pair["params"], batches, pair["jcfg"]).p)
    got = cal.calibrate(cal.capture_forward(tm), pair["tparams"], batches,
                        tcfg, device="cpu").p.numpy()
    att = tcfg.attention
    assert got.shape == want.shape == (tm.num_attn_layers, att.num_kv_heads,
                                       att.head_dim, att.head_dim)
    k = int(0.75 * att.head_dim)
    cross = np.einsum("lhdi,lhdj->lhij", want[..., k:], got[..., :k])
    assert np.abs(cross).max() < 1e-3


def test_masked_decode_keeps_idle_lanes_bitwise(pair):
    """A decode step with lanes 1 and 2 of 4 masked out leaves their
    state (conv windows, SSD states or RG-LRU hiddens, attention slots,
    counts) bit for bit; an all-False mask changes nothing."""
    tm, tparams = pair["tm"], pair["tparams"]
    _, tp = _projs(pair)
    rng = np.random.default_rng(9)
    state = tm.init_decode_state(4, MAX_SEQ)
    for lane, n in enumerate((5, 18, 9, 3)):
        toks = rng.integers(0, pair["tcfg"].vocab_size, (1, n))
        tm.prefill_into(tparams, {"tokens": _t(toks.astype(np.int32))},
                        MAX_SEQ, state, lane, aqua_proj=tp)
    from repro_torch.models.base import cache_tensors
    before = [t.clone() for t in cache_tensors(state.layers)]
    count = state.layers.count.clone()
    tok = torch.from_numpy(rng.integers(0, 100, 4).astype(np.int32))
    mask = torch.tensor([True, False, False, True])
    with torch.no_grad():
        tm.decode_step(tparams, state, tok, aqua_proj=tp, write_mask=mask)
    after = cache_tensors(state.layers)
    for b, a in zip(before, after):
        assert torch.equal(a[:, 1:3], b[:, 1:3])
    assert not all(torch.equal(a[:, 0], b[:, 0])
                   for a, b in zip(after, before))
    assert torch.equal(state.layers.count[:, [0, 3]], count[:, [0, 3]] + 1)
    snap = [t.clone() for t in after]
    with torch.no_grad():
        tm.decode_step(tparams, state, tok, aqua_proj=tp,
                       write_mask=torch.zeros(4, dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(cache_tensors(
        state.layers), snap))


# -- engines -------------------------------------------------------------------

def _jax_setting_requests(cls, vocab):
    """JAX's ``test_nonattention_families_serve_through_lanes`` trace."""
    rng = np.random.default_rng(0)
    return [cls(uid=i, tokens=rng.integers(0, vocab, size=(4 + 2 * i,),
                                           dtype=np.int32),
                arrival=float(i)) for i in range(3)]


@pytest.mark.parametrize("name", ARCHS)
def test_engine_greedy_tokens_match_jax_setting(name):
    """JAX's own setting (the reduced configs of 2 layers, 2 lanes, max_seq
    32, 4 new tokens): the port engine's tokens equal the JAX engine's and
    each request's solo ``ServeEngine`` run."""
    jcfg = dataclasses.replace(jax_reduced(name), remat=False)
    tcfg = reduced(name)
    jm = jax_build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np(params), "cpu")
    serve = dict(max_lanes=2, max_seq=32, max_new_tokens=4)
    want = JaxEngine(jcfg, params, None, serving=JaxServingConfig(
        **serve)).run(_jax_setting_requests(JaxRequest, jcfg.vocab_size))
    eng = ContinuousBatchingEngine(tcfg, tparams, None,
                                   serving=ServingConfig(**serve),
                                   device="cpu")
    reqs = _jax_setting_requests(Request, tcfg.vocab_size)
    got = eng.run(reqs)
    solo = ServeEngine(tcfg, tparams, None, max_seq=32, device="cpu")
    for r in reqs:
        assert got[r.uid].tokens == list(want[r.uid].tokens), r.uid
        ref = solo.generate({"tokens": np.asarray(r.tokens)[None]}, steps=4)
        assert got[r.uid].tokens == list(ref.tokens[0])
    assert eng.stats.mean_occupancy > 1.0
    assert not eng._supports_ragged


@pytest.fixture(scope="module")
def served(pair):
    """One JAX engine run and one port engine run of the pair: 3 lanes, 5
    requests of 20, 9, 20, 27 and 9 tokens (the hybrid's past its window
    of 16), 6 new tokens each."""
    serve = dict(max_lanes=3, max_seq=MAX_SEQ, max_new_tokens=6)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, pair["tcfg"].vocab_size, n, dtype=np.int32)
               for n in (20, 9, 20, 27, 9)]

    def reqs(cls):
        return [cls(uid=i, tokens=t, max_new_tokens=6, arrival=0.5 * i)
                for i, t in enumerate(prompts)]
    jp, tp = _projs(pair)
    jeng = JaxEngine(pair["jcfg"], pair["params"],
                     None if jp is None else JaxProjections(p=jp),
                     serving=JaxServingConfig(**serve))
    want = jeng.run(reqs(JaxRequest))
    eng = ContinuousBatchingEngine(
        pair["tcfg"], pair["tparams"],
        None if tp is None else AquaProjections(p=tp),
        serving=ServingConfig(**serve), device="cpu")
    got = eng.run(reqs(Request))
    return dict(want=want, got=got, jeng=jeng, eng=eng)


def test_engine_greedy_tokens_match_jax(pair, served):
    """The hybrid with AQUA (window rings wrapped by 20- and 27-token
    prompts) and Mamba-2: every request's greedy tokens equal the JAX
    engine's, lanes reused."""
    want, got, eng = served["want"], served["got"], served["eng"]
    assert want.keys() == got.keys()
    for uid, out in want.items():
        assert got[uid].tokens == list(out.tokens), (pair["name"], uid)
    assert len(want) > eng.scfg.max_lanes
    plan, jplan = eng.dispatch_plan(), served["jeng"].dispatch_plan()
    assert plan.backend == jplan.backend
    assert plan.cache_layout == jplan.cache_layout == "contiguous"
    assert eng.cache_bytes() > 0


def test_serve_engine_generate_matches_jax(pair):
    """The rectangular engine (the hybrid on ``aqua-masked-dense``) on a
    batch of two 18-token prompts, and its refusal of ragged lengths."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, pair["tcfg"].vocab_size, (2, 18)).astype(np.int32)
    jp, tp = _projs(pair)
    backend = None if jp is None else "aqua-masked-dense"
    jeng = JaxServeEngine(pair["jcfg"], pair["params"],
                          None if jp is None else JaxProjections(p=jp),
                          max_seq=MAX_SEQ, backend=backend)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, steps=4)
    eng = ServeEngine(pair["tcfg"], pair["tparams"],
                      None if tp is None else AquaProjections(p=tp),
                      max_seq=MAX_SEQ, backend=backend, device="cpu")
    got = eng.generate({"tokens": toks}, steps=4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits_last, np.asarray(want.logits_last),
                               **TOL)
    ragged = {"tokens": toks, "lengths": np.array([18, 7], np.int32)}
    with pytest.raises(ValueError, match="rectangular"):
        eng.generate(ragged, steps=2)
    with pytest.raises(ValueError, match="rectangular"):
        jeng.generate({k: jnp.asarray(v) for k, v in ragged.items()},
                      steps=2)


def test_refusals_raise_as_in_jax(pair, monkeypatch):
    """A paged cache raises ``ValueError`` in both engines; a prefill
    budget plans monolithic admission with ``REASON_FAMILY_SURGERY`` in
    both plans, whose fields agree."""
    from repro.configs.base import CacheSpec as JaxCacheSpec
    jp, tp = _projs(pair)
    jproj = None if jp is None else JaxProjections(p=jp)
    proj = None if tp is None else AquaProjections(p=tp)
    serve = dict(max_lanes=2, max_seq=MAX_SEQ, max_new_tokens=4)
    with pytest.raises(ValueError, match="paged"):
        JaxEngine(pair["jcfg"], pair["params"], jproj,
                  serving=JaxServingConfig(cache=JaxCacheSpec(page_size=8),
                                           **serve))
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(
            pair["tcfg"], pair["tparams"], proj, device="cpu",
            serving=ServingConfig(cache=CacheSpec(page_size=8), **serve))
    # JAX resolves backends as on its chip, where it prefers the kernels
    monkeypatch.setattr(runtime_flags, "PALLAS_OVERRIDE", True)
    budget = dict(serve, prefill_budget_tokens=16)
    jcfg = pair["jcfg"]
    jplan = jax_dispatch.resolve_dispatch_plan(
        attention=jcfg.attention, aqua=jcfg.aqua,
        serving=JaxServingConfig(**budget), mesh=None,
        prefix_sharing=False, family=jcfg.family,
        frontend=jcfg.frontend.kind)
    eng = ContinuousBatchingEngine(pair["tcfg"], pair["tparams"], proj,
                                   serving=ServingConfig(**budget),
                                   device="cpu")
    plan = eng.dispatch_plan()
    for f in dataclasses.fields(plan):
        assert getattr(plan, f.name) == getattr(jplan, f.name), f.name
    assert not plan.chunked_prefill
    assert dispatch.REASON_FAMILY_SURGERY in plan.chunked_reasons
    assert dispatch.REASON_FAMILY_SURGERY == jax_dispatch.REASON_FAMILY_SURGERY
    with pytest.raises(NotImplementedError):
        eng.model.prefill_chunk(None, None, None, 0, 0)
