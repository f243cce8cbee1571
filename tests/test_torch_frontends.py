"""The modality-frontend families in the port — Pixtral-12B (``vlm``:
``DenseLM`` with projected patch embeddings spliced over the first prompt
positions) and Whisper-tiny (``encdec``: ``EncDecLM``, a bidirectional
encoder over frame embeddings and a causal decoder with cross-attention)
— against the JAX package on the reduced configs (d_model 128: head dim
32, so that AQUA at ``block_dims`` 8 selects 3 of 4 dim-blocks), float32,
inputs from numpy seeds:

* the configs (fields, reductions, ``validate``'s ``encdec`` rule), the
  layers (``linear``, ``sinusoidal_positions``) and the bridged param
  trees (``patch_proj``; the ``encdec`` tree);
* logits within atol / rtol 1e-4 (as the dense model tests): Pixtral's
  ``forward`` (its patches change the logits), ``prefill`` with ragged
  lengths and its ``decode_step``s; Whisper's ``encode``, ``forward``,
  ``prefill`` with its cross K/V, and ``decode_step``s; AQUA on the
  ``aqua-block-sparse`` backend (JAX: Pallas in interpret mode);
* the calibration projections of both, from the same captured q/k:
  the port's top-k directions lie in JAX's top-k subspace (1e-3);
* the continuous-batching engines' greedy tokens equal the JAX engine's:
  Pixtral on the paged pool (8-token pages, prefix sharing asked for and
  off, as in JAX), some requests with patches and some without;
  Whisper on the contiguous cache, 5 requests through 3 lanes, each with
  its own frames (a reused lane's cross K/V grafted over an earlier
  request's);
* ``ServeEngine.generate`` for both families against JAX's;
* JAX's refusals raise in the port too: a paged ``encdec``, a prompt
  shorter than its patches (the 4-token one fits, as the engine test's
  8-token buckets show), ragged ``lengths`` for ``encdec``, and a
  prefill budget, which both plans refuse with ``REASON_FRONTEND``;
* ``core.aqua.SelectionTape`` (what holds the full-width Pixtral drive on
  the card to a plain drive with its selections): a replay returns the
  recording whatever the inputs, a plain engine replaying a kernel
  engine's drive makes the same calls and gives its tokens, and a
  recording decode step reads no value on the host (meta device).
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
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core import calibration as jax_cal
from repro.core import dispatch as jax_dispatch
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, ServingConfig,
                                 get_config, reduced)
from repro_torch.core import aqua as aqua_lib
from repro_torch.core import calibration as cal
from repro_torch.core import dispatch
from repro_torch.core.calibration import AquaProjections
from repro_torch.data.corpus import add_frontend_inputs, calibration_batches
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeEngine)

ARCHS = ("pixtral-12b", "whisper-tiny")
TOL = dict(atol=1e-4, rtol=1e-4)
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


def _frontend(cfg, rng, b=1):
    """One batch's stub frontend inputs of ``cfg`` from ``rng``."""
    fe = cfg.frontend
    if fe.kind == "vision_patches":
        return {"patches": rng.standard_normal(
            (b, fe.num_embeds, fe.embed_dim)).astype(np.float32)}
    return {"frames": rng.standard_normal(
        (b, fe.num_embeds, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, JAX params, JAX config, port model, port params, port
    config, projections) of a reduced arch with AQUA."""
    name = request.param
    jcfg = jax_reduced(name, d_model=128)
    tcfg = reduced(name, d_model=128)
    jcfg = dataclasses.replace(jcfg, aqua=JaxAquaConfig(
        prefill_k_blk=16, decode_seq_blk=16, **AQUA),
        attention=dataclasses.replace(jcfg.attention,
                                      backend="aqua-block-sparse"))
    tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(**AQUA),
                               attention=dataclasses.replace(
                                   tcfg.attention,
                                   backend="aqua-block-sparse"))
    jm = jax_build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    return dict(name=name, jm=jm, params=params, jcfg=jcfg,
                tm=build_model(tcfg, "cpu"),
                tparams=params_from_numpy(_np(params), "cpu"), tcfg=tcfg,
                proj=proj)


# -- configs, layers, bridge ---------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_jax(name):
    """Every field both packages define equal, published and reduced."""
    for get in (lambda n: (jax_get_config(n), get_config(n)),
                lambda n: (jax_reduced(n), reduced(n))):
        jcfg, tcfg = get(name)
        for f in dataclasses.fields(tcfg):
            if f.name in ("attention", "frontend", "aqua", "moe"):
                continue
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert dataclasses.asdict(tcfg.frontend) == dataclasses.asdict(
            jcfg.frontend)
        for f in dataclasses.fields(tcfg.attention):
            if f.name != "backend":
                assert getattr(tcfg.attention, f.name) == getattr(
                    jcfg.attention, f.name), f.name
    p, w = get_config("pixtral-12b"), get_config("whisper-tiny")
    assert (p.num_layers, p.d_model, p.d_ff, p.vocab_size) == (
        40, 5120, 14336, 131072)
    assert (p.frontend.num_embeds, p.frontend.embed_dim) == (256, 1024)
    assert (w.num_layers, w.num_encoder_layers, w.d_model, w.act,
            w.attention.use_rope) == (4, 4, 384, "gelu", False)
    assert (reduced("whisper-tiny").num_encoder_layers,
            reduced("pixtral-12b").frontend.num_embeds) == (2, 4)
    with pytest.raises(AssertionError):
        dataclasses.replace(w, num_encoder_layers=0).validate()
    with pytest.raises(AssertionError):
        dataclasses.replace(jax_get_config("whisper-tiny"),
                            num_encoder_layers=0).validate()


def test_linear_and_sinusoidal_positions_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    p = {"w": rng.standard_normal((12, 7)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    for keys in (("w",), ("w", "b")):
        q = {k: p[k] for k in keys}
        want = np.asarray(jax_layers.linear(
            {k: jnp.asarray(v) for k, v in q.items()}, jnp.asarray(x)))
        got = L.linear({k: torch.from_numpy(v) for k, v in q.items()},
                       torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # float32 sin / cos of angles up to 1499 rad: the two libraries'
    # argument reductions differ by a few 1e-6
    for seq, d in ((7, 16), (1500, 384)):
        np.testing.assert_allclose(
            L.sinusoidal_positions(seq, d).numpy(),
            np.asarray(jax_layers.sinusoidal_positions(seq, d)),
            atol=1e-5, rtol=0)
    lin = L.init_linear(torch.Generator().manual_seed(0), 32, 128)
    assert set(lin) == {"w"} and lin["w"].shape == (32, 128)


def test_bridge_carries_the_frontend_trees(pair):
    """``params_from_numpy`` gives the port's own init tree: the same keys
    and shapes (Pixtral's ``patch_proj``; Whisper's ``pos``,
    ``enc_layers``, ``enc_ln``, ``dec_layers`` with ``xattn`` and
    ``ln_x``, ``ln_f``), values equal to JAX's."""
    own = pair["tm"].init(torch.Generator().manual_seed(0))

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))
    assert shapes(pair["tparams"]) == shapes(own)
    if pair["name"] == "pixtral-12b":
        assert shapes(own["patch_proj"]) == {"w": (32, 128)}
    else:
        assert {"embed", "pos", "enc_layers", "enc_ln", "dec_layers",
                "ln_f"} == set(own)
        assert {"ln1", "ln_x", "ln2", "attn", "xattn", "ffn"} == set(
            own["dec_layers"])
        assert "w3" not in own["dec_layers"]["ffn"]
    flat = jax.tree_util.tree_leaves_with_path(pair["params"])
    for path, leaf in flat:
        t = pair["tparams"]
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


# -- models --------------------------------------------------------------------

def _steps(pair, lj, sj, lt, st, n=3):
    """``n`` greedy decode steps of both packages from their prefills,
    logits within TOL at each."""
    jm, tm = pair["jm"], pair["tm"]
    jp, tp = jnp.asarray(pair["proj"]), torch.from_numpy(pair["proj"])
    step = jax.jit(lambda p, s, t, pr: jm.decode_step(p, s, t, aqua_proj=pr))
    for _ in range(n):
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
        lj, sj = step(pair["params"], sj, jnp.asarray(tok), jp)
        lt, st = tm.decode_step(pair["tparams"], st, torch.from_numpy(tok),
                                aqua_proj=tp)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_array_equal(st.layers.count.numpy(),
                                  np.asarray(sj.layers.count))


def test_model_logits_equal_jax(pair):
    jm, tm, jcfg = pair["jm"], pair["tm"], pair["jcfg"]
    params, tparams = pair["params"], pair["tparams"]
    jp, tp = jnp.asarray(pair["proj"]), torch.from_numpy(pair["proj"])
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    batch = dict(tokens=toks, **_frontend(jcfg, rng, 2))

    def both(b):
        return ({k: jnp.asarray(v) for k, v in b.items()},
                {k: torch.from_numpy(v) for k, v in b.items()})
    jb, tb = both(batch)
    forward = jax.jit(lambda p, b, pr: jm.forward(p, b, aqua_proj=pr))
    prefill = jax.jit(lambda p, b, pr: jm.prefill(p, b, MAX_SEQ,
                                                  aqua_proj=pr))
    with torch.no_grad():
        want = forward(params, jb, jp)
        got = tm.forward(tparams, tb, aqua_proj=tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        if pair["name"] == "whisper-tiny":
            np.testing.assert_allclose(
                tm.encode(tparams, tb["frames"]).numpy(),
                np.asarray(jax.jit(jm.encode)(params, jb["frames"])), **TOL)
            lj, sj = prefill(params, jb, jp)
            lt, st = tm.prefill(tparams, tb, MAX_SEQ, aqua_proj=tp)
            for a, b in zip(st.extra["cross"], sj.extra["cross"]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        else:
            # the patches replace the first positions' embeddings
            plain = tm.forward(tparams, both({"tokens": toks})[1],
                               aqua_proj=tp).numpy()
            assert not np.allclose(got.numpy()[:, :4], plain[:, :4])
            lengths = np.array([20, 11], np.int32)
            jb["lengths"], tb["lengths"] = (jnp.asarray(lengths),
                                            torch.from_numpy(lengths))
            lj, sj = prefill(params, jb, jp)
            lt, st = tm.prefill(tparams, tb, MAX_SEQ, aqua_proj=tp)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(st.layers.k.numpy(),
                                   np.asarray(sj.layers.k), **TOL)
        _steps(pair, lj, sj, lt, st)


def test_calibration_projections_match_jax(pair):
    """The same batches (tokens and frontend inputs) through both
    packages' capture and ``calibrate``: the port's top-k directions lie
    in JAX's top-k subspace."""
    jm, tm, tcfg = pair["jm"], pair["tm"], pair["tcfg"]
    batches = list(calibration_batches(tcfg.vocab_size, num_batches=1,
                                       batch=2, seq=16, model_cfg=tcfg))
    assert all(set(b) == {"tokens", *_frontend(tcfg, np.random.default_rng(
        0))} for b in batches)
    capture = jax.jit(lambda p, b: jm.forward(p, b, capture=True)[1])
    want = np.asarray(jax_cal.calibrate(
        lambda p, b: capture(p, {k: jnp.asarray(v) for k, v in b.items()}),
        pair["params"], batches, pair["jcfg"]).p)
    got = cal.calibrate(cal.capture_forward(tm), pair["tparams"], batches,
                        tcfg, device="cpu").p.numpy()
    assert got.shape == want.shape == (tcfg.num_layers,
                                       tcfg.attention.num_kv_heads,
                                       tcfg.attention.head_dim,
                                       tcfg.attention.head_dim)
    k = int(0.75 * tcfg.attention.head_dim)
    cross = np.einsum("lhdi,lhdj->lhij", want[..., k:], got[..., :k])
    assert np.abs(cross).max() < 1e-3


# -- engines -------------------------------------------------------------------

SERVE = dict(max_new_tokens=8, prompt_bucket=8, max_seq=MAX_SEQ)
# Pixtral: paged, 4 lanes, 6 requests off the bucket (two buckets), every
# other one with patches; Whisper: contiguous, 3 lanes, 5 requests of two
# prompt lengths (each a program of its own in JAX: exact-length prefill)
ENGINES = {"pixtral-12b": dict(lanes=4, prompts=(5, 12, 7, 13, 3, 15),
                               page_size=8, patches=lambda i: i % 2 == 0),
           "whisper-tiny": dict(lanes=3, prompts=(5, 12, 5, 12, 5),
                                page_size=None, patches=lambda i: True)}


def _requests(cls, tcfg, spec):
    """Arrivals 0.75 steps apart, each request's own frontend inputs."""
    rng = np.random.default_rng(6)
    out = []
    for i, n in enumerate(spec["prompts"]):
        toks = rng.integers(0, tcfg.vocab_size, n, dtype=np.int32)
        extra = _frontend(tcfg, rng) if spec["patches"](i) else None
        out.append(cls(uid=i, tokens=toks, max_new_tokens=8,
                       arrival=0.75 * i, extra_inputs=extra))
    return out


@pytest.fixture(scope="module")
def served(pair):
    """One JAX engine run and one port engine run of the arch's trace."""
    spec = ENGINES[pair["name"]]
    cache = ({} if spec["page_size"] is None
             else dict(page_size=spec["page_size"]))
    serve = dict(SERVE, max_lanes=spec["lanes"])
    jeng = JaxEngine(pair["jcfg"], pair["params"],
                     JaxProjections(p=jnp.asarray(pair["proj"])),
                     serving=JaxServingConfig(cache=JaxCacheSpec(**cache),
                                              **serve),
                     backend="aqua-block-sparse")
    want = jeng.run(_requests(JaxRequest, pair["tcfg"], spec))
    eng = ContinuousBatchingEngine(
        pair["tcfg"], pair["tparams"],
        AquaProjections(p=torch.from_numpy(pair["proj"])),
        serving=ServingConfig(cache=CacheSpec(**cache), **serve),
        backend="aqua-block-sparse", device="cpu")
    got = eng.run(_requests(Request, pair["tcfg"], spec))
    return dict(want=want, got=got, jeng=jeng, eng=eng)


def test_engine_greedy_tokens_match_jax(pair, served):
    want, got, eng = served["want"], served["got"], served["eng"]
    assert want.keys() == got.keys()
    for uid, out in want.items():
        assert got[uid].tokens == list(out.tokens), (pair["name"], uid)
    plan, jplan = eng.dispatch_plan(), served["jeng"].dispatch_plan()
    assert not plan.prefix_sharing and not jplan.prefix_sharing
    assert plan.cache_layout == jplan.cache_layout
    if pair["name"] == "pixtral-12b":
        assert eng.paged and eng.page_pool.prefix_hits == 0
    else:
        # exact-length admissions; a reused lane holds its latest
        # request's cross K/V
        assert not eng._supports_ragged and len(want) > eng.scfg.max_lanes
        assert eng.last_state.extra["cross"][0].abs().sum() > 0


def test_serve_engine_generate_matches_jax(pair):
    """The rectangular engine (``aqua-masked-dense``: no kernel) on a batch
    of two prompts with their frontend inputs."""
    rng = np.random.default_rng(7)
    batch = dict(tokens=rng.integers(0, pair["tcfg"].vocab_size, (2, 10))
                 .astype(np.int32), **_frontend(pair["tcfg"], rng, 2))
    want = JaxServeEngine(pair["jcfg"], pair["params"], JaxProjections(
        p=jnp.asarray(pair["proj"])), max_seq=MAX_SEQ,
        backend="aqua-masked-dense").generate(
            {k: jnp.asarray(v) for k, v in batch.items()}, steps=4)
    eng = ServeEngine(pair["tcfg"], pair["tparams"], AquaProjections(
        p=torch.from_numpy(pair["proj"])), max_seq=MAX_SEQ,
        backend="aqua-masked-dense", device="cpu")
    got = eng.generate(batch, steps=4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits_last, np.asarray(want.logits_last),
                               **TOL)
    if pair["name"] == "whisper-tiny":
        ragged = dict(batch, lengths=np.array([10, 6], np.int32))
        with pytest.raises(ValueError, match="rectangular"):
            eng.generate(ragged, steps=2)
        with pytest.raises(ValueError, match="rectangular"):
            JaxServeEngine(pair["jcfg"], pair["params"], JaxProjections(
                p=jnp.asarray(pair["proj"])), max_seq=MAX_SEQ).generate(
                    ragged, steps=2)


def test_refusals_raise_as_in_jax(pair, monkeypatch):
    """A paged ``encdec`` cache raises ``ValueError`` in both engines, and
    so does a VLM prompt shorter than its patches (JAX's splice
    ``x.at[:, :n].set(pe)``; the port's launcher checks it before it
    makes the full Pixtral's weights: tests/test_torch_serve_cli.py); a
    prefill budget plans monolithic admission with ``REASON_FRONTEND`` in
    both plans (and the encoder-decoder's ``REASON_FAMILY_SURGERY``)."""
    jcfg, tcfg, name = pair["jcfg"], pair["tcfg"], pair["name"]
    proj = AquaProjections(p=torch.from_numpy(pair["proj"]))
    jproj = JaxProjections(p=jnp.asarray(pair["proj"]))
    if name == "pixtral-12b":
        short = dict(tokens=np.zeros((1, 3), np.int32),
                     **_frontend(tcfg, np.random.default_rng(5)))
        with pytest.raises(ValueError):
            pair["jm"].prefill(pair["params"], {
                k: jnp.asarray(v) for k, v in short.items()}, MAX_SEQ)
        with pytest.raises(ValueError, match="4 patch embeddings"):
            pair["tm"].prefill(pair["tparams"], {
                k: torch.from_numpy(v) for k, v in short.items()}, MAX_SEQ)
    if name == "whisper-tiny":
        with pytest.raises(ValueError, match="paged"):
            JaxEngine(jcfg, pair["params"], jproj, serving=JaxServingConfig(
                cache=JaxCacheSpec(page_size=8), **SERVE))
        with pytest.raises(ValueError, match="paged"):
            ContinuousBatchingEngine(tcfg, pair["tparams"], proj,
                                     serving=ServingConfig(
                                         cache=CacheSpec(page_size=8),
                                         **SERVE), device="cpu")
    # JAX resolves backends as on its chip, where it prefers the kernels
    monkeypatch.setattr(runtime_flags, "PALLAS_OVERRIDE", True)
    serve = dict(SERVE, max_lanes=2, prefill_budget_tokens=16)
    cache = {} if name == "whisper-tiny" else dict(page_size=8)
    jplan = jax_dispatch.resolve_dispatch_plan(
        attention=jcfg.attention, aqua=jcfg.aqua,
        serving=JaxServingConfig(cache=JaxCacheSpec(**cache), **serve),
        mesh=None, prefix_sharing=False, family=jcfg.family,
        frontend=jcfg.frontend.kind)
    eng = ContinuousBatchingEngine(
        tcfg, pair["tparams"], proj, device="cpu",
        serving=ServingConfig(cache=CacheSpec(**cache), **serve))
    plan = eng.dispatch_plan()
    for f in dataclasses.fields(plan):
        assert getattr(plan, f.name) == getattr(jplan, f.name), f.name
    assert not plan.chunked_prefill
    assert dispatch.REASON_FRONTEND in plan.chunked_reasons
    assert dispatch.REASON_FRONTEND == jax_dispatch.REASON_FRONTEND
    assert (dispatch.REASON_FAMILY_SURGERY in plan.chunked_reasons) == (
        name == "whisper-tiny")


def test_add_frontend_inputs_shapes_as_jax():
    """The port draws its stub inputs from its own generator (a deliberate
    difference): the same keys, shapes and dtype as JAX's."""
    from repro.data.pipeline import add_frontend_inputs as jax_add
    for name in ARCHS:
        for cfg, jcfg in ((reduced(name), jax_reduced(name)),):
            got = add_frontend_inputs({"tokens": np.zeros((2, 3), np.int32)},
                                      cfg, 1)
            want = jax_add({"tokens": jnp.zeros((2, 3), jnp.int32)}, jcfg, 1)
            assert {k: (v.shape, str(v.dtype)) for k, v in got.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in want.items()}


def test_selection_tape_records_and_replays(pair):
    """A replay gives each call the recording of the same call, whatever
    its own inputs; the serving engines: the plain backend replaying the
    block-sparse engine's drive makes the same calls (decode steps and
    prefill chunks) and gives the same tokens; a recording decode step on
    the meta device reads no value on the host (CUDA graphs capture the
    tape's writes)."""
    tape = aqua_lib.SelectionTape("cpu")
    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(
        np.float32)) for _ in range(2))
    tape.install("record")
    try:
        want = aqua_lib.topk_block_indices(a, 24, 8)
        tape.install("replay")
        got = aqua_lib.topk_block_indices(b, 24, 8)
    finally:
        tape.remove()
    assert torch.equal(got, want)
    assert not torch.equal(aqua_lib.topk_block_indices(b, 24, 8), want)

    spec = ENGINES[pair["name"]]
    cache = ({} if spec["page_size"] is None
             else dict(page_size=spec["page_size"]))
    serve = ServingConfig(cache=CacheSpec(**cache), max_lanes=spec["lanes"],
                          **SERVE)
    proj = AquaProjections(p=torch.from_numpy(pair["proj"]))
    outs = {}
    for backend, mode in (("aqua-block-sparse", "record"),
                          ("aqua-block-sparse-plain", "replay")):
        eng = ContinuousBatchingEngine(pair["tcfg"], pair["tparams"], proj,
                                       serving=serve, backend=backend,
                                       device="cpu")
        tape.install(mode)
        try:
            outs[mode] = eng.run(_requests(Request, pair["tcfg"], spec)[:3])
        finally:
            tape.remove()
        if mode == "record":
            recorded = tape.calls.tolist()
    assert tape.calls.tolist() == recorded and min(recorded) > 0
    assert not tape.overflowed
    assert {u: o.tokens for u, o in outs["replay"].items()} == \
        {u: o.tokens for u, o in outs["record"].items()}

    meta = torch.device("meta")
    tape = aqua_lib.SelectionTape(meta)
    lanes = eng.scfg.max_lanes
    state = eng.model.init_decode_state(lanes, MAX_SEQ, device=meta)
    params = jax.tree.map(lambda t: t.to(meta), eng.params)
    tape.install("record")
    try:
        logits, _ = eng.model.decode_step(
            params, state, torch.zeros(lanes, dtype=torch.int32,
                                       device=meta),
            aqua_proj=eng.proj.to(meta),
            write_mask=torch.ones(lanes, dtype=torch.bool, device=meta))
    finally:
        tape.remove()
    assert logits.device == meta
