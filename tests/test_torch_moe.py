"""The MoE family (OLMoE-1B-7B, Qwen2-MoE-A2.7B) in the port, against the
JAX package, on the same numpy-seeded inputs:

* ``blocked_dispatch``: the dispatch tensor bit for bit (at capacity
  factor 1.25, where tokens drop, and with zero rows whose uniform gates
  tie), the combine weights and the aux loss within 1e-6;
* ``moe_ffn``: dropless, with drops, and with a shared expert, float32
  outputs within atol / rtol 1e-5; bf16 params keep a float32 router
  (the port's init and the bridge alike);
* the reduced models' logits within the dense tests' 1e-4, and their aux
  losses;
* the continuous-batching engine's greedy tokens equal the JAX engine's
  (``aqua-block-sparse``, Pallas interpret mode; JAX's CPU ``auto`` would
  take the masked-dense path) at capacity factor 1.25, 8 lanes, prompt
  lengths off the bucket and lanes idle while others decode, paged and
  contiguous, at ``block_dims`` 8 and at 1 (flash on the masked q̂, whose
  pad rows see every valid key, as JAX's dense reference), and with
  prefix sharing (``prefix_hits`` > 0): the port's routing tape shows
  real tokens dropped at admission and in decode, so pad rows and idle
  lanes, which take capacity as real tokens do, decided them alike; the
  tape's recording, replayed, routes a call alike;
* the dispatch plan with a prefill budget equals JAX's
  ``resolve_dispatch_plan(..., family="moe")``: monolithic, with
  ``REASON_MOE_CAPACITY``;
* the launcher serves both archs with ``--verify``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime_flags
from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core import dispatch as jax_dispatch
from repro.core.calibration import AquaProjections as JaxProjections
from repro.kernels import ops as jax_ops
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (AquaConfig, CacheSpec, ServingConfig,
                                 get_config, reduced)
from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch
from repro_torch.core.calibration import AquaProjections
from repro_torch.kernels import ops
from repro_torch.launch.serve import main
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.serving import ContinuousBatchingEngine, Request

ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side of these small shapes on one thread: the suite runs
    several test processes at once, and their thread pools would contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, capacity_factor=1.25, d_model=128):
    """(JAX, port) reduced configs at ``capacity_factor`` (the reduction's
    8.0 never drops)."""
    jcfg = jax_reduced(name, d_model=d_model)
    tcfg = reduced(name, d_model=d_model)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=capacity_factor)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, capacity_factor=capacity_factor)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_published_geometries_and_refusals():
    o, q = get_config("olmoe-1b-7b"), get_config("qwen2-moe-a2.7b")
    assert (o.num_layers, o.d_model, o.vocab_size) == (16, 2048, 50304)
    assert (o.moe.num_experts, o.moe.top_k, o.moe.expert_ff,
            o.moe.num_shared) == (64, 8, 1024, 0)
    assert o.attention.qk_norm and o.attention.group_size == 1
    assert (q.num_layers, q.d_model, q.vocab_size) == (24, 2048, 151936)
    assert (q.moe.num_experts, q.moe.top_k, q.moe.expert_ff,
            q.moe.num_shared) == (60, 4, 1408, 4)
    assert q.attention.qkv_bias and q.attention.num_kv_heads == 16
    for name in ARCHS:
        assert type(build_model(get_config(name), "cpu")).__name__ \
            == "DenseLM"
    r = reduced("olmoe-1b-7b").moe
    assert (r.num_experts, r.top_k, r.expert_ff, r.num_shared,
            r.capacity_factor) == (8, 2, 64, 0, 8.0)
    assert reduced("qwen2-moe-a2.7b").moe.num_shared == 1
    # the recurrent families, refused until the port served them
    for name, cls in (("mamba2-370m", "Mamba2LM"),
                      ("recurrentgemma-9b", "HybridLM")):
        assert type(build_model(get_config(name), "cpu")).__name__ == cls
    # the frontend families, refused until the port served them
    for name, cls in (("pixtral-12b", "DenseLM"), ("whisper-tiny",
                                                   "EncDecLM")):
        assert type(build_model(get_config(name), "cpu")).__name__ == cls
    with pytest.raises(AssertionError):
        dataclasses.replace(o, moe=None).validate()
    assert isinstance(o, ModelConfig)


def _gates(t, g, e, seed):
    """Router probabilities (T, G, E) float32, the low experts favoured
    (they fill up), the last rows of the last block uniform (zero-padded
    tokens: every expert ties)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((t, g, e)) * 2.0
              + np.linspace(2.0, 0.0, e)).astype(np.float32)
    logits[-1, g - 5:] = 0.0
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("e,k,cf", [(8, 2, 1.25), (64, 8, 1.25),
                                    (60, 4, 1.25), (8, 2, 8.0)])
def test_blocked_dispatch_equals_jax(e, k, cf):
    t, g = 3, 128
    gates = _gates(t, g, e, seed=e + k)
    cap = max(k, int(cf * k * g / e) + 1)
    jd, jc, jaux = jax_moe.blocked_dispatch(jnp.asarray(gates), k, cap)
    d, c, aux = moe.blocked_dispatch(torch.from_numpy(gates.copy()), k, cap)
    want = np.asarray(jd.astype(jnp.float32))
    assert d.dtype == torch.bfloat16
    assert np.array_equal(d.float().numpy(), want)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    placed = want.sum()
    if cf < 8:
        assert placed < t * g * k          # tokens dropped
    else:
        assert placed == t * g * k


def _ffn_params(name, cf, dtype=jnp.float32):
    jcfg, tcfg = _configs(name, cf, d_model=64)
    p = jax_moe.init_moe_ffn(jax.random.PRNGKey(3), jcfg, dtype)
    return jcfg, tcfg, p


@pytest.mark.parametrize("name,cf", [("olmoe-1b-7b", 8.0),
                                     ("olmoe-1b-7b", 1.25),
                                     ("qwen2-moe-a2.7b", 1.25)])
def test_moe_ffn_equals_jax(name, cf):
    """200 tokens: a full block of 128 and a zero-padded one of 72."""
    jcfg, tcfg, p = _ffn_params(name, cf)
    assert ("shared" in p) == (name == "qwen2-moe-a2.7b")
    x = np.random.default_rng(7).standard_normal((2, 100, 64)).astype(
        np.float32)
    jy, jaux = jax_moe.moe_ffn(jcfg, p, jnp.asarray(x))
    tp = params_from_numpy(_np(p), "cpu")
    tape = moe.RoutingTape(dataclasses.replace(tcfg, num_layers=1),
                           tp["router"][None], lanes=2, rows=256)
    tape.install("record")
    try:
        y, aux = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    finally:
        tape.remove()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    topi, kept = tape.latest(decode=False)
    assert kept.shape == (1, 256, tcfg.moe.top_k)      # 72 zero rows too
    placed, dropped = moe.kept_counts(kept[:, :200])
    assert (dropped > 0) == (cf < 8)
    # the tape's record routes a second call alike
    tape.install("replay")
    try:
        y2, _ = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    finally:
        tape.remove()
    assert torch.equal(y2, y)


def test_bf16_params_keep_a_float32_router():
    jcfg, tcfg, p = _ffn_params("qwen2-moe-a2.7b", 1.25, jnp.bfloat16)
    assert p["router"].dtype == jnp.float32
    tp = params_from_numpy(_np(jax.tree.map(
        lambda a: a.astype(jnp.float32), p)), "cpu", dtype=torch.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w1"].dtype == tp["shared"]["w1"].dtype == torch.bfloat16
    own = moe.init_moe_ffn(torch.Generator().manual_seed(0), tcfg,
                           torch.bfloat16, "cpu")
    assert own["router"].dtype == torch.float32
    assert own["w2"].dtype == torch.bfloat16
    # float32 activations over the bf16 params: JAX's numbers
    x = np.random.default_rng(8).standard_normal((1, 40, 64)).astype(
        np.float32)
    jy, _ = jax_moe.moe_ffn(jcfg, p, jnp.asarray(x))
    y, _ = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_reduced_model_logits_equal_jax(name, cf):
    jcfg, tcfg = _configs(name, cf, d_model=64)
    jcfg = dataclasses.replace(jcfg, remat=False)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np(params), "cpu")
    toks = np.random.default_rng(0).integers(0, 128, (2, 72), np.int32)
    jl, jaux = jax_build_model(jcfg).forward(params,
                                             {"tokens": jnp.asarray(toks)})
    model = build_model(tcfg, "cpu")
    tl, taux = model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-5)
    # the capture forward calibration runs: q/k per layer and the
    # unweighted losses
    _, cap = model.forward(tparams, {"tokens": torch.from_numpy(toks)},
                           capture=True)
    _, jcap = jax_build_model(jcfg).forward(
        params, {"tokens": jnp.asarray(toks)}, capture=True)
    assert len(cap["qk"]) == tcfg.num_layers
    np.testing.assert_allclose(cap["qk"][1][0].numpy(),
                               np.asarray(jcap["qk"][1][0]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(cap["aux_loss"]),
                               float(jcap["aux_loss"]), rtol=1e-5)
    # the port's own init makes the same tree, the router in float32
    own = model.init(torch.Generator().manual_seed(0))
    assert own["layers"]["ffn"].keys() == tparams["layers"]["ffn"].keys()
    assert own["layers"]["ffn"]["w1"].shape == \
        tparams["layers"]["ffn"]["w1"].shape


def test_calibration_of_an_moe_model_matches_jax():
    """``calibrate`` over the MoE model's capture forward (the corpus's
    windows, both packages' own forwards): each layer and KV head keeps
    the same top-k subspace of q/k directions as JAX's projections."""
    import os
    from repro.core import calibration as jax_cal
    from repro.data.pipeline import calibration_batches as jax_batches
    from repro_torch.core import calibration as cal
    from repro_torch.data.corpus import calibration_batches
    corpus = os.path.join(os.path.dirname(__file__), "..", "corpora",
                          "calibration.txt")
    jcfg, tcfg = _configs("qwen2-moe-a2.7b", d_model=64)
    jcfg = dataclasses.replace(jcfg, remat=False)
    jmodel, model = jax_build_model(jcfg), build_model(tcfg, "cpu")
    params = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np(params), "cpu")
    want = np.asarray(jax_cal.calibrate(
        lambda p, b: jmodel.forward(p, b, capture=True)[1], params,
        jax_batches(jcfg, num_batches=1, batch=2, seq=32,
                    corpus_path=corpus), jcfg).p)
    got = cal.calibrate(
        lambda p, b: model.forward(
            p, {"tokens": torch.from_numpy(b["tokens"])}, capture=True)[1],
        tparams, calibration_batches(tcfg.vocab_size, corpus, num_batches=1,
                                     batch=2, seq=32), tcfg,
        device="cpu").p.numpy()
    k = int(0.75 * tcfg.attention.head_dim)
    # the part of the port's top-k directions outside JAX's top-k subspace
    cross = np.einsum("lhdi,lhdj->lhij", want[..., k:], got[..., :k])
    assert np.abs(cross).max() < 1e-3


# -- idle lanes and pad rows, the values an MoE routes ------------------------

@pytest.mark.parametrize("mode", ["contiguous", "paged", "quant", "part",
                                  "part+quant"])
def test_idle_lanes_decode_like_the_pallas_kernels(mode):
    """Lanes of length 0 (an idle lane of the decode step) get what the
    Pallas kernels write there, the mean of the V slots they visit: the
    lane's stripe, or every page of its table row with unmapped entries
    read as page 0 (only the participating ones; dequantized)."""
    rng = np.random.default_rng(len(mode))
    b, h, kvh, d, ps, npl, p = 4, 4, 2, 32, 8, 4, 9
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kw = dict(k_ratio=0.75, block_dims=8, scale=0.25)
    if mode == "contiguous":
        k, v = (rng.standard_normal((b, kvh, npl * ps, d)).astype(np.float32)
                for _ in range(2))
        lengths = np.array([0, 7, 0, 32], np.int32)
        want = np.asarray(jax_ops.aqua_decode(
            *map(jnp.asarray, (q, k, v, lengths)), seq_blk=8, **kw))
        got = ops.aqua_decode(*map(torch.from_numpy, (q, k, v, lengths)),
                              **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        return
    ks = vs = part = None
    if "quant" in mode:
        k, v = (rng.integers(-127, 128, (p, kvh, ps, d)).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.002, 0.02, (p, kvh)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.standard_normal((p, kvh, ps, d)).astype(np.float32)
                for _ in range(2))
    # lane 0 maps no page, lane 2 two; both idle
    table = np.array([[-1, -1, -1, -1], [2, 7, -1, -1], [6, 3, -1, -1],
                      [8, 1, 5, 4]], np.int32)
    lengths = np.array([0, ps + 3, 0, 4 * ps], np.int32)
    if "part" in mode:
        part = np.array([[0, 2], [0, 1], [1, 3], [1, 3]], np.int32)
    opt = [None if x is None else x for x in (ks, vs, part)]
    want = np.asarray(jax_ops.aqua_paged_decode(
        *map(jnp.asarray, (q, k, v, table, lengths)),
        *(None if x is None else jnp.asarray(x) for x in opt),
        seq_blk=8, **kw))
    got = ops.aqua_paged_decode(
        *map(torch.from_numpy, (q, k, v, table, lengths)),
        *(None if x is None else torch.from_numpy(x) for x in opt), **kw)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    assert np.abs(want[lengths == 0]).max() > 0


def test_flash_pad_rows_equal_the_dense_reference_with_lengths():
    """A bucket-padded admission's flash call (the ``flash`` backend, and
    AQUA at ``block_dims`` 1 on the masked q̂): every row, pad rows too,
    is JAX's dense reference with lengths."""
    from repro.core import attention as jax_attn
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(2)
    b, s, kvh, g, d = 2, 24, 2, 2, 16
    q = rng.standard_normal((b, s, kvh, g, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32)
            for _ in range(2))
    lengths = np.array([24, 9], np.int32)
    acfg = jax_reduced("olmoe-1b-7b").attention
    want, _ = jax_attn._dense_jnp_prefill(
        *map(jnp.asarray, (q, k, v)), cfg=acfg, aqua=None,
        positions=jnp.arange(s), lengths=jnp.asarray(lengths), causal=True)
    got = flash_attention(
        torch.from_numpy(q).permute(0, 2, 3, 1, 4).reshape(b, kvh * g, s, d),
        torch.from_numpy(k).permute(0, 2, 1, 3),
        torch.from_numpy(v).permute(0, 2, 1, 3), causal=True,
        lengths=torch.from_numpy(lengths))
    got = got.reshape(b, kvh, g, s, d).permute(0, 3, 1, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# -- engines against the JAX engine ------------------------------------------

SERVE = dict(max_lanes=8, max_new_tokens=10, prompt_bucket=8)
PROMPTS = (5, 12, 21, 13, 7, 22, 3, 15, 19, 10)    # off the bucket of 8
SHARED_PREFIX = 16
# name: (arch, block_dims, paged, prefix sharing)
CASES = {"olmoe-paged": ("olmoe-1b-7b", 8, True, False),
         "olmoe-contiguous": ("olmoe-1b-7b", 8, False, False),
         "olmoe-paged-bd1": ("olmoe-1b-7b", 1, True, False),
         "qwen2-moe-prefix": ("qwen2-moe-a2.7b", 8, True, True)}


def _requests(cls, vocab, shared):
    """Arrivals 0.75 steps apart: lanes idle while the first requests
    decode and again while the last ones finish."""
    rng = np.random.default_rng(5)
    pre = np.random.default_rng(6).integers(0, vocab, SHARED_PREFIX,
                                            dtype=np.int32)
    out = []
    for i, n in enumerate(PROMPTS):
        toks = rng.integers(0, vocab, n, dtype=np.int32)
        if shared:
            toks = np.concatenate([pre, toks])
        out.append(cls(uid=i, tokens=toks, max_new_tokens=10,
                       arrival=0.75 * i))
    return out


def _serve_port(eng, reqs):
    """Serve ``reqs`` on the port's CPU engine with a routing tape: tokens
    by uid, and the routing choices real tokens kept and dropped at
    admissions (rows below the prompt's tail length) and at decode steps
    (lanes that emitted in the step), and the steps with an idle lane."""
    tape = moe.RoutingTape(eng.cfg, eng.params["layers"]["ffn"]["router"],
                           eng.scfg.max_lanes, eng.scfg.max_seq)
    tokens, steps, emitted = {}, [], []
    admit = np.zeros(2, np.int64)
    prompt = {r.uid: r.prompt_len for r in reqs}
    saved = 0
    tape.install("record")
    try:
        for ev in eng.serve(reqs):
            if ev.index == 0:
                # a prefix-shared admission routes its tail only
                pool = eng.page_pool
                now = 0 if pool is None else pool.tokens_saved
                tail, saved = prompt[ev.uid] - (now - saved), now
                _, kept = tape.latest(decode=False)
                admit += moe.kept_counts(kept[:, :tail])
            elif eng.stats.decode_steps > len(steps):
                steps.append((tape.latest(decode=True)[1],
                              eng.last_lanes.uid.copy()))
                emitted.append(set())
            if ev.index > 0:
                emitted[-1].add(ev.uid)
            tokens.setdefault(ev.uid, []).append(ev.token)
    finally:
        tape.remove()
    decode = np.zeros(2, np.int64)
    for (kept, uids), live in zip(steps, emitted):
        decode += moe.kept_counts(
            kept[:, [i for i, u in enumerate(uids) if u in live]])
    idle_steps = sum(len(live) < eng.scfg.max_lanes for live in emitted)
    return tokens, admit, decode, idle_steps


@pytest.fixture(scope="module", params=list(CASES))
def served(request):
    """One JAX engine run and one port engine run of a case."""
    arch, bd, paged, shared = CASES[request.param]
    aqua = dict(k_ratio=0.75, block_dims=bd, prefill_q_blk=16)
    jcfg, tcfg = _configs(arch)
    jcfg = dataclasses.replace(jcfg, aqua=JaxAquaConfig(
        prefill_k_blk=16, decode_seq_blk=16, **aqua))
    tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(**aqua))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    cache = dict(page_size=8, prefix_sharing=shared) if paged else {}
    serve = dict(SERVE, max_seq=72 if shared else 64)
    jeng = JaxEngine(jcfg, params, JaxProjections(p=jnp.asarray(proj)),
                     serving=JaxServingConfig(cache=JaxCacheSpec(**cache),
                                              **serve),
                     backend="aqua-block-sparse")
    want = jeng.run(_requests(JaxRequest, tcfg.vocab_size, shared))
    eng = ContinuousBatchingEngine(
        tcfg, params_from_numpy(_np(params), "cpu"),
        AquaProjections(p=torch.from_numpy(proj)),
        serving=ServingConfig(cache=CacheSpec(**cache), **serve),
        backend="aqua-block-sparse", device="cpu")
    got = _serve_port(eng, _requests(Request, tcfg.vocab_size, shared))
    return dict(case=request.param, want=want, jeng=jeng, eng=eng, got=got,
                shared=shared)


def test_engine_greedy_tokens_match_jax(served):
    tokens = served["got"][0]
    assert tokens.keys() == served["want"].keys()
    for uid, out in served["want"].items():
        assert tokens[uid] == list(out.tokens), (served["case"], uid)
    if served["shared"]:
        assert served["eng"].page_pool.prefix_hits > 0
        assert served["eng"].page_pool.prefix_hits == \
            served["jeng"].page_pool.prefix_hits


def test_engine_drops_real_tokens_with_lanes_idle(served):
    """The trace is one where capacity decides: real tokens drop choices
    at admission and in decode, and decode steps run with idle lanes."""
    _, admit, decode, idle_steps = served["got"]
    assert admit[1] > 0 and decode[1] > 0, (admit, decode)
    assert admit[0] > 0 and decode[0] > 0
    assert idle_steps > 0


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_budget_plans_monolithic_like_jax(name, monkeypatch):
    # JAX resolves backends as on its chip, where it prefers the kernels;
    # the port always resolves so
    monkeypatch.setattr(runtime_flags, "PALLAS_OVERRIDE", True)
    jcfg, tcfg = _configs(name)
    serve = dict(max_lanes=2, max_seq=64, prompt_bucket=8,
                 prefill_budget_tokens=16)
    jplan = jax_dispatch.resolve_dispatch_plan(
        attention=jcfg.attention,
        aqua=JaxAquaConfig(block_dims=8, prefill_q_blk=16),
        serving=JaxServingConfig(cache=JaxCacheSpec(page_size=8), **serve),
        mesh=None, prefix_sharing=True, family="moe")
    tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(block_dims=8,
                                                      prefill_q_blk=16))
    att = tcfg.attention
    eng = ContinuousBatchingEngine(
        tcfg, build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0)),
        AquaProjections(p=torch.eye(att.head_dim).expand(
            tcfg.num_layers, att.num_kv_heads, -1, -1).clone()),
        serving=ServingConfig(cache=CacheSpec(page_size=8), **serve),
        device="cpu")
    plan = eng.dispatch_plan()
    for f in dataclasses.fields(plan):
        assert getattr(plan, f.name) == getattr(jplan, f.name), f.name
    assert not plan.chunked_prefill
    assert dispatch.REASON_MOE_CAPACITY in plan.chunked_reasons
    assert plan.chunked_reasons == (jax_dispatch.REASON_MOE_CAPACITY,)
    # a dense model of the same plan chunks
    dense = dispatch.resolve_dispatch_plan(
        attention=att, aqua=tcfg.aqua,
        serving=ServingConfig(cache=CacheSpec(page_size=8), **serve),
        mesh=None, prefix_sharing=True)
    assert dense.chunked_prefill


@pytest.mark.parametrize("name,extra", [
    ("olmoe-1b-7b", []),
    ("qwen2-moe-a2.7b", ["--page-size", "8", "--shared-prefix-len", "16",
                         "--block-dims", "8"])])
def test_launcher_serves_the_moe_archs(name, extra, capsys):
    run = main(["--device", "cpu", "--arch", name, "--reduced",
                "--requests", "4", "--verify", *extra])
    printed = capsys.readouterr().out
    assert "[serve] verify: all 4 requests token-identical" in printed
    assert run.engine.cfg.name == name and run.engine.cfg.family == "moe"
    assert len(run.streamed) == 4
    if extra:
        assert run.engine.page_pool.prefix_hits > 0
