"""The port's training path against the JAX package's, on the CPU, float32,
reduced configs of 2 layers (the hybrid at 4), weights carried by
``bridge.params_from_numpy`` and batches drawn by JAX's ``make_batch``:

* ``optim/adamw.py`` (``update``, ``global_norm``, clipping) and
  ``optim/schedule.py`` on the same numpy arrays: float32 to 1e-6
  relative (float32 sums in another order), a bfloat16 param to one bf16
  step (its rounding of the same float32 value);
* ``cross_entropy`` and ``LM.loss`` (dense, MoE with its aux loss and the
  copy task's ``loss_mask``, the hybrid) at 1e-5 relative;
* autograd's gradients against ``jax.grad``, per leaf, within 1e-4 of the
  leaf's largest JAX gradient (dense, dense with AQUA on, MoE);
* 4 ``make_train_step`` steps: losses at 1e-5 relative, params within
  1e-5 of their scale at the end;
* microbatches 2 against 1 (JAX's own tolerances, ``test_data_optim``);
  remat on against off (bit for bit on the CPU);
* the gradient guard: each kernel wrapper, and a training forward on a
  kernel backend, raise ``NotImplementedError`` under grad; ``auto``
  trains (on ``dense``, or ``aqua-masked-dense`` with AQUA);
* a trained model serves through ``ServeEngine`` and the
  continuous-batching engine;
* ``make_batch``'s kinds: shapes and dtypes as JAX's, the copy task and
  the LCG rule, the corpus windows equal to JAX's;
* ``python -m repro_torch.launch.train --reduced --steps 20 --device cpu``
  lowers the loss.

JAX's train steps are jitted once per module (module-scoped fixtures).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import pipeline as jax_pipeline
from repro.launch.train import TrainState as JaxTrainState
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import cosine_with_warmup as jax_cosine
from repro_torch import tree as tree_lib
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import AquaConfig, ServingConfig, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import attention as attn
from repro_torch.core.calibration import calibrate, capture_forward
from repro_torch.data import pipeline
from repro_torch.kernels.aqua_decode import (aqua_decode_attention,
                                             aqua_paged_decode_attention)
from repro_torch.kernels.aqua_prefill import aqua_prefill_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.train import (Trainer, TrainState, loss_and_grads,
                                      make_train_step, to_device)
from repro_torch.models import build_model
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeEngine)

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
AQUA = dict(k_ratio=0.5, block_dims=8, prefill_q_blk=16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _items(tree) -> dict:
    """{path: float64 numpy array} of a port (tensor) or JAX (numpy)
    tree."""
    return {k: (v.detach().double().cpu().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v, np.float64))
            for k, v in tree_lib.items(tree)}


def _clone(tree):
    return tree_lib.tree_map(lambda t: t.clone(), tree)


# name -> (JAX config, port config): 2 layers, the hybrid at 4 (recurrent,
# recurrent, attention, recurrent) and d_model 128; "aqua": the dense
# config with AQUA on (head dim 32, block_dims 8)
def _configs(name):
    if name == "recurrentgemma-9b":
        kw = dict(layers=4, d_model=128)
    elif name == "aqua":
        kw = dict(d_model=128)
    else:
        kw = {}
    arch = "qwen3-0.6b" if name in ("dense", "aqua") else name
    jcfg = dataclasses.replace(jax_reduced(arch, **kw), remat=False)
    tcfg = reduced(arch, **kw)
    if name == "aqua":
        jcfg = jcfg.with_aqua(JaxAquaConfig(**AQUA))
        tcfg = tcfg.with_aqua(AquaConfig(**AQUA))
    return jcfg, tcfg


_PAIRS = {}


def _pair(name):
    """(JAX model, JAX params, port model, port params), made once per
    module."""
    if name not in _PAIRS:
        jcfg, tcfg = _configs(name)
        jm = jax_build_model(jcfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = build_model(tcfg, "cpu")
        _PAIRS[name] = (jm, params, tm,
                        params_from_numpy(_np(params), "cpu"))
    return _PAIRS[name]


def _batch(kind="lcg", vocab=128, seq=16, batch=4, step=0):
    """JAX's batch as numpy arrays."""
    dcfg = jax_pipeline.DataConfig(vocab_size=vocab, seq_len=seq,
                                   global_batch=batch, kind=kind)
    return _np(jax_pipeline.make_batch(dcfg, step))


# -- optimizer and schedule ----------------------------------------------------

def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 8)).astype(np.float32),
              "layers": [{"b": rng.standard_normal(8).astype(np.float32)}],
              "h": rng.standard_normal((3, 5)).astype(np.float32)}
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                     * 3.0).astype(np.float32), params)
             for _ in range(3)]
    return params, grads


def test_adamw_update_matches_jax():
    """Three ``update`` steps from the same params and grads (the second
    clipped: its norm is past ``grad_clip``), float32 and a bfloat16
    param; params, moments and step, and ``global_norm`` /
    ``clip_by_global_norm``."""
    params, grads = _opt_trees()
    jcfg = JaxTrainConfig(learning_rate=0.05, weight_decay=0.1,
                          grad_clip=5.0)
    tcfg = TrainConfig(learning_rate=0.05, weight_decay=0.1, grad_clip=5.0)
    jp = jax.tree.map(jnp.asarray, params)
    jp["h"] = jp["h"].astype(jnp.bfloat16)
    tp = params_from_numpy(params, "cpu")
    tp["h"] = tp["h"].to(torch.bfloat16)
    js, ts = jax_adamw.init(jp), adamw.init(tp)
    for i, g in enumerate(grads):
        jg = jax.tree.map(jnp.asarray, g)
        tg = params_from_numpy(g, "cpu")
        jg["h"], tg["h"] = jg["h"].astype(jnp.bfloat16), tg["h"].to(
            torch.bfloat16)
        np.testing.assert_allclose(float(adamw.global_norm(tg)),
                                   float(jax_adamw.global_norm(jg)),
                                   rtol=1e-6)
        jc, jn = jax_adamw.clip_by_global_norm(jg, 5.0)
        tc, tn = adamw.clip_by_global_norm(tg, 5.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k, v in _items(tc).items():
            np.testing.assert_allclose(v, _items(_np(jc))[k], rtol=1e-2
                                       if k == "h" else 1e-6, atol=1e-7)
        lr = 0.05 * (i + 1) / 3
        jp, js = jax_adamw.update(jp, jg, js, jnp.float32(lr), jcfg)
        tp, ts = adamw.update(tp, tg, ts, torch.tensor(lr), tcfg)
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, _np(jp)), (ts.mu, _np(js.mu)),
                      (ts.nu, _np(js.nu))):
        want = _items(want)
        for k, v in _items(got).items():
            if k == "h" and got is tp:      # bf16: one step of 2^-8
                np.testing.assert_allclose(v, want[k], rtol=2 ** -8,
                                           atol=1e-6)
            else:
                np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-7)
    assert tp["h"].dtype == torch.bfloat16
    assert ts.mu["h"].dtype == torch.float32


def test_schedule_matches_jax():
    for warm, total in ((1, 10), (100, 1000), (20, 400), (5, 5)):
        jcfg = JaxTrainConfig(learning_rate=3e-3, warmup_steps=warm,
                              total_steps=total)
        tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=warm,
                           total_steps=total)
        for step in (0, 1, warm - 1, warm, warm + 1, total // 2, total,
                     total + 7):
            np.testing.assert_allclose(
                float(cosine_with_warmup(torch.tensor(step, dtype=torch.int32),
                                         tcfg)),
                float(jax_cosine(step, jcfg)), rtol=1e-6, atol=1e-12)


def test_train_config_defaults_equal_jax():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        JaxTrainConfig())
    for arch in ("qwen3-0.6b", "olmoe-1b-7b", "mamba2-370m"):
        assert reduced(arch).remat is False
        assert jax_reduced(arch).remat is False


# -- the loss --------------------------------------------------------------------

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name,kind", [("dense", "lcg"),
                                       ("olmoe-1b-7b", "copy"),
                                       ("recurrentgemma-9b", "lcg")])
def test_loss_matches_jax(name, kind):
    """``LM.loss`` on bridged params: the MoE adds its router aux loss
    (checked non-zero) under the copy task's ``loss_mask``."""
    jm, params, tm, tparams = _pair(name)
    batch = _batch(kind)
    jl, jaux = jax.jit(jm.loss)(params, batch)
    with torch.no_grad():
        tl, taux = tm.loss(tparams, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               **LOSS_TOL)
    if name == "olmoe-1b-7b":
        logits, aux = tm.forward(tparams, to_device(batch, "cpu"))
        assert float(aux["aux_loss"]) > 0
        ce = cross_entropy(logits, torch.tensor(batch["labels"]),
                           torch.tensor(batch["loss_mask"]))
        np.testing.assert_allclose(float(ce + aux["aux_loss"]), float(tl),
                                   rtol=1e-6)


def _jax_grads(jm, params, batch):
    return _np(jax.jit(jax.grad(lambda p: jm.loss(p, batch)[0]))(params))


@pytest.mark.parametrize("name", ["dense", "aqua", "olmoe-1b-7b"])
def test_grads_match_jax_grad(name):
    """autograd through the port's forward (``auto`` under grad: ``dense``,
    ``aqua-masked-dense`` with AQUA) against ``jax.grad`` through JAX's
    (its CPU ``auto``: the same two backends), per leaf."""
    jm, params, tm, tparams = _pair(name)
    batch = _batch("copy" if name == "olmoe-1b-7b" else "lcg")
    want = _items(_jax_grads(jm, params, batch))
    loss, grads = loss_and_grads(tm, tparams, to_device(batch, "cpu"))
    got = _items(grads)
    assert got.keys() == want.keys()
    for k, g in got.items():
        scale = np.abs(want[k]).max()
        assert np.abs(g - want[k]).max() <= 1e-4 * scale + 1e-8, k
    assert not any(t.requires_grad for t in tree_lib.leaves(tparams))


# -- train steps ---------------------------------------------------------------------

def _steps(name, n, mb=1, lr=1e-3):
    """n train steps of both packages from the same params on JAX's lcg
    batches: (JAX losses, JAX params, port losses, port state)."""
    jm, params, tm, tparams = _pair(name)
    jt = JaxTrainConfig(learning_rate=lr, warmup_steps=1, total_steps=10,
                        microbatches=mb)
    tt = TrainConfig(learning_rate=lr, warmup_steps=1, total_steps=10,
                     microbatches=mb)
    js = JaxTrainState(params=params, opt=jax_adamw.init(params),
                       step=jnp.zeros((), jnp.int32))
    tparams = _clone(tparams)
    ts = TrainState(params=tparams, opt=adamw.init(tparams),
                    step=torch.zeros((), dtype=torch.int32))
    jfn = jax.jit(jax_make_train_step(jm, jt))
    tfn = make_train_step(tm, tt)
    jl, tl = [], []
    for i in range(n):
        batch = _batch(step=i)
        js, jmet = jfn(js, batch)
        ts, tmet = tfn(ts, to_device(batch, "cpu"))
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    return jl, _np(js.params), tl, ts


def test_four_train_steps_match_jax():
    jl, jparams, tl, ts = _steps("dense", 4)
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert tl[-1] < tl[0]
    assert int(ts.step) == 4
    want = _items(jparams)
    for k, v in _items(ts.params).items():
        scale = np.abs(want[k]).max()
        assert np.abs(v - want[k]).max() <= 1e-5 * scale, k


def test_microbatches_two_equal_one():
    """One step at microbatches 2 against 1, from the same params and
    batch (JAX's ``test_microbatch_equivalence`` tolerances)."""
    _, _, tm, tparams = _pair("dense")
    batch = to_device(_batch(), "cpu")
    out = []
    for mb in (1, 2):
        tt = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                         microbatches=mb)
        p = _clone(tparams)
        st = TrainState(params=p, opt=adamw.init(p),
                        step=torch.zeros((), dtype=torch.int32))
        out.append(make_train_step(tm, tt)(st, batch))
    (s1, m1), (s2, m2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_lib.leaves(s1.params), tree_lib.leaves(s2.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b",
                                  "whisper-tiny", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_remat_on_equals_off(arch):
    """``ModelConfig.remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``): the same loss and gradients bit for bit
    on the CPU; without grad it runs nothing twice."""
    kw = dict(layers=4, d_model=128) if arch == "recurrentgemma-9b" else {}
    cfg = reduced(arch, **kw)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=2)
    batch = to_device(pipeline.add_frontend_inputs(
        pipeline.make_batch(dcfg, 0), cfg, 0), "cpu")
    out = []
    calls = []
    for remat in (False, True):
        m = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: calls.append(remat) or t, lambda t: t):
            out.append(loss_and_grads(m, params, batch))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_lib.leaves(g0), tree_lib.leaves(g1)):
        assert torch.equal(a, b)
    # remat keeps fewer tensors for the backward pass
    assert calls.count(True) < calls.count(False)


# -- the gradient guard --------------------------------------------------------------

def _kernel_calls():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q4, k4, v4 = t(1, 2, 16, 16), t(1, 1, 16, 16), t(1, 1, 16, 16)
    q3 = t(1, 2, 16)
    lengths = torch.tensor([16], dtype=torch.int32)
    idx = torch.zeros(1, 2, 1, 1, dtype=torch.int32)
    pages = torch.zeros(1, 1, dtype=torch.int32)
    return {
        "flash_attention": lambda g: flash_attention(
            q4.requires_grad_(g), k4, v4),
        "aqua_prefill": lambda g: aqua_prefill_attention(
            q4.requires_grad_(g), k4, v4, idx, lengths, block_dims=8,
            q_blk=16),
        "aqua_decode": lambda g: aqua_decode_attention(
            q3, k4, v4.requires_grad_(g), idx[:, :, 0], lengths,
            block_dims=8),
        "aqua_paged_decode": lambda g: aqua_paged_decode_attention(
            q3, k4.requires_grad_(g), v4, idx[:, :, 0], pages, lengths,
            block_dims=8),
    }


@pytest.mark.parametrize("name", ["flash_attention", "aqua_prefill",
                                  "aqua_decode", "aqua_paged_decode"])
def test_kernel_wrappers_raise_under_grad(name):
    """A kernel wrapper given an input that requires grad raises under
    grad mode (the CPU runs the plain version, and refuses all the same,
    as JAX's interpret mode does); without grad, or with no input
    requiring grad, it runs."""
    call = _kernel_calls()[name]
    with pytest.raises(NotImplementedError, match="no reverse mode"):
        call(True)
    with torch.no_grad():
        assert torch.isfinite(call(True)).all()
    assert torch.isfinite(call(False)).all()


def _tiny_trainer(cfg, steps=3, tmp=None, lr=1e-3, **dkw):
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=1, total_steps=steps)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4, **dkw)
    return Trainer(cfg, tcfg, dcfg, ckpt_dir=tmp, device="cpu")


@pytest.mark.parametrize("backend,aqua", [("flash", None),
                                          ("aqua-block-sparse", AQUA)])
def test_training_on_a_kernel_backend_raises(backend, aqua):
    cfg = reduced("qwen3-0.6b", d_model=128)
    if aqua is not None:
        cfg = cfg.with_aqua(AquaConfig(**aqua))
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend=backend))
    with pytest.raises(NotImplementedError, match="no reverse mode"):
        _tiny_trainer(cfg).run(1)


@pytest.mark.parametrize("aqua", [None, AQUA])
def test_auto_trains_on_the_dense_references(aqua):
    """Under grad ``auto`` is ``dense`` (``aqua-masked-dense`` with AQUA):
    the run would raise had a kernel wrapper been reached."""
    on = None if aqua is None else AquaConfig(**aqua)
    want = "dense" if aqua is None else "aqua-masked-dense"
    assert attn.resolve_backend("auto", on, grad=True).name == want
    assert attn.resolve_backend("auto", on).name == (
        "flash" if aqua is None else "aqua-block-sparse")
    cfg = reduced("qwen3-0.6b", d_model=128).with_aqua(on)
    _, losses = _tiny_trainer(cfg, steps=4, lr=3e-3).run(4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_trained_model_serves_through_both_engines():
    """A model trained with AQUA on (its params never require grad) is
    calibrated and serves on the kernel backend's plain versions: greedy
    tokens of ``ServeEngine`` and of the continuous-batching engine agree,
    and ``score`` is finite."""
    cfg = reduced("qwen3-0.6b", d_model=128).with_aqua(AquaConfig(**AQUA))
    state, _ = _tiny_trainer(cfg, steps=3).run(3)
    params = state.params
    assert not any(t.requires_grad for t in tree_lib.leaves(params))
    model = build_model(cfg, "cpu")
    proj = calibrate(capture_forward(model), params,
                     pipeline.calibration_batches(cfg, seq=32), cfg,
                     device="cpu")
    prompts = pipeline.make_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2), 9)
    eng = ServeEngine(cfg, params, proj, max_seq=64, device="cpu")
    toks = eng.generate({"tokens": prompts["tokens"]}, steps=4).tokens
    assert np.isfinite(float(eng.score(prompts)))
    cb = ContinuousBatchingEngine(
        cfg, params, proj, serving=ServingConfig(max_lanes=2, max_seq=64,
                                                 max_new_tokens=4),
        device="cpu")
    outs = cb.run([Request(uid=i, tokens=prompts["tokens"][i],
                           max_new_tokens=4) for i in range(2)])
    for i in range(2):
        assert list(outs[i].tokens) == toks[i].tolist()


# -- data ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lcg", "uniform", "copy", "corpus"])
def test_make_batch_kinds(kind):
    """Shapes and dtypes as JAX's; deterministic in (seed, step); the
    rules: labels are tokens shifted by one, the copy task's repeat and
    ``loss_mask``, the LCG recurrence, tokens in the vocab; corpus windows
    equal to JAX's."""
    v, s, b = 50, 20, 3
    kw = dict(vocab_size=v, seq_len=s, global_batch=b, kind=kind, seed=5)
    if kind == "corpus":
        kw["corpus_path"] = str(ROOT / "corpora" / "calibration.txt")
    cfg = pipeline.DataConfig(**kw)
    got = pipeline.make_batch(cfg, 3)
    want = _np(jax_pipeline.make_batch(jax_pipeline.DataConfig(**kw), 3))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    t, lab = got["tokens"], got["labels"]
    assert t.min() >= 0 and t.max() < v
    np.testing.assert_array_equal(t[:, 1:], lab[:, :-1])
    again = pipeline.make_batch(cfg, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], again[k])
    assert not np.array_equal(pipeline.make_batch(cfg, 4)["tokens"], t)
    if kind == "corpus":
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    if kind == "copy":
        half = (s + 1) // 2 + 1
        seq = np.concatenate([t, lab[:, -1:]], axis=1)
        np.testing.assert_array_equal(seq[:, half:], seq[:, :s + 1 - half])
        np.testing.assert_array_equal(got["loss_mask"], want["loss_mask"])
    if kind == "lcg":
        seq = np.concatenate([t, lab[:, -1:]], axis=1).astype(np.int64)
        for row in seq:
            fits = [(a, c) for a in range(1, 17) for c in range(v)
                    if np.array_equal((a * row[:-1] + c) % v, row[1:])]
            assert fits, row


def test_calibration_batches_and_frontend_inputs():
    cfg = reduced("pixtral-12b")
    got = list(pipeline.calibration_batches(cfg, num_batches=2, batch=2,
                                            seq=16))
    assert len(got) == 2
    fe = cfg.frontend
    for b in got:
        assert b["tokens"].shape == (2, 16) and b["tokens"].dtype == np.int32
        assert b["patches"].shape == (2, fe.num_embeds, fe.embed_dim)


# -- the entry point ----------------------------------------------------------------

def test_cli_trains_and_the_loss_falls():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "20", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    m = re.search(r"first loss ([\d.]+) -> last loss ([\d.]+)", out.stdout)
    assert m, out.stdout
    assert float(m.group(2)) < float(m.group(1))


def test_cli_refuses_a_mesh_and_a_missing_card():
    with pytest.raises(NotImplementedError):
        Trainer(reduced("qwen3-0.6b"), TrainConfig(),
                pipeline.DataConfig(128, 16, 4), mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        from repro_torch.launch.train import main
        with pytest.raises(SystemExit):
            main(["--reduced", "--steps", "1"])


def test_grad_compress_is_refused():
    """``grad_compress`` compresses a mesh's allreduce; the port trains on
    one device and refuses it rather than ignore it."""
    with pytest.raises(NotImplementedError, match="grad_compress"):
        Trainer(reduced("qwen3-0.6b"), TrainConfig(grad_compress=True),
                pipeline.DataConfig(128, 16, 4), device="cpu")
