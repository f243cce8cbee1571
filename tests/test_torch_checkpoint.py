"""The port's checkpoint manager, ``ServeEngine.score`` and AQUA's
fidelity helpers against the JAX package's, on the CPU:

* the manager's round trip (dicts, lists, bfloat16, int32, a 0-d leaf),
  keep-N, an async save, no ``.tmp`` left behind, the shape-mismatch and
  missing-checkpoint errors, mesh placement refused (JAX's
  ``tests/test_checkpoint.py``);
* an exact preemption resume: 4 steps, a save, a fresh ``Trainer`` that
  restores and trains 4 more, against 8 straight steps (JAX's
  tolerances);
* the on-disk format is JAX's: a checkpoint that JAX's
  ``CheckpointManager`` writes from a JAX ``TrainState`` restores in the
  port's ``Trainer``, which goes on with JAX's losses, and the reverse;
  params in bfloat16 beside float32 moments. Both trainers read the same
  corpus windows (``kind="corpus"``). Losses at 1e-4 relative: a bf16
  param rounds the same float32 update one step apart where the float32
  sums differ in their last bits;
* ``ServeEngine.score`` against JAX's ``score`` with AQUA off (flash's
  plain version against JAX's ``dense-jnp``) and at ``k_ratio`` 0.75 and
  0.5 with ``block_dims`` 8 on ``aqua-block-sparse`` (the prefill's plain
  version against JAX's Pallas kernel in interpret mode) and on
  ``aqua-masked-dense``, at 1e-5 relative;
* the seven ``core/aqua.py`` helpers on the same numpy arrays, at 1e-6.
"""
import dataclasses
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import aqua as jax_aqua
from repro.core.calibration import AquaProjections as JaxProjections
from repro.data import pipeline as jax_pipeline
from repro.launch.train import Trainer as JaxTrainer
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import tree as tree_lib
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import AquaConfig, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import aqua
from repro_torch.core.calibration import AquaProjections
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import Trainer
from repro_torch.serving import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
CORPUS = str(ROOT / "corpora" / "calibration.txt")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(4, 8, generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32),
                   "c": [torch.ones(2),
                         torch.randn(3, 3, generator=g).to(torch.bfloat16)]},
        "scalar": torch.tensor(3.5),
    }


def _equal(a, b):
    for (ka, x), (kb, y) in zip(tree_lib.items(a), tree_lib.items(b)):
        assert ka == kb and x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), ka


# -- the manager ---------------------------------------------------------------

def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    m.save(10, t)
    target = tree_lib.tree_map(lambda x: torch.empty_like(x, device="meta"),
                               t)
    restored, step = m.restore(None, target)
    assert step == 10
    _equal(t, restored)


@pytest.mark.parametrize("seed", [1, 7, 123])
def test_roundtrip_seeds(tmp_path, seed):
    m = CheckpointManager(str(tmp_path))
    t = _tree(seed)
    m.save(seed, t)
    r, _ = m.restore(seed, t)
    _equal(t, r)


def test_keep_n(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree())
    assert m.all_steps() == [3, 4]


def test_async_save(tmp_path):
    """``blocking=False`` copies to the host before it returns: writing
    the tensors afterwards does not reach the checkpoint."""
    m = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    want = tree_lib.tree_map(lambda x: x.clone(), t)
    m.save(5, t, blocking=False)
    t["a"].add_(1.0)
    m.wait()
    assert m.latest_step() == 5
    _equal(want, m.restore(5, t)[0])


def test_atomic_no_tmp_left(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(7, _tree())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert sorted(os.listdir(tmp_path / "ckpt_00000007")) == [
        "arrays.npz", "manifest.json"]


def test_restore_errors(tmp_path):
    m = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        m.restore(None, {})
    m.save(1, {"x": torch.ones(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore(1, {"x": torch.ones(5)})
    with pytest.raises(NotImplementedError):
        m.restore(1, {"x": torch.ones(4)}, shardings={"x": None})


def test_files_read_across_packages(tmp_path):
    """The same tree written by either manager reads back in the other,
    bit for bit, bfloat16 included; the manifests agree but for the
    time."""
    t = _tree(3)
    jt = jax.tree.map(lambda x: jnp.asarray(x.float().numpy()).astype(
        {torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}.get(
            x.dtype, jnp.float32)), t)
    CheckpointManager(str(tmp_path / "port")).save(2, t)
    JaxCheckpointManager(str(tmp_path / "jax")).save(2, jt)
    got, _ = CheckpointManager(str(tmp_path / "jax")).restore(2, t)
    _equal(t, got)
    back, _ = JaxCheckpointManager(str(tmp_path / "port")).restore(2, jt)
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    import json
    man = [json.load(open(tmp_path / d / "ckpt_00000002" / "manifest.json"))
           for d in ("port", "jax")]
    assert man[0]["arrays"] == man[1]["arrays"]


def test_projection_sidecar(tmp_path):
    m = CheckpointManager(str(tmp_path))
    assert m.load_aqua_projections("cpu") is None
    p = AquaProjections(p=torch.randn(2, 1, 8, 8))
    m.save_aqua_projections(p)
    assert torch.equal(m.load_aqua_projections("cpu").p, p.p)
    jp = JaxCheckpointManager(str(tmp_path)).load_aqua_projections()
    np.testing.assert_array_equal(np.asarray(jp.p), p.p.numpy())


def test_import_hf(tmp_path):
    from repro_torch.checkpoint.fixtures import write_hf_fixture
    from repro_torch.checkpoint.hf import config_from_hf
    hf = tmp_path / "hf"
    write_hf_fixture(str(hf), dtype="bfloat16", device="cpu")
    cfg = config_from_hf(str(hf))
    m = CheckpointManager(str(tmp_path / "ck"))
    params = m.import_hf(str(hf), cfg, step=3, device="cpu")
    assert m.latest_step() == 3
    _equal(params, m.restore(3, params)[0])


# -- training resumes -------------------------------------------------------------

def _trainer_args(dtype="float32", steps=8):
    cfg = dataclasses.replace(reduced("qwen3-0.6b"), param_dtype=dtype)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, checkpoint_every=4,
                       learning_rate=1e-3)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      kind="corpus", corpus_path=CORPUS)
    return cfg, tcfg, dcfg


def test_preemption_resume_exact(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run."""
    args = _trainer_args()
    s1, l1 = Trainer(*args, device="cpu").run(8, log_every=100)
    ck = str(tmp_path / "ck")
    _, l2 = Trainer(*args, ckpt_dir=ck, device="cpu").run(4, log_every=100)
    s3, l3 = Trainer(*args, ckpt_dir=ck, device="cpu").run(4, log_every=100)
    assert int(s1.step) == int(s3.step) == 8
    np.testing.assert_allclose(l2 + l3, l1, rtol=1e-6)
    for a, b in zip(tree_lib.leaves(s1.params), tree_lib.leaves(s3.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX trainer (its step jitted once) for the bf16-param config."""
    cfg, tcfg, dcfg = _trainer_args("bfloat16")
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), remat=False,
                               param_dtype="bfloat16")
    jt = JaxTrainConfig(**dataclasses.asdict(tcfg))
    jd = jax_pipeline.DataConfig(**dataclasses.asdict(dcfg))
    return JaxTrainer(jcfg, jt, jd, ckpt_dir=None, donate=False)


def _jax_run(trainer, ckpt_dir, steps):
    trainer.ckpt = JaxCheckpointManager(ckpt_dir, keep=3)
    return trainer.run(steps, log_every=100)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, jax_trainer):
    """JAX trains 2 steps and saves; from that checkpoint JAX's trainer and
    the port's each train 2 more: the same losses and params."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_run(jax_trainer, a, 2)
    shutil.copytree(a, b)
    js, jl = _jax_run(jax_trainer, a, 2)
    port = Trainer(*_trainer_args("bfloat16"), ckpt_dir=b, device="cpu")
    ts, tl = port.run(2, log_every=100)
    assert int(ts.step) == int(js.step) == 4
    assert ts.params["embed"]["table"].dtype == torch.bfloat16
    assert ts.opt.mu["embed"]["table"].dtype == torch.float32
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for (k, t), j in zip(tree_lib.items(ts.params),
                         jax.tree.leaves(_np(js.params))):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j,
                                   np.float32), rtol=2 ** -7, atol=1e-4,
                                   err_msg=k)


def test_port_checkpoint_resumes_in_jax(tmp_path, jax_trainer):
    """The reverse: the port trains 2 steps from its own init and saves;
    JAX's trainer restores it and goes on with the port's losses."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    args = _trainer_args("bfloat16")
    Trainer(*args, ckpt_dir=a, device="cpu").run(2, log_every=100)
    shutil.copytree(a, b)
    _, tl = Trainer(*args, ckpt_dir=a, device="cpu").run(2, log_every=100)
    js, jl = _jax_run(jax_trainer, b, 2)
    assert int(js.step) == 4
    np.testing.assert_allclose(jl, tl, rtol=1e-4)


# -- ServeEngine.score ---------------------------------------------------------------

@pytest.fixture(scope="module")
def scored():
    """JAX params and projections (random orthogonal) of the reduced Qwen3
    at head dim 32, and 2 batches of the copy task."""
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b", d_model=128),
                               remat=False)
    params = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    att = jcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (jcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    dcfg = jax_pipeline.DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                   global_batch=4, kind="copy")
    batches = [_np(jax_pipeline.make_batch(dcfg, 50_000 + i))
               for i in range(2)]
    return jcfg, params, proj, batches


@pytest.mark.parametrize("k_ratio,backend", [
    (None, None), (0.75, "aqua-block-sparse"), (0.5, "aqua-block-sparse"),
    (0.75, "aqua-masked-dense"), (0.5, "aqua-masked-dense")])
def test_score_matches_jax(scored, k_ratio, backend):
    jcfg, params, proj, batches = scored
    tcfg = reduced("qwen3-0.6b", d_model=128)
    if k_ratio is not None:
        kw = dict(k_ratio=k_ratio, block_dims=8, prefill_q_blk=16)
        jcfg = jcfg.with_aqua(JaxAquaConfig(**kw))
        tcfg = tcfg.with_aqua(AquaConfig(**kw))
    jeng = JaxServeEngine(jcfg, params, JaxProjections(p=jnp.asarray(proj)),
                          max_seq=64, backend=backend)
    teng = ServeEngine(tcfg, params_from_numpy(_np(params), "cpu"),
                       AquaProjections(p=torch.from_numpy(proj)), max_seq=64,
                       backend=backend, device="cpu")
    for batch in batches:
        want = float(jeng.score(batch))
        got = teng.score(batch)
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


# -- a lane of length 0 ----------------------------------------------------------

def test_length_zero_lane_gets_the_dense_reference_answer(scored):
    """``ServeEngine.generate`` passes a caller's ``lengths`` straight to
    the prefill, so a lane of length 0 reaches the prefill kernel (and
    flash with AQUA off). Every row of it takes the mean of V over all S
    keys, JAX's dense reference's answer (``dense-jnp``, where JAX sends
    flash with lengths, and ``kernels/ref.py``'s oracle; JAX's Pallas
    prefill averages the keys of the tiles its causal band visits
    instead). Held here: the engines' logits and greedy tokens with AQUA
    off (flash's plain version against JAX's ``dense-jnp``), at 1e-4 (the
    model tests' limit); the prefill's plain version against JAX's oracle
    at 1e-6, and flash's equal to it on the empty lane."""
    from repro.kernels.ref import aqua_prefill_ref as jax_prefill_ref
    from repro_torch.kernels.aqua_prefill import aqua_prefill_attention
    from repro_torch.kernels.flash_attention import flash_attention
    jcfg, params, proj, batches = scored
    tokens = batches[0]["tokens"][:3]
    lengths = np.array([32, 0, 11], np.int32)
    want = JaxServeEngine(jcfg, params, max_seq=64).generate(
        {"tokens": tokens, "lengths": lengths}, steps=3)
    got = ServeEngine(reduced("qwen3-0.6b", d_model=128),
                      params_from_numpy(_np(params), "cpu"), max_seq=64,
                      device="cpu").generate(
        {"tokens": tokens, "lengths": lengths}, steps=3)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logits_last, want.logits_last, rtol=1e-4,
                               atol=1e-4)
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, h, 48, 16)).astype(np.float32)
               for h in (4, 2, 2))
    ln = np.array([48, 0], np.int32)
    idx = np.zeros((2, 4, 3, 1), np.int32)
    got = aqua_prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(idx),
                                 torch.from_numpy(ln), block_dims=8,
                                 q_blk=16)
    want = jax_prefill_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(idx), jnp.asarray(ln), 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    mean = v[1].mean(1)                                   # (KV, D)
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(
        np.repeat(mean, 2, 0)[:, None], got[1].shape), rtol=1e-5, atol=1e-6)
    flash = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), lengths=torch.from_numpy(ln))
    np.testing.assert_allclose(flash[1].numpy(), got[1].numpy(), rtol=1e-5,
                               atol=1e-6)


# -- the fidelity helpers ---------------------------------------------------------------

def test_aqua_helpers_match_jax():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    t, j = torch.from_numpy, jnp.asarray
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    qs, ks = f(3, 10, 16), f(10, 16)
    close(aqua.gqa_calibration_matrix(t(qs), t(ks)),
          jax_aqua.gqa_calibration_matrix(j(qs), j(ks)))
    p = np.linalg.qr(f(16, 16))[0].astype(np.float32)
    for m in (p, p * 1.01):
        assert bool(aqua.check_orthogonal(t(m))) == bool(
            jax_aqua.check_orthogonal(j(m)))
    q, kh = f(2, 3, 16), f(2, 3, 7, 16)
    mask = (rng.random((2, 3, 16)) > 0.5).astype(np.float32)
    close(aqua.approx_scores(t(q), t(kh), t(mask)),
          jax_aqua.approx_scores(j(q), j(kh), j(mask)))
    cfg, jcfg = AquaConfig(s_ratio=0.25), JaxAquaConfig(s_ratio=0.25)
    v = f(2, 5, 16)
    close(aqua.static_slice(t(v), cfg, 16),
          jax_aqua.static_slice(j(v), jcfg, 16))
    vh = f(2, 5, 16)
    close(aqua.info_retention_loss(t(v), t(vh), t(mask[:, :1])),
          jax_aqua.info_retention_loss(j(v), j(vh), j(mask[:, :1])))
    like = f(4, 3, 16)
    got = aqua.slicing_mask(16, 6, t(like))
    close(got, jax_aqua.slicing_mask(16, 6, j(like)))
    assert got.shape == like.shape
    wq, wk = f(32, 4, 16), f(32, 16)
    for a, b in zip(aqua.fold_projection_into_weights(t(wq), t(wk), t(p)),
                    jax_aqua.fold_projection_into_weights(j(wq), j(wk),
                                                          j(p))):
        close(a, b)
