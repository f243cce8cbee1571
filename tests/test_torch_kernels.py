"""The port's kernel ops against the JAX package's Pallas kernels (run in
interpret mode on the CPU, as tests/test_kernels.py runs them), plus the
no-fallback and no-JAX rules of the port.

On the CPU the port's wrappers run the kernels' plain PyTorch versions.
Tolerance: float32, atol = rtol = 1e-5 — the plain versions materialize
the masked scores and take one softmax, the Pallas kernels run an online
softmax over sequence tiles, so the two differ only in summation order.
Rows with ``lengths`` 0 are excluded: there the Pallas kernel returns the
mean of the V slots it visited and the CUDA kernel returns zeros; no
caller reads such rows.
"""
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.configs import AquaConfig, reduced
from repro_torch.core.calibration import identity_projections
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.runtime import resolve_device
from repro_torch.serving import ContinuousBatchingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,h,kv,s,d,k_ratio", [
    (3, 4, 2, 40, 32, 0.75),
    (2, 8, 2, 64, 64, 0.5),      # GQA group 4
    (2, 4, 4, 24, 32, 1.0),      # MHA, every block
])
def test_aqua_decode_matches_jax(b, h, kv, s, d, k_ratio):
    rng = np.random.default_rng(s + d)
    q, k, v = _randn(rng, b, h, d), _randn(rng, b, kv, s, d), \
        _randn(rng, b, kv, s, d)
    lengths = np.array([s, 7, 1][:b], np.int32)
    want = np.asarray(jax_ops.aqua_decode(
        q, k, v, lengths, k_ratio=k_ratio, block_dims=8, seq_blk=8,
        scale=0.3))
    got = ops.aqua_decode(*map(torch.from_numpy, (q, k, v, lengths)),
                          k_ratio=k_ratio, block_dims=8, scale=0.3).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ps", [8, 16])
def test_aqua_paged_decode_matches_jax(ps):
    rng = np.random.default_rng(ps)
    b, h, kv, d, npl, p = 3, 4, 2, 32, 4, 9
    q = _randn(rng, b, h, d)
    k_pool, v_pool = _randn(rng, p, kv, ps, d), _randn(rng, p, kv, ps, d)
    # -1 unmapped entries, and physical page 2 shared by lanes 0 and 1
    table = np.array([[0, 2, 5, -1], [2, 7, -1, -1], [8, 1, 3, 4]], np.int32)
    lengths = np.array([3 * ps - 2, ps + 3, 4 * ps], np.int32)
    want = np.asarray(jax_ops.aqua_paged_decode(
        q, k_pool, v_pool, table, lengths, k_ratio=0.75, block_dims=8,
        seq_blk=8, scale=0.25))
    got = ops.aqua_paged_decode(
        *map(torch.from_numpy, (q, k_pool, v_pool, table, lengths)),
        k_ratio=0.75, block_dims=8, scale=0.25).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_decode_equals_contiguous_decode():
    """A contiguous cache is a page pool with one page per lane."""
    rng = np.random.default_rng(4)
    b, h, kv, s, d = 2, 4, 2, 32, 32
    q, k, v = (torch.from_numpy(_randn(rng, *sh)) for sh in
               ((b, h, d), (b, kv, s, d), (b, kv, s, d)))
    lengths = torch.tensor([20, 32], dtype=torch.int32)
    table = torch.tensor([[0], [1]], dtype=torch.int32)
    a = ops.aqua_decode(q, k, v, lengths)
    p = ops.aqua_paged_decode(q, k, v, table, lengths)
    np.testing.assert_array_equal(a.numpy(), p.numpy())


@pytest.mark.parametrize("b,h,kv,s,d,q_blk,k_ratio", [
    (2, 4, 2, 40, 32, 16, 0.75),   # ragged: S not a multiple of q_blk
    (1, 8, 2, 64, 64, 8, 0.5),
    (2, 4, 4, 48, 32, 32, 1.0),
])
def test_aqua_prefill_matches_jax(b, h, kv, s, d, q_blk, k_ratio):
    rng = np.random.default_rng(s + q_blk)
    q, k, v = _randn(rng, b, h, s, d), _randn(rng, b, kv, s, d), \
        _randn(rng, b, kv, s, d)
    lengths = np.array([s, s - 13][:b], np.int32)
    want = np.asarray(jax_ops.aqua_prefill(
        q, k, v, lengths, k_ratio=k_ratio, block_dims=8, q_blk=q_blk,
        k_blk=16, scale=0.2))
    got = ops.aqua_prefill(*map(torch.from_numpy, (q, k, v, lengths)),
                           k_ratio=k_ratio, block_dims=8, q_blk=q_blk,
                           scale=0.2).numpy()
    valid = (np.arange(s)[None, :] < lengths[:, None])[:, None, :, None]
    np.testing.assert_allclose(got * valid, want * valid, **TOL)


@pytest.mark.parametrize("window", [None, 24])
def test_aqua_prefill_at_head_dim_256_matches_jax(window):
    """RecurrentGemma's head dim (256: the CUDA kernel's wide engine) and
    its one KV head (4 query heads here), the window form and the full
    causal form, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(256 + (window or 0))
    b, h, kv, s, d = 2, 4, 1, 40, 256
    q, k, v = _randn(rng, b, h, s, d), _randn(rng, b, kv, s, d), \
        _randn(rng, b, kv, s, d)
    lengths = np.array([s, s - 9], np.int32)
    want = np.asarray(jax_ops.aqua_prefill(
        q, k, v, lengths, k_ratio=0.75, block_dims=8, q_blk=16, k_blk=16,
        window=window, scale=d ** -0.5))
    got = ops.aqua_prefill(*map(torch.from_numpy, (q, k, v, lengths)),
                           k_ratio=0.75, block_dims=8, q_blk=16,
                           window=window, scale=d ** -0.5).numpy()
    valid = (np.arange(s)[None, :] < lengths[:, None])[:, None, :, None]
    np.testing.assert_allclose(got * valid, want * valid, **TOL)


def test_prefill_reads_strided_views():
    """The model passes permuted views; results equal contiguous inputs."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_randn(rng, 1, 24, 2, 2, 32))   # (B, S, KV, G, D)
    k = torch.from_numpy(_randn(rng, 1, 24, 2, 32))
    v = torch.from_numpy(_randn(rng, 1, 24, 2, 32))
    qf = q.permute(0, 2, 3, 1, 4).reshape(1, 4, 24, 32)
    views = ops.aqua_prefill(qf, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                             q_blk=8)
    dense = ops.aqua_prefill(qf.contiguous(), k.permute(0, 2, 1, 3)
                             .contiguous(), v.permute(0, 2, 1, 3).contiguous(),
                             q_blk=8)
    np.testing.assert_array_equal(views.numpy(), dense.numpy())


def test_dim_major_and_block_accounting_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 32)).astype(
        np.float32)
    np.testing.assert_array_equal(
        ops.to_dim_major_blocks(torch.from_numpy(x), 8).numpy(),
        np.asarray(jax_ops.to_dim_major_blocks(jnp.asarray(x), 8)))
    for d in (32, 64, 128):
        for r in (0.1, 0.5, 0.75, 0.9, 1.0):
            assert ops.round_k_dims(d, r, 8) == jax_ops.round_k_dims(d, r, 8)
            assert ops.block_counts(d, r, 8) == jax_ops.block_counts(d, r, 8)


# ---------------------------------------------------------------------------
# No fallback, no JAX
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_non_cpu_non_cuda_tensors():
    q = torch.zeros(1, 2, 32, device="meta")
    k = torch.zeros(1, 1, 8, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.aqua_decode(q, k, k, torch.tensor([8]))


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    cfg = reduced("qwen3-0.6b", d_model=64)
    with pytest.raises(RuntimeError):
        build_model(cfg)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        ContinuousBatchingEngine(cfg, params)
    q = torch.zeros(1, 2, 32)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.aqua_decode(q.to("cuda"), torch.zeros(1, 1, 8, 32).to("cuda"),
                        torch.zeros(1, 1, 8, 32).to("cuda"),
                        torch.tensor([8]))
    aq = AquaConfig(k_ratio=0.75, block_dims=8)
    cfg = cfg.with_aqua(aq)
    proj = identity_projections(cfg.num_layers, 1, 32, device="cpu")
    with pytest.raises(RuntimeError):
        ContinuousBatchingEngine(cfg, params, proj, device="cuda")


def test_port_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'repro', 'safetensors', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_port_sources_never_import_jax_or_repro():
    """Nor ``safetensors`` or ``ml_dtypes``: the GPU machine has neither
    (the port reads and writes the format itself)."""
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"(?!_torch)|from\s+repro(\.|\s)(?!_torch)"
                     r"|(import|from)\s+(safetensors|ml_dtypes)\b)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "kernel_race.py",
              ROOT / "pixtral_divergence.py", ROOT / "train_profile.py"]
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/checkpoint/safetensors.py",
            "src/repro_torch/checkpoint/hf.py",
            "src/repro_torch/checkpoint/fixtures.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/configs/pixtral_12b.py",
            "src/repro_torch/configs/whisper_tiny.py",
            "src/repro_torch/configs/mamba2_370m.py",
            "src/repro_torch/configs/recurrentgemma_9b.py",
            "src/repro_torch/models/mamba2.py",
            "src/repro_torch/models/rglru.py"} <= names
    assert len(files) > 40
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)
