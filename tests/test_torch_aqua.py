"""Parity of the port's AQUA core, configs, calibration, corpus reader and
trace generator with the JAX package, on the same numpy inputs."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import aqua as jax_aqua
from repro.core import calibration as jax_cal
from repro.data.pipeline import calibration_batches as jax_calib_batches
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch.configs import get_config, reduced
from repro_torch.core import aqua
from repro_torch.core import calibration as cal
from repro_torch.data.corpus import calibration_batches
from repro_torch.serving import poisson_trace

CORPUS = os.path.join(os.path.dirname(__file__), "..", "corpora",
                      "calibration.txt")


def _tied(rng, shape):
    """Values from a tiny set so that block magnitude sums tie often."""
    return rng.choice(np.array([-2.0, -1.0, 1.0, 2.0], np.float32), shape)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("d,k_dims", [(32, 24), (32, 8), (128, 96)])
def test_topk_block_indices_match_jax(tied, d, k_dims):
    rng = np.random.default_rng(d + k_dims)
    q = (_tied(rng, (3, 4, d)) if tied
         else rng.standard_normal((3, 4, d)).astype(np.float32))
    want = np.asarray(jax_aqua.topk_block_indices(jnp.asarray(q), k_dims, 8))
    got = aqua.topk_block_indices(torch.from_numpy(q), k_dims, 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("q_chunk", [1, 8, 16])
def test_chunk_topk_block_indices_match_jax(tied, q_chunk):
    rng = np.random.default_rng(q_chunk)
    shape = (2, 4, 32, 32)
    q = (_tied(rng, shape) if tied
         else rng.standard_normal(shape).astype(np.float32))
    lengths = np.array([32, 11], np.int32)
    want = np.asarray(jax_aqua.chunk_topk_block_indices(
        jnp.asarray(q), 16, 8, q_chunk, jnp.asarray(lengths)))
    got = aqua.chunk_topk_block_indices(torch.from_numpy(q), 16, 8, q_chunk,
                                        torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block_dims,k_dims", [(1, 20), (8, 24), (8, 32)])
def test_magnitude_mask_matches_jax_on_ties(block_dims, k_dims):
    q = _tied(np.random.default_rng(5), (2, 3, 32))
    want = np.asarray(jax_aqua.magnitude_mask(jnp.asarray(q), k_dims,
                                              block_dims=block_dims))
    got = aqua.magnitude_mask(torch.from_numpy(q), k_dims,
                              block_dims=block_dims).numpy()
    np.testing.assert_array_equal(got, want)


def test_compute_projection_matches_jax_up_to_sign():
    rng = np.random.default_rng(0)
    # distinct variances per direction so the eigenvectors are unique
    d_calib = (rng.standard_normal((512, 16))
               * np.linspace(4.0, 0.5, 16)).astype(np.float32)
    want = np.asarray(jax_aqua.compute_projection(jnp.asarray(d_calib)))
    got = aqua.compute_projection(torch.from_numpy(d_calib)).numpy()
    sign = np.sign((want * got).sum(axis=0))
    np.testing.assert_allclose(got * sign, want, atol=1e-4)


def test_calibrate_is_bit_identical_to_jax():
    cfg_j = jax_reduced("qwen3-0.6b", d_model=128)
    cfg_t = reduced("qwen3-0.6b", d_model=128)
    rng = np.random.default_rng(7)
    att = cfg_t.attention
    batches = [[(rng.standard_normal((2, 16, att.num_kv_heads,
                                      att.group_size, att.head_dim)
                                     ).astype(np.float32),
                 rng.standard_normal((2, 16, att.num_kv_heads, att.head_dim)
                                     ).astype(np.float32))
                for _ in range(cfg_t.num_layers)] for _ in range(3)]
    fwd = lambda params, qk: {"qk": qk}
    want = np.asarray(jax_cal.calibrate(fwd, None, batches, cfg_j).p)
    got = cal.calibrate(fwd, None, batches, cfg_t, device="cpu").p.numpy()
    assert np.array_equal(got, want)


def test_projections_npz_round_trip_between_packages(tmp_path):
    p = np.random.default_rng(1).standard_normal((2, 2, 8, 8)).astype(
        np.float32)
    jax_cal.save_projections(str(tmp_path / "a.npz"),
                             jax_cal.AquaProjections(p=jnp.asarray(p)))
    loaded = cal.load_projections(str(tmp_path / "a.npz"), device="cpu")
    assert np.array_equal(loaded.p.numpy(), p)
    cal.save_projections(str(tmp_path / "b.npz"), loaded)
    back = jax_cal.load_projections(str(tmp_path / "b.npz"))
    assert np.array_equal(np.asarray(back.p), p)


def test_identity_projections():
    p = cal.identity_projections(3, 2, 8, device="cpu").p
    assert p.shape == (3, 2, 8, 8)
    assert torch.equal(p[2, 1], torch.eye(8))


def test_calibration_batches_match_jax_corpus_windows():
    cfg = jax_reduced("qwen3-0.6b", d_model=128)
    want = [np.asarray(b["tokens"]) for b in jax_calib_batches(
        cfg, num_batches=3, batch=2, seq=32, corpus_path=CORPUS)]
    got = [b["tokens"] for b in calibration_batches(
        cfg.vocab_size, CORPUS, num_batches=3, batch=2, seq=32)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3.1-8b"])
def test_configs_match_jax(arch):
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (reduced(arch, d_model=128),
                       jax_reduced(arch, d_model=128))):
        for f in dataclasses.fields(mine):
            if f.name in ("attention", "frontend"):
                # the two packages' own dataclasses: compared field by
                # field (the backend names differ by design)
                sub, jsub = getattr(mine, f.name), getattr(ref, f.name)
                for af in dataclasses.fields(sub):
                    if af.name == "backend":
                        continue
                    assert getattr(sub, af.name) == getattr(jsub, af.name), \
                        (f.name, af.name)
            else:
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_poisson_trace_matches_jax():
    kw = dict(mean_interarrival=2.0, prompt_lens=(5, 9), max_new_tokens=4,
              vocab_size=100, seed=3)
    for a, b in zip(poisson_trace(6, **kw), jax_poisson_trace(6, **kw)):
        assert a.uid == b.uid and a.arrival == b.arrival
        np.testing.assert_array_equal(a.tokens, b.tokens)
