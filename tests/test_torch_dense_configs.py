"""The dense configs Qwen1.5-4B (MHA: GQA group 1, q/k/v biases) and
Minitron-4B (group 3) in the port, against the JAX package.

* ``get_config`` of every arch the port registers equals the JAX
  package's config field by field (``act`` and ``skip_long_context``
  included, the attention's fields too);
* the MLP follows ``ModelConfig.act`` as in JAX (gated iff "silu"): a
  reduced model's logits with each activation against JAX's forward on
  the same params (float32, within 1e-4, as tests/test_torch_model.py
  holds the model's logits);
* the continuous-batching engine's greedy tokens on ``aqua-block-sparse``
  (JAX: Pallas interpret mode) at group 1 (reduced Qwen1.5-4B: 4 heads,
  4 KV heads, biases) and at an explicit group 3 (Minitron's structure at
  6 heads and 2 KV heads: ``reduce_config`` would give it group 2),
  paged: identical;
* the launcher serves both names (``--arch``, ``--reduced``) with
  ``--verify``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (ALL_ARCHS, AquaConfig, CacheSpec,
                                 ServingConfig, get_config, reduced)
from repro_torch.core.calibration import AquaProjections
from repro_torch.launch.serve import main
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, Request

NEW_ARCHS = ("qwen1.5-4b", "minitron-4b")
AQUA_KW = dict(k_ratio=0.75, block_dims=8, prefill_q_blk=16)
SERVE = dict(max_lanes=3, max_seq=64, max_new_tokens=8, prompt_bucket=8)
PROMPTS = (5, 12, 20, 30, 9)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_config_fields_equal_jax(name):
    got, want = get_config(name), jax_get_config(name)
    for f in dataclasses.fields(got):
        if (f.name in ("attention", "moe", "frontend", "ssm", "rglru")
                and getattr(got, f.name) is not None):
            sub, jsub = getattr(got, f.name), getattr(want, f.name)
            for g in dataclasses.fields(sub):
                assert getattr(sub, g.name) == getattr(jsub, g.name), \
                    (name, f.name, g.name)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), \
                (name, f.name)
    if name in NEW_ARCHS:
        assert got.act == "silu" and got.skip_long_context


def test_published_geometries():
    q, m = get_config("qwen1.5-4b"), get_config("minitron-4b")
    assert (q.num_layers, q.d_model, q.d_ff, q.vocab_size) == \
        (40, 2560, 6912, 151936)
    assert (q.attention.num_heads, q.attention.num_kv_heads,
            q.attention.head_dim, q.attention.group_size) == (20, 20, 128, 1)
    assert q.attention.qkv_bias and q.attention.rope_theta == 1e6
    assert (m.num_layers, m.d_model, m.d_ff, m.vocab_size) == \
        (32, 3072, 9216, 256000)
    assert (m.attention.num_heads, m.attention.num_kv_heads,
            m.attention.head_dim, m.attention.group_size) == (24, 8, 128, 3)
    assert m.attention.rope_theta == 1e4
    # the reduction keeps MHA as MHA, and turns group 3 into group 2
    assert reduced("qwen1.5-4b").attention.group_size == 1
    assert reduced("minitron-4b").attention.group_size == 2


def _configs(name):
    """(JAX config, port config) at a reduced width; Minitron at an
    explicit group 3 (6 heads over 2 KV heads)."""
    jcfg, tcfg = jax_reduced(name, d_model=128), reduced(name, d_model=128)
    if name == "minitron-4b":
        jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
            jcfg.attention, num_heads=6, num_kv_heads=2, head_dim=32))
        tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(
            tcfg.attention, num_heads=6, num_kv_heads=2, head_dim=32))
    return jcfg, tcfg


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_follows_act_like_jax(act):
    jcfg, tcfg = _configs("qwen1.5-4b")
    jcfg = dataclasses.replace(jcfg, act=act, remat=False)
    tcfg = dataclasses.replace(tcfg, act=act)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(2))
    assert ("w3" in params["layers"]["ffn"]) == (act == "silu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(0).integers(0, 128, (2, 24), np.int32)
    want = np.asarray(jax_build_model(jcfg).forward(
        params, {"tokens": jnp.asarray(toks)}))
    got = build_model(tcfg, "cpu").forward(
        tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # the port's own init makes the same tree
    own = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert ("w3" in own["layers"]["ffn"]) == (act == "silu")


def _requests(cls):
    rng = np.random.default_rng(5)
    return [cls(uid=i, tokens=rng.integers(0, 128, size=(n,),
                                           dtype=np.int32),
                max_new_tokens=8, arrival=float(i))
            for i, n in enumerate(PROMPTS)]


@pytest.mark.parametrize("name,group", [("qwen1.5-4b", 1),
                                        ("minitron-4b", 3)])
def test_engine_greedy_tokens_match_jax(name, group):
    jcfg, tcfg = _configs(name)
    jcfg = dataclasses.replace(jcfg, aqua=JaxAquaConfig(
        prefill_k_blk=16, decode_seq_blk=16, **AQUA_KW))
    tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(**AQUA_KW))
    assert tcfg.attention.group_size == group
    assert tcfg.attention.qkv_bias == (name == "qwen1.5-4b")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    want = JaxEngine(jcfg, params, JaxProjections(p=jnp.asarray(proj)),
                     serving=JaxServingConfig(
                         cache=JaxCacheSpec(page_size=8,
                                            prefix_sharing=False), **SERVE),
                     backend="aqua-block-sparse").run(_requests(JaxRequest))
    eng = ContinuousBatchingEngine(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        AquaProjections(p=torch.from_numpy(proj)),
        serving=ServingConfig(cache=CacheSpec(page_size=8,
                                              prefix_sharing=False),
                              **SERVE),
        backend="aqua-block-sparse", device="cpu")
    got = eng.run(_requests(Request))
    assert eng.stats.decode_steps > 0
    for uid, out in want.items():
        assert got[uid].tokens == list(out.tokens), uid


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_launcher_serves_the_new_archs(name, capsys):
    run = main(["--device", "cpu", "--arch", name, "--reduced",
                "--block-dims", "8", "--page-size", "8", "--requests", "4",
                "--verify"])
    printed = capsys.readouterr().out
    assert "[serve] verify: all 4 requests token-identical" in printed
    assert run.engine.cfg.name == name
    assert len(run.streamed) == 4
