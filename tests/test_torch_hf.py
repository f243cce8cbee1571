"""The port's HF ingestion against the JAX package's: its safetensors codec,
``checkpoint/hf.py`` and ``checkpoint/fixtures.py``, at the JAX writer's
tiny qwen3 geometry (``QWEN3_TINY``, 2 layers).

- Every fixture variant the JAX writer makes loads bit-equal, leaf by
  leaf, through the port's ``load_hf_checkpoint`` and JAX's.
- Files the port's writer makes are read by JAX's loader (bit-equal to the
  port's loader) and by ``safetensors.numpy.load_file``.
- ``config_from_hf`` agrees field by field; the four error cases hold.
- A ``qkv_bias`` checkpoint's logits agree with JAX's ``DenseLM.forward``
  (float32; |port - JAX| <= 1e-5 + 1e-5 |JAX|: the same float32 math in
  other summation orders over 2 layers of width 64).
- ``ServeEngine.generate`` gives JAX's greedy tokens, and its cache bytes.
"""
import dataclasses
import json
import os
import struct


import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers bfloat16 with numpy)
import numpy as np
import pytest
import torch

from repro.checkpoint import fixtures as jfix
from repro.checkpoint import hf as jhf
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.core.calibration import AquaProjections as JaxProjections
from repro.models import build_model as jax_build_model
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.checkpoint import fixtures as tfix
from repro_torch.checkpoint import hf as thf
from repro_torch.checkpoint import safetensors as st
from repro_torch.configs import AquaConfig
from repro_torch.core.calibration import AquaProjections
from repro_torch.data.corpus import calibration_batches, lcg_batch
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine

# (variant, tied, bias, dtype, extra_tensors)
VARIANTS = {
    "single": ("single", False, False, "float32", False),
    "sharded": ("sharded", False, False, "float32", False),
    "tied": ("single", True, False, "float32", False),
    "bias": ("single", False, True, "float32", False),
    "bf16": ("single", False, False, "bfloat16", False),
    "bf16-sharded-tied": ("sharded", True, False, "bfloat16", False),
    "extra": ("sharded", False, False, "float32", True),
}


def _kw(name):
    variant, tied, bias, dtype, extra = VARIANTS[name]
    return dict(variant=variant, tied=tied, bias=bias, dtype=dtype,
                extra_tensors=extra)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_trees_bit_equal(jtree, ttree):
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert sorted(jl) == sorted(tl)
    for path, jv in jl.items():
        j, t = np.asarray(jv), tl[path]
        assert t.dtype == torch.float32 and j.dtype == np.float32, path
        assert tuple(t.shape) == j.shape, path
        np.testing.assert_array_equal(t.numpy().view(np.int32),
                                      j.view(np.int32), err_msg=str(path))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_jax_written_fixture_loads_bit_equal(tmp_path, name):
    out = str(tmp_path / "ckpt")
    jfix.write_hf_fixture(out, seed=3, **_kw(name))
    jcfg, tcfg = jhf.config_from_hf(out), thf.config_from_hf(out)
    _assert_trees_bit_equal(jhf.load_hf_checkpoint(out, jcfg),
                            thf.load_hf_checkpoint(out, tcfg, device="cpu"))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_port_written_fixture_read_by_jax_and_safetensors(tmp_path, name):
    out = str(tmp_path / "ckpt")
    sd = tfix.write_hf_fixture(out, seed=5, device="cpu", **_kw(name))
    jcfg, tcfg = jhf.config_from_hf(out), thf.config_from_hf(out)
    _assert_trees_bit_equal(jhf.load_hf_checkpoint(out, jcfg),
                            thf.load_hf_checkpoint(out, tcfg, device="cpu"))
    st_numpy = pytest.importorskip("safetensors.numpy")
    stored = {"float32": torch.float32,
              "bfloat16": torch.bfloat16}[VARIANTS[name][3]]
    files = sorted(f for f in os.listdir(out) if f.endswith(".safetensors"))
    seen = set()
    for fname in files:
        theirs = st_numpy.load_file(os.path.join(out, fname))
        ours = st.load_file(os.path.join(out, fname))
        assert sorted(theirs) == sorted(ours)
        for k, arr in theirs.items():
            t = ours[k]
            assert tuple(t.shape) == arr.shape, k
            bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
            np.testing.assert_array_equal(
                t.view(bits).numpy(),
                arr.view(np.int16 if bits == torch.int16 else np.int32))
            if k in sd:        # the writer's contract: sd cast to `stored`
                assert torch.equal(t, sd[k].to(stored)), k
        seen |= set(theirs)
    assert set(sd) <= seen
    assert ("model.layers.0.self_attn.rotary_emb.inv_freq" in seen) \
        == VARIANTS[name][4]
    if VARIANTS[name][0] == "sharded":
        with open(os.path.join(out, thf.INDEX_NAME)) as f:
            index = json.load(f)
        assert set(index["weight_map"]) == seen
        assert sorted(set(index["weight_map"].values())) == files


@pytest.mark.parametrize("overrides", [
    {}, {"tie_word_embeddings": True}, {"attention_bias": True},
    {"model_type": "qwen2"}, {"model_type": "llama", "num_key_value_heads": 4},
    {"model_type": "llama", "head_dim": None, "rms_norm_eps": 1e-5,
     "rope_theta": 500000.0, "_name_or_path": "tiny-llama",
     "rope_scaling": {"rope_type": "llama3", "factor": 8.0}}])
def test_config_from_hf_agrees_field_by_field(tmp_path, overrides):
    out = str(tmp_path / "ckpt")
    cfg = dict(jfix.QWEN3_TINY, **overrides)
    if cfg["head_dim"] is None:
        del cfg["head_dim"]
    os.makedirs(out)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(cfg, f)
    j, t = jhf.config_from_hf(out), thf.config_from_hf(out)
    for f in ("name", "family", "num_layers", "d_model", "d_ff",
              "vocab_size", "norm_eps", "tie_embeddings", "dtype",
              "param_dtype"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("num_heads", "num_kv_heads", "head_dim", "qk_norm", "qkv_bias",
              "rope_theta", "window"):
        assert getattr(t.attention, f) == getattr(j.attention, f), f
    assert j.attention.kind == t.attention.kind == "full"


def _write_config(d, outdir):
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "config.json"), "w") as f:
        json.dump(d, f)
    return outdir


@pytest.mark.parametrize("overrides", [{}, {"tie_word_embeddings": True},
                                       {"attention_bias": True}])
def test_mapping_specs_match_jax(tmp_path, overrides):
    out = _write_config(dict(jfix.QWEN3_TINY, **overrides), str(tmp_path))
    j = jhf.mapping_specs(jhf.config_from_hf(out))
    t = thf.mapping_specs(thf.config_from_hf(out))
    assert [dataclasses.astuple(s) for s in t] == \
        [dataclasses.astuple(s) for s in j]


def test_missing_tensor_names_tensor_and_leaf(tmp_path):
    out = str(tmp_path / "ckpt")
    tfix.write_hf_fixture(out, device="cpu")
    fname = os.path.join(out, "model.safetensors")
    sd = st.load_file(fname)
    del sd["model.layers.1.mlp.down_proj.weight"]
    st.save_file(sd, fname)
    with pytest.raises(KeyError) as ei:
        thf.load_hf_checkpoint(out, thf.config_from_hf(out), device="cpu")
    assert "model.layers.1.mlp.down_proj.weight" in str(ei.value)
    assert "layers/ffn/w2[1]" in str(ei.value)


@pytest.mark.parametrize("field,factor", [("d_ff", 2), ("num_heads", 2)])
def test_wrong_geometry_raises_value_error(tmp_path, field, factor):
    out = str(tmp_path / "ckpt")
    tfix.write_hf_fixture(out, device="cpu")
    cfg = thf.config_from_hf(out)
    if field == "d_ff":
        cfg = dataclasses.replace(cfg, d_ff=cfg.d_ff * factor)
    else:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, num_heads=cfg.attention.num_heads * factor))
    with pytest.raises(ValueError, match="shape"):
        thf.load_hf_checkpoint(out, cfg, device="cpu")


def test_missing_checkpoint_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        thf.resolve_tensor_files(str(tmp_path / "nope"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        thf.load_hf_checkpoint(str(tmp_path / "empty"),
                               thf.config_from_hf(_write_config(
                                   jfix.QWEN3_TINY, str(tmp_path / "c"))),
                               device="cpu")


def test_unknown_model_type_raises(tmp_path):
    out = str(tmp_path / "ckpt")
    tfix.write_hf_fixture(out, config_overrides={"model_type": "mamba"},
                          device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        thf.config_from_hf(out)
    assert thf.SUPPORTED_MODEL_TYPES == jhf.SUPPORTED_MODEL_TYPES


def test_direct_file_path_and_loader_dtype(tmp_path):
    out = str(tmp_path / "ckpt")
    tfix.write_hf_fixture(out, dtype="bfloat16", device="cpu")
    cfg = thf.config_from_hf(out)
    a = thf.load_hf_checkpoint(out, cfg, device="cpu")
    b = thf.load_hf_checkpoint(os.path.join(out, "model.safetensors"), cfg,
                               device="cpu")
    c = thf.load_hf_checkpoint(out, cfg, dtype="bfloat16", device="cpu")
    for (pa, x), (pb, y), (pc, z) in zip(_leaves(a), _leaves(b), _leaves(c)):
        assert pa == pb == pc and torch.equal(x, y)
        assert z.dtype == torch.bfloat16 and torch.equal(z.float(), x)


def test_loader_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "ckpt")
    tfix.write_hf_fixture(out, device="cpu")
    with pytest.raises(RuntimeError):
        thf.load_hf_checkpoint(out, thf.config_from_hf(out))


def test_fixture_writer_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                             capsys):
    """The writer and its CLI draw on the card by default and refuse to
    carry on without one; ``--device cpu`` writes what the function
    writes on the CPU with the same seed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tfix.write_hf_fixture(str(tmp_path / "a"))
    with pytest.raises(SystemExit) as ei:
        tfix.main([str(tmp_path / "b")])
    assert ei.value.code != 0 and "--device cpu" in str(ei.value.code)
    tfix.main([str(tmp_path / "c"), "--variant", "sharded", "--seed", "4",
               "--device", "cpu"])
    assert "drawn on cpu" in capsys.readouterr().out
    sd = tfix.write_hf_fixture(str(tmp_path / "d"), seed=4,
                               variant="sharded", device="cpu")
    cfg = thf.config_from_hf(str(tmp_path / "c"))
    _assert_trees_bit_equal(
        thf.load_hf_checkpoint(str(tmp_path / "c"), cfg, device="cpu"),
        thf.load_hf_checkpoint(str(tmp_path / "d"), cfg, device="cpu"))
    assert len(sd) == 3 + 11 * cfg.num_layers


# -- the codec ---------------------------------------------------------------


def test_codec_round_trips_every_dtype_at_unaligned_offsets(tmp_path):
    """A 3-element run of bf16 and one of 5 f16 put the float32 and int64
    tensors after them at offsets that are no multiple of their width;
    the header pads to 8 bytes."""
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "a": torch.randn(3, generator=gen).to(torch.bfloat16),
        "b": torch.randn(2, 3, generator=gen),
        "c": torch.randn(5, generator=gen).to(torch.float16),
        "d": torch.arange(-3, 4, dtype=torch.int64).reshape(7, 1),
        "e": torch.tensor([7, -8, 2 ** 31 - 1], dtype=torch.int32),
        "f": torch.randn(4, 3, generator=gen).T,      # non-contiguous
        "g": torch.zeros(0, 4),
        "h": torch.tensor(2.5)}
    path = str(tmp_path / "x.safetensors")
    st.save_file(tensors, path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    assert n % 8 == 0
    assert any(h["data_offsets"][0] % 4 for h in header.values()
               if h["dtype"] in ("F32", "I64"))
    with st.SafetensorsFile(path) as f:
        assert sorted(f.keys()) == sorted(tensors)
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and torch.equal(got, t), k
    st_numpy = pytest.importorskip("safetensors.numpy")
    theirs = st_numpy.load_file(path)
    for k, t in tensors.items():
        np.testing.assert_array_equal(theirs[k].astype(np.float64),
                                      t.double().numpy())
    # a reference writer's file, with its __metadata__ entry (skipped)
    st_numpy.save_file({k: theirs[k] for k in ("b", "d")}, path,
                       metadata={"format": "pt"})
    with st.SafetensorsFile(path) as f:
        assert sorted(f.keys()) == ["b", "d"]
        assert torch.equal(f.get_tensor("d"), tensors["d"])


def test_codec_rejects_truncated_and_unknown_dtype(tmp_path):
    path = str(tmp_path / "x.safetensors")
    st.save_file({"w": torch.ones(4, 4)}, path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-4])
    with st.SafetensorsFile(path) as f, pytest.raises(ValueError):
        f.get_tensor("w")
    with pytest.raises(ValueError):
        st.save_file({"w": torch.ones(2, dtype=torch.uint8)}, path)


# -- the LCG calibration source ----------------------------------------------


def test_lcg_batches_follow_the_affine_rule():
    v = 256
    b = lcg_batch(v, 24, 3, seed=7, step=2)
    toks, labels = b["tokens"].astype(np.int64), b["labels"].astype(np.int64)
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    seq = np.concatenate([toks, labels[:, -1:]], axis=1)
    for row in seq:
        # (a, c) from two consecutive transitions, then every transition
        ok = [(a, c) for a in range(1, 17) for c in range(v)
              if (a * row[0] + c) % v == row[1]
              and (a * row[1] + c) % v == row[2]]
        assert any(all((a * x + c) % v == y for x, y in zip(row, row[1:]))
                   for a, c in ok)
    again = lcg_batch(v, 24, 3, seed=7, step=2)
    assert np.array_equal(again["tokens"], b["tokens"])
    assert not np.array_equal(lcg_batch(v, 24, 3, seed=7, step=3)["tokens"],
                              b["tokens"])
    got = list(calibration_batches(v, None, num_batches=2, batch=3, seq=24,
                                   seed=7))
    assert np.array_equal(got[0]["tokens"],
                          lcg_batch(v, 24, 3, 7, 0)["tokens"])


# -- forward and rectangular engine on loaded weights ------------------------


def test_qkv_bias_logits_match_jax_forward(tmp_path):
    out = str(tmp_path / "ckpt")
    jfix.write_hf_fixture(out, seed=9, bias=True, tied=True)
    jcfg, tcfg = jhf.config_from_hf(out), thf.config_from_hf(out)
    assert tcfg.attention.qkv_bias and jcfg.attention.qkv_bias
    tokens = np.random.default_rng(0).integers(0, 256, (2, 20),
                                               dtype=np.int32)
    want = np.asarray(jax_build_model(jcfg).forward(
        jhf.load_hf_checkpoint(out, jcfg), {"tokens": jnp.asarray(tokens)}))
    got = build_model(tcfg, "cpu").forward(
        thf.load_hf_checkpoint(out, tcfg, device="cpu"),
        {"tokens": torch.from_numpy(tokens)}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the biases are live: zeroing them moves the logits
    params = thf.load_hf_checkpoint(out, tcfg, device="cpu")
    for k in ("bq", "bk", "bv"):
        params["layers"]["attn"][k].zero_()
    moved = build_model(tcfg, "cpu").forward(
        params, {"tokens": torch.from_numpy(tokens)}).numpy()
    assert np.abs(moved - want).max() > 1e-3


def test_serve_engine_generate_matches_jax(tmp_path):
    out = str(tmp_path / "ckpt")
    jfix.write_hf_fixture(out, seed=4, dtype="bfloat16")
    jcfg, tcfg = jhf.config_from_hf(out), thf.config_from_hf(out)
    aqua = dict(k_ratio=0.5, block_dims=8, prefill_q_blk=16)
    jcfg = dataclasses.replace(jcfg, aqua=JaxAquaConfig(**aqua))
    tcfg = dataclasses.replace(tcfg, aqua=AquaConfig(**aqua))
    att = tcfg.attention
    proj = np.linalg.qr(np.random.default_rng(2).standard_normal(
        (tcfg.num_layers, att.num_kv_heads, att.head_dim, att.head_dim))
    )[0].astype(np.float32)
    prompts = lcg_batch(tcfg.vocab_size, 24, 2, seed=0, step=0)["tokens"]
    jeng = JaxServeEngine(jcfg, jhf.load_hf_checkpoint(out, jcfg),
                          JaxProjections(p=jnp.asarray(proj)), max_seq=64,
                          backend="aqua-block-sparse")
    want = jeng.generate({"tokens": jnp.asarray(prompts)}, steps=8)
    eng = ServeEngine(tcfg, thf.load_hf_checkpoint(out, tcfg, device="cpu"),
                      AquaProjections(p=torch.from_numpy(proj)), max_seq=64,
                      backend="aqua-block-sparse", device="cpu")
    got = eng.generate({"tokens": prompts}, steps=8)
    assert got.tokens.shape == (2, 8)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits_last, np.asarray(want.logits_last),
                               rtol=1e-4, atol=1e-4)
    # JAX's contiguous cache also holds a float32 acc_score (L, B, KV, S)
    # under every policy; the port's only under H2O (a deliberate
    # difference, ROADMAP queue 3)
    assert jeng.cache_bytes(2) - eng.cache_bytes(2) == \
        4 * tcfg.num_layers * 2 * att.num_kv_heads * 64
    # temperature > 0 samples (from torch generators): tokens in range,
    # reproducible per engine seed
    hot = [ServeEngine(tcfg, eng.params, AquaProjections(
        p=torch.from_numpy(proj)), max_seq=64, backend="aqua-block-sparse",
        device="cpu").generate({"tokens": prompts}, steps=4,
                               temperature=1.0).tokens for _ in range(2)]
    assert np.array_equal(hot[0], hot[1])
    assert ((0 <= hot[0]) & (hot[0] < tcfg.vocab_size)).all()
