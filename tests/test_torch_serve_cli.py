"""The port's serving entry point, ``python -m repro_torch.launch.serve``,
against the JAX package's engine, at the JAX writer's tiny qwen3 geometry
(``QWEN3_TINY``: 2 layers, width 64) and the width of
tests/test_torch_chunked_engine.py (max_seq 96, 8-token pages, budget 16).

``main([... --device cpu --verify])`` serves an HF checkpoint (bf16
stored, written by the JAX writer) calibrated on
``corpora/calibration.txt`` and saves the projections; a JAX
``ContinuousBatchingEngine`` on JAX's load of the same files and those
projections (``aqua-block-sparse``, Pallas in interpret mode) must give the
same greedy tokens, on the contiguous cache, the paged pool, an int8 pool,
and hierarchical AQUA with chunked prefill on bf16 and int8 pools. The
launcher's own ``--verify`` (token identity with its reference engine,
the pool checks, the page-ranking oracle, the chunked gap check) passes
on every path. A paged drive sharing a prompt prefix (``--shared-prefix-len``,
prefix sharing on as in JAX) against the JAX launcher's prefix line and
the JAX engine's tokens. Plus ``--rectangular`` against JAX's
``ServeEngine``, the refusals of what the engine does not serve (meshes),
int8 pools under a window ring, under H2O and with hot residents (refused
until the engine served them) against the JAX engine's tokens, the
recurrent archs (``mamba2-370m``, ``recurrentgemma-9b``) with ``--verify``
against the JAX engine's tokens, the refusal without a card and of an arch
outside both registries, and ``ScheduleStats``' gap statistics against
JAX's.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import fixtures as jfix
from repro.checkpoint import hf as jhf
from repro.configs import reduced as jax_reduced
from repro.configs.base import AquaConfig as JaxAquaConfig
from repro.configs.base import CacheSpec as JaxCacheSpec
from repro.configs.base import QuantSpec as JaxQuantSpec
from repro.configs.base import ServingConfig as JaxServingConfig
from repro.configs.base import SparsitySpec as JaxSparsitySpec
from repro.core.calibration import AquaProjections as JaxProjections
from repro.core.calibration import load_projections as jax_load_projections
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro.serving.scheduler import ScheduleStats as JaxScheduleStats
from repro_torch.data.corpus import lcg_batch
from repro_torch.launch.serve import main
from repro_torch.serving.scheduler import ScheduleStats

CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "corpora", "calibration.txt")
AQUA = dict(k_ratio=0.5, block_dims=8, prefill_q_blk=16)
TRACE = dict(requests=5, lanes=4, prompt_lens=(20, 40, 60), steps=6,
             max_seq=96, mean_interarrival=2.0)
PAGED = ["--page-size", "8", "--no-prefix-share"]
PATHS = {
    "contiguous": [],
    "paged": PAGED,
    "int8": PAGED + ["--kv-dtype", "int8"],
    "hier-chunked": PAGED + ["--page-keep-ratio", "0.375",
                             "--prefill-budget", "16"],
    "hier-chunked-int8": PAGED + ["--kv-dtype", "int8",
                                  "--page-keep-ratio", "0.375",
                                  "--prefill-budget", "16"],
}
# the chunked paths: a trace whose first request decodes alone while the
# other 19 arrive (within 0.65 steps), so the monolithic reference stalls
# it behind 19 admissions in one gap (~65 ms on an idle host) where the
# chunked engine runs one chunk (~8 ms): the gap check's margin stays
# above what a host loaded by other test workers adds to a gap
BUNCHED = dict(TRACE, requests=20, lanes=20, mean_interarrival=0.03, seed=0)


def _argv(ckpt, proj_path, *extra, t=TRACE):
    return ["--device", "cpu", "--hf-checkpoint", ckpt,
            "--calibration-corpus", CORPUS, "--projections", proj_path,
            "--k-ratio", str(AQUA["k_ratio"]),
            "--block-dims", str(AQUA["block_dims"]),
            "--prefill-q-blk", str(AQUA["prefill_q_blk"]),
            "--backend", "aqua-block-sparse",
            "--requests", str(t["requests"]), "--lanes", str(t["lanes"]),
            "--prompt-lens", ",".join(map(str, t["prompt_lens"])),
            "--steps", str(t["steps"]), "--max-seq", str(t["max_seq"]),
            "--mean-interarrival", str(t["mean_interarrival"]),
            "--seed", str(t.get("seed", 0)), *extra]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hf") / "qwen3_tiny")
    jfix.write_hf_fixture(out, seed=1, variant="sharded", dtype="bfloat16")
    jcfg = jhf.config_from_hf(out)
    return out, jcfg, jhf.load_hf_checkpoint(out, jcfg)


@pytest.fixture
def one_thread():
    """One intra-op thread while a drive runs: the chunked ``--verify``
    compares wall-clock gaps, which thread oversubscription under several
    test workers would blur."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_serving(extra, t):
    page = "--page-size" in extra
    opt = {a: b for a, b in zip(extra, extra[1:]) if a.startswith("--")}
    return JaxServingConfig(
        max_lanes=t["lanes"], max_seq=t["max_seq"], max_new_tokens=t["steps"],
        prefill_budget_tokens=(int(opt["--prefill-budget"])
                               if "--prefill-budget" in opt else None),
        cache=JaxCacheSpec(page_size=8 if page else None,
                           prefix_sharing=False),
        quant=JaxQuantSpec(kv_dtype=opt.get("--kv-dtype", "bf16")),
        sparsity=JaxSparsitySpec(page_keep_ratio=float(
            opt.get("--page-keep-ratio", 1.0))))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cli_greedy_tokens_match_jax_engine(ckpt, tmp_path, capsys,
                                            one_thread, path):
    out, jcfg, jparams = ckpt
    proj_path = str(tmp_path / "proj.npz")
    extra = PATHS[path]
    t = BUNCHED if "--prefill-budget" in extra else TRACE
    run = main(_argv(out, proj_path, "--verify", *extra, t=t))
    printed = capsys.readouterr().out
    assert f"[serve] verify: all {t['requests']} requests token-identical" \
        in printed
    assert os.path.exists(proj_path)
    reqs = jax_poisson_trace(t["requests"],
                             mean_interarrival=t["mean_interarrival"],
                             prompt_lens=t["prompt_lens"],
                             max_new_tokens=t["steps"],
                             vocab_size=jcfg.vocab_size,
                             seed=t.get("seed", 0))
    jeng = JaxEngine(dataclasses.replace(jcfg, aqua=JaxAquaConfig(**AQUA)),
                     jparams, jax_load_projections(proj_path),
                     serving=_jax_serving(extra, t),
                     backend="aqua-block-sparse")
    want = jeng.run(reqs)
    assert sorted(run.streamed) == sorted(want)
    # the reference engine's first drive served the whole trace
    assert run.reference_stats.admissions == t["requests"]
    assert run.reference_stats.tokens_emitted == t["requests"] * t["steps"]
    for uid, o in want.items():
        assert run.streamed[uid] == list(o.tokens), uid
    plan = run.engine.dispatch_plan()
    jplan = jeng.dispatch_plan()
    assert (plan.chunked_prefill, plan.quantization, plan.token_sparsity) \
        == (jplan.chunked_prefill, jplan.quantization, jplan.token_sparsity)
    if "--prefill-budget" in extra:
        assert plan.chunked_prefill and plan.token_sparsity == "hierarchical"
        assert "page-ranking oracle agrees on all 2 layer caches" in printed
        assert "max inter-token gap" in printed
    if "--kv-dtype" in extra:
        assert "quantized pool (int8)" in printed
    if extra:
        assert run.engine.pool_geometry == (12 * t["lanes"], 12, 8)
        assert "[serve] pool bytes vs lane-stripe bytes" in printed


def test_cli_rectangular_matches_jax_serve_engine(ckpt, tmp_path, capsys):
    out, jcfg, jparams = ckpt
    proj_path = str(tmp_path / "proj.npz")
    run = main(_argv(out, proj_path, "--rectangular"))
    printed = capsys.readouterr().out
    assert "[serve] rectangular: generated (4, 6) tokens" in printed
    prompts = lcg_batch(jcfg.vocab_size, 20, 4, seed=0, step=0)["tokens"]
    jeng = JaxServeEngine(dataclasses.replace(jcfg,
                                              aqua=JaxAquaConfig(**AQUA)),
                          jparams, jax_load_projections(proj_path),
                          max_seq=TRACE["max_seq"],
                          backend="aqua-block-sparse")
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(prompts)},
                                    steps=TRACE["steps"]).tokens)
    assert run.stats is None
    assert [run.streamed[i] for i in range(4)] == want.tolist()


def test_cli_reuses_saved_projections(ckpt, tmp_path, capsys):
    out = ckpt[0]
    proj_path = str(tmp_path / "proj.npz")
    first = main(_argv(out, proj_path))
    assert "saved AQUA projections" in capsys.readouterr().out
    second = main(_argv(out, proj_path, "--itl-slo-ms", "5"))
    printed = capsys.readouterr().out
    assert "loaded AQUA projections" in printed
    assert (f"max {second.stats.max_itl * 1e3:.1f}ms, SLO>5ms miss rate "
            f"{second.stats.slo_miss_rate(0.005):.3f}") in printed
    assert second.streamed == first.streamed
    assert torch.equal(second.projections.p, first.projections.p)


def test_cli_registry_model_with_synthetic_calibration(capsys):
    """No checkpoint and no corpus: the reduced registry config, random
    params, and the synthetic LCG calibration language, with the
    launcher's defaults."""
    run = main(["--device", "cpu", "--reduced", "--block-dims", "8",
                "--verify"])
    printed = capsys.readouterr().out
    assert "(corpus: synthetic LCG)" in printed
    assert "[serve] verify: all 8 requests token-identical to the " \
           "single-device contiguous reference engine" in printed
    assert len(run.streamed) == 8
    assert all(len(t) == 16 for t in run.streamed.values())
    assert run.stats.tokens_emitted == 8 * 16


@pytest.mark.parametrize("extra,words", [
    (["--mesh", "2x2", "--verify"],
     "served the kernels on shard-local shapes of the mesh"),
    ([], "EXPECT-KERNEL FAILED: engine did not plan the kernel-native mesh "
         "path (backend='aqua-block-sparse' layout=contiguous); reasons: "
         "no serving mesh installed"),
])
def test_cli_refuses_what_the_engine_does_not_serve(ckpt, tmp_path, capsys,
                                                    extra, words):
    """What the launcher refused until meshes were ported. ``--mesh 2x2``
    serves: the launcher spawns four ranks (real processes, CPU), the plan
    is mesh-native with no kernel fallback and ``--verify`` holds every
    token to the single-device engine, whose tokens, on the projections
    the mesh drive calibrated, are the JAX engine's.
    ``--expect-kernel-mesh`` without a mesh fails with the JAX launcher's
    message."""
    import subprocess
    import sys
    out, jcfg, jparams = ckpt
    proj_path = str(tmp_path / "proj.npz")
    argv = _argv(out, proj_path, "--expect-kernel-mesh", *extra)
    if not extra:
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 1
        assert words in capsys.readouterr().out
        return
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *argv], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mesh 2x2 (data, model) over 4 ranks, collectives over gloo" \
        in proc.stdout
    assert words in proc.stdout
    assert (f"[serve] verify: all {TRACE['requests']} requests "
            "token-identical to the single-device contiguous reference "
            "engine") in proc.stdout
    run = main(_argv(out, proj_path))
    want = JaxEngine(dataclasses.replace(jcfg, aqua=JaxAquaConfig(**AQUA)),
                     jparams, jax_load_projections(proj_path),
                     serving=_jax_serving([], TRACE),
                     backend="aqua-block-sparse").run(jax_poisson_trace(
        TRACE["requests"], mean_interarrival=TRACE["mean_interarrival"],
        prompt_lens=TRACE["prompt_lens"], max_new_tokens=TRACE["steps"],
        vocab_size=jcfg.vocab_size, seed=0))
    for uid, o in want.items():
        assert run.streamed[uid] == list(o.tokens), uid


# what the launcher refused until the engine served it: int8 pools under
# Danube's window ring and under H2O, and hot residents
SERVED_SINCE = {
    "int8-ring": ["--arch", "h2o-danube-1.8b", "--page-size", "8",
                  "--kv-dtype", "int8"],
    "int8-hot": PAGED + ["--kv-dtype", "int8", "--hot-frac", "0.5"],
    "int8-h2o": PAGED + ["--kv-dtype", "int8", "--h2o-ratio", "0.5"],
}


@pytest.mark.parametrize("case", sorted(SERVED_SINCE))
def test_cli_serves_int8_pools_under_every_policy_like_jax(case, capsys):
    """The registry's reduced config with the launcher's random params and
    synthetic calibration; the JAX engine on the same params and
    projections (``aqua-block-sparse``, Pallas interpret) gives the same
    greedy tokens. ``--verify`` (token identity with the paged int8
    reference engine) where JAX's launcher passes it: with ``--hot-frac``
    0.5 the pool holds half its pages twice, so the 0.60 pool-bytes gate
    fails in both launchers."""
    extra = SERVED_SINCE[case]
    t = dict(TRACE, requests=5, lanes=3)
    argv = ["--device", "cpu", "--reduced", "--block-dims", "8",
            "--prefill-q-blk", "16", "--backend", "aqua-block-sparse",
            "--requests", str(t["requests"]), "--lanes", str(t["lanes"]),
            "--prompt-lens", ",".join(map(str, t["prompt_lens"])),
            "--steps", str(t["steps"]), "--max-seq", str(t["max_seq"]),
            *extra]
    run = main(argv + ([] if case == "int8-hot" else ["--verify"]))
    printed = capsys.readouterr().out
    assert "quantized pool (int8)" in printed
    if case != "int8-hot":
        assert f"[serve] verify: all {t['requests']} requests " \
               "token-identical to the single-device paged int8 " \
               "reference engine" in printed
    eng = run.engine
    assert eng.eviction == {"int8-ring": "ring", "int8-h2o": "h2o",
                            "int8-hot": "none"}[case]
    assert eng.hot_pages == (round(0.5 * eng.pool_geometry[0])
                             if case == "int8-hot" else 0)
    opt = {a: b for a, b in zip(extra, extra[1:]) if a.startswith("--")}
    arch = opt.get("--arch", "qwen3-0.6b")
    jcfg = dataclasses.replace(
        jax_reduced(arch), aqua=JaxAquaConfig(
            k_ratio=0.75, block_dims=8, prefill_q_blk=16,
            h2o_ratio=float(opt.get("--h2o-ratio", 1.0))))
    jparams = jax.tree.map(jnp.asarray, {
        k: jax.tree.map(lambda x: x.numpy(), v)
        for k, v in eng.params.items() if k != "unembed_f32"})
    jeng = JaxEngine(jcfg, jparams, JaxProjections(
        p=jnp.asarray(run.projections.p.numpy())),
        serving=JaxServingConfig(
            max_lanes=t["lanes"], max_seq=t["max_seq"],
            max_new_tokens=t["steps"],
            cache=JaxCacheSpec(page_size=8, prefix_sharing=(
                "--no-prefix-share" not in extra)),
            quant=JaxQuantSpec(kv_dtype="int8", hot_resident_fraction=float(
                opt.get("--hot-frac", 0.0)))),
        backend="aqua-block-sparse")
    want = jeng.run(jax_poisson_trace(
        t["requests"], mean_interarrival=t["mean_interarrival"],
        prompt_lens=t["prompt_lens"], max_new_tokens=t["steps"],
        vocab_size=jcfg.vocab_size, seed=0))
    assert {u: list(o.tokens) for u, o in want.items()} == run.streamed


# the frontend families: a reduced VLM on the paged pool (prefix sharing
# on by default, off for a frontend model, as in JAX) and the reduced
# encoder-decoder on the contiguous cache
FRONTENDS = {"pixtral-12b": ["--page-size", "8"], "whisper-tiny": []}


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_cli_serves_the_frontend_archs_like_jax(arch, capsys):
    """The launcher gives every request the stub frontend inputs (the same
    for all, as JAX's launcher does) and calibrates on batches that carry
    them; ``--verify`` (token identity with the contiguous reference
    engine) passes, and the JAX engine on the same params, projections
    and frontend inputs (``aqua-block-sparse``, Pallas interpret) gives
    the same greedy tokens. ``--rectangular`` serves a frontend batch."""
    extra = FRONTENDS[arch]
    t = dict(TRACE, requests=4, lanes=3)
    argv = ["--device", "cpu", "--arch", arch, "--reduced", "--block-dims",
            "8", "--prefill-q-blk", "16", "--backend", "aqua-block-sparse",
            "--requests", str(t["requests"]), "--lanes", str(t["lanes"]),
            "--prompt-lens", ",".join(map(str, t["prompt_lens"])),
            "--steps", str(t["steps"]), "--max-seq", str(t["max_seq"]),
            *extra]
    run = main(argv + ["--verify"])
    printed = capsys.readouterr().out
    assert f"[serve] verify: all {t['requests']} requests token-identical " \
           "to the single-device contiguous reference engine" in printed
    key = "patches" if arch == "pixtral-12b" else "frames"
    assert all(set(r.extra_inputs) == {key} for r in run.requests)
    eng = run.engine
    assert eng.paged == bool(extra) and not eng.dispatch_plan().prefix_sharing
    jcfg = dataclasses.replace(jax_reduced(arch), aqua=JaxAquaConfig(
        k_ratio=0.75, block_dims=8, prefill_q_blk=16))
    jparams = jax.tree.map(jnp.asarray, {
        k: jax.tree.map(lambda x: x.numpy(), v)
        for k, v in eng.params.items() if k != "unembed_f32"})
    jeng = JaxEngine(jcfg, jparams, JaxProjections(
        p=jnp.asarray(run.projections.p.numpy())),
        serving=JaxServingConfig(
            max_lanes=t["lanes"], max_seq=t["max_seq"],
            max_new_tokens=t["steps"],
            cache=JaxCacheSpec(page_size=8 if extra else None)),
        backend="aqua-block-sparse")
    reqs = jax_poisson_trace(
        t["requests"], mean_interarrival=t["mean_interarrival"],
        prompt_lens=t["prompt_lens"], max_new_tokens=t["steps"],
        vocab_size=jcfg.vocab_size, seed=0)
    for r, mine in zip(reqs, run.requests):
        r.extra_inputs = mine.extra_inputs
    want = jeng.run(reqs)
    assert {u: list(o.tokens) for u, o in want.items()} == run.streamed
    rect = main(argv + ["--rectangular"])
    assert len(rect.streamed) == t["lanes"]


def test_cli_full_pixtral_calibration_window_raises_as_jax():
    """JAX's launcher calibrates on 32-token windows, which cannot take
    the full Pixtral's 256 patch embeddings: its splice raises
    ``ValueError``. The port's launcher raises there too, before it
    makes the 12B weights (a reference limitation, ROADMAP queue 3)."""
    with pytest.raises(ValueError, match="256 patch embeddings"):
        main(["--device", "cpu", "--arch", "pixtral-12b"])


def test_cli_shares_prompt_prefixes_like_the_jax_launcher(
        ckpt, tmp_path, capsys, monkeypatch):
    """A paged drive without ``--no-prefix-share`` (prefix sharing on, as
    in JAX) at the launcher's default ``--block-dims`` 1, every prompt
    behind one 16-token prefix: ``--verify`` passes (tokens equal to the
    contiguous reference, and the prefix gate: a shared prefix was
    offered and admissions reused it); the launcher's prefix line equals
    the JAX launcher's on the same checkpoint and projections, and its
    greedy tokens equal the JAX engine's."""
    import sys
    from repro.launch import serve as jax_launcher
    out, jcfg, jparams = ckpt
    proj_path = str(tmp_path / "proj.npz")
    flags = ["--hf-checkpoint", out, "--calibration-corpus", CORPUS,
             "--projections", proj_path, "--k-ratio", "0.5",
             "--page-size", "8", "--shared-prefix-len", "16",
             "--requests", str(TRACE["requests"]),
             "--lanes", str(TRACE["lanes"]),
             "--prompt-lens", ",".join(map(str, TRACE["prompt_lens"])),
             "--steps", str(TRACE["steps"]),
             "--max-seq", str(TRACE["max_seq"])]
    run = main(["--device", "cpu", "--verify", *flags])
    printed = capsys.readouterr().out
    assert "[serve] verify: all 5 requests token-identical to the " \
           "single-device contiguous reference engine" in printed
    line = next(ln for ln in printed.splitlines()
                if ln.startswith("[serve] prefix sharing:"))
    pool = run.engine.page_pool
    assert pool.prefix_hits == 4 and pool.tokens_saved == 4 * 16
    assert run.engine.dispatch_plan().prefix_sharing
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jax_launcher.main()                       # loads the saved projections
    jprinted = capsys.readouterr().out
    assert "loaded AQUA projections" in jprinted
    assert line in jprinted.splitlines()
    reqs = jax_poisson_trace(TRACE["requests"],
                             mean_interarrival=TRACE["mean_interarrival"],
                             prompt_lens=TRACE["prompt_lens"],
                             max_new_tokens=TRACE["steps"],
                             vocab_size=jcfg.vocab_size, seed=0)
    pre = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(16,),
                                            dtype=np.int32)
    for r in reqs:
        r.tokens = np.concatenate([pre, np.asarray(r.tokens, np.int32)])
    jeng = JaxEngine(dataclasses.replace(jcfg, aqua=JaxAquaConfig(
        k_ratio=0.5)), jparams, jax_load_projections(proj_path),
        serving=JaxServingConfig(max_lanes=TRACE["lanes"],
                                 max_seq=TRACE["max_seq"],
                                 max_new_tokens=TRACE["steps"],
                                 cache=JaxCacheSpec(page_size=8)))
    want = jeng.run(reqs)
    assert {u: list(o.tokens) for u, o in want.items()} == run.streamed
    assert jeng.page_pool.prefix_hits == pool.prefix_hits


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as ei:
        main(["--reduced"])
    assert ei.value.code not in (None, 0)
    assert "--device cpu" in str(ei.value.code)


def test_cli_rejects_an_arch_outside_the_registry(capsys):
    """A name in neither package's registry is refused by argparse, which
    lists the port's archs (every family of JAX's registry since the
    recurrent ones were ported)."""
    from repro.configs import ALL_ARCHS as JAX_ARCHS
    from repro_torch.configs import ALL_ARCHS
    outsider = "mamba-7b"
    assert outsider not in ALL_ARCHS and outsider not in JAX_ARCHS
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)
    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", "--arch", outsider])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    for name in ("qwen3-0.6b", "llama3.1-8b", "h2o-danube-1.8b",
                 "mamba2-370m", "recurrentgemma-9b"):
        assert name in err


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_cli_serves_the_recurrent_archs_like_jax(arch, capsys):
    """``--arch mamba2-370m`` (no AQUA: nothing to calibrate) and
    ``--arch recurrentgemma-9b`` (identity projections over its attention
    layers, none at the reduced depth of 2, no calibration), reduced, on
    the CPU with ``--verify``; the JAX engine on the same params and
    projections gives the same greedy tokens over prompts past the
    hybrid's reduced window of 16."""
    t = dict(TRACE, requests=4, lanes=3)
    argv = ["--device", "cpu", "--arch", arch, "--reduced",
            "--requests", str(t["requests"]), "--lanes", str(t["lanes"]),
            "--prompt-lens", ",".join(map(str, t["prompt_lens"])),
            "--steps", str(t["steps"]), "--max-seq", str(t["max_seq"])]
    run = main(argv + ["--verify"])
    printed = capsys.readouterr().out
    assert f"[serve] verify: all {t['requests']} requests token-identical " \
           "to the single-device contiguous reference engine" in printed
    # JAX's launcher announces the calibration for the hybrid, then takes
    # identity projections; it has nothing to calibrate for Mamba-2
    assert ("AQUA calibration" in printed) == (arch != "mamba2-370m")
    eng = run.engine
    assert not eng.paged and not eng._supports_ragged
    jcfg = jax_reduced(arch)
    if arch == "mamba2-370m":
        assert run.projections is None and eng.cfg.aqua is None
        jproj = None
    else:
        p = run.projections.p
        assert p.shape[0] == eng.model.num_attn_layers == 0
        jcfg = dataclasses.replace(jcfg, aqua=JaxAquaConfig(
            k_ratio=0.75, block_dims=1))
        jproj = JaxProjections(p=jnp.asarray(p.numpy()))

    def leaves(v):
        if isinstance(v, dict):
            return {k: leaves(x) for k, x in v.items()}
        if isinstance(v, list):
            return [leaves(x) for x in v]
        return jnp.asarray(v.numpy())
    jparams = {k: leaves(v) for k, v in eng.params.items()
               if k != "unembed_f32"}
    jeng = JaxEngine(jcfg, jparams, jproj, serving=JaxServingConfig(
        max_lanes=t["lanes"], max_seq=t["max_seq"],
        max_new_tokens=t["steps"]))
    reqs = jax_poisson_trace(
        t["requests"], mean_interarrival=t["mean_interarrival"],
        prompt_lens=t["prompt_lens"], max_new_tokens=t["steps"],
        vocab_size=jcfg.vocab_size, seed=0)
    want = jeng.run(reqs)
    assert {u: list(o.tokens) for u, o in want.items()} == run.streamed


@pytest.mark.parametrize("gaps", [[], [0.01], [0.003, 0.02, 0.011, 0.2],
                                  list(np.random.default_rng(0).exponential(
                                      0.01, 257))])
def test_schedule_stats_gap_statistics_match_jax(gaps):
    mine, theirs = ScheduleStats(itl_gaps=list(gaps)), JaxScheduleStats(
        itl_gaps=list(gaps))
    assert mine.max_itl == theirs.max_itl
    for thr in (0.0, 0.005, 0.011, 1.0):
        assert mine.slo_miss_rate(thr) == theirs.slo_miss_rate(thr)
    for pct in (50, 99):
        assert mine.itl_percentile(pct) == theirs.itl_percentile(pct)
