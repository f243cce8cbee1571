"""Serving entry point of the port: calibrate once, then serve a mixed trace.

The counterpart of the JAX package's ``launch/serve.py``, with the same
flags and defaults plus ``--device``. Drives the continuous-batching
engine over a Poisson arrival trace (exponential inter-arrival times in
decode-step units, mixed prompt lengths) and reports throughput, lane
occupancy and inter-token gaps; ``--rectangular`` runs the fixed-batch
``ServeEngine`` instead. ``--hf-checkpoint`` serves real weights
(``checkpoint/hf.py``: float32 params and activations, as in JAX).
A config with a modality frontend (``pixtral-12b``, ``whisper-tiny``)
gives every request, the ``--rectangular`` batch and each calibration
batch the stub frontend inputs (``data.corpus.add_frontend_inputs``), as
JAX's launcher does; a VLM's calibration windows (32 tokens) must hold its
patches, so the full ``pixtral-12b`` raises ``ValueError`` there, as in
JAX (before its weights are made). ``mamba2-370m`` (no attention) serves
without AQUA, and ``recurrentgemma-9b`` with identity projections over its
attention layers and no calibration, as JAX's launcher does; both admit at
the prompt's exact length on the contiguous cache. ``--verify`` re-serves the trace on a
reference engine and requires
token-identical outputs, plus the JAX launcher's pool-bytes, int8-pool,
page-ranking, prefix-sharing and chunked-gap checks; a failed check
prints ``[serve] VERIFY FAILED: ...`` and raises ``SystemExit(1)``.
Paged drives share page-aligned prompt prefixes unless
``--no-prefix-share`` (``--shared-prefix-len`` gives every prompt one).

Runs on the CUDA card (``--device cuda``, the default; exits non-zero
without one) or, when asked, on the CPU (``--device cpu``: the kernels'
plain versions). What the engine does not serve yet is refused with its
own message.

``--mesh DxM`` (or ``PxDxM``) serves on a data x model mesh, one rank
per position, as the JAX launcher's ``--mesh`` does on a device mesh:
outside ``torchrun`` the launcher builds the kernels once (on the card)
and spawns the ranks itself (``launch.mesh.spawn_ranks``); each rank runs
this same drive, rank 0 prints, and a failed rank fails the run. Each
rank makes or loads the whole weights on the host (random weights from
the CPU generator), calibrates there, and copies only its blocks to its
device (``bridge.params_from_numpy(mesh=)``). The
serve line names the collective backend (chosen from the topology before
anything runs: gloo where ranks share a card) and whether the decode step
is a CUDA graph (not with a ``model`` axis > 1: its collectives run
eagerly). ``--expect-kernel-mesh`` fails unless the plan serves the
attention kernels on shard-local shapes; with ``--verify`` on a mesh the
greedy reference is the single-device engine (the paged one where prefix
sharing engages on the kernel path), at temperature > 0 each request
alone on a same-mesh engine, and a mesh-native plan must record no
kernel fallback.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --device cpu --block-dims 8 --requests 8 --lanes 4

    PYTHONPATH=src python -m repro_torch.launch.serve --hf-checkpoint DIR \\
        --calibration-corpus corpora/calibration.txt --block-dims 8 \\
        --page-size 64 --max-seq 2048 --verify

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --mesh 2x2 --backend aqua-block-sparse --block-dims 8 \\
        --verify --expect-kernel-mesh

``main(argv)`` returns a :class:`ServeRun` (the engine, the streamed
tokens and the stats), so scripts and tests can call it in-process.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.configs.base import (AquaConfig, CacheSpec, ModelConfig,
                                      QuantSpec, ServingConfig, SparsitySpec)
from repro_torch.core.calibration import (AquaProjections, calibrate,
                                          capture_forward,
                                          identity_projections,
                                          load_projections, save_projections)
from repro_torch.data.corpus import (add_frontend_inputs, calibration_batches,
                                     lcg_batch, request_frontend_inputs)
from repro_torch.launch.mesh import (make_serving_mesh, parse_mesh_spec,
                                     spawn_ranks)
from repro_torch.models import build_model
from repro_torch.models.base import PagingSpec
from repro_torch.models.transformer import check_splice
from repro_torch.models.layers import with_unembedding
from repro_torch.runtime import resolve_device
from repro_torch.serving import (ContinuousBatchingEngine, ServeEngine,
                                 poisson_trace)
from repro_torch.serving.engine import decode_state_bytes
from repro_torch.serving.scheduler import Request, ScheduleStats

#: calibration forwards (batches of 2 x 32 tokens) when none are loaded
CALIBRATION_BATCHES = 2
CALIBRATION_SEQ = 32


@dataclasses.dataclass
class ServeRun:
    """What one launcher run served. ``streamed`` maps a request uid (for
    ``--rectangular``: a batch row) to its tokens; ``stats`` is None for
    ``--rectangular``; ``requests`` is the trace served (empty for
    ``--rectangular``); ``projections`` the calibrated or loaded AQUA
    projections (None with AQUA off); ``seconds`` the drive's wall time,
    ``load_seconds`` the checkpoint's (None without one);
    ``reference_stats`` the greedy ``--verify`` reference engine's stats
    after its first drive (None otherwise)."""

    engine: object
    streamed: Dict[int, List[int]]
    stats: Optional[ScheduleStats]
    requests: List[Request]
    projections: Optional[AquaProjections]
    seconds: float
    load_seconds: Optional[float] = None
    reference_stats: Optional[ScheduleStats] = None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ALL_ARCHS,
                    help="the port's registry config")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="serve on the CUDA card (default; exits non-zero "
                         "without one) or on the CPU (the kernels' plain "
                         "versions)")
    ap.add_argument("--hf-checkpoint", default=None,
                    help="serve real weights: path to an HF-format "
                         "safetensors checkpoint dir (config.json + "
                         "model.safetensors[.index.json]); overrides "
                         "--arch/--reduced — the architecture is read "
                         "from config.json (see checkpoint.hf)")
    ap.add_argument("--calibration-corpus", default=None,
                    help="tokenized corpus file for the offline SVD "
                         "calibration (.npy/.npz ids or .txt byte-level); "
                         "default is the synthetic LCG language")
    ap.add_argument("--projections", default=None,
                    help="AquaProjections .npz artifact path: load it if "
                         "it exists, else calibrate and save there "
                         "(the JAX package's format)")
    ap.add_argument("--k-ratio", type=float, default=0.75)
    ap.add_argument("--s-ratio", type=float, default=0.0)
    ap.add_argument("--h2o-ratio", type=float, default=1.0)
    ap.add_argument("--block-dims", type=int, default=1)
    ap.add_argument("--prefill-q-blk", type=int, default=None,
                    help="block-sparse prefill kernel q-chunk tile (one "
                         "dim-block selection per tile); a chunked-prefill "
                         "budget must be a multiple of it")
    ap.add_argument("--no-aqua", action="store_true")
    ap.add_argument("--backend", default=None,
                    help="attention backend override (see core.attention)")
    # trace shape
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--mean-interarrival", type=float, default=2.0,
                    help="Poisson trace: mean inter-arrival (decode steps)")
    ap.add_argument("--prompt-lens", default="8,16,24",
                    help="comma-separated mixed prompt lengths")
    ap.add_argument("--steps", type=int, default=16,
                    help="max new tokens per request")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rectangular", action="store_true",
                    help="fixed-batch ServeEngine drive (comparison)")
    # block-paged KV cache
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV-cache page: a global page pool + "
                         "per-lane page tables (None = contiguous)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="page-pool size; default = lane-stripe parity "
                         "(lanes * slots / page_size)")
    ap.add_argument("--no-prefix-share", action="store_true",
                    help="disable prompt prefix page sharing")
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"),
                    help="paged K̂/V pool storage dtype: 'int8' stores "
                         "per-page symmetric-quantized pools with f32 "
                         "scales (requires --page-size)")
    ap.add_argument("--scale-granularity", default="page_head",
                    choices=("page_head", "page"),
                    help="int8 scale granularity: one scale per "
                         "(page, kv head) or one per page")
    ap.add_argument("--hot-frac", type=float, default=0.0,
                    help="fraction of the pool kept as full-precision hot "
                         "residents (H2O score policy; mixed precision "
                         "serves on the reference path, not the kernel)")
    # hierarchical (two-stage) token sparsity
    ap.add_argument("--page-keep-ratio", type=float, default=1.0,
                    help="hierarchical AQUA: fraction of each lane's pages "
                         "participating in decode attention (requires "
                         "--page-size; 1.0 = every page)")
    ap.add_argument("--pin-recent-pages", type=int, default=2,
                    help="hierarchical: trailing pages per lane always "
                         "participating")
    # chunked-prefill/decode interleaving
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="interleave admissions with decode: at most this "
                         "many prefill tokens run between consecutive "
                         "decode steps (None = monolithic admission)")
    ap.add_argument("--itl-slo-ms", type=float, default=None,
                    help="report the fraction of inter-token gaps above "
                         "this wall-clock threshold (SLO miss rate)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend a fixed random prefix of this length to "
                         "every trace prompt (what prefix sharing shares)")
    ap.add_argument("--mesh", default="",
                    help="serving mesh 'DATAxMODEL' (e.g. 2x2) or "
                         "'PODxDATAxMODEL', one rank per position "
                         "(spawned unless under torchrun); empty/1x1 = "
                         "single device")
    ap.add_argument("--verify", action="store_true",
                    help="re-serve the trace on a reference engine and "
                         "require token-identical outputs (exits 1 on "
                         "mismatch)")
    ap.add_argument("--expect-kernel-mesh", action="store_true",
                    help="require the mesh kernel path: fail unless the "
                         "engine plans the attention kernels on shard-local "
                         "shapes of the mesh")
    return ap


def _fail(msg: str):
    print(f"[serve] VERIFY FAILED: {msg}", flush=True)
    raise SystemExit(1)


def _refused(err: NotImplementedError):
    raise SystemExit(f"[serve] refused: {err}")


def _rank_main(argv) -> None:
    """One spawned rank of a ``--mesh`` drive (``spawn_ranks``)."""
    main(argv)


def main(argv=None) -> Optional[ServeRun]:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e} (--device cpu)") from None
    mesh_spec = parse_mesh_spec(args.mesh)
    if mesh_spec is not None and args.rectangular:
        raise SystemExit("[serve] --rectangular serves one device; drop "
                         "--mesh")
    if mesh_spec is not None and "RANK" not in os.environ:
        # not under torchrun: build the kernels once, here, then start one
        # rank per mesh position (each re-enters main under its RANK)
        n = math.prod(mesh_spec[0])
        if dev.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all()
        print(f"[serve] spawning {n} ranks for mesh {args.mesh}", flush=True)
        try:
            spawn_ranks(n, _rank_main, (argv,))
        except Exception as e:        # a rank failed: the run fails
            raise SystemExit(f"[serve] a mesh rank failed: {e}") from None
        return None
    mesh = None
    if mesh_spec is not None:
        mesh = make_serving_mesh(*mesh_spec, device=dev)
        dev = mesh.device
        print(f"[serve] {mesh.describe()}", flush=True)
    rank0 = mesh is None or mesh.rank == 0

    if args.hf_checkpoint is not None:
        from repro_torch.checkpoint.hf import (config_from_hf,
                                               load_hf_checkpoint)
        cfg = config_from_hf(args.hf_checkpoint)
        print(f"[serve] HF checkpoint {args.hf_checkpoint}: "
              f"{cfg.name} ({cfg.num_layers}L d{cfg.d_model})")
    else:
        cfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    aqua = None
    if not args.no_aqua and cfg.attention is not None:
        aqua = AquaConfig(k_ratio=args.k_ratio, s_ratio=args.s_ratio,
                          h2o_ratio=args.h2o_ratio,
                          block_dims=args.block_dims)
        if args.prefill_q_blk is not None:
            aqua = dataclasses.replace(aqua,
                                       prefill_q_blk=args.prefill_q_blk)
    cfg = dataclasses.replace(cfg, aqua=aqua)
    if (aqua is not None and cfg.frontend.kind == "vision_patches"
            and not (args.projections is not None
                     and os.path.exists(args.projections))):
        # the calibration windows splice the patches as JAX's do, and raise
        # where JAX's raise: checked before the weights are made
        check_splice(CALIBRATION_SEQ, cfg.frontend.num_embeds)

    # on a mesh the whole weights stay on the host: each rank copies only
    # its blocks to its device (below), and calibrates on the host
    wdev = dev if mesh is None else torch.device("cpu")
    model = build_model(cfg, wdev)
    load_s = None
    if args.hf_checkpoint is not None:
        t0 = time.time()
        params = load_hf_checkpoint(args.hf_checkpoint, cfg, device=wdev)
        if wdev.type == "cuda":
            torch.cuda.synchronize(wdev)
        load_s = time.time() - t0
        print(f"[serve] loaded {cfg.param_dtype} params onto {wdev} in "
              f"{load_s:.2f}s")
    else:
        params = model.init(torch.Generator(device=wdev).manual_seed(0))
    if mesh is None:
        # the float32 unembedding, made once for every engine below
        params = with_unembedding(params, model.tied_unembedding)

    proj = None
    if aqua is not None and args.projections is not None \
            and os.path.exists(args.projections):
        proj = load_projections(args.projections, dev)
        print(f"[serve] loaded AQUA projections from {args.projections}")
    elif aqua is not None:
        src = args.calibration_corpus or "synthetic LCG"
        print(f"[serve] offline AQUA calibration for {cfg.name} "
              f"(corpus: {src}) ...")

        if cfg.family == "hybrid":
            # as JAX's launcher: identity projections over the attention
            # layers, no calibration forwards
            proj = identity_projections(model.num_attn_layers,
                                        cfg.attention.num_kv_heads,
                                        cfg.attention.head_dim, device=dev)
        else:
            proj = calibrate(capture_forward(model), params,
                             calibration_batches(
                                 cfg.vocab_size, args.calibration_corpus,
                                 num_batches=CALIBRATION_BATCHES, batch=2,
                                 seq=CALIBRATION_SEQ, model_cfg=cfg),
                             cfg, device=dev)
        if args.projections is not None and rank0:
            save_projections(args.projections, proj)
            print(f"[serve] saved AQUA projections to {args.projections}")

    if mesh is not None and proj is not None:
        # every rank calibrated alike; rank 0's projections, bit for bit
        from repro_torch.distributed.collectives import from_rank0
        proj = AquaProjections(p=from_rank0(proj.p, mesh))
    host_params = None
    if mesh is not None:
        # this rank's blocks, cut on the host (the engine refuses whole
        # tensors on a mesh); rank 0's --verify reference places the whole
        host_params, params = params, params_from_numpy(params, dev,
                                                        mesh=mesh)

    if args.rectangular:
        return dataclasses.replace(
            _drive_rectangular(cfg, params, proj, args, dev),
            load_seconds=load_s)

    scfg = ServingConfig(max_lanes=args.lanes, max_seq=args.max_seq,
                         max_new_tokens=args.steps,
                         temperature=args.temperature,
                         prefill_budget_tokens=args.prefill_budget,
                         cache=CacheSpec(
                             page_size=args.page_size,
                             num_pages=args.pool_pages,
                             prefix_sharing=not args.no_prefix_share),
                         quant=QuantSpec(
                             kv_dtype=args.kv_dtype,
                             scale_granularity=args.scale_granularity,
                             hot_resident_fraction=args.hot_frac),
                         sparsity=SparsitySpec(
                             page_keep_ratio=args.page_keep_ratio,
                             pin_recent_pages=args.pin_recent_pages),
                         mesh_shape=None if mesh is None else mesh.dims,
                         mesh_axes=("data", "model") if mesh is None
                         else mesh.axes)
    try:
        eng = ContinuousBatchingEngine(cfg, params, proj, serving=scfg,
                                       backend=args.backend, device=dev,
                                       mesh=mesh)
    except NotImplementedError as e:
        _refused(e)
    plan = eng.dispatch_plan()
    if args.expect_kernel_mesh and not plan.mesh_native:
        # the caller declares the kernel path required for this geometry:
        # a plan that serves the reference fails loudly, as in JAX
        print("[serve] EXPECT-KERNEL FAILED: engine did not plan the "
              "kernel-native mesh path "
              f"(backend={plan.backend!r} layout={plan.cache_layout}); "
              f"reasons: {'; '.join(plan.reasons)}", flush=True)
        raise SystemExit(1)
    if mesh is not None:
        print(f"[serve] mesh plan: backend {plan.backend!r}, "
              f"{plan.cache_layout}, mesh-native {plan.mesh_native}; "
              f"this rank holds {eng.rank_cache_bytes():,} KV-cache bytes; "
              "decode step "
              + ("a CUDA graph" if eng.uses_graphs else
                 "eager (no CUDA graph: collectives inside the step)"
                 if dev.type == "cuda" else "eager (CPU)"), flush=True)
    if args.prefill_budget is not None and not plan.chunked_prefill:
        print("[serve] chunked prefill OFF (monolithic admission): "
              f"{'; '.join(plan.chunked_reasons)}")
        if args.verify:
            _fail("--prefill-budget requested but the engine planned "
                  "monolithic admission")
    if args.page_keep_ratio < 1.0 and plan.token_sparsity != "hierarchical":
        print("[serve] hierarchical token sparsity OFF (all pages "
              f"participate): {'; '.join(plan.token_reasons)}")
        if args.verify:
            _fail("--page-keep-ratio requested but the engine planned full "
                  "page participation")
    prompt_lens = tuple(int(x) for x in args.prompt_lens.split(","))
    reqs = poisson_trace(args.requests,
                         mean_interarrival=args.mean_interarrival,
                         prompt_lens=prompt_lens, max_new_tokens=args.steps,
                         vocab_size=cfg.vocab_size, seed=args.seed,
                         temperature=args.temperature)
    if args.shared_prefix_len > 0:
        pre = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, size=(args.shared_prefix_len,),
            dtype=np.int32)
        for r in reqs:
            r.tokens = np.concatenate([pre, np.asarray(r.tokens, np.int32)])
    # every request carries the same stub frontend inputs, as in JAX
    extra = request_frontend_inputs(cfg)
    for r in reqs:
        r.extra_inputs = extra

    t0 = time.time()
    finished = 0
    streamed: Dict[int, List[int]] = {}
    for ev in eng.serve(reqs):
        streamed.setdefault(ev.uid, []).append(ev.token)
        if ev.finished:
            finished += 1
            print(f"[serve] request {ev.uid} done: {ev.index + 1} tokens "
                  f"({ev.finish_reason})")
    dt = time.time() - t0
    st = eng.stats
    print(f"[serve] {finished}/{len(reqs)} requests, "
          f"{st.tokens_emitted} tokens in {dt:.2f}s "
          f"({st.tokens_emitted / dt:.1f} tok/s), "
          f"{st.decode_steps} decode steps, "
          f"mean lane occupancy {st.mean_occupancy:.2f}/{args.lanes}")
    if st.itl_gaps:
        line = (f"[serve] inter-token latency: p50 "
                f"{st.itl_percentile(50) * 1e3:.1f}ms, p99 "
                f"{st.itl_percentile(99) * 1e3:.1f}ms, max "
                f"{st.max_itl * 1e3:.1f}ms")
        if args.itl_slo_ms is not None:
            line += (f", SLO>{args.itl_slo_ms:g}ms miss rate "
                     f"{st.slo_miss_rate(args.itl_slo_ms / 1e3):.3f}")
        print(line)
    if args.prefill_budget is not None and plan.chunked_prefill:
        print(f"[serve] chunked prefill: {st.chunked_admissions} admissions "
              f"interleaved over {st.prefill_chunks} chunk steps "
              f"(budget {args.prefill_budget} tokens/step)")
    print(f"[serve] KV cache bytes @ {args.lanes} lanes: "
          f"{eng.cache_bytes():,}")
    if eng.paged:
        _report_pool(eng, cfg, args, dev)
    if (args.verify or args.expect_kernel_mesh) and mesh is not None \
            and plan.mesh_native:
        # the plan said kernels: any fallback event means the reference
        # core served some call instead
        events = eng.mesh_fallback_events()
        if events:
            _fail(f"backend {plan.backend!r} should serve the kernels on "
                  f"the mesh but fell back: {events}")
        print(f"[serve] verify: backend {plan.backend!r} served the kernels "
              "on shard-local shapes of the mesh (no kernel fallback)")
    ref_stats = None
    if args.verify:
        ref_stats = _verify_tokens(eng, cfg, params, proj, scfg, plan, reqs,
                                   streamed, args, dev, host_params)
    return ServeRun(engine=eng, streamed=streamed, stats=st, requests=reqs,
                    projections=proj, seconds=dt, load_seconds=load_s,
                    reference_stats=ref_stats)


def _report_pool(eng, cfg: ModelConfig, args, dev) -> None:
    """The paged pool's lines, and with ``--verify`` the pool-bytes check,
    the page-ranking oracle (hierarchical) and the int8 pool's < 0.60
    gate."""
    pool = eng.page_pool
    num_pages, per_lane, ps = eng.pool_geometry
    stripe_bytes = decode_state_bytes(build_model(cfg, dev), args.lanes,
                                      args.max_seq)
    ratio = eng.cache_bytes() / stripe_bytes
    print(f"[serve] page pool: {num_pages} pages x {ps} tokens "
          f"(lane-stripe parity {per_lane * args.lanes}), "
          f"peak {pool.peak_in_use} in use, "
          f"mean utilization {pool.mean_utilization:.2f}")
    print(f"[serve] prefix sharing: {pool.prefix_hits} admissions reused a "
          f"shared prefix, {pool.tokens_saved} prefill tokens saved")
    print(f"[serve] pool bytes vs lane-stripe bytes: "
          f"{eng.cache_bytes():,} / {stripe_bytes:,} = {ratio:.2f}x")
    if args.verify and num_pages < per_lane * args.lanes \
            and eng.cache_bytes() >= stripe_bytes:
        _fail("paged pool is smaller than lane-stripe parity but does not "
              "report fewer cache bytes")
    if (args.verify and args.shared_prefix_len > 0
            and not args.no_prefix_share and args.requests >= 2
            and pool.prefix_hits < 1):
        _fail(f"every prompt carries the same {args.shared_prefix_len}-token "
              "prefix but no admission reused shared prefix pages")
    if eng.kept_pages is not None:
        kp = eng.kept_pages
        print(f"[serve] hierarchical: {kp}/{per_lane} pages per lane "
              f"participate in decode (keep ratio "
              f"{args.page_keep_ratio:g}, {args.pin_recent_pages} "
              "recent pinned)")
        # the page-ranking oracle against the stage-1 selection on the
        # terminal engine state: the table the kernels read is the one the
        # reference ranking math produces
        if args.verify:
            from repro_torch.core import selection
            layers = eng.last_state.layers
            n = layers.page_table.shape[0]
            bad = 0
            for li in range(n):
                c = layers.layer(li)
                got = selection.participating_pages(
                    c.acc_pool, c.page_table, c.count, page_size=ps,
                    kept_pages=kp,
                    pin_recent_pages=args.pin_recent_pages).cpu().numpy()
                want = selection.reference_participating_pages(
                    c.acc_pool.cpu(), c.page_table.cpu(), c.count.cpu(),
                    page_size=ps, kept_pages=kp,
                    pin_recent_pages=args.pin_recent_pages)
                bad += int(not np.array_equal(got, want))
            if bad:
                _fail(f"page ranking diverges from the numpy oracle on "
                      f"{bad}/{n} layer caches")
            print(f"[serve] verify: page-ranking oracle agrees on all {n} "
                  "layer caches")
    if eng.scfg.quant_spec.quantized:
        fp_model = build_model(cfg, dev)
        fp_model.enable_paging(PagingSpec(ps, num_pages))
        fp_bytes = decode_state_bytes(fp_model, args.lanes, args.max_seq)
        qratio = eng.cache_bytes() / fp_bytes
        print(f"[serve] quantized pool ({eng.scfg.quant_spec.kv_dtype}) "
              f"bytes vs full-precision paged: {eng.cache_bytes():,} "
              f"/ {fp_bytes:,} = {qratio:.2f}x")
        if args.verify and qratio >= 0.60:
            _fail("quantized pool does not realize the memory win "
                  "(expected <= 0.60x the full-precision paged pool)")


def _verify_tokens(eng, cfg, params, proj, scfg, plan, reqs, streamed, args,
                   dev, host_params=None) -> Optional[ScheduleStats]:
    """Token identity with a reference engine, as the JAX launcher routes
    it: the reference is single-device. Greedy: the contiguous engine, or,
    for int8 pools and hierarchical drives (whose rounding or page
    dropping is part of the result), and for a prefix-shared drive whose
    plan is mesh-native (a shared tail prefills through another
    reduction than a whole prompt), the paged engine with the same specs;
    always admitting monolithically, so a chunked drive is pinned to the
    engine it replaces. Temperature > 0: each request re-served alone on
    a fresh engine of the same specs (on a mesh, a same-mesh engine:
    placement independence). Then, for a chunked greedy drive, the warm
    max inter-token gap check. On a mesh (``params`` the rank's blocks),
    rank 0 runs the single-device reference on the whole ``host_params``
    and decides. Returns the greedy reference engine's stats after its
    first drive (None when sampling, and on other ranks)."""
    mesh = eng.mesh
    rank0 = mesh is None or mesh.rank == 0
    ref_stats = None
    if args.temperature > 0:
        where = "solo" if mesh is None else "solo same-mesh"
        ref = {}
        for r in reqs:
            solo = ContinuousBatchingEngine(cfg, params, proj, serving=scfg,
                                            backend=args.backend, device=dev,
                                            mesh=mesh)
            ref.update(solo.run([dataclasses.replace(r, arrival=0.0)]))
        if not rank0:
            return None
    elif not rank0:
        return None
    else:
        prefix_engaged = (plan.prefix_sharing and plan.mesh_native
                          and args.shared_prefix_len > 0)
        if (prefix_engaged or plan.quantization != "none"
                or plan.token_sparsity != "none"):
            where = ("single-device paged" if plan.quantization == "none"
                     else f"single-device paged {plan.quantization}")
            if plan.token_sparsity != "none":
                where += " hierarchical"
            ref_scfg = scfg
        else:
            where = "single-device contiguous"
            ref_scfg = dataclasses.replace(scfg, cache=CacheSpec(),
                                           quant=QuantSpec())
        ref_scfg = dataclasses.replace(ref_scfg, prefill_budget_tokens=None,
                                       mesh_shape=None)
        if args.prefill_budget is not None:
            where += " monolithic-admit"
        if mesh is not None:
            params = params_from_numpy(host_params, dev)
        ref_eng = ContinuousBatchingEngine(cfg, params, proj,
                                           serving=ref_scfg,
                                           backend=args.backend, device=dev)
        ref = ref_eng.run(reqs)
        ref_stats = ref_eng.stats    # each serve makes a new one
    bad = [uid for uid, toks in streamed.items()
           if list(ref[uid].tokens) != toks]
    if bad:
        _fail(f"outputs diverge from the {where} reference for uids {bad}")
    print(f"[serve] verify: all {len(streamed)} requests token-identical to "
          f"the {where} reference engine")
    if (args.prefill_budget is not None and plan.chunked_prefill
            and args.temperature == 0 and mesh is None):
        # (on a mesh the ranks share the host and the card, and the
        # re-drive would need every rank: no wall-clock gap check there)
        # interleaving exists to keep decode lanes from stalling behind a
        # whole co-tenant prefill: the worst gap must come down against
        # the monolithic reference on the same trace. Both engines re-serve
        # warm, once each: the first drives' gaps hold one-off costs
        # (the chunked engine's extra chunk shapes), not admission stalls
        eng.run([dataclasses.replace(r) for r in reqs])
        ref_eng.run([dataclasses.replace(r) for r in reqs])
        warm_max, ref_max = eng.stats.max_itl, ref_eng.stats.max_itl
        if warm_max >= ref_max and ref_max > 0:
            _fail(f"chunked max inter-token gap {warm_max * 1e3:.1f}ms is "
                  f"not below the monolithic reference's "
                  f"{ref_max * 1e3:.1f}ms (warm re-drives)")
        print(f"[serve] verify: max inter-token gap {warm_max * 1e3:.1f}ms "
              f"< monolithic {ref_max * 1e3:.1f}ms (warm re-drives)")
    return ref_stats


def _drive_rectangular(cfg, params, proj, args, dev) -> ServeRun:
    """Fixed-batch drive: every request prefills together and decodes in
    lockstep (no overlap). Prompts: the synthetic LCG language."""
    eng = ServeEngine(cfg, params, proj, max_seq=args.max_seq,
                      backend=args.backend, device=dev)
    batch_size = min(args.requests, args.lanes)
    prompt_len = int(args.prompt_lens.split(",")[0])
    batch = add_frontend_inputs(
        {"tokens": lcg_batch(cfg.vocab_size, prompt_len, batch_size, seed=0,
                             step=0)["tokens"]}, cfg)
    t0 = time.time()
    res = eng.generate(batch, steps=args.steps,
                       temperature=args.temperature)
    dt = time.time() - t0
    tps = batch_size * args.steps / dt
    print(f"[serve] rectangular: generated {res.tokens.shape} tokens in "
          f"{dt:.2f}s ({tps:.1f} tok/s)")
    print(f"[serve] KV cache bytes @ batch={batch_size}: "
          f"{eng.cache_bytes(batch_size):,}")
    print("[serve] sample:", res.tokens[0][:16].tolist())
    return ServeRun(engine=eng, streamed={i: row.tolist() for i, row in
                                          enumerate(res.tokens)},
                    stats=None, requests=[], projections=proj, seconds=dt)


if __name__ == "__main__":
    main()
