#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. Device: require CUDA; print the card's name and power limit, the torch
   and CUDA versions; turn TF32 off for float32 matmuls and convolutions.
2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed as
   set-up; one ``nvcc`` per source, in parallel).
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes (bf16, D=128) of Qwen3-0.6B (H=16, KV=8) and of
   Llama-3.1-8B (H=32, KV=8): decode B=8, S=4096 (contiguous, and paged
   with 64-token pages and a shuffled page table); prefill B=1, S=2048.
   One JSON line per kernel and geometry: max abs error and the worst
   ratio of error to the per-element tolerance, kernel / plain / library
   ms (CUDA events) and the bound. Planted faults (one 256-position split
   of a lane dropped, one head's dim-block selection shifted) must fail
   the same tolerance: it is tight enough to catch a wrong kernel.
4. Serve Qwen3-0.6B at its full published width and depth (random bf16
   weights from a seeded generator, AQUA k_ratio=0.75, block_dims=8,
   projections calibrated on ``corpora/calibration.txt``) through the
   continuous-batching engine: 12 Poisson requests (prompts 128/512/1024,
   32 new tokens, greedy) on the paged pool, then 4 on the contiguous
   cache. The launch counters are zeroed just before each drive and read
   just after it: each path must have launched its kernels once per layer
   per admission and per decode step, and not the other path's decode
   kernel. Both traces are also served by the kernels' plain versions
   (backend ``aqua-block-sparse-plain``): every admission's logits and
   those of the first decode steps (on lanes whose tokens still agree)
   must match them within a stated bf16 limit; the greedy token match is
   reported. A paged drive of 4 requests runs under ``torch.profiler``
   for the device's idle share and its top kernels.
5. The ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
K_RATIO, BLOCK_DIMS = 0.75, 8
# bf16 outputs, per element |out - ref| <= KERNEL_RTOL * |ref| +
# KERNEL_ATOL: kernel and plain version both compute in float32 from the
# same inputs (in different summation orders) and round once to bf16, so
# they may differ by one bf16 ulp, at most 2^-7 * |ref|; KERNEL_ATOL covers
# the float32 difference near zero. Decode outputs average thousands of V
# rows (|out| ~ 0.02), so an absolute limit alone would be too loose.
KERNEL_RTOL, KERNEL_ATOL = 2.0 ** -7, 1e-4
# logits of the bf16 model through 28 layers: kernel and plain attention
# outputs differ by about one bf16 ulp per layer; each row's logits must
# stay within 5% of that row's largest magnitude
LOGIT_RTOL = 0.05
DECODE_STEPS_CHECKED = 16


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tol_ratio(out, ref) -> float:
    """Worst ratio of |out - ref| to the per-element tolerance (<= 1 is
    within it)."""
    ref = ref.float()
    return ((out.float() - ref).abs()
            / (KERNEL_RTOL * ref.abs() + KERNEL_ATOL)).max().item()


def check_kernel(out, ref, faults: dict) -> dict:
    """Error of ``out`` against ``ref``, and the same for each planted
    fault's output, which must fall outside the tolerance."""
    ratio = tol_ratio(out, ref)
    caught = {name: tol_ratio(f, ref) for name, f in faults.items()}
    return dict(max_abs_err=(out.float() - ref.float()).abs().max().item(),
                tol_ratio=ratio, fault_tol_ratios=caught,
                ok=ratio <= 1.0 and all(r > 1.0 for r in caught.values()))


def shifted(block_idx, nb: int):
    """``block_idx`` with lane 0, head 0 (and chunk 0) choosing every
    selected block one further, mod ``nb``: a planted selection fault."""
    import torch
    bad = block_idx.clone()
    first = (0,) * (bad.ndim - 1)
    bad[first] = torch.sort((bad[first] + 1) % nb)[0]
    return bad.contiguous()


def bound(nbytes: float, ops: float) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------


def decode_phase(geom: str, h: int, kvh: int, paged: bool, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core import aqua
    from repro_torch.kernels import aqua_decode as dk
    from repro_torch.kernels.ops import round_k_dims

    b, s, d, ps = 8, 4096, 128, 64
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(b, h, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.randint(s // 2, s + 1, (b,), device=dev, generator=gen,
                            dtype=torch.int32)
    scale = d ** -0.5
    nsel = round_k_dims(d, K_RATIO, BLOCK_DIMS)
    block_idx = aqua.topk_block_indices(q, nsel, BLOCK_DIMS).contiguous()
    nb = d // BLOCK_DIMS
    cut = lengths.clone()
    cut[0] -= 256                      # lane 0 loses its last split
    if paged:
        npl = s // ps
        perm = torch.randperm(b * npl, device=dev, generator=gen)
        table = perm.reshape(b, npl).to(torch.int32)
        # pool page table[b, j] holds lane b's logical page j
        k_pool = torch.empty(b * npl, kvh, ps, d, device=dev, dtype=bf)
        v_pool = torch.empty_like(k_pool)
        k_pool[table.long()] = k.reshape(b, kvh, npl, ps, d).transpose(1, 2)
        v_pool[table.long()] = v.reshape(b, kvh, npl, ps, d).transpose(1, 2)

        def kernel(block_idx=block_idx, lengths=lengths):
            return dk.aqua_paged_decode_attention(
                q, k_pool, v_pool, block_idx, table, lengths,
                block_dims=BLOCK_DIMS, scale=scale)

        def plain():
            return dk.aqua_decode_plain(q, k_pool, v_pool, block_idx,
                                        lengths, table,
                                        block_dims=BLOCK_DIMS, scale=scale)
    else:
        def kernel(block_idx=block_idx, lengths=lengths):
            return dk.aqua_decode_attention(q, k, v, block_idx, lengths,
                                            block_dims=BLOCK_DIMS,
                                            scale=scale)

        def plain():
            return dk.aqua_decode_plain(q, k, v, block_idx, lengths, None,
                                        block_dims=BLOCK_DIMS, scale=scale)

    check = check_kernel(kernel(), plain(), {
        "dropped_split": kernel(lengths=cut),
        "shifted_block": kernel(block_idx=shifted(block_idx, nb))})
    # yardstick: one library call on the equivalent masked-q̂ dense problem
    sel = torch.zeros(b, h, d // BLOCK_DIMS, device=dev)
    sel.scatter_(-1, block_idx.long(), 1.0)
    qm = (q * sel.repeat_interleave(BLOCK_DIMS, -1).to(bf))[:, :, None]
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qm, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    # bytes this run needs: per (lane, kv head) the union of the dim-blocks
    # its G heads selected, over the valid rows, plus the valid V rows
    g = h // kvh
    union = sel.reshape(b, kvh, g, -1).amax(dim=2).sum(dim=-1)   # (B, KV)
    lens = lengths.double()
    nbytes = 2 * float((lens[:, None] * (union * BLOCK_DIMS + d)).sum())
    nbytes += 2 * (q.numel() + b * h * d) + 4 * (block_idx.numel() + b)
    ops = 2 * float(lens.sum()) * h * (nsel + d)
    bms, by = bound(nbytes, ops)
    name = "aqua_paged_decode" if paged else "aqua_decode"
    return dict(name=name, geometry=geom, shape=dict(B=b, H=h, KV=kvh, S=s,
                                                     D=d, page_size=ps
                                                     if paged else None),
                **check, ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library), bound_ms=bms, bound_by=by)


def prefill_phase(geom: str, h: int, kvh: int, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core import aqua
    from repro_torch.kernels import aqua_prefill as pk
    from repro_torch.kernels.ops import round_k_dims

    b, s, d, q_blk = 1, 2048, 128, 128
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    nsel = round_k_dims(d, K_RATIO, BLOCK_DIMS)
    block_idx = aqua.chunk_topk_block_indices(q, nsel, BLOCK_DIMS, q_blk,
                                              lengths).contiguous()
    kw = dict(block_dims=BLOCK_DIMS, q_blk=q_blk, causal=True, scale=scale)

    def kernel(block_idx=block_idx):
        return pk.aqua_prefill_attention(q, k, v, block_idx, lengths, **kw)

    def plain():
        return pk.aqua_prefill_plain(q, k, v, block_idx, lengths, **kw)

    check = check_kernel(kernel(), plain(), {
        "shifted_block": kernel(shifted(block_idx, d // BLOCK_DIMS))})
    sel = torch.zeros(b, h, s // q_blk, d // BLOCK_DIMS, device=dev)
    sel.scatter_(-1, block_idx.long(), 1.0)
    qmask = sel.repeat_interleave(BLOCK_DIMS, -1).repeat_interleave(q_blk, 2)
    qm = q * qmask.to(bf)

    def library():
        return F.scaled_dot_product_attention(qm, k, v, is_causal=True,
                                              scale=scale, enable_gqa=True)

    pairs = s * (s + 1) / 2
    ops = 2 * pairs * h * (nsel + d)
    # q's selected dims, all of K̂ (the chunks' selections cover every
    # block across the sequence), V, and the output, each once
    nbytes = 2 * (b * h * s * nsel + 2 * b * kvh * s * d + b * h * s * d)
    bms, by = bound(nbytes, ops)
    return dict(name="aqua_prefill", geometry=geom,
                shape=dict(B=b, H=h, KV=kvh, S=s, D=d, q_blk=q_blk),
                **check, ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library), bound_ms=bms, bound_by=by)


# ---------------------------------------------------------------------------
# Serving phase
# ---------------------------------------------------------------------------


def launch_counts() -> dict:
    from repro_torch.kernels import aqua_decode as dk
    from repro_torch.kernels import aqua_prefill as pk
    return {"aqua_prefill": pk.aqua_prefill_attention.launches,
            "aqua_decode": dk.aqua_decode_attention.launches,
            "aqua_paged_decode": dk.aqua_paged_decode_attention.launches}


def reset_counts() -> None:
    from repro_torch.kernels import aqua_decode as dk
    from repro_torch.kernels import aqua_prefill as pk
    pk.aqua_prefill_attention.launches = 0
    dk.aqua_decode_attention.launches = 0
    dk.aqua_paged_decode_attention.launches = 0


def serve_drive(eng, reqs) -> dict:
    """Serve ``reqs``; returns tokens per uid, each admission's logits, the
    logits of the first decode steps with each lane's uid and the tokens
    it held at that step, and wall-clock figures (the host reads every
    sampled token, so each step's time includes its device work). Every
    admission's and every decode step's logits must be finite."""
    import torch
    tokens, admit_logits, steps = {}, {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ev in eng.serve(reqs):
        if ev.index == 0:               # an admission: its prefill logits
            logits = eng.last_admit_logits
            assert torch.isfinite(logits).all(), f"request {ev.uid}"
            admit_logits[ev.uid] = logits.float().clone()
        elif eng.stats.decode_steps > len(steps):
            # the first event of a new decode step: ``tokens`` still holds
            # what each lane had fed in
            logits = eng.last_step_logits
            assert torch.isfinite(logits).all(), \
                f"decode step {eng.stats.decode_steps}"
            if len(steps) < DECODE_STEPS_CHECKED:
                uids = [int(u) for u in eng.last_lanes.uid]
                steps.append(dict(logits=logits.float().clone(), uids=uids,
                                  held={u: tuple(tokens[u]) for u in uids
                                        if u in tokens}))
            else:
                steps.append(None)
        tokens.setdefault(ev.uid, []).append(ev.token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    return dict(tokens=tokens, admit_logits=admit_logits,
                step_logits=[x for x in steps if x is not None], wall_s=wall,
                tokens_emitted=st.tokens_emitted,
                tokens_per_s=st.tokens_emitted / wall,
                decode_steps=st.decode_steps,
                decode_step_ms=1e3 * st.decode_seconds / max(st.decode_steps,
                                                             1),
                admissions=st.admissions,
                admit_ms=1e3 * st.admit_seconds / max(st.admissions, 1),
                itl_p50_ms=1e3 * st.itl_percentile(50),
                itl_p99_ms=1e3 * st.itl_percentile(99),
                mean_occupancy=st.mean_occupancy)


def compare_logits(run: dict, ref: dict, max_new: int) -> dict:
    """Logits of the kernel drive against the plain drive of the same
    trace: every admission (same prompt), and in each checked decode step
    every lane that was still generating and held the same tokens in both
    drives. Each row must stay within LOGIT_RTOL of its largest
    magnitude; raises otherwise."""
    def row_check(got, want, what):
        err = (got - want).abs().max().item()
        limit = LOGIT_RTOL * want.abs().max().item()
        assert err <= limit, f"{what}: logits error {err} > {limit}"
        return err / limit
    worst_admit = max(row_check(run["admit_logits"][u], want, f"admit {u}")
                      for u, want in ref["admit_logits"].items())
    worst_step, rows = 0.0, 0
    assert len(run["step_logits"]) == len(ref["step_logits"]) \
        == DECODE_STEPS_CHECKED
    for i, (got, want) in enumerate(zip(run["step_logits"],
                                        ref["step_logits"])):
        assert got["uids"] == want["uids"], (i, got["uids"], want["uids"])
        for lane, u in enumerate(want["uids"]):
            held = want["held"].get(u)
            if held is None or len(held) >= max_new \
                    or got["held"].get(u) != held:
                continue
            worst_step = max(worst_step, row_check(
                got["logits"][lane], want["logits"][lane],
                f"decode step {i + 1} lane {lane}"))
            rows += 1
    assert rows > 0, "no decode-step logits were compared"
    pairs = [(a, b) for uid in ref["tokens"]
             for a, b in zip(run["tokens"][uid], ref["tokens"][uid])]
    return dict(admissions_compared=len(ref["admit_logits"]),
                admit_worst_err_over_limit=worst_admit,
                decode_rows_compared=rows,
                decode_worst_err_over_limit=worst_step,
                greedy_token_match=sum(a == b for a, b in pairs) / len(pairs),
                first_token_match=sum(
                    run["tokens"][u][0] == ref["tokens"][u][0]
                    for u in ref["tokens"]) / len(ref["tokens"]))


def profiled_drive(eng, reqs) -> dict:
    """Serve ``reqs`` under ``torch.profiler``: the device's busy share of
    the wall time and the kernels that take most of the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in eng.serve(reqs):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() * 1e-6
    busy = sum(by_name.values())
    assert busy > 0, "the profiled drive ran nothing on the device"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
                decode_steps=eng.stats.decode_steps,
                top_kernels=[dict(name=n[:80], s=t, share=t / busy)
                             for n, t in top])


def serve_phase(card: str) -> dict:
    import torch
    from repro_torch.configs import AquaConfig, CacheSpec, ServingConfig
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import calibrate
    from repro_torch.data.corpus import calibration_batches
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousBatchingEngine, poisson_trace

    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              aqua=AquaConfig(k_ratio=K_RATIO,
                                              block_dims=BLOCK_DIMS),
                              dtype="bfloat16", param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))

    def fwd_cap(p, batch):
        toks = torch.from_numpy(batch["tokens"]).cuda()
        return model.forward(p, {"tokens": toks}, capture=True)[1]
    proj = calibrate(fwd_cap, params, calibration_batches(
        cfg.vocab_size, os.path.join(ROOT, "corpora", "calibration.txt"),
        num_batches=2, batch=2, seq=32), cfg)
    setup_s = time.perf_counter() - t0

    def trace(n):
        return poisson_trace(n, mean_interarrival=4.0,
                             prompt_lens=(128, 512, 1024), max_new_tokens=32,
                             vocab_size=cfg.vocab_size, seed=0)
    paged = ServingConfig(max_lanes=8, max_seq=2048, max_new_tokens=32,
                          cache=CacheSpec(page_size=64, prefix_sharing=False))
    contiguous = dataclasses.replace(paged, cache=None)

    def drive(serving, n: int, backend=None) -> dict:
        """One drive with the counters zeroed just before it and read just
        after it."""
        eng = ContinuousBatchingEngine(cfg, params, proj, serving=serving,
                                       backend=backend)
        reset_counts()
        run = serve_drive(eng, trace(n))
        run["launches"], run["engine"] = launch_counts(), eng
        assert len(run["tokens"]) == n, len(run["tokens"])
        for toks in run["tokens"].values():
            assert len(toks) == 32, len(toks)
            assert all(0 <= t < cfg.vocab_size for t in toks)
        return run

    layers = cfg.num_layers
    runs = {}
    for path, serving, n, decode_kernel in (
            ("paged", paged, 12, "aqua_paged_decode"),
            ("contiguous", contiguous, 4, "aqua_decode")):
        # the reference: the same engine through the kernels' plain versions
        ref = drive(serving, n, backend="aqua-block-sparse-plain")
        assert sum(ref["launches"].values()) == 0, ref["launches"]
        run = drive(serving, n)
        want = {"aqua_prefill": layers * run["admissions"],
                "aqua_decode": 0, "aqua_paged_decode": 0}
        want[decode_kernel] = layers * run["decode_steps"]
        assert run["launches"] == want, (path, run["launches"], want)
        run["vs_plain"] = compare_logits(run, ref, 32)
        runs[path], runs[path + "_plain"] = run, ref
    # one more paged drive, traced: where the device time goes
    prof = profiled_drive(runs["paged"]["engine"], trace(4))
    log(f"[serve paged, traced] device idle share {prof['idle_share']:.3f} "
        f"on {card}")

    summary = {}
    for key, run in runs.items():
        summary[key] = {k: v for k, v in run.items()
                        if k not in ("tokens", "admit_logits", "step_logits",
                                     "engine")}
        log(f"[serve {key}] tokens/s {run['tokens_per_s']:.2f} on {card}")
        log(f"[serve {key}] decode step ms {run['decode_step_ms']:.3f} "
            f"on {card}")
    result = dict(model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
                  setup_s=setup_s, logit_rtol=LOGIT_RTOL,
                  profile_paged=prof,
                  cache_bytes_paged=runs["paged"]["engine"].cache_bytes(),
                  cache_bytes_contiguous=runs["contiguous"][
                      "engine"].cache_bytes(),
                  **summary)
    log({"serve": result})
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    log("tf32: off for float32 matmuls and cuDNN")

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    log(f"build: {build_s:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    phases = []
    for geom, h, kvh in (("qwen3-0.6b", 16, 8), ("llama3.1-8b", 32, 8)):
        phases.append(decode_phase(geom, h, kvh, False, gen))
        phases.append(decode_phase(geom, h, kvh, True, gen))
        phases.append(prefill_phase(geom, h, kvh, gen))
    for p in phases:
        log(p)
    bad = [p for p in phases if not p["ok"]]
    assert not bad, f"kernel disagrees with its plain version: {bad}"

    serve = serve_phase(card)
    sources = {"aqua_decode": ("src/repro_torch/kernels/csrc/aqua_decode.cu",
                               "src/repro/kernels/aqua_decode.py:50"),
               "aqua_paged_decode": (
                   "src/repro_torch/kernels/csrc/aqua_decode.cu",
                   "src/repro/kernels/aqua_decode.py:99"),
               "aqua_prefill": ("src/repro_torch/kernels/csrc/aqua_prefill.cu",
                                "src/repro/kernels/aqua_prefill.py:58")}
    # each kernel's launches in the drive of its path (the prefill kernel's
    # main path is the paged one), and in each path's own drive
    main_path = {"aqua_decode": "contiguous", "aqua_paged_decode": "paged",
                 "aqua_prefill": "paged"}
    kernels = []
    for p in phases:
        if p["geometry"] != "qwen3-0.6b":
            continue
        src, rep = sources[p["name"]]
        by_path = {path: serve[path]["launches"][p["name"]]
                   for path in ("paged", "contiguous")}
        kernels.append(dict(
            name=p["name"], route="cuda", source=src, replaces=rep,
            launches=by_path[main_path[p["name"]]], launches_by_path=by_path,
            max_abs_err=p["max_abs_err"], ms=p["ms"], plain_ms=p["plain_ms"],
            bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=p["library_ms"]))
    log(card)                      # name, power.limit as nvidia-smi prints
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
