#!/usr/bin/env python3
"""Race the prefill, flash and decode kernels of several checkouts on one
GPU.

    python3 kernel_race.py [--lengths | --f32] OUT.jsonl PARENT_DIR . . PARENT_DIR

Each directory is a checkout of the repo whose ``src/`` is the tree under
test; ``git archive <commit>`` unpacked into a gitignored directory gives
one. The measurements are this checkout's ``chip_smoke.py`` phases
(``prefill_phase``, ``flash_phase``, ``decode_phase``,
``paged_variant_phase``, ``step_graph_phase``), so every
tree runs the same code against its own kernels. Each directory runs in a process of its own, in
the order given (parent, change, change, parent puts drift on both sides).
Per tree:

- the prefill and flash at Qwen3-0.6B's and Llama-3.1-8B's geometry, B=1,
  causal: S=2048 and the served form (S=1024), each against its plain
  version at chip_smoke's limits;
- the shapes of the generic kernels (``"form": "generic"``): flash at
  head_dim 80 (H2O-Danube-1.8B), the prefill at k_ratio 0.5;
- the float32 routes of the prefill and flash (a served HF checkpoint's
  dtype) in the served form at Qwen3-0.6B's geometry;
- the window forms of the prefill and flash at RecurrentGemma-9B's
  geometry (16 heads over one KV head of 256 dims, S 4096, window 2048),
  in bf16 and in float32, each with its no-window form and one causal
  SDPA call beside it (a tree whose wrapper refuses the shape, as one
  whose float32 routes stop at a Dv of 128 does, records the refusal);
- the decode at full precision, contiguous and paged, at both
  geometries: bf16 at B=8, S=4096 and paged in the served form; float32
  (a served HF checkpoint's) at B=8, S=4096 and in the served form, with
  the route the tree's ``decode_route`` chose;
- the paged decode over int8 pools, over the participating pages of
  hierarchical AQUA, and over both, at both geometries: B=8, S=4096 and
  the served form (lengths 128-1056 in a 2048-token table), each against
  its plain version at chip_smoke's limits, with the route the tree's
  ``decode_route`` chose;
- the float32 serving decode step (Qwen3-0.6B at full width and depth,
  float32 params and activations as a served HF checkpoint's, 8 lanes,
  64-token pages, prompts 128/512/1024): ``step_graph_phase``'s replay =
  eager (bitwise) and the graph's device ms per replay;
- the host microseconds of one wrapper call at a tiny shape (S=128, where
  the device work is a few microseconds, so the host bounds a loop of
  calls; the five repeats of 2000 calls, sorted), and of one
  ``cuTensorMapEncodeTiled`` call through ctypes beside a no-op ctypes
  call (the bf16 flash encodes two maps a launch, the prefill five).

With ``--lengths`` only the forms that mask keys by ``lengths`` run, at
S=2048 with the last 21 rows past the length (a bucket-padded
admission): flash's generic kernel (head_dim 80, H2O-Danube-1.8B's
geometry) with and without ``lengths``, flash at Qwen3-0.6B's geometry,
and the prefill's generic kernel (k_ratio 0.5, which always passes
``lengths``); no step graph and no host timings. With ``--f32`` only the
float32 prefill and flash forms run: the served forms at Qwen3-0.6B's
geometry, the generic shapes (the prefill at k_ratio 0.5, flash at
head_dim 80) and RecurrentGemma-9B's window and no-window forms at
head_dim 256 beside causal SDPA; no step graph and no host timings.

Each phase appends one JSON line to OUT with ``"tree"`` set to its
directory; the card's name and power limit (``nvidia-smi``) head the
output, a table by phase follows on stdout. Exits non-zero if a tree
fails or a kernel disagrees with its plain version.
"""

import collections
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KEEP = ("name", "geometry", "form", "dtype", "route", "shape", "ms",
        "loop_ms", "library_ms", "plain_ms", "max_abs_err", "tol_ratio",
        "fault_tol_ratios", "ok", "bound_ms", "read_bytes", "device_us",
        "no_window_ms", "sdpa_causal_ms")


def host_us(gen) -> dict:
    """Host microseconds per wrapper call and per tensor-map encode."""
    import torch
    from repro_torch.core import aqua
    from repro_torch.kernels import aqua_prefill as pk
    from repro_torch.kernels import flash_attention as fk

    s, h, kvh, d = 128, 16, 8, 128
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(1, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(1, kvh, s, d, device=dev, generator=gen).to(bf)
    v = torch.randn(1, kvh, s, d, device=dev, generator=gen).to(bf)
    lengths = torch.full((1,), s, dtype=torch.int32, device=dev)
    block_idx = aqua.chunk_topk_block_indices(q, 96, 8, 128,
                                              lengths).contiguous()
    calls = {
        "flash": lambda: fk.flash_attention(q, k, v, causal=True),
        "prefill": lambda: pk.aqua_prefill_attention(
            q, k, v, block_idx, lengths, block_dims=8, q_blk=128,
            causal=True, scale=d ** -0.5)}
    out = {}
    for name, fn in calls.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            reps.append((time.perf_counter() - t0) / 2000 * 1e6)
            torch.cuda.synchronize()
        out[name] = sorted(reps)
    # cuTensorMapEncodeTiled with a V map's arguments: bf16 (9), rank 4,
    # 64 x 64 boxes, no interleave (0), 128-byte swizzle (3), L2 promotion
    # 128B (2), no OOB fill (0)
    enc = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    buf = (ctypes.c_uint8 * 256)()
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    args = (ctypes.c_void_p((ctypes.addressof(buf) + 63) // 64 * 64), 9, 4,
            ctypes.c_void_p(v.data_ptr()), (u64 * 4)(d, s, kvh, 1),
            (u64 * 3)(2 * d, 2 * d * s, 2 * d * s * kvh),
            (u32 * 4)(64, 64, 1, 1), (u32 * 4)(1, 1, 1, 1), 0, 3, 2, 0)
    assert enc(*args) == 0
    noop = ctypes.CDLL(None).abs
    n = 20000
    for name, fn, a in (("encode", enc, args), ("ctypes_noop", noop, (1,))):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*a)
        out[name] = (time.perf_counter() - t0) / n * 1e6
    return out


def f32_step_graph(cs) -> dict:
    """The float32 serving decode step through ``cs.step_graph_phase``:
    Qwen3-0.6B at full width and depth with float32 weights, the engine
    the HF launcher builds (8 lanes, max_seq 2048, 64-token pages; prefix
    sharing off, as these prompts share no page), prompts 128/512/1024."""
    from repro_torch.configs import CacheSpec, ServingConfig
    from repro_torch.serving import ContinuousBatchingEngine, poisson_trace
    cfg, params, proj = cs.load_model("qwen3-0.6b", 0, dtype="float32")
    eng = ContinuousBatchingEngine(cfg, params, proj, serving=ServingConfig(
        max_lanes=8, max_seq=2048, max_new_tokens=32,
        cache=CacheSpec(page_size=64, prefix_sharing=False)))
    reqs = poisson_trace(8, mean_interarrival=4.0,
                         prompt_lens=(128, 512, 1024), max_new_tokens=32,
                         vocab_size=cfg.vocab_size, seed=0)
    return cs.step_graph_phase("f32_paged", eng, reqs, trace=True)


def lengths_phases(cs, gen) -> list:
    """The forms that mask keys by ``lengths`` (``--lengths``)."""
    return [lambda: cs.flash_phase("h2o-danube-1.8b", 32, 8, gen, d=80,
                                   form="generic"),
            lambda: cs.flash_phase("h2o-danube-1.8b", 32, 8, gen, d=80,
                                   form="generic_lengths", pad=21),
            lambda: cs.flash_phase("qwen3-0.6b", 16, 8, gen,
                                   form="lengths", pad=21),
            lambda: cs.prefill_phase("qwen3-0.6b", 16, 8, gen, k_ratio=0.5,
                                     form="generic_lengths", pad=21)]


def f32_phases(cs, gen) -> list:
    """The float32 prefill and flash forms (``--f32``)."""
    f32 = "float32"
    return [lambda: cs.prefill_phase("qwen3-0.6b", 16, 8, gen, s=1024,
                                     form="served", dtype=f32),
            lambda: cs.flash_phase("qwen3-0.6b", 16, 8, gen, s=1024,
                                   form="served", dtype=f32),
            lambda: cs.prefill_phase("qwen3-0.6b", 16, 8, gen, k_ratio=0.5,
                                     form="generic", dtype=f32),
            lambda: cs.flash_phase("h2o-danube-1.8b", 32, 8, gen, d=80,
                                   form="generic", dtype=f32),
            lambda: cs.prefill_window_phase(
                "recurrentgemma-9b", 16, 1, 256, gen, s=4096, window=2048,
                heads=True, dtype=f32),
            lambda: cs.flash_window_phase("recurrentgemma-9b", 16, 1, 256,
                                          gen, dtype=f32)]


def one_tree(tree: str, out_path: str, only: str = None) -> int:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # the tree under test ahead of this checkout's src/
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import repro_torch
    from repro_torch.kernels import _build
    assert repro_torch.__file__.startswith(os.path.abspath(tree)), \
        repro_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    for name, text in _build.build_all().items():
        for line in text.splitlines():
            if "C7511" in line or "spill" in line and "bf16" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if only == "--lengths":
        return run_phases(cs, tree, out_path, lengths_phases(cs, gen))
    if only == "--f32":
        return run_phases(cs, tree, out_path, f32_phases(cs, gen))
    phases = []
    for geom, h, kvh in (("qwen3-0.6b", 16, 8), ("llama3.1-8b", 32, 8)):
        phases += [lambda g=geom, h=h, kv=kvh: cs.prefill_phase(g, h, kv, gen),
                   lambda g=geom, h=h, kv=kvh: cs.prefill_phase(
                       g, h, kv, gen, s=1024, form="served"),
                   lambda g=geom, h=h, kv=kvh: cs.flash_phase(g, h, kv, gen),
                   lambda g=geom, h=h, kv=kvh: cs.flash_phase(
                       g, h, kv, gen, s=1024, form="served"),
                   lambda g=geom, h=h, kv=kvh: cs.prefill_phase(
                       g, h, kv, gen, k_ratio=0.5, form="generic")]
    phases.append(lambda: cs.flash_phase("h2o-danube-1.8b", 32, 8, gen, d=80,
                                         form="generic"))
    phases += [lambda: cs.prefill_phase("qwen3-0.6b", 16, 8, gen, s=1024,
                                        form="served", dtype="float32"),
               lambda: cs.flash_phase("qwen3-0.6b", 16, 8, gen, s=1024,
                                      form="served", dtype="float32")]
    for dtype in ("bfloat16", "float32"):
        phases += [lambda dt=dtype: cs.prefill_window_phase(
                       "recurrentgemma-9b", 16, 1, 256, gen, s=4096,
                       window=2048, heads=True, dtype=dt),
                   lambda dt=dtype: cs.flash_window_phase(
                       "recurrentgemma-9b", 16, 1, 256, gen, dtype=dt)]
    for geom, h, kvh in (("qwen3-0.6b", 16, 8), ("llama3.1-8b", 32, 8)):
        for paged in (False, True):
            phases += [lambda g=geom, h=h, kv=kvh, pg=paged:
                       cs.decode_phase(g, h, kv, pg, gen),
                       lambda g=geom, h=h, kv=kvh, pg=paged:
                       cs.decode_phase(g, h, kv, pg, gen, dtype="float32"),
                       lambda g=geom, h=h, kv=kvh, pg=paged:
                       cs.decode_phase(g, h, kv, pg, gen, s=2048,
                                       len_range=(128, 1056), form="served",
                                       dtype="float32")]
        phases.append(lambda g=geom, h=h, kv=kvh: cs.decode_phase(
            g, h, kv, True, gen, s=2048, len_range=(128, 1056),
            form="served"))
        for quant, part in ((True, False), (False, True), (True, True)):
            phases += [lambda g=geom, h=h, kv=kvh, qt=quant, pt=part:
                       cs.paged_variant_phase(g, h, kv, qt, pt, gen),
                       lambda g=geom, h=h, kv=kvh, qt=quant, pt=part:
                       cs.paged_variant_phase(g, h, kv, qt, pt, gen, s=2048,
                                              len_range=(128, 1056),
                                              form="served")]
    return run_phases(cs, tree, out_path, phases, gen)


def run_phases(cs, tree: str, out_path: str, phases: list, gen=None) -> int:
    """Each phase's line to OUT; with ``gen`` also the float32 step graph
    and the host timings. 0 if every kernel agreed with its plain
    version."""
    ok = True
    with open(out_path, "a") as out:
        for run in phases:
            try:
                p = run()
            except ValueError as err:          # the tree's wrapper refuses
                out.write(json.dumps({"tree": tree, "refused": str(err)})
                          + "\n")
                continue
            line = dict({k: p.get(k) for k in KEEP}, tree=tree)
            out.write(json.dumps(line) + "\n")
            ok = ok and p["ok"]
        if gen is not None:
            graph = f32_step_graph(cs)
            out.write(json.dumps({"tree": tree, "step_graph": graph})
                      + "\n")
            out.write(json.dumps({"tree": tree, "host_us": host_us(gen)})
                      + "\n")
    return 0 if ok else 1


def main() -> int:
    args = sys.argv[1:]
    only = args[0] if args[0] in ("--lengths", "--f32") else None
    if only:
        args = args[1:]
    if args[0] == "--one":
        return one_tree(args[1], args[2], only)
    import torch
    if not torch.cuda.is_available():
        print("kernel_race: no CUDA device", file=sys.stderr)
        return 1
    out_path, trees = args[0], args[1:]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print("card:", cs.card_line(), flush=True)
    rc = 0
    for tree in trees:
        r = subprocess.run([sys.executable, os.path.abspath(__file__)]
                           + [only] * bool(only)
                           + ["--one", tree, out_path]).returncode
        print(f"tree {tree}: rc {r}", flush=True)
        rc = rc or r
    rows = [json.loads(line) for line in open(out_path)]
    table = collections.defaultdict(list)
    for r in rows:
        if "host_us" in r:
            print(r["tree"], "host us", json.dumps(r["host_us"]))
            continue
        if "refused" in r:
            print(r["tree"], "refused:", r["refused"])
            continue
        if "step_graph" in r:
            g = r["step_graph"]
            print(r["tree"], "float32 step graph: device ms per replay",
                  f"{g['replay_device_ms']:.4f}, device ops",
                  g["device_ops_per_replay"], "bitwise",
                  g["logits_bitwise"] and g["state_bitwise"])
            continue
        key = (r["name"], r["geometry"], r["form"], r.get("dtype"),
               (r["shape"] or {}).get("k_ratio"))
        extra = "".join(f" {k} {r[k]:.4f}" for k in ("no_window_ms",
                                                      "sdpa_causal_ms")
                        if r.get(k) is not None)
        table[key].append(f"{r['tree']} {r['ms']:.4f}{extra}"
                          f"{' ' + r['route'] if r.get('route') else ''}"
                          f"{'' if r['ok'] else ' FAILED'}")
    for key, cells in table.items():
        print(key, " | ".join(cells))
    return rc


if __name__ == "__main__":
    sys.exit(main())
