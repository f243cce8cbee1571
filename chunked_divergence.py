#!/usr/bin/env python3
"""Chunked against monolithic admission on the card, each held to a float64
reference on the same weights.

    python3 chunked_divergence.py [--block-dims 1 8]

For each ``--block-dims`` value, runs the port's launcher in-process with
``--prefill-budget 256 --prompt-lens 512,1024 --max-seq 2048 --steps 32
--lanes 8 --requests 8 --page-size 64 --no-prefix-share`` (Qwen3-0.6B at
its full width and depth, random bf16 weights from seed 0, projections
calibrated on the synthetic LCG language: the launcher's defaults), then
serves the same trace on the launcher's chunked paged engine again, on the
engine ``--verify`` holds it to (contiguous, monolithic admission) and on
a paged engine that admits monolithically, recording every admission's
and every decode step's logits. A float64 forward of each prompt followed
by the chunked engine's tokens (up to the first token where the chunked
and the contiguous engine part, else 16), written here from the weights
(embedding, RMSNorm, qk-norm, RoPE, AQUA projection, the same dim
selection: per query in decode, per query or per ``prefill_q_blk`` tile
in the prefill as the engines select, causal softmax, MLP, unembedding),
gives each of those logits' reference row.

Prints one JSON line per block_dims and request: where the engines' tokens
part, each engine's worst logit error over the compared rows as a fraction
of the reference row's largest magnitude, the top-2 margins of the three
logit rows at the first parting token and the chunked and contiguous
rows' largest distance there. Then one line per block_dims with the
verdict: a near tie when every engine stays within ``LOGIT_RTOL`` of the
reference and the reference's top-2 margin at the parting token is below
the two engines' distance. Needs one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: chip_smoke.py's bf16 logit limit: a row within 5% of its largest magnitude
LOGIT_RTOL = 0.05
#: decode steps compared where the engines' tokens never part
STEPS_WITHOUT_PARTING = 16
LAUNCHER_ARGS = ["--prefill-budget", "256", "--prompt-lens", "512,1024",
                 "--max-seq", "2048", "--steps", "32", "--lanes", "8",
                 "--requests", "8", "--page-size", "64",
                 "--no-prefix-share"]


def collect(eng, reqs) -> tuple:
    """Serve ``reqs`` on ``eng``: (tokens by uid, logits by uid: the
    admission's row, then one row per decode step, float32 on the card)."""
    tokens, logits = {}, {}
    for ev in eng.serve(reqs):
        if ev.index == 0:
            row = eng.last_admit_logits[0]
        else:
            lane = [int(u) for u in eng.last_lanes.uid].index(ev.uid)
            row = eng.last_step_logits[lane]
        logits.setdefault(ev.uid, []).append(row.float().clone())
        tokens.setdefault(ev.uid, []).append(ev.token)
    return tokens, logits


def _rms(x, scale, eps):
    return x * (x.square().mean(-1, keepdim=True) + eps).rsqrt() \
        * scale.double()


def _rope(x, positions, theta):
    import torch
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                         device=x.device) / half)
    ang = positions[:, None] * freqs
    for _ in range(x.ndim - 3):
        ang = ang[:, None]
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _top(mag, k):
    """Indices of the k largest entries of the last axis, the lower index
    first among ties (the port's ``topk_indices``)."""
    import torch
    return torch.sort(mag, dim=-1, descending=True, stable=True)[1][..., :k]


def selection_mask(qh, aqua, prompt_len: int):
    """0/1 mask over q̂ (1, T, KV, G, D) float64: the prompt's rows select
    as the engines' prefill does (per query at block_dims 1; per
    ``prefill_q_blk`` tile of summed block magnitudes, padding excluded,
    at whole blocks), later rows per query (whole blocks at
    block_dims > 1), as decode does."""
    import torch
    _, t, kvh, g, d = qh.shape
    bd, k = aqua.block_dims, aqua.topk_dims(d)
    mag = qh.abs()
    if bd == 1:
        return torch.zeros_like(mag).scatter_(-1, _top(mag, k), 1.0)
    nb, kb = d // bd, k // bd
    bmag = mag.reshape(1, t, kvh, g, nb, bd).sum(-1)
    per_query = torch.zeros_like(bmag).scatter_(-1, _top(bmag, kb), 1.0)
    qb = aqua.prefill_q_blk
    tiles = -(-prompt_len // qb)
    pm = torch.zeros(1, tiles * qb, kvh, g, nb, dtype=bmag.dtype,
                     device=bmag.device)
    pm[:, :prompt_len] = bmag[:, :prompt_len]
    tile_mag = pm.reshape(1, tiles, qb, kvh, g, nb).sum(2)
    tile_sel = torch.zeros_like(tile_mag).scatter_(-1, _top(tile_mag, kb),
                                                   1.0)
    per_tile = tile_sel.repeat_interleave(qb, dim=1)[:, :prompt_len]
    sel = torch.cat([per_tile, per_query[:, prompt_len:]], dim=1)
    return sel.repeat_interleave(bd, dim=-1)


def reference_logits(eng, tokens, prompt_len: int):
    """float64 logits (T - prompt_len + 1, V) of rows prompt_len - 1 ..
    T - 1 of ``tokens`` (T,), from ``eng``'s params and stored
    projections."""
    import torch
    from repro_torch.models.transformer import layer_params
    cfg, p = eng.cfg, eng.params
    acfg, aqua = cfg.attention, cfg.aqua
    dev = p["embed"]["table"].device
    tok = torch.as_tensor(tokens, device=dev).long()[None]
    t = tok.shape[1]
    pos = torch.arange(t, dtype=torch.float64, device=dev)
    x = p["embed"]["table"][tok].double()
    causal = pos[:, None] >= pos[None, :]
    for i in range(cfg.num_layers):
        lp = layer_params(p["layers"], i)
        a = lp["attn"]
        h = _rms(x, lp["ln1"], cfg.norm_eps)
        q = torch.einsum("btm,mkgd->btkgd", h, a["wq"].double())
        k = torch.einsum("btm,mkd->btkd", h, a["wk"].double())
        v = torch.einsum("btm,mkd->btkd", h, a["wv"].double())
        if acfg.qkv_bias:
            q, k, v = (q + a["bq"].double(), k + a["bk"].double(),
                       v + a["bv"].double())
        if acfg.qk_norm:
            q, k = _rms(q, a["q_norm"], 1e-6), _rms(k, a["k_norm"], 1e-6)
        q, k = _rope(q, pos, acfg.rope_theta), _rope(k, pos, acfg.rope_theta)
        proj = eng.proj[i].double()
        qh = torch.einsum("btkgd,kde->btkge", q, proj)
        kh = torch.einsum("btkd,kde->btke", k, proj)
        qq = qh * selection_mask(qh, aqua, prompt_len)
        s = torch.einsum("btkgd,bskd->bkgts", qq, kh) / acfg.head_dim ** 0.5
        s = torch.where(causal, s, torch.full_like(s, -torch.inf))
        o = torch.einsum("bkgts,bskd->btkgd", s.softmax(-1), v)
        x = x + o.reshape(1, t, -1) @ a["wo"].double().reshape(
            -1, cfg.d_model)
        f = lp["ffn"]
        hm = _rms(x, lp["ln2"], cfg.norm_eps)
        x = x + (torch.nn.functional.silu(hm @ f["w1"].double())
                 * (hm @ f["w3"].double())) @ f["w2"].double()
    table = p["embed" if cfg.tie_embeddings else "unembed"]["table"]
    xs = _rms(x[0, prompt_len - 1:], p["ln_f"], cfg.norm_eps)
    return xs @ table.double().T


def margin(row) -> float:
    top = row.double().topk(2).values
    return float(top[0] - top[1])


def probe(block_dims: int, card: str, extra=()) -> list:
    import torch
    from repro_torch.configs import CacheSpec, QuantSpec
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import ContinuousBatchingEngine
    run = launcher.main(LAUNCHER_ARGS + ["--block-dims", str(block_dims),
                                         *extra])
    eng = run.engine
    reqs = lambda: [dataclasses.replace(r) for r in run.requests]
    chunked = collect(eng, reqs())
    assert chunked[0] == run.streamed, "second serve changed tokens"
    assert eng.stats.chunked_admissions == len(run.requests)
    ref_scfg = dataclasses.replace(eng.scfg, prefill_budget_tokens=None)
    engines = {
        "contiguous": dataclasses.replace(ref_scfg, cache=CacheSpec(),
                                          quant=QuantSpec()),
        "paged_monolithic": ref_scfg}
    drives = {"chunked": chunked}
    for name, scfg in engines.items():
        drives[name] = collect(ContinuousBatchingEngine(
            eng.cfg, eng.params, run.projections, serving=scfg,
            device=eng.device), reqs())
    lines = []
    for r in run.requests:
        u, plen = r.uid, r.prompt_len
        tc, tm = drives["chunked"][0][u], drives["contiguous"][0][u]
        part = next((j for j, (a, b) in enumerate(zip(tc, tm)) if a != b),
                    None)
        n = STEPS_WITHOUT_PARTING if part is None else part
        seq = list(map(int, r.tokens)) + tc[:n]
        ref = reference_logits(eng, seq, plen)           # (n + 1, V)
        line = dict(block_dims=block_dims, uid=u, prompt_len=plen,
                    first_parting_token=part, rows_compared=n + 1)
        for name, (toks, logits) in drives.items():
            errs = [float((logits[u][j].double() - ref[j]).abs().max()
                          / ref[j].abs().max()) for j in range(n + 1)]
            line[name] = dict(worst_err_over_row_max=max(errs),
                              admission_err_over_row_max=errs[0],
                              token_match_with_chunked=sum(
                                  a == b for a, b in zip(toks[u], tc))
                              / len(tc))
        if part is not None:
            c = drives["chunked"][1][u][part].double()
            m = drives["contiguous"][1][u][part].double()
            line["at_parting_token"] = dict(
                tokens=dict(chunked=tc[part], contiguous=tm[part],
                            reference=int(ref[part].argmax())),
                top2_margin=dict(chunked=margin(c), contiguous=margin(m),
                                 reference=margin(ref[part])),
                chunked_vs_contiguous_max_abs=float((c - m).abs().max()),
                reference_row_max_abs=float(ref[part].abs().max()))
        lines.append(line)
        print(json.dumps(line), flush=True)
        del ref
        if eng.device.type == "cuda":
            torch.cuda.empty_cache()
    parted = [ln for ln in lines if ln["first_parting_token"] is not None]
    within = all(ln[name]["worst_err_over_row_max"] <= LOGIT_RTOL
                 for ln in lines for name in drives)
    ties = all(ln["at_parting_token"]["top2_margin"]["reference"]
               < ln["at_parting_token"]["chunked_vs_contiguous_max_abs"]
               for ln in parted)
    verdict = dict(block_dims=block_dims, parted_uids=[ln["uid"]
                                                       for ln in parted],
                   all_within_logit_rtol=within,
                   reference_margins_below_engine_distance=ties,
                   near_tie=within and ties, logit_rtol=LOGIT_RTOL,
                   card=card)
    print(json.dumps({"verdict": verdict}), flush=True)
    return lines


def main() -> int:
    import subprocess
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block-dims", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="the reduced config on the CPU (checks the script, "
                         "measures nothing)")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        for bd in args.block_dims:
            probe(bd, "cpu rehearsal", ("--device", "cpu", "--reduced"))
        return 0
    if not torch.cuda.is_available():
        print("chunked_divergence: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for bd in args.block_dims:
        probe(bd, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
