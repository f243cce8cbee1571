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

At whole dim-blocks (block_dims > 1) each request's line also holds the
selection check: the engines' own selections, the block indices their
kernels receive in an eager run of the same model code over the same
tokens (``engine_masks``), against the float64 reference's. At each row past ``LOGIT_RTOL`` it counts the
dim-blocks (over layers, KV heads and query heads) whose selection
differs, and over the prompt's rows the share that differs; a second
float64 reference that takes the engines' selections instead of its own
gives each engine's worst error again. The verdict line then says whether
every row past the limit selects other blocks and whether, with the
engines' selections, every engine stays within the limit: a selection
difference (the float64 and the model-dtype q̂ rank near-equal block
magnitudes differently), not a fault of the kernels.

``--float32`` serves a synthetic checkpoint in HF layout at Qwen3-0.6B's
published geometry instead (random bf16 weights from seed 0, written to
``build/hf_divergence`` and deleted after), so params and activations are
float32, as the launcher serves every HF checkpoint: the float32 routes.
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


def engine_masks(eng, tokens, prompt_len: int) -> list:
    """Per layer, the 0/1 mask (1, T, KV, G, D) of the dim-blocks the
    engines' kernels select for ``tokens`` (T,): the block indices that
    the kernel wrappers receive in an eager run of the engine's model
    (the prompt's prefill into a contiguous cache, then one decode step
    per later token: the code the engines' graphs captured), recorded at
    ``ops.prefill_blocks`` (per ``prefill_q_blk`` tile) and
    ``ops.decode_blocks`` (per query)."""
    import torch
    from repro_torch.kernels import ops
    cfg, aqua = eng.cfg, eng.cfg.aqua
    att = cfg.attention
    kvh, g, d, bd = (att.num_kv_heads, att.group_size, att.head_dim,
                     aqua.block_dims)
    calls = []
    pre, dec = ops.prefill_blocks, ops.decode_blocks

    def prefill_blocks(*a, **kw):
        out = pre(*a, **kw)
        calls.append(("prefill", out[0], out[2]))
        return out

    def decode_blocks(*a, **kw):
        out = dec(*a, **kw)
        calls.append(("decode", out, None))
        return out
    dev = eng.device
    tok = torch.as_tensor(tokens, device=dev).to(torch.int32)
    ops.prefill_blocks, ops.decode_blocks = prefill_blocks, decode_blocks
    try:
        _, state = eng.model.prefill(eng.params, {"tokens": tok[None,
                                                                :prompt_len]},
                                     eng.scfg.max_seq, aqua_proj=eng.proj)
        for t in range(prompt_len, tok.shape[0]):
            eng.model.decode_step(eng.params, state, tok[t:t + 1],
                                  aqua_proj=eng.proj)
    finally:
        ops.prefill_blocks, ops.decode_blocks = pre, dec
    layers = cfg.num_layers
    assert len(calls) == layers * (1 + tok.shape[0] - prompt_len), len(calls)
    masks = []
    for i in range(layers):
        m = torch.zeros(1, tok.shape[0], kvh * g, d // bd,
                        dtype=torch.float64, device=dev)
        _, idx, q_blk = calls[i]                  # (1, H, NQC, NB_sel)
        rows = torch.arange(prompt_len, device=dev) // q_blk
        m[0, :prompt_len].scatter_(
            -1, idx[0].permute(1, 0, 2)[rows].long(), 1.0)
        for t in range(prompt_len, tok.shape[0]):
            _, idx, _ = calls[layers * (1 + t - prompt_len) + i]
            m[0, t].scatter_(-1, idx[0].long(), 1.0)   # (H, NB_sel)
        masks.append(m.reshape(1, -1, kvh, g, d // bd)
                     .repeat_interleave(bd, dim=-1))
    return masks


def reference_logits(eng, tokens, prompt_len: int, masks=None,
                     own_masks=None):
    """float64 logits (T - prompt_len + 1, V) of rows prompt_len - 1 ..
    T - 1 of ``tokens`` (T,), from ``eng``'s params and stored
    projections; ``masks`` (per layer) replaces its own selection, and
    ``own_masks`` (a list) collects its own."""
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
        sel = selection_mask(qh, aqua, prompt_len)
        if own_masks is not None:
            own_masks.append(sel)
        qq = qh * (sel if masks is None else masks[i])
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


def blocks_differing(a, b, block_dims: int):
    """Per row (T,): the dim-blocks, over layers, KV heads and query heads,
    that one list of per-layer masks selects and the other does not."""
    import torch
    d = a[0].shape[-1]
    return sum((x != y).reshape(*x.shape[:-1], d // block_dims,
                                block_dims).any(-1).sum(dim=(0, 2, 3, 4))
               for x, y in zip(a, b)).to(torch.int64)


def probe(block_dims: int, card: str, extra=()) -> list:
    import torch
    from repro_torch.configs import CacheSpec, QuantSpec
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import ContinuousBatchingEngine
    run = launcher.main(LAUNCHER_ARGS + ["--block-dims", str(block_dims),
                                         *extra])
    eng = run.engine
    dtype = eng.cfg.dtype
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
        own = []
        ref = reference_logits(eng, seq, plen, own_masks=own)  # (n + 1, V)
        line = dict(block_dims=block_dims, uid=u, prompt_len=plen,
                    first_parting_token=part, rows_compared=n + 1)
        for name, (toks, logits) in drives.items():
            errs = [float((logits[u][j].double() - ref[j]).abs().max()
                          / ref[j].abs().max()) for j in range(n + 1)]
            line[name] = dict(worst_err_over_row_max=max(errs), errs=errs,
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
        if block_dims > 1:
            mine = engine_masks(eng, seq, plen)
            diff = blocks_differing(own, mine, block_dims)
            aq, att = eng.cfg.aqua, eng.cfg.attention
            per_row = (eng.cfg.num_layers * att.num_heads
                       * aq.topk_dims(att.head_dim) // block_dims)
            same_sel = reference_logits(eng, seq, plen, masks=mine)
            past = sorted({j for name in drives for j in range(n + 1)
                           if line[name]["errs"][j] > LOGIT_RTOL})
            line["selection"] = dict(
                selected_blocks_per_row=per_row,
                prompt_rows_share_differing=float(
                    diff[:plen].double().mean() / per_row),
                rows_past_limit=[dict(
                    row=j, position=plen - 1 + j,
                    blocks_differing=int(diff[plen - 1 + j]))
                    for j in past],
                with_engine_selection={
                    name: max(float((logits[u][j].double() - same_sel[j])
                                    .abs().max() / same_sel[j].abs().max())
                              for j in range(n + 1))
                    for name, (_, logits) in drives.items()})
            del same_sel, mine
        for name in drives:
            del line[name]["errs"]
        lines.append(line)
        print(json.dumps(line), flush=True)
        del ref, own
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
                   dtype=dtype, card=card)
    if block_dims > 1:
        past = [r for ln in lines for r in ln["selection"]["rows_past_limit"]]
        verdict.update(
            rows_past_limit=len(past),
            every_row_past_limit_selects_other_blocks=all(
                r["blocks_differing"] > 0 for r in past),
            within_limit_with_engine_selection=all(
                err <= LOGIT_RTOL for ln in lines
                for err in ln["selection"]["with_engine_selection"].values()))
    print(json.dumps({"verdict": verdict}), flush=True)
    return lines


def main() -> int:
    import subprocess
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block-dims", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--float32", action="store_true",
                    help="serve a synthetic full-width HF checkpoint "
                         "(float32 params and activations)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="the reduced config on the CPU (checks the script, "
                         "measures nothing)")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        for bd in args.block_dims:
            probe(bd, "cpu rehearsal", ("--device", "cpu", "--reduced"))
        return 0
    extra = ()
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
    if args.float32:
        extra = ("--hf-checkpoint", write_checkpoint())
    try:
        for bd in args.block_dims:
            probe(bd, card, extra)
    finally:
        if args.float32:
            import shutil
            shutil.rmtree(HF_DIR, ignore_errors=True)
    return 0


HF_DIR = os.path.join(ROOT, "build", "hf_divergence")


def write_checkpoint() -> str:
    """The synthetic HF checkpoint of ``--float32`` (Qwen3-0.6B's published
    geometry, tied, random bf16 weights from seed 0) in ``HF_DIR``."""
    from repro_torch.checkpoint.fixtures import write_hf_fixture
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-0.6b")
    att = cfg.attention
    write_hf_fixture(HF_DIR, seed=0, variant="sharded", tied=True,
                     dtype="bfloat16", device="cuda", config_overrides={
                         "_name_or_path": "qwen3-0.6b-synthetic",
                         "hidden_size": cfg.d_model,
                         "num_hidden_layers": cfg.num_layers,
                         "num_attention_heads": att.num_heads,
                         "num_key_value_heads": att.num_kv_heads,
                         "head_dim": att.head_dim,
                         "intermediate_size": cfg.d_ff,
                         "vocab_size": cfg.vocab_size,
                         "rope_theta": att.rope_theta,
                         "rms_norm_eps": cfg.norm_eps})
    return HF_DIR


if __name__ == "__main__":
    sys.exit(main())
