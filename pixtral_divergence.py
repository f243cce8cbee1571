#!/usr/bin/env python3
"""Pixtral-12B's admission logits on the card: the kernel path, its plain
version and a float32-activation plain reference, on the same weights.

    python3 pixtral_divergence.py

Loads Pixtral-12B at its published width and depth as ``chip_smoke.py``
does (random bf16 weights from seed 6, AQUA k_ratio 0.75 at block_dims 8,
projections calibrated on 320-token windows of
``corpora/calibration.txt`` with patches) and prefills its drive's first
three prompts (300/700/1000 tokens, bucket-padded to 16 with ragged
lengths, each with its own 256 patch embeddings) three ways: the
``aqua-block-sparse`` backend (the CUDA kernels, bf16), the
``aqua-block-sparse-plain`` backend (their plain versions, bf16) and the
plain backend with float32 activations over the same bf16 weights. Each
pair's worst logit difference is printed as a fraction of the limit
``chip_smoke.py`` holds drives to (5% of the reference row's largest
magnitude), with and without the patches and at k_ratio 0.75 and 1.0
(every dim-block selected: no selection to differ). Then, for the
300-token prompt with patches at k_ratio 0.75, the relative distance of
the three hidden states of its last valid row after every layer. Prints
one JSON line per case, then the card's name and power limit. Needs one
card (about 30 GB of device memory).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pixtral_divergence: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.models import build_model
    from repro_torch.models.transformer import block_forward, layer_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    mcfg, mparams, mproj = cs.load_model("pixtral-12b", 6, calib_seq=320)
    proj = mproj.p.cuda()
    reqs = cs.drive_trace(4, mcfg.vocab_size, (300, 700, 1000), mcfg=mcfg)

    def model(backend, dtype=None, k_ratio=0.75):
        cfg = dataclasses.replace(
            mcfg, attention=dataclasses.replace(mcfg.attention,
                                                backend=backend),
            aqua=dataclasses.replace(mcfg.aqua, k_ratio=k_ratio))
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        return build_model(cfg)

    def batch(r, patches=True):
        n = r.prompt_len
        toks = np.zeros((1, -(-n // 16) * 16), np.int32)
        toks[0, :n] = r.tokens
        out = {"tokens": torch.from_numpy(toks).cuda(),
               "lengths": torch.tensor([n], dtype=torch.int32,
                                       device="cuda")}
        if patches:
            out["patches"] = torch.from_numpy(
                r.extra_inputs["patches"]).cuda()
        return out

    def over_limit(got, want):
        return ((got - want).abs().max()
                / (cs.LOGIT_RTOL * want.abs().max())).item()

    for k_ratio in (0.75, 1.0):
        kernel = model("aqua-block-sparse", k_ratio=k_ratio)
        plain = model("aqua-block-sparse-plain", k_ratio=k_ratio)
        f32 = model("aqua-block-sparse-plain", "float32", k_ratio)
        for patches in (True, False):
            rows = []
            for r in reqs[:3]:
                bt = batch(r, patches)
                lk, lp, lf = (m.prefill(mparams, bt, 2048,
                                        aqua_proj=proj)[0].float()
                              for m in (kernel, plain, f32))
                rows.append(dict(prompt=r.prompt_len,
                                 kernel_vs_plain=over_limit(lk, lp),
                                 kernel_vs_f32=over_limit(lk, lf),
                                 plain_vs_f32=over_limit(lp, lf),
                                 argmax_agree=int(lk.argmax())
                                 == int(lp.argmax()) == int(lf.argmax())))
            print(json.dumps(dict(k_ratio=k_ratio, patches=patches,
                                  rows=rows)), flush=True)

    # the hidden state of the 300-token prompt's last valid row, layer by
    # layer, in the three ways
    bt = batch(reqs[0])
    last = reqs[0].prompt_len - 1
    states = {}
    for name, m in (("kernel", model("aqua-block-sparse")),
                    ("plain", model("aqua-block-sparse-plain")),
                    ("f32", model("aqua-block-sparse-plain", "float32"))):
        x = m._embed(mparams, bt)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device="cuda")
        states[name] = []
        for i in range(mcfg.num_layers):
            x, _ = block_forward(m.cfg, layer_params(mparams["layers"], i),
                                 x, pos, proj[i], bt["lengths"])
            states[name].append(x[0, last].float().clone())

    def dist(a, b, i):
        x, y = states[a][i], states[b][i]
        return ((x - y).norm() / y.norm()).item()
    print(json.dumps({"per_layer": [
        dict(layer=i, kernel_vs_plain=dist("kernel", "plain", i),
             kernel_vs_f32=dist("kernel", "f32", i),
             plain_vs_f32=dist("plain", "f32", i))
        for i in range(mcfg.num_layers)]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
