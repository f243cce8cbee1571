#!/usr/bin/env python3
"""Where a train step of Qwen3-0.6B goes on one GPU.

    python3 train_profile.py

The setup of ``chip_smoke.py``'s training phase (full width and depth,
float32 params, bf16 compute, batch 8 of 64 tokens, ``lcg`` data), with
remat on and off: the host milliseconds (median of 3, synchronized) of
the forward alone, ``loss_and_grads``, ``adamw.global_norm``,
``adamw.update`` and the whole step, one JSON line each; then, with
remat on, ``torch.profiler`` over 2 steps: the device busy milliseconds
and device operations a step, and the profiler's tables by device and by
host time. Needs a CUDA device (exits non-zero without one); imports
nothing of JAX.
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))


def median_ms(fn, n: int = 3):
    import torch
    out, r = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return sorted(out)[n // 2], r


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import Trainer, loss_and_grads
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import cosine_with_warmup
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for remat in (True, False):
        mcfg = dataclasses.replace(get_config("qwen3-0.6b"), remat=remat)
        tcfg = TrainConfig(total_steps=10, warmup_steps=1)
        tr = Trainer(mcfg, tcfg, DataConfig(mcfg.vocab_size, 64, 8))
        st = tr.init_state(0)
        batch = tr.batch(0)
        fwd, _ = median_ms(lambda: tr.model.loss(st.params, batch))
        grads_ms, (_, g) = median_ms(
            lambda: loss_and_grads(tr.model, st.params, batch))
        norm_ms, _ = median_ms(lambda: adamw.global_norm(g))
        upd_ms, _ = median_ms(lambda: adamw.update(
            st.params, g, st.opt, cosine_with_warmup(st.step, tcfg), tcfg))
        step = tr._step_fn
        step_ms, _ = median_ms(lambda: step(st, batch))
        print(json.dumps(dict(remat=remat, forward_ms=fwd,
                              loss_and_grads_ms=grads_ms,
                              global_norm_ms=norm_ms, update_ms=upd_ms,
                              step_ms=step_ms)), flush=True)
        if remat:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    step(st, batch)
                torch.cuda.synchronize()
            ka = prof.key_averages()
            print(json.dumps({
                "device_busy_ms_per_step": sum(
                    e.self_device_time_total for e in ka) / 2 / 1e3,
                "device_ops_per_step": sum(
                    e.count for e in ka if e.device_type
                    == torch.autograd.DeviceType.CUDA) / 2}), flush=True)
            print(ka.table(sort_by="self_device_time_total", row_limit=25))
            print(ka.table(sort_by="self_cpu_time_total", row_limit=25))
        del tr, st, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
