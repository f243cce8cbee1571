"""Training entry point of the port: the JAX package's ``launch/train.py``
(train step with gradient accumulation, checkpointing with auto-resume)
on one device.

The forward is differentiated by autograd through the attention
backends that have a reverse mode: under grad, ``auto`` resolves to
``dense`` (``aqua-masked-dense`` with AQUA on), JAX's ``auto`` off the
TPU and the only backends JAX differentiates; a kernel backend named in
the config raises ``NotImplementedError`` (the kernels have no reverse
mode, as JAX's Pallas kernels have none). A step updates the params and
the moments in place; the params never require grad (each step
differentiates through detached aliases of them), so a trained model
serves through the engines as it is. Meshes are not ported
(``NotImplementedError``).

CLI::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import (DataConfig, add_frontend_inputs,
                                       make_batch)
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.runtime import resolve_device


@dataclasses.dataclass
class TrainState:
    """params: the model's tree; step: 0-d int32 tensor."""

    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy (or any array) values as tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in batch.items()}


def loss_and_grads(model, params, batch):
    """(loss, grads): the loss of ``model.loss`` (detached) and its
    gradient per leaf, in each param's dtype (zeros for a param the loss
    does not reach, as ``jax.grad`` gives). ``params`` stay as they are:
    autograd runs through detached aliases that require grad, in grad
    mode whatever the caller's."""
    live = tree_lib.tree_map(lambda p: p.detach().requires_grad_(), params)
    keyed = tree_lib.items(live)
    with torch.enable_grad():
        loss, _ = model.loss(live, batch)
        grads = torch.autograd.grad(loss, [p for _, p in keyed],
                                    allow_unused=True)
    by_key = {k: torch.zeros_like(p) if g is None else g
              for (k, p), g in zip(keyed, grads)}
    return loss.detach(), tree_lib.map_with_path(lambda k, _: by_key[k],
                                                 params)


def make_train_step(model, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the state
    updated in place, metrics ``loss``, ``lr`` and ``grad_norm`` (before
    clipping) as 0-d tensors. ``tcfg.microbatches`` > 1 accumulates over
    that many slices of the batch (its leading dim must divide), each
    microbatch's loss and float32 grads divided by their number, as JAX's
    scan does. ``tcfg.grad_compress`` (the int8 error-feedback
    allreduce across a mesh) raises ``NotImplementedError``: the port
    trains on one device."""
    if tcfg.grad_compress:
        raise NotImplementedError(
            "grad_compress is not ported: it compresses the allreduce "
            "across a mesh, and the port trains on one device")

    def train_step(state: TrainState, batch):
        mb = tcfg.microbatches
        if mb > 1:
            loss = 0.0
            grads = tree_lib.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            for i in range(mb):
                micro = {k: v.reshape(mb, v.shape[0] // mb,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                lm, gm = loss_and_grads(model, state.params, micro)
                loss = loss + lm / mb
                grads = tree_lib.tree_map(lambda a, b: a + (b / mb).float(),
                                          grads, gm)
        else:
            loss, grads = loss_and_grads(model, state.params, batch)
        lr = cosine_with_warmup(state.step, tcfg)
        adamw.update(state.params, grads, state.opt, lr, tcfg)
        metrics = {"loss": loss, "lr": lr,
                   "grad_norm": adamw.global_norm(grads)}
        state.step += 1
        return state, metrics

    return train_step


class Trainer:
    """``run(steps)`` trains from the latest checkpoint in ``ckpt_dir``
    (or a fresh init from ``tcfg.seed``) on ``make_batch(dcfg, step)``.
    ``device`` None is the CUDA card (raises without one)."""

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig,
                 dcfg: DataConfig, ckpt_dir: Optional[str] = None,
                 mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh training is not ported: the port trains on one device")
        self.mcfg, self.tcfg, self.dcfg = mcfg, tcfg, dcfg
        self.device = resolve_device(device)
        self.model = build_model(mcfg, self.device)
        self.ckpt = (CheckpointManager(ckpt_dir, keep=tcfg.keep_checkpoints)
                     if ckpt_dir else None)
        self._step_fn = make_train_step(self.model, tcfg)

    def init_state(self, seed: int = 0) -> TrainState:
        """Params from ``LM.init`` with a ``torch.Generator`` seeded with
        ``seed`` on the model's device (other values than JAX's init for
        the same seed), zero moments, step 0."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen)
        return TrainState(params=params, opt=adamw.init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def restore_or_init(self) -> TrainState:
        state = self.init_state(self.tcfg.seed)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, step = self.ckpt.restore(None, state)
            print(f"[train] resumed from step {step}")
        return state

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch (with the model's frontend inputs) on the
        model's device."""
        batch = add_frontend_inputs(make_batch(self.dcfg, step), self.mcfg,
                                    step)
        return to_device(batch, self.device)

    def run(self, steps: int, log_every: int = 10):
        """Train ``steps`` steps past the restored one, saving every
        ``tcfg.checkpoint_every`` steps (on a thread) and at the end.
        Returns (state, the losses as floats)."""
        state = self.restore_or_init()
        start = int(state.step)
        t0 = time.time()
        losses = []
        for i in range(start, start + steps):
            state, metrics = self._step_fn(state, self.batch(i))
            losses.append(float(metrics["loss"]))
            if (i + 1) % log_every == 0:
                dt = (time.time() - t0) / max(i + 1 - start, 1)
                print(f"step {i+1} loss={losses[-1]:.4f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f} ms/step")
            if (self.ckpt is not None
                    and (i + 1) % self.tcfg.checkpoint_every == 0):
                self.ckpt.save(i + 1, state, blocking=False)
        if self.ckpt is not None:
            self.ckpt.wait()
            self.ckpt.save(start + steps, state, blocking=True)
        return state, losses


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    return ap


def main(argv=None):
    """Returns (state, losses)."""
    args = build_parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[train] {e} (--device cpu)") from None
    mcfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       microbatches=args.microbatches,
                       checkpoint_every=max(10, args.steps // 4))
    dcfg = DataConfig(vocab_size=mcfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    trainer = Trainer(mcfg, tcfg, dcfg, ckpt_dir=args.ckpt_dir, device=dev)
    state, losses = trainer.run(args.steps)
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    return state, losses


if __name__ == "__main__":
    main()
