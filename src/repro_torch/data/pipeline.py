"""Deterministic, stateless-indexed data pipeline (the JAX package's
``data/pipeline.py``): every batch is a pure function of (seed, step), so
a resumed run needs only its step counter.

Kinds: ``lcg`` (a learnable affine next-token language), ``uniform``
(i.i.d. tokens), ``copy`` (a random prefix of S/2 + 1 tokens and its
repeat, the loss masked to the attention-dependent second half) and
``corpus`` (windows of a tokenized file). Batches are numpy arrays:
"tokens" and "labels" (B, S) int32, and the copy task's "loss_mask" (B,
S) float32.

``corpus`` windows hash from (seed, step, row) exactly as JAX's, so both
packages draw the same tokens from the same file. The synthetic kinds
follow JAX's shapes, ranges and rules but draw from a numpy
``Generator`` seeded with (seed, step), not from ``jax.random``: other
values (the rule ``data/corpus.py`` follows for the LCG language).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data import corpus
from repro_torch.data.corpus import add_frontend_inputs  # noqa: F401

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lcg"  # lcg | uniform | copy | corpus
    corpus_path: Optional[str] = None  # required for kind="corpus"


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng([cfg.seed, step])


def lcg_batch(cfg: DataConfig, step: int) -> Batch:
    """tokens[t+1] = (a * tokens[t] + c) mod V with per-row (a, c)."""
    return corpus.lcg_batch(cfg.vocab_size, cfg.seq_len, cfg.global_batch,
                            cfg.seed, step)


def copy_batch(cfg: DataConfig, step: int) -> Batch:
    """A random prefix of ``(S + 1) // 2 + 1`` tokens followed by its
    repeat; ``loss_mask`` keeps the positions whose label lies in the
    repeat."""
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    half = (s + 1) // 2 + 1
    prefix = _rng(cfg, step).integers(0, v, (b, half), dtype=np.int32)
    seq = np.concatenate([prefix, prefix], axis=1)[:, :s + 1]
    mask = (np.arange(s) >= half - 1).astype(np.float32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:],
            "loss_mask": np.broadcast_to(mask, (b, s)).copy()}


def uniform_batch(cfg: DataConfig, step: int) -> Batch:
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    tokens = _rng(cfg, step).integers(0, v, (b, s + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def corpus_batch(cfg: DataConfig, step: int) -> Batch:
    """Windows of ``cfg.corpus_path`` whose starts hash from (seed, step,
    row): JAX's windows."""
    assert cfg.corpus_path is not None, 'kind="corpus" needs corpus_path'
    return corpus.corpus_batch(cfg.corpus_path, cfg.vocab_size, cfg.seq_len,
                               cfg.global_batch, cfg.seed, step)


_GENERATORS = {
    "lcg": lcg_batch,
    "uniform": uniform_batch,
    "copy": copy_batch,
    "corpus": corpus_batch,
}


def make_batch(cfg: DataConfig, step: int) -> Batch:
    return _GENERATORS[cfg.kind](cfg, step)


def calibration_batches(mcfg: ModelConfig, *, num_batches: int = 4,
                        batch: int = 2, seq: int = 128, seed: int = 1234,
                        corpus_path: Optional[str] = None
                        ) -> Iterator[Batch]:
    """Calibration batches for ``core.calibration.calibrate``: windows of
    ``corpus_path``, or without one the LCG language, each with the
    model's frontend inputs (``add_frontend_inputs``)."""
    return corpus.calibration_batches(
        mcfg.vocab_size, corpus_path, num_batches=num_batches, batch=batch,
        seq=seq, seed=seed, model_cfg=mcfg)
