"""Calibration sources (port of the ``kind="corpus"`` and ``kind="lcg"``
sources of the JAX package's ``data/pipeline.py``) and the stub modality
frontends' inputs (``add_frontend_inputs``), numpy only.

Corpus windows are a pure function of (seed, step, row), so both packages
draw the same token windows from the same file. The synthetic LCG
language follows the same affine rule as JAX's, but draws its
coefficients from a numpy ``Generator`` seeded with (seed, step), not from
``jax.random``: its tokens differ from the JAX package's. Likewise the
frontend inputs are standard normals from a numpy ``Generator`` seeded
with ``step + 7`` (JAX: ``jax.random.PRNGKey(step + 7)``), of the same
shapes, not the same values.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Iterator, Optional

import numpy as np


@functools.lru_cache(maxsize=8)
def load_token_corpus(path: str, vocab_size: int) -> np.ndarray:
    """1-D int32 token ids folded into ``vocab_size``: ``.npy``/``.npz``
    hold ids, ``.txt``/``.text`` are tokenized byte-level (one token per
    UTF-8 byte)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".npy", ".npz"):
        loaded = np.load(path)
        arr = loaded[loaded.files[0]] if hasattr(loaded, "files") else loaded
        ids = np.asarray(arr).reshape(-1)
        if not np.issubdtype(ids.dtype, np.integer):
            raise ValueError(f"token corpus {path!r} must hold integer ids")
    elif ext in (".txt", ".text"):
        with open(path, "rb") as f:
            ids = np.frombuffer(f.read(), dtype=np.uint8)
    else:
        raise ValueError(f"unsupported corpus format {ext!r} for {path!r} "
                         "(expected .npy/.npz token ids or .txt text)")
    return (ids.astype(np.int64) % vocab_size).astype(np.int32)


def corpus_batch(path: str, vocab_size: int, seq_len: int, batch: int,
                 seed: int, step: int) -> Dict[str, np.ndarray]:
    """Deterministic windows over a tokenized corpus: starts hash from
    (seed, step, row). Returns {"tokens", "labels"} (B, S) int32."""
    tokens = load_token_corpus(path, vocab_size)
    n = tokens.size - (seq_len + 1)
    if n <= 0:
        raise ValueError(f"corpus {path!r} has {tokens.size} tokens; "
                         f"need > seq_len + 1 = {seq_len + 2}")
    row = np.arange(batch, dtype=np.int64)
    mix = (seed * 1_000_003 + step * batch + row) * 2_654_435_761
    starts = (mix % n).astype(np.int64)
    windows = tokens[starts[:, None] + np.arange(seq_len + 1)[None, :]]
    return {"tokens": windows[:, :-1].astype(np.int32),
            "labels": windows[:, 1:].astype(np.int32)}


def lcg_batch(vocab_size: int, seq_len: int, batch: int, seed: int,
              step: int) -> Dict[str, np.ndarray]:
    """The synthetic LCG language: ``tokens[t+1] = (a * tokens[t] + c) mod
    V`` with per-row a in [1, min(V, 17)), c and tokens[0] in [0, V),
    drawn from ``default_rng([seed, step])``. Returns {"tokens",
    "labels"} (B, S) int32."""
    rng = np.random.default_rng([seed, step])
    a = rng.integers(1, min(vocab_size, 17), size=batch, dtype=np.int64)
    c = rng.integers(0, vocab_size, size=batch, dtype=np.int64)
    seq = np.empty((batch, seq_len + 1), np.int64)
    seq[:, 0] = rng.integers(0, vocab_size, size=batch, dtype=np.int64)
    for t in range(seq_len):
        seq[:, t + 1] = (a * seq[:, t] + c) % vocab_size
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


def add_frontend_inputs(batch: Dict[str, np.ndarray], cfg,
                        step: int = 0) -> Dict[str, np.ndarray]:
    """``batch`` plus the stub frontend inputs of model config ``cfg``
    (float32, batch size that of ``batch["tokens"]``): "patches" (B,
    num_embeds, embed_dim) for ``vision_patches``, "frames" (B,
    num_embeds, d_model) for ``audio_frames``, nothing otherwise."""
    fe = cfg.frontend
    width = {"vision_patches": fe.embed_dim,
             "audio_frames": cfg.d_model}.get(fe.kind)
    if width is not None:
        key = "patches" if fe.kind == "vision_patches" else "frames"
        batch[key] = np.random.default_rng(step + 7).standard_normal(
            (batch["tokens"].shape[0], fe.num_embeds, width),
            dtype=np.float32)
    return batch


def request_frontend_inputs(cfg, step: int = 0
                            ) -> Optional[Dict[str, np.ndarray]]:
    """One request's stub frontend inputs (batch 1, as
    ``Request.extra_inputs`` takes them) for ``cfg``, or None without a
    frontend."""
    if cfg.frontend.kind == "none":
        return None
    out = add_frontend_inputs({"tokens": np.zeros((1, 1), np.int32)}, cfg,
                              step)
    del out["tokens"]
    return out


def calibration_batches(vocab_size: int, corpus_path: Optional[str] = None,
                        *, num_batches: int = 4, batch: int = 2,
                        seq: int = 128, seed: int = 1234, model_cfg=None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Calibration batches ({"tokens": (batch, seq) int32}): windows of the
    corpus file at ``corpus_path``, or, without one, the synthetic LCG
    language — the JAX ``calibration_batches``. With ``model_cfg`` each
    batch carries its frontend inputs too (``add_frontend_inputs``, step
    = the batch's index)."""
    for i in range(num_batches):
        if corpus_path is None:
            tokens = lcg_batch(vocab_size, seq, batch, seed, i)["tokens"]
        else:
            tokens = corpus_batch(corpus_path, vocab_size, seq, batch, seed,
                                  i)["tokens"]
        out = {"tokens": tokens}
        if model_cfg is not None:
            add_frontend_inputs(out, model_cfg, i)
        yield out
