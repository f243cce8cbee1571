"""Calibration corpus reader (port of the ``kind="corpus"`` source of the
JAX package's ``data/pipeline.py``), numpy only.

Windows are a pure function of (seed, step, row), so both packages draw
the same token windows from the same file.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Iterator

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


def calibration_batches(vocab_size: int, corpus_path: str, *,
                        num_batches: int = 4, batch: int = 2, seq: int = 128,
                        seed: int = 1234) -> Iterator[Dict[str, np.ndarray]]:
    """Calibration batches ({"tokens": (batch, seq) int32}) from a corpus
    file — the JAX ``calibration_batches`` with ``corpus_path`` set."""
    for i in range(num_batches):
        yield {"tokens": corpus_batch(corpus_path, vocab_size, seq, batch,
                                      seed, i)["tokens"]}
