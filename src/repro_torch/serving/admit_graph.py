"""One monolithic admission of the serving engine as a captured CUDA graph,
one graph per prompt bucket.

Counterpart of the JAX engine's jitted admissions (``_admit`` and
``_admit_paged``): JAX compiles one program per bucket shape, with the
lane and the page-table row as traced arguments, so one program serves
every lane. Here one CUDA graph per bucket captures the admission through
the model's own entry points over the engine's one decode state:

* paged: install the lane's page-table row in every layer (JAX's
  ``_set_table_row``), ``model.prefill`` into a B=1 contiguous cache,
  ``model.graft_paged`` into the lane's pages;
* contiguous: ``model.prefill_into`` (prefill, then ``insert_lane``).

Its inputs live in static device buffers, filled from pinned host buffers
at each admission: the bucket-padded prompt (1, bucket) int32, its valid
length (1,) int32, the lane (1,) int64, paged, the page-table row
(pages_per_lane,) int32 and, for an admission that carries frontend
inputs (a VLM's patch embeddings), each of them as a float32 buffer of
its shape. Lane, row and frontend inputs are buffer contents, not
capture-time constants. An admission with frontend inputs and one without
are two programs (one splices, one does not), as under JAX's ``jit``: the
engine keeps a graph per bucket for each. Its output is the next-token logits (1, V)
float32; the lane is written in place. Sampling and the lane bookkeeping
stay on the host, as for the step graph (``serving/step_graph.py``).

A bucket's graph is captured at the bucket's first admission, as JAX
compiles a bucket's program at its first call: that admission runs
eagerly on a side stream and its logits are used; then the capture
records the same call, which executes nothing. Later admissions of the
bucket replay. The capture's launches are taken back out of
``kernels/_build.LAUNCHES``; each replay adds the launches the capture
recorded.

All of an engine's admission graphs share one memory pool (``pool``, a
``torch.cuda.graph_pool_handle()``): a graph's B=1 cache and activations
are dead once its replay has been grafted and its logits sampled, so the
pool holds about the largest bucket's working set, not the sum. So a
graph's logits are valid only until the next admission, of any bucket.

Nothing in the captured region reads a tensor value on the host
(``tests/test_torch_admit_graph.py`` runs it on the meta device). CUDA
only: a CPU state raises, and a failed capture raises (there is no eager
fallback).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import kvcache as kvc
from repro_torch.kernels import _build
from repro_torch.serving.step_graph import Staging, capture


def admission(model, params, state, aqua_proj, max_seq: int,
              tokens: torch.Tensor, lengths: Optional[torch.Tensor], lane,
              row: Optional[torch.Tensor] = None,
              num_slots: Optional[int] = None,
              extra: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
    """A monolithic admission, the one an :class:`AdmitGraph` captures:
    prefill ``tokens`` (1, T) of valid length ``lengths`` (1,) (None: all
    T, as window, H2O and encoder-decoder admissions run), with the
    frontend inputs ``extra`` in the batch, and graft the result into lane
    ``lane`` (a Python int or a (1,) device tensor) of ``state``, in place
    (paged: after installing the page-table ``row`` (NP,), grafting
    logical slots [0, ``num_slots``), T by default). Returns the logits
    (1, V) float32. Reads no tensor value on the host. Paged with ``lane``
    None: the pages ``row`` maps are written and no lane's row or count
    is touched (a mesh rank's replica of the pool, for a lane of another
    data rank)."""
    batch = dict(extra or {}, tokens=tokens)
    if lengths is not None:
        batch["lengths"] = lengths
    if row is None:
        return model.prefill_into(params, batch, max_seq, state, lane,
                                  aqua_proj=aqua_proj)[0]
    if lane is not None:
        kvc.install_table_row(state.layers, lane, row)
    logits, req_state = model.prefill(params, batch, max_seq,
                                      aqua_proj=aqua_proj)
    model.graft_paged(state, req_state, lane, tokens.shape[1]
                      if num_slots is None else num_slots, row)
    return logits


class AdmitGraph:
    """The admission of one prompt bucket, captured over ``state`` (the
    engine's ``DecodeState`` on a CUDA device)::

        graph = AdmitGraph(model, params, state, aqua_proj, bucket=512,
                           max_seq=2048, pool=pool)
        logits = graph.admit(prompt_np, lane, row_np)   # (1, V) float32

    ``frontend`` {name: shape}: the admission also takes those frontend
    inputs (``admit(..., extra={name: array})``; ``extra`` holds their
    buffers).

    The first ``admit`` runs eagerly and captures; later ones replay.
    ``logits`` is valid until the next admission of any graph sharing
    ``pool``. ``launches`` counts the kernel launches of one admission by
    body, ``capture_ms`` the host time of the first admission's eager
    run and the capture, ``pool_bytes`` the device memory the capture
    added to the shared pool."""

    def __init__(self, model, params, state, aqua_proj, bucket: int,
                 max_seq: int, pool=None,
                 frontend: Optional[Dict[str, tuple]] = None):
        device = state.layers.count.device
        if device.type != "cuda":
            raise ValueError(f"AdmitGraph captures a CUDA graph; the decode "
                             f"state lies on {device}")
        self.bucket = bucket
        self.pool = pool
        self.paged = isinstance(state.layers, kvc.PagedAttnCache)
        self.tokens = torch.zeros(1, bucket, dtype=torch.int32, device=device)
        self.lengths = torch.zeros(1, dtype=torch.int32, device=device)
        self.lane = torch.zeros(1, dtype=torch.int64, device=device)
        self.row = None
        buffers = dict(tokens=self.tokens, lengths=self.lengths,
                       lane=self.lane)
        if self.paged:
            self.row = torch.full((state.layers.pages_per_lane,), -1,
                                  dtype=torch.int32, device=device)
            buffers["row"] = self.row
        self.extra = {k: torch.zeros(shape, dtype=torch.float32,
                                     device=device)
                      for k, shape in (frontend or {}).items()}
        buffers.update(self.extra)
        self._staging = Staging(**buffers)
        self._device = device
        # what the admission runs on (no closure over self: a graph held
        # in a reference cycle would be freed by a cyclic collection,
        # which could fall inside another graph's capture)
        self._model, self._params, self._state = model, params, state
        self._proj, self._max_seq = aqua_proj, max_seq
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launches: Counter = Counter()
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def fill(self, prompt: np.ndarray, lane: int,
             row: Optional[np.ndarray] = None,
             extra: Optional[Dict[str, np.ndarray]] = None) -> None:
        """The admission's inputs into the static buffers: ``prompt`` (its
        ``len`` is the valid length; padded with zeros to the bucket),
        ``lane``, the page-table ``row`` (paged) and the frontend inputs
        ``extra`` (exactly the graph's)."""
        n = len(prompt)
        if not 1 <= n <= self.bucket:
            raise ValueError(f"prompt of {n} tokens in the {self.bucket}-"
                             f"token bucket")
        if (row is None) == self.paged:
            raise ValueError("a paged admission takes its page-table row, "
                             "a contiguous one none")
        if set(extra or {}) != set(self.extra):
            raise ValueError(f"frontend inputs {sorted(extra or {})} in a "
                             f"graph of {sorted(self.extra)}")
        toks = np.zeros((1, self.bucket), np.int32)
        toks[0, :n] = prompt
        values = dict(tokens=toks, lengths=n, lane=lane)
        if self.paged:
            values["row"] = row
        values.update(extra or {})
        self._staging.fill(**values)

    def admit(self, prompt: np.ndarray, lane: int,
              row: Optional[np.ndarray] = None,
              extra: Optional[Dict[str, np.ndarray]] = None) -> torch.Tensor:
        """One admission: fill the buffers, then replay (the first call:
        run eagerly and capture). Returns the logits (1, V) float32."""
        self.fill(prompt, lane, row, extra)
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        return self.logits

    def _call(self) -> torch.Tensor:
        return admission(self._model, self._params, self._state, self._proj,
                         self._max_seq, self.tokens, self.lengths, self.lane,
                         self.row, extra=self.extra)

    def _capture(self) -> torch.Tensor:
        (logits, self.graph, self.logits, self.launches, self.pool_bytes,
         self.capture_ms) = capture(self._call, self._device, self.pool)
        return logits
