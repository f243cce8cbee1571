"""One decode step of the serving engine as a captured CUDA graph.

Counterpart of the JAX engine's jitted decode step: where JAX compiles the
step once into one program, PyTorch captures it once into a CUDA graph and
replays it every step, so the ~150 kernels a layer launches from Python
become one graph launch. The graph holds the model step (embedding, every
layer's ``block_step`` with its decode kernel, the unembedding) over one
decode state, with its inputs in static buffers: the lanes' tokens (B,)
int32 and the write mask (B,) bool. Sampling, stop rules and the lane
bookkeeping stay on the host, as in the eager engine.

The graph holds the addresses of the state's tensors, of the params and of
the projections, so everything outside it must write them in place
(admission grafts, page tables, chunk tails, ``kvcache.reset_cache``), and
every step inside it must be free of host reads (``core/kvcache.py``).

Warm-up and capture follow PyTorch's recipe (one eager step on a side
stream, then ``torch.cuda.graph``), both with the write mask all False: a
step that no lane writes leaves the state as it was, bit for bit, while the
kernel builds, library loads and shared-memory attributes happen outside the
capture. Their launches are taken back out of ``kernels/_build.LAUNCHES``;
each replay adds the launches the capture recorded.

CUDA only: a CPU state raises, and a failed capture raises (there is no
eager fallback).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from repro_torch.kernels import _build


def capture(fn, device, pool=None) -> tuple:
    """PyTorch's recipe for capturing ``fn`` (no arguments, returns a
    tensor) into a CUDA graph: one eager call on a side stream, then the
    capture, which executes nothing. Returns (the eager call's output, the
    graph, the graph's output tensor, the launches the capture recorded by
    body, the device memory the capture reserved, the host ms of it all).
    The capture's launches are taken back out of ``_build.LAUNCHES``; the
    eager call's stay. ``pool``: a ``torch.cuda.graph_pool_handle()`` to
    share (None: the graph's own)."""
    t0 = time.perf_counter()
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        eager = fn()
    current.wait_stream(side)
    torch.cuda.synchronize(device)
    # garbage freed inside a capture (pinned buffers, events, graphs of
    # objects in reference cycles) invalidates it: collect it first
    gc.collect()
    # torch.cuda.graph empties the allocator's cache as it enters: do so
    # first, so what the capture reserves is its own pool's growth
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = _build.LAUNCHES.copy()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
        torch.cuda.synchronize(device)
        launches = _build.LAUNCHES - before
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(before)
    return (eager, graph, out, launches,
            torch.cuda.memory_reserved(device) - reserved,
            1e3 * (time.perf_counter() - t0))


class Staging:
    """A graph's static input buffers on the device, each filled from a
    pinned host twin: ``fill(name=value, ...)`` writes the values on the
    host and copies them without blocking, after the previous fill's
    copies have left the pinned buffers."""

    def __init__(self, **buffers: torch.Tensor):
        self.buffers = buffers
        self._host = {k: torch.empty_like(b, device="cpu").pin_memory()
                      for k, b in buffers.items()}
        self._copied = torch.cuda.Event()

    def fill(self, **values) -> None:
        self._copied.synchronize()
        for k, v in values.items():
            self._host[k].numpy()[...] = v
            self.buffers[k].copy_(self._host[k], non_blocking=True)
        self._copied.record()


class StepGraph:
    """``model.decode_step(params, state, tokens, aqua_proj, write_mask)``
    captured once over ``state`` (a ``DecodeState`` on a CUDA device)::

        graph = StepGraph(model, params, state, aqua_proj)
        logits = graph.replay(tokens_np, active_np)   # (B, V) float32

    ``logits`` is the graph's own output tensor: valid until the next
    replay. ``launches`` counts the kernel launches of one step by body,
    ``capture_ms`` the host time of warm-up and capture, ``pool_bytes``
    the device memory the capture reserved (the graph's private pool)."""

    def __init__(self, model, params, state, aqua_proj=None):
        device = state.layers.count.device
        if device.type != "cuda":
            raise ValueError(f"StepGraph captures a CUDA graph; the decode "
                             f"state lies on {device}")
        lanes = state.layers.count.shape[-1]
        self.tokens = torch.zeros(lanes, dtype=torch.int32, device=device)
        self.write_mask = torch.zeros(lanes, dtype=torch.bool, device=device)
        self._staging = Staging(tokens=self.tokens,
                                write_mask=self.write_mask)

        def step():
            return model.decode_step(params, state, self.tokens,
                                     aqua_proj=aqua_proj,
                                     write_mask=self.write_mask)[0]

        # the warm-up's launches are not the path's: take them out too
        before = _build.LAUNCHES.copy()
        try:
            (_, self.graph, self.logits, self.launches, self.pool_bytes,
             self.capture_ms) = capture(step, device)
        finally:
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(before)

    def replay(self, tokens: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """One decode step: ``tokens`` (B,) int32 and ``active`` (B,) bool
        (the write mask) from the host into the static buffers, then the
        graph. Returns the logits (B, V) float32, valid until the next
        replay."""
        self._staging.fill(tokens=tokens, write_mask=active)
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        return self.logits
