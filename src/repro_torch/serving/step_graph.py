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

import time
from collections import Counter

import numpy as np
import torch

from repro_torch.kernels import _build


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
        self._host_tokens = torch.zeros(lanes, dtype=torch.int32,
                                        pin_memory=True)
        self._host_mask = torch.zeros(lanes, dtype=torch.bool,
                                      pin_memory=True)
        self._copied = torch.cuda.Event()

        def step():
            return model.decode_step(params, state, self.tokens,
                                     aqua_proj=aqua_proj,
                                     write_mask=self.write_mask)[0]

        t0 = time.perf_counter()
        before = _build.LAUNCHES.copy()
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            # torch.cuda.graph empties the allocator's cache as it enters:
            # do so first, so what the capture reserves is its own pool
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            warm = _build.LAUNCHES.copy()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits = step()
            torch.cuda.synchronize(device)
            self.launches: Counter = _build.LAUNCHES - warm
        finally:
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(before)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.capture_ms = 1e3 * (time.perf_counter() - t0)

    def replay(self, tokens: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """One decode step: ``tokens`` (B,) int32 and ``active`` (B,) bool
        (the write mask) from the host into the static buffers, then the
        graph. Returns the logits (B, V) float32, valid until the next
        replay."""
        # the previous step's copies must have left the pinned buffers
        self._copied.synchronize()
        self._host_tokens.numpy()[:] = tokens
        self._host_mask.numpy()[:] = active
        self.tokens.copy_(self._host_tokens, non_blocking=True)
        self.write_mask.copy_(self._host_mask, non_blocking=True)
        self._copied.record()
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        return self.logits
