"""Mixture-of-Experts FFN with blocked GShard-style dispatch (PyTorch port
of the JAX package's ``models/moe.py``).

Covers olmoe-1b-7b (64 experts, top-8) and qwen2-moe-a2.7b (60 experts,
top-4, plus a shared path). Tokens are routed in blocks of ``BLOCK``: each
block places its tokens into per-expert capacity buffers through a 0/1
dispatch tensor (T, G, E, C), every expert runs over its whole buffer,
and a combine tensor carrying the renormalized top-k weights brings the
outputs back. A token whose expert is full in its block drops that
choice. Everything is static in shape and reads no tensor on the host
(``topk_indices``, comparisons against ``arange``, ``cumsum``), so the
serving engine's CUDA graphs capture it. The einsums are plain products,
as in JAX, where no Pallas kernel computes them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.aqua import topk_indices
from repro_torch.models import layers as L

BLOCK = 128  # tokens per dispatch block

# Routing tapes by device (``RoutingTape.install``)
_TAPES: Dict[torch.device, "RoutingTape"] = {}


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class RoutingTape:
    """Every routing of a drive, on the device, in call order: each
    ``moe_ffn`` call's tokens' top-k experts (in choice order) and which
    choices kept a capacity slot, decode steps (S == 1: one row a lane)
    and admissions (up to ``rows`` rows: the call's tokens, pad rows too,
    which take capacity as real tokens do) apart. ``install("record")``
    records while routing as usual; ``install("replay")`` routes each call
    by the recording of the same call instead of by its own gates, which
    still weigh the choices: a second drive of one trace makes the same
    calls in the same order, so a drive whose rounding differs can be held
    to the first's routing. The call counters live on the device and
    every write is in place, so CUDA graphs captured while a tape is
    installed record and replay too (calls past the tape's length share
    its last slot); the tape must outlive such graphs. ``router``: the
    model's stacked (L, d, E) router, by which a call finds its layer."""

    def __init__(self, cfg, router: torch.Tensor, lanes: int, rows: int,
                 calls: int = 1024, admissions: int = 64):
        self.layers, self.lanes, self.rows = cfg.num_layers, lanes, rows
        self.num_experts, self.top_k = cfg.moe.num_experts, cfg.moe.top_k
        self._router = router
        dev = router.device
        self.topi = {True: torch.zeros(calls * self.layers, lanes,
                                       self.top_k, dtype=torch.int16,
                                       device=dev),
                     False: torch.zeros(admissions * self.layers, rows,
                                        self.top_k, dtype=torch.int16,
                                        device=dev)}
        self.kept = {d: torch.zeros(t.shape, dtype=torch.bool, device=dev)
                     for d, t in self.topi.items()}
        # rows each slot's call routed (its tokens, padded to whole blocks)
        self.n = {d: torch.zeros(t.shape[0], dtype=torch.int64, device=dev)
                  for d, t in self.topi.items()}
        self.calls = torch.zeros(2, dtype=torch.int64, device=dev)
        self.mode = "record"

    def install(self, mode: str) -> None:
        """Route the device's ``moe_ffn`` calls through this tape
        (``"record"`` or ``"replay"``) from call 0 on."""
        assert mode in ("record", "replay"), mode
        self.mode = mode
        self.calls.zero_()
        _TAPES[_key(self._router.device)] = self

    def remove(self) -> None:
        _TAPES.pop(_key(self._router.device), None)

    def latest(self, decode: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """(top-k experts (L, n, K) int64, kept (L, n, K) bool) of the
        latest decode step or admission (its n routed rows), read on the
        host."""
        c = 1 if decode else 0
        first = (int(self.calls[c]) - 1) * self.layers
        first = min(max(first, 0), self.topi[decode].shape[0] - self.layers)
        sl = slice(first, first + self.layers)
        n = int(self.n[decode][first])
        return (self.topi[decode][sl, :n].long().cpu(),
                self.kept[decode][sl, :n].cpu())

    def route(self, router: torch.Tensor, gates: torch.Tensor, top_k: int,
              cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        t, g, e = gates.shape
        stride = self._router.stride(0) * self._router.element_size()
        layer = (router.data_ptr() - self._router.data_ptr()) // stride
        decode = t == 1 and g == self.lanes
        c = 1 if decode else 0
        topi_tape, kept_tape = self.topi[decode], self.kept[decode]
        idx = (self.calls[c:c + 1] * self.layers + layer).clamp(
            max=topi_tape.shape[0] - 1)
        n = t * g
        if self.mode == "record":
            dispatch, combine, aux = blocked_dispatch(gates, top_k, cap)
            topi = topk_indices(gates, top_k)
            kept = torch.gather(dispatch.float().sum(-1) > 0, -1, topi)
            pad = (0, 0, 0, topi_tape.shape[1] - n)
            topi_tape.index_copy_(0, idx, F.pad(
                topi.reshape(n, top_k).to(torch.int16), pad)[None])
            kept_tape.index_copy_(0, idx, F.pad(kept.reshape(n, top_k),
                                                pad)[None])
            self.n[decode].index_fill_(0, idx, n)
        else:
            topi = topi_tape.index_select(0, idx)[0, :n].reshape(
                t, g, top_k).long()
            kept = kept_tape.index_select(0, idx)[0, :n].reshape(t, g, top_k)
            dispatch, combine, aux = _place(gates, topi, kept, cap)
        if layer == self.layers - 1:
            self.calls[c:c + 1].add_(1)
        return dispatch, combine, aux


def kept_counts(kept: torch.Tensor) -> Tuple[int, int]:
    """(choices kept, choices dropped) of ``kept`` rows of a tape."""
    placed = int(kept.sum())
    return placed, kept.numel() - placed
def init_moe_ffn(gen: torch.Generator, cfg, dtype, device) -> dict:
    """One layer's expert weights in ``dtype``, each drawn on its own (a
    float32 draw of one layer's (E, d, f) at a time, then cast); the
    router stays float32 whatever ``dtype`` is, as in JAX."""
    m = cfg.moe
    e, dm, f = m.num_experts, cfg.d_model, m.expert_ff
    std_in, std_out = dm ** -0.5, f ** -0.5
    p = {"router": L._normal(gen, (dm, e), std_in, torch.float32, device),
         "w1": L._normal(gen, (e, dm, f), std_in, dtype, device),
         "w3": L._normal(gen, (e, dm, f), std_in, dtype, device),
         "w2": L._normal(gen, (e, f, dm), std_out, dtype, device)}
    if m.num_shared > 0:
        p["shared"] = L.init_mlp(gen, dm, f * m.num_shared, dtype, device,
                                 gated=True)
        p["shared_gate"] = L._normal(gen, (dm, 1), std_in, dtype, device)
    return p


def capacity(cfg, g: int) -> int:
    """Slots per expert in a routing block of ``g`` tokens (a Python int
    from static shapes)."""
    m = cfg.moe
    return max(m.top_k,
               int(m.capacity_factor * m.top_k * g / m.num_experts) + 1)


def _place(gates: torch.Tensor, topi: torch.Tensor, keep: torch.Tensor,
           cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch and combine of the choices ``topi`` (T, G, K) that ``keep``
    allows, each in the next free slot of its expert (choice by choice,
    token by token), weighed by the gates renormalized over the top k;
    and the aux loss."""
    t, g, e = gates.shape
    topw = torch.gather(gates, -1, topi)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(e, device=gates.device)
    slots = torch.arange(cap, device=gates.device)
    counts = torch.zeros(t, e, dtype=torch.int32, device=gates.device)
    dispatch = torch.zeros(t, g, e, cap, dtype=torch.bfloat16,
                           device=gates.device)
    combine = torch.zeros(t, g, e, cap, dtype=torch.float32,
                          device=gates.device)
    for j in range(topi.shape[-1]):
        oh = (topi[..., j, None] == experts).to(torch.int32)    # (T, G, E)
        pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh \
            + counts[:, None, :]
        mypos = (oh * pos).sum(-1)                                # (T, G)
        ok = ((mypos < cap) & keep[..., j]).float()
        pos_oh = (mypos[..., None] == slots).float()             # (T, G, C)
        d_j = (oh.float()[..., None] * pos_oh[..., None, :]
               * ok[..., None, None])
        dispatch = dispatch + d_j.to(torch.bfloat16)
        combine = combine + d_j * topw[..., j, None, None]
        counts = counts + (oh * keep[..., j, None]).sum(dim=1,
                                                        dtype=torch.int32)
    me = gates.mean(dim=(0, 1))
    ce = (topi[..., 0, None] == experts).float().mean(dim=(0, 1))
    return dispatch, combine, e * torch.sum(me * ce)


def blocked_dispatch(gates: torch.Tensor, top_k: int, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates (T, G, E) float32 router probabilities per token block.

    Returns dispatch (T, G, E, C) 0/1 in bf16, combine (T, G, E, C)
    float32 and the load-balance aux loss. Slots go by choice order: all
    tokens' j-th choices of a block are placed, in token order, before
    any (j+1)-th choice; a choice whose expert is full drops."""
    topi = topk_indices(gates, top_k)                       # (T, G, K)
    return _place(gates, topi, torch.ones_like(topi, dtype=torch.bool), cap)


def moe_ffn(cfg, p: dict, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, M) -> (y (B, S, M), load-balance aux loss). The B·S tokens
    are routed in blocks of min(BLOCK, B·S), the last zero-padded: a
    decode step routes its lanes (idle ones too) as one block, an
    admission its bucket-padded rows (pad rows too)."""
    m = cfg.moe
    b, s, dm = x.shape
    n = b * s
    g = min(BLOCK, n)
    pad = (-n) % g
    xf = x.reshape(n, dm)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    t = xf.shape[0] // g
    xb = xf.reshape(t, g, dm)
    gates = torch.softmax(xb.float() @ p["router"].float(), dim=-1)
    tape = _TAPES.get(x.device)
    if tape is None:
        dispatch, combine, aux = blocked_dispatch(gates, m.top_k,
                                                  capacity(cfg, g))
    else:
        dispatch, combine, aux = tape.route(p["router"], gates, m.top_k,
                                            capacity(cfg, g))
    ein = torch.einsum("tgec,tgm->tecm", dispatch.to(x.dtype), xb)
    h = F.silu(torch.einsum("tecm,emf->tecf", ein, p["w1"].to(x.dtype)))
    h = h * torch.einsum("tecm,emf->tecf", ein, p["w3"].to(x.dtype))
    eout = torch.einsum("tecf,efm->tecm", h, p["w2"].to(x.dtype))
    y = torch.einsum("tgec,tecm->tgm", combine.to(x.dtype), eout)
    y = y.reshape(-1, dm)[:n]
    if m.num_shared > 0:
        g_sh = torch.sigmoid(xf[:n] @ p["shared_gate"].to(x.dtype))
        y = y + g_sh * L.mlp(p["shared"], xf[:n], "silu")
    return y.reshape(b, s, dm), aux


