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

On a serving mesh (``tp``, a ``distributed.layout.MeshLayout``) the
rank holds its blocks of the router and the experts, and
:func:`moe_ffn` runs the collectives the layout names: the router
logits all-gathered over ``model`` (every rank routes alike), the
expert-parallel hidden states all-gathered along E where ``w2`` shards
f, the expert and shared outputs' partial sums all-reduced; a decode
step's lanes are gathered over the data axes and routed as one global
block, as one device routes them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.aqua import topk_indices
from repro_torch.models import layers as L

BLOCK = 128  # tokens per dispatch block

# Routing tapes by device and mesh rank (``RoutingTape.install``)
_TAPES: Dict[tuple, "RoutingTape"] = {}


def _key(device, mesh=None) -> tuple:
    """A tape's key: its device, and the rank where a mesh installs it
    (ranks that are threads of one process share a device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, None if mesh is None else mesh.rank


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
    model's stacked (L, d, E) router, by which a call finds its layer (a
    mesh rank's block of it: (L, d, E / model)). ``mesh``: the rank whose
    calls the tape takes (None: one device); ``lanes`` counts every lane
    of the decode batch, which a mesh routes as one block."""

    def __init__(self, cfg, router: torch.Tensor, lanes: int, rows: int,
                 calls: int = 1024, admissions: int = 64, mesh=None):
        self.layers, self.lanes, self.rows = cfg.num_layers, lanes, rows
        self._mesh = mesh
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
        _TAPES[_key(self._router.device, self._mesh)] = self

    def remove(self) -> None:
        _TAPES.pop(_key(self._router.device, self._mesh), None)

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


def moe_ffn(cfg, p: dict, x: torch.Tensor, tp=None, decode: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, M) -> (y (B, S, M), load-balance aux loss). The B·S tokens
    are routed in blocks of min(BLOCK, B·S), the last zero-padded: a
    decode step routes its lanes (idle ones too) as one block, an
    admission its bucket-padded rows (pad rows too).

    ``tp``: this rank's mesh layout (``p`` the rank's blocks; see the
    module docstring). ``decode``: ``x`` holds a decode step's lanes, one
    row each; where they split over the data axes (``tp.lanes``) every
    lane is gathered and routed in one block, and the rank's rows come
    back."""
    m = cfg.moe
    lanes = None
    if tp is not None and decode and tp.lanes is not None:
        lanes = tp.lanes
        x = tp.gather_lanes(x)
    b, s, dm = x.shape
    n = b * s
    g = min(BLOCK, n)
    pad = (-n) % g
    xf = x.reshape(n, dm)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    t = xf.shape[0] // g
    xb = xf.reshape(t, g, dm)
    logits = xb.float() @ p["router"].float()
    if tp is not None:
        logits = tp.router_logits(logits)
    gates = torch.softmax(logits, dim=-1)
    tape = _TAPES.get(_key(x.device, None if tp is None else tp.mesh))
    if tape is None:
        dispatch, combine, aux = blocked_dispatch(gates, m.top_k,
                                                  capacity(cfg, g))
    else:
        dispatch, combine, aux = tape.route(p["router"], gates, m.top_k,
                                            capacity(cfg, g))
    ep = tp is not None and tp.expert_block is not None
    if ep:
        # the rank's experts' capacity buffers only
        lo, ne = tp.expert_block
        dispatch = dispatch[:, :, lo:lo + ne]
    ein = torch.einsum("tgec,tgm->tecm", dispatch.to(x.dtype), xb)
    h = F.silu(torch.einsum("tecm,emf->tecf", ein, p["w1"].to(x.dtype)))
    h = h * torch.einsum("tecm,emf->tecf", ein, p["w3"].to(x.dtype))
    w2 = p["w2"]
    if ep and tp.w2_rows is not None:
        # w2 shards f: every expert's h, the rank's block of f
        lo_f, nf = tp.w2_rows
        h = tp.gather(h, 1)[..., lo_f:lo_f + nf]
    elif ep:
        combine = combine[:, :, lo:lo + ne]
        w2 = w2[lo:lo + ne]
    eout = torch.einsum("tecf,efm->tecm", h, w2.to(x.dtype))
    y = torch.einsum("tgec,tecm->tgm", combine.to(x.dtype), eout)
    y = y.reshape(-1, dm)[:n]
    # partial sums over model: the rank's experts (EP) or w2's f block
    # (expert-ff TP, or EP with w2 on f), and the shared MLP's
    # row-parallel w2
    partial = ep or (tp is not None and tp.w2_rows is not None)
    if m.num_shared > 0:
        g_sh = torch.sigmoid(xf[:n] @ p["shared_gate"].to(x.dtype))
        sh = g_sh * L.mlp(p["shared"], xf[:n], "silu")
        if tp is not None and tp.shared_tp != partial:
            sh = tp.reduce(sh) if tp.shared_tp else sh
            y = tp.reduce(y) if partial else y
            partial = False
        y = y + sh
    if partial:
        y = tp.reduce(y)
    y = y.reshape(b, s, dm)
    if lanes is not None:
        y = y[lanes[0]:lanes[0] + lanes[1]]
    return y, aux
