"""Shared model layers: norms, MLP, embeddings, the loss (PyTorch port).

On a serving mesh ``tp`` (a ``distributed.layout.MeshLayout``) is this
rank's layout: the MLP's ``w2`` is row-parallel (its output all-reduced
over ``model``), and the embedding and unembedding take the rank's block
of the vocab (or of d_model) with the exchange the layout names."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.attention import rms_norm  # noqa: F401  (re-export)

def _normal(gen, shape, std, dtype, device):
    return torch.randn(*shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(std).to(dtype)


def act_fn(name: str):
    """The MLP activation by ``ModelConfig.act`` name (JAX's ``gelu`` is
    the tanh approximation)."""
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device=None, gated: bool = True) -> dict:
    """MLP weights (w1 in, w2 down; a gated MLP adds w3 up)."""
    p = {"w1": _normal(gen, (d_model, d_ff), d_model ** -0.5, dtype, device),
         "w2": _normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype, device)}
    if gated:
        p["w3"] = _normal(gen, (d_model, d_ff), d_model ** -0.5, dtype,
                          device)
    return p


def mlp(p: dict, x: torch.Tensor, act: str = "silu", tp=None) -> torch.Tensor:
    """``act(x w1) [* x w3] w2``: gated where the params hold ``w3`` (the
    model makes them iff ``act == "silu"``, as in JAX)."""
    h = act_fn(act)(x @ p["w1"].to(x.dtype))
    if "w3" in p:
        h = h * (x @ p["w3"].to(x.dtype))
    y = h @ p["w2"].to(x.dtype)
    return y if tp is None else tp.ffn_out(y)


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype=torch.float32, device=None, bias: bool = False) -> dict:
    """A linear map ``w`` (d_in, d_out) [+ zero bias ``b``]."""
    p = {"w": _normal(gen, (d_in, d_out), d_in ** -0.5, dtype, device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def sinusoidal_positions(seq: int, d_model: int, device=None
                         ) -> torch.Tensor:
    """(seq, d_model) float32 sinusoidal position table: sin at the even
    columns, cos at the odd ones, frequencies 10000^(-2i/d_model)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            dim / d_model)
    pe = torch.zeros(seq, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, :d_model - d_model // 2])
    return pe


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32, device=None) -> dict:
    return {"table": _normal(gen, (vocab, d_model), d_model ** -0.5, dtype,
                             device)}


def embed(p: dict, tokens: torch.Tensor, dtype, tp=None) -> torch.Tensor:
    if tp is not None:
        return tp.embed(p["table"], tokens, dtype)
    return p["table"][tokens.long()].to(dtype)


def unembed(params: dict, table_key: str, x: torch.Tensor,
            tp=None) -> torch.Tensor:
    """Logits in float32 from the float32 (V, d) matrix that
    ``with_unembedding`` made once where ``params`` carry it, else from
    ``params[table_key]["table"]`` cast here (the same GEMM on the same
    values)."""
    w = params.get(UNEMBED_F32)
    if w is None:
        w = params[table_key]["table"].float()
    if tp is not None:
        return tp.unembed(w, x)
    return x.float() @ w.T


#: the params key of the float32 unembedding matrix (``with_unembedding``)
UNEMBED_F32 = "unembed_f32"


def with_unembedding(params: dict, tied: bool) -> dict:
    """``params`` plus the float32 (V, d) unembedding matrix under
    ``UNEMBED_F32``, made once where an engine takes its params instead of
    cast in every step and admission: a new dict (the caller's tree is
    left as it was) whose other entries are the caller's tensors. A
    float32 table is reused, not copied; params that already hold the
    matrix come back as they are. ``tied``: the table is the embedding's
    (else ``params["unembed"]``)."""
    if UNEMBED_F32 in params:
        return params
    table = params["embed" if tied else "unembed"]["table"]
    return {**params, UNEMBED_F32: table.float()}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy: logits (B, S, V) float32, labels (B,
    S) int; with ``mask`` (B, S) the mean over its weight (at least 1)."""
    logits = logits.float()
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
