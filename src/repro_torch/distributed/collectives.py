"""Collectives over a named axis of a :class:`~repro_torch.launch.mesh.Mesh`.

The port's counterparts of what GSPMD inserts implicitly in the JAX
package: an all-reduce (sum or max) and an all-gather over ``model``
(tensor parallelism) or over the data axes (``pod`` x ``data``: the
decode lanes' sampled tokens). Each call goes straight to the axis's
process group (never the default group) and waits at most the mesh's
``timeout``; an axis of size 1 is the identity.

Gloo takes CUDA tensors for every collective used here (``allreduce``
with sum and max, ``allgather``; float32 and bfloat16), so the tensors
stay on their device on either backend.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axis: Axes) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _wait(work, mesh) -> None:
    work.wait(mesh.timeout)


def all_reduce(t: torch.Tensor, mesh, axis: Axes,
               op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over ``axis`` (a name, or several, reduced one
    after another) with ``op`` ("sum" or "max"); returns ``t``."""
    opts = dist.AllreduceOptions()
    opts.reduceOp = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in _axes(axis):
        pg = mesh.group(a)
        if pg is None:
            continue
        if not t.is_contiguous():
            raise ValueError("all_reduce needs a contiguous tensor")
        _wait(pg.allreduce([t], opts), mesh)
    return t


def _gather_one(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    pg = mesh.group(axis)
    if pg is None:
        return t
    src = t.contiguous()
    outs = [torch.empty_like(src) for _ in range(mesh.axis_size(axis))]
    _wait(pg.allgather([outs], [src]), mesh)
    return torch.cat(outs, dim=dim)


def all_gather(t: torch.Tensor, mesh, axis: Axes, dim: int = 0
               ) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim`` in the order of its
    index on ``axis``; several axes (``("pod", "data")``) gather in their
    flattened order, the last axis fastest. Returns a new tensor (``t``
    itself on an axis of size 1)."""
    for a in reversed(_axes(axis)):
        t = _gather_one(t, mesh, a, dim)
    return t


def from_rank0(t: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (a new tensor): every other rank
    contributes zeros to an all-reduce over each axis, which adds exactly
    nothing. For what each rank computes alike but must hold bit for bit
    alike (calibrated projections)."""
    out = t.clone() if mesh.rank == 0 else torch.zeros_like(t)
    return all_reduce(out.contiguous(), mesh, mesh.axes)

