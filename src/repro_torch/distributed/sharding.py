"""Sharding rules of the serving mesh (port of the JAX package's
``distributed/sharding.py``), as plain functions over ``{axis: size}``.

* ``pod`` x ``data`` is the data-parallel domain: the decode lanes.
* ``model`` carries tensor parallelism: KV heads (or query groups and
  head_dim where KV heads do not divide), the FFN hidden dim, the vocab.

A spec is a tuple with one entry per dim: None (whole), an axis name, or
a tuple of names (sharded over their product, the first major). Rules are
name and shape based and divisibility-sanitized exactly as in JAX: an
axis that does not divide its dim, or that the mesh lacks, falls back to
the next candidate or to replicated. ``mesh`` is anything with a
``shape`` dict (a :class:`~repro_torch.launch.mesh.Mesh`) or the dict
itself.

The port's placement: :func:`shard` cuts a tensor (or numpy array) to
this rank's contiguous block of a spec, :func:`unshard` all-gathers the
blocks back. ``zero1_pspec``, ``constrain_seq`` and ``constrain_lru_gate``
(training and GSPMD hints) come with training on a mesh.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[object, ...]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a mesh object or of the dict itself."""
    if isinstance(mesh, dict):
        return mesh
    return dict(mesh.shape)


def _names(s) -> tuple:
    return (s,) if isinstance(s, str) else tuple(s)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _names(axes))


def sanitize(spec: Sequence, shape: Sequence[int], mesh) -> Spec:
    """Drop spec entries whose mesh-axis size does not divide the dim, or
    that name an axis the mesh does not carry."""
    ms = mesh_shape(mesh)
    out = []
    for i in range(len(shape)):
        s = spec[i] if i < len(spec) else None
        if s is not None:
            if any(a not in ms for a in _names(s)):
                s = None
            elif shape[i] % _axis_size(ms, s) != 0:
                s = None
        out.append(s)
    return tuple(out)


def _spec_at(ndim: int, dim_from_end: int, axes) -> Spec:
    lst = [None] * ndim
    if 0 <= ndim + dim_from_end < ndim:
        lst[ndim + dim_from_end] = axes
    return tuple(lst)


def _first_feasible(cands: Sequence[Spec], shape, mesh) -> Spec:
    for c in cands:
        if len(shape) < len(c):
            continue
        if sanitize(c, shape, mesh) == (*c, *([None] * (len(shape)
                                                        - len(c)))):
            return sanitize(c, shape, mesh)
    return tuple([None] * len(shape))


def path_str(path) -> str:
    """A tree path (a "/"-joined string or a sequence of keys) as a
    string."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

_REPLICATED_NAMES = {"ln", "ln1", "ln2", "ln_x", "ln_f", "enc_ln", "q_norm",
                     "k_norm", "out_norm", "lam", "dt_bias", "b"}


def param_pspec(path, shape, mesh, model_axis: str = "model") -> Spec:
    """A parameter's spec by its name (the last path key) and shape."""
    name = path_str(path).split("/")[-1]
    nd = len(shape)
    m = model_axis
    if name in _REPLICATED_NAMES or nd == 0:
        return tuple([None] * nd)
    cands = {
        "wq": [_spec_at(nd, -3, m), _spec_at(nd, -2, m)],
        "wk": [_spec_at(nd, -2, m), _spec_at(nd, -1, m)],
        "wv": [_spec_at(nd, -2, m), _spec_at(nd, -1, m)],
        "wo": [_spec_at(nd, -4, m), _spec_at(nd, -3, m)],
        "bq": [_spec_at(nd, -3, m), _spec_at(nd, -2, m)],
        "bk": [_spec_at(nd, -2, m)],
        "bv": [_spec_at(nd, -2, m)],
        "w2": [_spec_at(nd, -2, m)],
        "router": [_spec_at(nd, -1, m)],
        "table": [_spec_at(nd, -2, m), _spec_at(nd, -1, m)],
        "pos": [_spec_at(nd, -1, m)],
        "wout": [_spec_at(nd, -2, m)],
        "out_proj": [_spec_at(nd, -2, m)],
        "a_log": [_spec_at(nd, -1, m)],
        "d_skip": [_spec_at(nd, -1, m)],
    }.get(name)
    if cands is None:
        if name in ("w1", "w3"):
            if nd >= 4:  # MoE experts (L, E, dm, f): EP first, then ff-TP
                cands = [_spec_at(nd, -3, m), _spec_at(nd, -1, m)]
            else:
                cands = [_spec_at(nd, -1, m)]
        else:
            # generic projections: shard the output dim
            cands = [_spec_at(nd, -1, m)]
    return _first_feasible(cands, shape, mesh)


# ---------------------------------------------------------------------------
# batch and decode-state rules
# ---------------------------------------------------------------------------


def data_axes(mesh) -> Tuple[str, ...]:
    ms = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in ms)


def batch_pspec(mesh, shape) -> Spec:
    """(B, ...) activations: the batch over pod x data if it divides, else
    over data alone."""
    dp = data_axes(mesh)
    spec = (dp, *([None] * (len(shape) - 1)))
    s = sanitize(spec, shape, mesh)
    if s[0] is None and len(dp) > 1:
        s = sanitize((dp[-1], *([None] * (len(shape) - 1))), shape, mesh)
    return s


def decode_state_pspec(path, shape, mesh, *, kv_shardable: bool = True,
                       batch_shardable: bool = True,
                       slot_absorb: bool = True,
                       model_axis: str = "model") -> Spec:
    """A decode-state leaf's spec by its name and shape (JAX's rules, leaf
    for leaf). Paged pools stay whole over the data axes (any lane may map
    any page) with KV heads over ``model``; page tables ride the lanes.
    With ``slot_absorb`` an unshardable batch or KV-head axis moves its
    mesh axes onto the slot axis (context parallelism); the port always
    serves ``slot_absorb=False`` (whole slot stripes on every rank)."""
    name = path_str(path).split("/")[-1]
    nd = len(shape)
    dp = data_axes(mesh)
    base = {
        "k": 4, "v": 4, "positions": 2, "count": 1, "acc_score": 3,
        "conv": 3, "state": 2,
    }.get(name)
    batch_ax = dp if batch_shardable else None
    kv_ax = model_axis if kv_shardable else None
    paged = {"k_pool": 4, "v_pool": 4, "acc_pool": 3, "pos_pool": 2,
             "page_table": 2, "k_scale": 2, "v_scale": 2,
             "k_hot": 4, "v_hot": 4, "hot_ids": 1}.get(name)
    if paged is not None:
        pad = [None] * (nd - paged)
        if name in ("k_pool", "v_pool", "k_hot", "v_hot"):
            spec = (*pad, None, kv_ax, None, None)
        elif name == "acc_pool":
            spec = (*pad, None, kv_ax, None)
        elif name == "page_table":
            spec = (*pad, batch_ax, None)
        elif name in ("k_scale", "v_scale"):
            spec = (*pad, None, kv_ax)
        elif name == "hot_ids":
            spec = (*pad, None)
        else:                                  # pos_pool ((L,) P, ps)
            spec = (*pad, None, None)
        return sanitize(spec, shape, mesh)
    slot_axes = tuple(
        ((() if batch_shardable else dp)
         + (() if kv_shardable else (model_axis,)))
        if slot_absorb else ())
    slot_ax = (slot_axes[0] if len(slot_axes) == 1 else slot_axes) \
        if slot_axes else None
    lead = nd - base if base is not None else 0
    pad = [None] * lead

    def build(*tail):
        return (*pad, *tail)
    if base is None:
        # extra entries (whisper cross K/V): (L, B, S_enc, KV, D)
        if nd >= 5:
            return sanitize((None, batch_ax, None, kv_ax, None), shape, mesh)
        return tuple([None] * nd)
    if name in ("k", "v"):
        spec = build(batch_ax, kv_ax, slot_ax, None)
    elif name == "positions":
        spec = build(batch_ax, slot_ax)
    elif name == "count":
        spec = build(batch_ax)
    elif name == "acc_score":
        spec = build(batch_ax, kv_ax, slot_ax)
    elif name == "conv":
        spec = build(batch_ax, None, model_axis)
    elif name == "state":
        if nd - lead >= 4 or nd >= 4:   # ssm ((L,) B, H, P, N)
            spec = (*([None] * (nd - 4)), batch_ax, model_axis, None, None)
        else:                           # rglru ((L,) B, W)
            spec = (*([None] * (nd - 2)), batch_ax, model_axis)
    else:
        spec = tuple([None] * nd)
    return sanitize(spec, shape, mesh)


def state_shardable(mesh, *, kv_heads: int, batch: int) -> Tuple[bool, bool]:
    """(kv_shardable, batch_shardable) of a decode state, as JAX's
    ``make_state_shardings`` decides them."""
    model = mesh_shape(mesh).get("model", 1)
    kv_ok = kv_heads > 0 and kv_heads % model == 0
    b_ok = batch % _axis_size(mesh, data_axes(mesh)) == 0
    return kv_ok, b_ok


# The paged decode kernel tiles each page into whole 8-token sequence
# blocks (JAX's TPU sublane granularity, kept as the same predicate).
KERNEL_PAGE_MULTIPLE = 8


def kernel_shardable(mesh, cfg, aqua=None, *, batch: Optional[int] = None,
                     page_size: Optional[int] = None) -> bool:
    """Can the attention kernels run on shard-local shapes under ``mesh``?
    JAX's geometry-only predicate: AQUA's kept dims tile into whole
    dim-blocks (``aqua`` given), a multi-row batch divides the data axes
    (``batch == 1``, an admission, replicates instead), and pages tile into
    :data:`KERNEL_PAGE_MULTIPLE`-token blocks (``page_size`` given)."""
    if mesh is None:
        return False
    if aqua is not None:
        if not aqua.enabled or aqua.block_dims < 1:
            return False
        if aqua.kept_dims(cfg.head_dim) % aqua.block_dims != 0:
            return False
    if batch is not None and batch > 1:
        if batch % _axis_size(mesh, data_axes(mesh)) != 0:
            return False
    if page_size is not None and page_size % KERNEL_PAGE_MULTIPLE != 0:
        return False
    return True


def lane_pspec(mesh, num_lanes: int) -> Spec:
    """(L,) per-lane vectors: over pod x data when divisible."""
    dp = data_axes(mesh)
    if not dp:
        return (None,)
    return sanitize((dp,), (num_lanes,), mesh)


def page_rank_pspec(mesh, batch: int) -> Spec:
    """(B, KP) hierarchical participating-page tables: lane-partitioned
    over pod x data like the page-table rows, width whole."""
    dp = data_axes(mesh)
    if not dp:
        return (None, None)
    return sanitize((dp, None), (batch, 1), mesh)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def block_index(spec_entry, mesh) -> Tuple[int, int]:
    """(this rank's block index, the number of blocks) along a dim sharded
    by ``spec_entry`` (a mesh object is needed: its coordinate)."""
    if spec_entry is None:
        return 0, 1
    idx, n = 0, 1
    for a in _names(spec_entry):
        size = mesh.axis_size(a)
        idx = idx * size + mesh.axis_index(a)
        n *= size
    return idx, n


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The block shape of ``shape`` under ``spec``."""
    return tuple(d // _axis_size(mesh, s) for d, s in zip(shape, spec))


def shard(x, spec: Spec, mesh):
    """This rank's contiguous block of ``x`` (a tensor or a numpy array)
    under ``spec``: a new contiguous tensor or array, ``x``'s own type."""
    for dim, s in enumerate(spec):
        idx, n = block_index(s, mesh)
        if n == 1:
            continue
        size = x.shape[dim] // n
        if isinstance(x, torch.Tensor):
            x = x.narrow(dim, idx * size, size)
        else:
            x = np.take(x, np.arange(idx * size, (idx + 1) * size), axis=dim)
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return np.ascontiguousarray(x)


def unshard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (an
    all-gather over each sharded dim's axes)."""
    from repro_torch.distributed.collectives import all_gather
    for dim, s in enumerate(spec):
        if s is not None:
            x = all_gather(x, mesh, _names(s), dim=dim)
    return x
