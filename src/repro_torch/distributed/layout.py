"""One rank's tensor-parallel layout of a transformer on a serving mesh.

GSPMD derives the collectives of a sharded program from the shardings of
its operands; the port names each one. :class:`MeshLayout` reads the
``param_pspec`` of every weight the serving path of the ``dense``,
``moe`` and ``vlm`` families touches and keeps what this rank holds and
what it must exchange over ``model`` (and, for MoE routing, over the
data axes):

* ``heads``: what ``wq`` shards, "kv" (KV heads, and their query groups
  with them), "group" (the query groups, where the KV heads do not
  divide: MQA) or None; the rank's attention config has that many heads;
* ``gather_kv``: ``wk``/``wv`` shard head_dim (KV heads not divisible):
  k and v are all-gathered right after the projection, since qk-norm and
  RoPE's rotate-half need the whole head_dim;
* ``reduce_attn`` / ``reduce_ffn``: ``wo`` / ``w2`` are row-parallel, so
  their outputs are partial sums, all-reduced over ``model``;
* ``embed_rows`` / ``embed_cols``: the embedding table shards the vocab
  (mask the tokens outside the shard, look up, all-reduce: exact) or
  d_model (look up, all-gather the columns); ``unembed_rows`` /
  ``unembed_cols`` the same for the unembedding matrix (local logits
  all-gathered in vocab order, or partial logits all-reduced);
* ``patch_cols`` (``vlm``): ``patch_proj`` (1024 -> d_model) falls to the
  generic rule and shards its output dim; the projected patches are
  all-gathered over ``model`` before the splice;
* the cross-head sums GSPMD would all-reduce silently: H2O's victim
  scores, hierarchical page ranking and hot residents' promotion mass sum
  over KV heads (:meth:`sum_heads`), H2O's accumulated mass over query
  heads (:meth:`sum_groups`);
* int8 pools: with ``scale_granularity="page_head"`` each page's scales
  shard with its KV heads (``k_scale``/``v_scale`` (P, KV)), so the
  per-page amax never leaves the rank: no collective. With ``"page"``
  (one scale per page, SH 1, replicated; ``scale_per_page``) the page
  amax of an admission and the running scale of a decode insert span KV
  heads on other ranks: :meth:`max_heads` takes the max over ``model``
  (all-reduce, op max), so every rank grows, and requantizes, the same
  pages by the same ratio;
* ``moe``: the router (d, E) shards E (``router_cols``): the local
  logits are all-gathered over ``model`` before the softmax and top-k
  (:meth:`router_logits`), so every rank routes alike. The experts
  (``experts``) are "ep" where ``model`` divides E (``w1``/``w3`` (E, d,
  f) shard E, ``expert_block``), "ff" where it does not (they shard f),
  or None. ``w2`` (E, f, d) shards f (``w2_rows``) whenever f divides,
  even under "ep": then the rank's experts' hidden ``h`` is all-gathered
  over ``model`` along E and its f-block multiplies the rank's ``w2``
  block. The expert outputs (and the shared experts' MLP, ordinary
  tensor parallelism: ``shared_tp``) are partial sums, all-reduced over
  ``model`` in one call. ``shared_gate`` (d, 1) is replicated.
  A decode step routes every lane as one block (``capacity`` and a
  token's slot depend on the block), so where lanes split over the data
  axes (``lanes``, set by the engine) the lanes' hidden states are
  all-gathered over ``pod`` x ``data`` in global lane order
  (:meth:`gather_lanes`), the block routed whole, and the rank keeps its
  rows; admissions (one row) need no data exchange.

It also carries the serving engine's per-engine fallback record
(``fallback_sink``, see ``core.attention.log_mesh_fallback``) and whether
decode may run the kernels on this mesh (``decode_kernel_reason`` None).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as dsh


def param_shapes(cfg) -> dict:
    """The param tree of ``cfg`` as meta-device tensors (shapes only)."""
    from repro_torch.models import build_model
    model = build_model(cfg, "cpu")
    model.device = torch.device("meta")
    return model.init(torch.Generator())


def spec_tree(tree, mesh, path=()) -> dict:
    """``param_pspec`` of every leaf of a param tree (same nesting)."""
    if isinstance(tree, dict):
        return {k: spec_tree(v, mesh, path + (k,)) for k, v in tree.items()}
    return dsh.param_pspec(path, tuple(tree.shape), mesh)


def _sharded_dim(spec) -> Optional[int]:
    """The dim a spec shards (counted from the end), or None."""
    for i, s in enumerate(spec):
        if s is not None:
            return i - len(spec)
    return None


def _block(spec, shape, mesh) -> Optional[Tuple[int, int]]:
    """(first index, length) of this rank's block along the sharded dim."""
    dim = _sharded_dim(spec)
    if dim is None:
        return None
    idx, n = dsh.block_index(spec[dim], mesh)
    size = shape[dim] // n
    return idx * size, size


@dataclasses.dataclass
class MeshLayout:
    mesh: object
    shapes: dict
    specs: dict
    heads: Optional[str]
    gather_kv: bool
    reduce_attn: bool
    reduce_ffn: bool
    embed_rows: Optional[Tuple[int, int]]
    embed_cols: Optional[Tuple[int, int]]
    unembed_rows: Optional[Tuple[int, int]]
    unembed_cols: Optional[Tuple[int, int]]
    patch_cols: bool = False
    router_cols: Optional[Tuple[int, int]] = None
    experts: Optional[str] = None
    expert_block: Optional[Tuple[int, int]] = None
    w2_rows: Optional[Tuple[int, int]] = None
    shared_tp: bool = False
    lanes: Optional[Tuple[int, int]] = None
    scale_per_page: bool = False
    decode_kernel_reason: Optional[str] = None
    fallback_sink: set = dataclasses.field(default_factory=set)

    @classmethod
    def build(cls, cfg, mesh) -> "MeshLayout":
        """The layout of a ``dense``, ``moe`` or ``vlm`` ``cfg`` (a global
        config) on ``mesh``."""
        shapes = param_shapes(cfg)
        specs = spec_tree(shapes, mesh)
        attn = specs["layers"]["attn"]
        wq = attn["wq"]                                  # (L, M, KV, G, D)
        heads = ("kv" if wq[2] is not None else
                 "group" if wq[3] is not None else None)
        table = shapes["embed"]["table"]
        tspec = specs["embed"]["table"]
        utable, uspec = table, tspec
        if not cfg.tie_embeddings:
            utable, uspec = (shapes["unembed"]["table"],
                             specs["unembed"]["table"])
        rows_or_cols = [None, None, None, None]
        for i, (shape, spec) in enumerate(((table.shape, tspec),
                                           (utable.shape, uspec))):
            block = _block(spec, shape, mesh)
            if block is not None:
                rows_or_cols[2 * i + (_sharded_dim(spec) == -1)] = block
        ffn, ffn_shapes = specs["layers"]["ffn"], shapes["layers"]["ffn"]
        moe = {}
        if cfg.family == "moe":
            w1 = ffn["w1"]                               # (L, E, d, f)
            moe = dict(
                router_cols=_block(ffn["router"], ffn_shapes["router"].shape,
                                   mesh),
                experts=("ep" if w1[-3] is not None else
                         "ff" if w1[-1] is not None else None),
                expert_block=(_block(w1, ffn_shapes["w1"].shape, mesh)
                              if w1[-3] is not None else None),
                w2_rows=_block(ffn["w2"], ffn_shapes["w2"].shape, mesh),
                shared_tp="shared" in ffn and any(
                    s is not None for s in ffn["shared"]["w2"]))
        return cls(mesh=mesh, shapes=shapes, specs=specs, heads=heads,
                   gather_kv=attn["wk"][-1] is not None,
                   reduce_attn=any(s is not None for s in attn["wo"]),
                   reduce_ffn=any(s is not None for s in ffn["w2"]),
                   embed_rows=rows_or_cols[0], embed_cols=rows_or_cols[1],
                   unembed_rows=rows_or_cols[2],
                   unembed_cols=rows_or_cols[3],
                   patch_cols="patch_proj" in specs and any(
                       s is not None for s in specs["patch_proj"]["w"]),
                   **moe)

    # -- what this rank holds ------------------------------------------
    @property
    def model_size(self) -> int:
        return self.mesh.axis_size("model")

    def local_config(self, cfg):
        """``cfg`` with this rank's attention heads (the rank's model is
        built from it: its decode state holds the rank's KV heads)."""
        a = cfg.attention
        m = self.model_size
        kv = a.num_kv_heads // m if self.heads == "kv" else a.num_kv_heads
        group = a.group_size // m if self.heads == "group" else a.group_size
        return dataclasses.replace(cfg, attention=dataclasses.replace(
            a, num_heads=kv * group, num_kv_heads=kv))

    def check_params(self, params) -> dict:
        """``params`` as this rank's blocks (placed on the host by
        ``bridge.params_from_numpy(mesh=)``): raises on a leaf of another
        shape than its block. Entries the spec tree lacks (a float32
        unembedding) are dropped: they are remade from the rank's
        blocks."""
        def walk(tree, specs, shapes):
            if isinstance(tree, dict):
                return {k: walk(v, specs[k], shapes[k])
                        for k, v in tree.items() if k in specs}
            local = dsh.local_shape(shapes.shape, specs, self.mesh)
            if tuple(tree.shape) != local:
                raise ValueError(
                    f"param of shape {tuple(tree.shape)} is not this rank's "
                    f"block {local} of {tuple(shapes.shape)}: place the "
                    "params with bridge.params_from_numpy(mesh=)")
            return tree
        return walk(params, self.specs, self.shapes)

    def shard_projection(self, p: torch.Tensor) -> torch.Tensor:
        """The whole AQUA projections (L, KV, D, D) -> the rank's KV heads
        where heads shard by KV head, else whole."""
        kv = self.shapes["layers"]["attn"]["wk"].shape[2]
        if p.shape[1] != kv:
            raise ValueError(f"projections of {p.shape[1]} KV heads for a "
                             f"model of {kv}: pass the whole projections")
        if self.heads != "kv":
            return p
        m, i = self.model_size, self.mesh.axis_index("model")
        n = p.shape[1] // m
        return p.narrow(1, i * n, n).contiguous()

    # -- the collectives -------------------------------------------------
    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) over ``model``: returns the sum (a new
        contiguous tensor when ``x`` was not)."""
        x = x.contiguous()
        return collectives.all_reduce(x, self.mesh, "model")

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return collectives.all_gather(x, self.mesh, "model", dim=dim)

    def attn_out(self, y: torch.Tensor) -> torch.Tensor:
        """After ``wo`` (row-parallel): the all-reduce over ``model``."""
        return self.reduce(y) if self.reduce_attn else y

    def ffn_out(self, y: torch.Tensor) -> torch.Tensor:
        """After the MLP's ``w2`` (row-parallel)."""
        return self.reduce(y) if self.reduce_ffn else y

    def kv_full(self, t: torch.Tensor) -> torch.Tensor:
        """k or v (..., D / model) after the projection -> (..., D)."""
        return self.gather(t, -1) if self.gather_kv else t

    def sum_heads(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over KV heads (H2O's victim scores, page ranking) made
        whole: KV heads shard over ``model``."""
        return self.reduce(x) if self.heads == "kv" else x

    def max_heads(self, x: torch.Tensor) -> torch.Tensor:
        """A max over KV heads made whole where an int8 page has one scale
        (``scale_per_page``, set by the engine for granularity "page") and
        KV heads shard over ``model`` (a rank's one KV head of
        "page_head" keeps its own scale)."""
        if self.heads != "kv" or not self.scale_per_page:
            return x
        return collectives.all_reduce(x.contiguous(), self.mesh, "model",
                                      op="max")

    def sum_groups(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over the query heads of a KV head (H2O's accumulated mass)
        made whole: query groups shard over ``model``."""
        return self.reduce(x) if self.heads == "group" else x

    def embed(self, table: torch.Tensor, tokens: torch.Tensor, dtype
              ) -> torch.Tensor:
        """Token embeddings from this rank's block of the table."""
        if self.embed_rows is not None:
            lo, n = self.embed_rows
            idx = tokens.long() - lo
            inside = (idx >= 0) & (idx < n)
            x = table[idx.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
            return self.reduce(x).to(dtype)
        x = table[tokens.long()]
        if self.embed_cols is not None:
            x = self.gather(x, -1)
        return x.to(dtype)

    def unembed(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """float32 logits (..., V) from this rank's block ``w`` of the
        unembedding matrix (float32)."""
        if self.unembed_cols is not None:
            lo, n = self.unembed_cols
            return self.reduce(x.float()[..., lo:lo + n] @ w.T)
        logits = x.float() @ w.T
        if self.unembed_rows is not None:
            logits = self.gather(logits, -1)
        return logits

    def patches(self, pe: torch.Tensor) -> torch.Tensor:
        """Projected patches (..., d_model / model) -> (..., d_model)."""
        return self.gather(pe, -1) if self.patch_cols else pe

    # -- MoE ---------------------------------------------------------------
    def router_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The rank's experts' router logits (..., E / model) -> every
        expert's (..., E), in expert order."""
        return self.gather(logits, -1) if self.router_cols is not None \
            else logits

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """A decode step's rows of this rank's lanes (B / data, ...) ->
        every lane's (B, ...) in global lane order (``lanes`` set: lanes
        split over the data axes)."""
        return collectives.all_gather(x, self.mesh, self.mesh.data_axes,
                                      dim=0)
