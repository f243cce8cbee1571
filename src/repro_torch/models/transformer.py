"""Transformer LMs (PyTorch port of ``models/transformer.py``):
``DenseLM`` for the ``dense``, ``moe`` and ``vlm`` families — the first two
differ only in the block's FFN (a dense MLP, or the routed experts of
``models/moe.py``), the VLM splices projected patch embeddings over the
first prompt positions — and ``EncDecLM``, the whisper-style
encoder-decoder.

Params keep the JAX package's tree and layouts — layers stacked on a
leading axis — so ``repro_torch.bridge.params_from_numpy`` can load a JAX
param tree unchanged. A Python loop over layers replaces ``lax.scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import attention as attn
from repro_torch.core import aqua as aqua_lib
from repro_torch.core import kvcache as kv
from repro_torch.core.h2o import h2o_budget
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.base import LM, DecodeState, remat


def layer_params(tree, i: int):
    """Layer ``i``'s views of a stacked param tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_layers(tree, n: int) -> list:
    """Every layer's views of a stacked param tree at once
    (``torch.unbind``): under autograd its backward stacks the layers'
    gradients once, where :func:`layer_params` layer by layer adds each
    into a zero tensor of the whole stack (traffic quadratic in depth)."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def init_block(gen: torch.Generator, cfg, dtype, device) -> dict:
    if cfg.family == "moe":
        ffn = moe_lib.init_moe_ffn(gen, cfg, dtype, device)
    else:
        ffn = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                         gated=cfg.act == "silu")
    return {
        "ln1": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "attn": attn.init_attention_params(gen, cfg.d_model, cfg.attention,
                                           dtype, device),
        "ffn": ffn,
    }


def _stack_layers(make, n: int):
    """The trees ``make()`` returns for ``n`` layers, stacked on a leading
    axis: each layer is written into the stack as it is made, so the
    peak is the stack plus one layer (a Qwen2-MoE's experts are 25 GB in
    bf16)."""
    first = make()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + t.shape)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


def ffn_apply(cfg, p: dict, x: torch.Tensor, tp=None, decode: bool = False):
    """The block's FFN: (y, the MoE layer's load-balance aux loss), the
    loss None for a dense MLP. ``tp``: the rank's mesh layout; ``decode``:
    ``x`` is a decode step's lanes (an MoE routes them as one block, on a
    mesh gathered over the data axes)."""
    if cfg.family == "moe":
        return moe_lib.moe_ffn(cfg, p, x, tp, decode)
    return L.mlp(p, x, cfg.act, tp), None


def block_forward(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  proj: Optional[torch.Tensor],
                  lengths: Optional[torch.Tensor] = None, tp=None):
    """One block over a sequence. Returns (x, aux) where aux holds the
    attention's q/k (capture), the layer's cache-form k̂ and v, and the
    FFN's ``aux_loss`` (None for a dense MLP)."""
    h_in = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    h, aux = attn.prefill_attention(p["attn"], h_in, cfg.attention, cfg.aqua,
                                    proj, positions, return_aux=True,
                                    lengths=lengths, tp=tp)
    x = x + h
    f, aux["aux_loss"] = ffn_apply(cfg, p["ffn"],
                                   L.rms_norm(x, p["ln2"], cfg.norm_eps), tp)
    return x + f, aux


def _block_slim(cfg, p, x, positions, proj, lengths=None, tp=None):
    """:func:`block_forward` keeping only the FFN's ``aux_loss``."""
    x, aux = block_forward(cfg, p, x, positions, proj, lengths, tp)
    return x, aux["aux_loss"]


def check_splice(seq_len: int, num_embeds: int) -> None:
    """A (bucket-padded) prompt of ``seq_len`` tokens takes ``num_embeds``
    patch embeddings over its first positions only if it is at least that
    long: JAX's ``x.at[:, :n].set(pe)`` raises otherwise, and so does the
    port."""
    if seq_len < num_embeds:
        raise ValueError(
            f"a {seq_len}-token prompt cannot take the {num_embeds} patch "
            "embeddings spliced over its first positions: it must be at "
            "least as long (after bucket padding)")


def _stack_caches(caches) -> kv.AttnCache:
    """Per-layer B-lane contiguous caches stacked on a leading layer axis."""
    return kv.AttnCache(*(None if ts[0] is None else torch.stack(ts)
                          for ts in zip(*(kv._tensors(c) for c in caches))))


def block_step(cfg, p: dict, x_t: torch.Tensor, cache,
               proj: Optional[torch.Tensor],
               write_mask: Optional[torch.Tensor] = None,
               token_sparsity=None, tp=None) -> torch.Tensor:
    h = attn.decode_attention(p["attn"], L.rms_norm(x_t, p["ln1"],
                                                    cfg.norm_eps),
                              cache, cfg.attention, cfg.aqua, proj,
                              write_mask=write_mask,
                              token_sparsity=token_sparsity, tp=tp)
    x = x_t + h
    # the lanes, idle ones too, are one (B, 1) sequence batch: an MoE
    # routes them as one block
    f, _ = ffn_apply(cfg, p["ffn"],
                     L.rms_norm(x, p["ln2"], cfg.norm_eps)[:, None], tp,
                     decode=True)
    return x + f[:, 0]


class DenseLM(LM):
    """Decoder-only GQA transformer (qk-norm/bias variants) with AQUA, with
    a dense MLP or (family ``moe``) routed experts as its FFN. Serves a
    contiguous or (``enable_paging``) paged decode state. Family ``vlm``
    (a ``vision_patches`` frontend): a batch's "patches" (B, n, embed_dim)
    go through ``patch_proj`` (no bias) and replace the embeddings of the
    first n positions at ``forward`` and ``prefill`` (so the engine's
    ``prefill_into`` and admissions); the prompt must be at least n long
    (:func:`check_splice`).

    On a serving mesh (``enable_mesh``; ``dense``, ``moe`` and ``vlm``)
    the model is one rank's: its config holds the rank's attention heads,
    its params are the rank's blocks (``bridge.params_from_numpy(mesh=)``:
    the experts, the router and ``patch_proj`` too) and every block passes
    the layout on, so the collectives it names run where GSPMD would
    insert them."""

    supports_paging = True

    def init(self, gen: torch.Generator) -> dict:
        """Random params from ``gen`` (a ``torch.Generator`` on the model's
        device) in the JAX package's layouts. The values differ from the
        JAX package's init for the same seed; tests bridge JAX params."""
        cfg, dt, dev = self.cfg, self.param_dtype, self.device
        params = {
            "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                      dev),
            "layers": _stack_layers(lambda: init_block(gen, cfg, dt, dev),
                                    cfg.num_layers),
            "ln_f": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L.init_embedding(gen, cfg.vocab_size,
                                                 cfg.d_model, dt, dev)
        if cfg.frontend.kind == "vision_patches":
            params["patch_proj"] = L.init_linear(
                gen, cfg.frontend.embed_dim, cfg.d_model, dt, dev)
        return params

    @property
    def tied_unembedding(self) -> bool:
        """Whether the logits come from the embedding table (else from
        ``params["unembed"]``): the ``tied`` of ``with_unembedding``."""
        return self.cfg.tie_embeddings

    def _unembed(self, params, x):
        return L.unembed(params, "embed" if self.tied_unembedding
                         else "unembed",
                         L.rms_norm(x, params["ln_f"], self.cfg.norm_eps),
                         self.tp)

    def _embed(self, params, batch) -> torch.Tensor:
        """Token embeddings, with a VLM batch's projected "patches" over
        the first positions."""
        x = L.embed(params["embed"], batch["tokens"], self.dtype, self.tp)
        if (self.cfg.frontend.kind == "vision_patches"
                and "patches" in batch):
            pe = L.linear(params["patch_proj"],
                          batch["patches"].to(self.dtype))
            if self.tp is not None:
                pe = self.tp.patches(pe)
            check_splice(x.shape[1], pe.shape[1])
            x[:, :pe.shape[1]] = pe
        return x

    def _proj(self, aqua_proj, i):
        return None if aqua_proj is None else aqua_proj[i]

    def _run_layers(self, params, x, aqua_proj, lengths=None,
                    slim: bool = False):
        """Every block over ``x``: (x, each block's aux). ``slim`` keeps
        only each aux's ``aux_loss`` and runs the blocks under
        :func:`remat` (the training forward)."""
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        layers = unstack_layers(params["layers"], self.cfg.num_layers)
        auxes = []
        for i in range(self.cfg.num_layers):
            args = (self.cfg, layers[i], x, positions,
                    self._proj(aqua_proj, i), lengths, self.tp)
            if slim:
                x, aux_loss = remat(self.cfg, _block_slim, *args)
                auxes.append({"aux_loss": aux_loss})
            else:
                x, aux = block_forward(*args)
                auxes.append(aux)
        return x, auxes

    # -- full-sequence forward ----------------------------------------
    def forward(self, params, batch, aqua_proj=None, capture: bool = False):
        """Logits (B, S, V) float32. With ``capture``: (logits, {"qk": [(q,
        k) per layer]}), the post-RoPE activations for calibration, plus
        for ``moe`` "aux_loss", the layers' summed load-balance losses.
        Without: logits, or for ``moe`` (logits, {"aux_loss": the summed
        losses times ``MoEConfig.router_aux_weight``}), as in JAX."""
        x, auxes = self._run_layers(params, self._embed(params, batch),
                                    aqua_proj, slim=not capture)
        logits = self._unembed(params, x)
        moe = self.cfg.family == "moe"
        aux_loss = sum(a["aux_loss"] for a in auxes) if moe else None
        if capture:
            out = {"qk": [(a["q"], a["k"]) for a in auxes]}
            if moe:
                out["aux_loss"] = aux_loss
            return logits, out
        if moe:
            return logits, {"aux_loss": aux_loss
                            * self.cfg.moe.router_aux_weight}
        return logits

    # -- serving --------------------------------------------------------
    def _cache_dims(self):
        """(stored K̂ width, V width): under AQUA the kept dims, padded to
        a multiple of 8 where the selection is by whole dim-blocks
        (``aqua.stored_dims``)."""
        acfg, aqua = self.cfg.attention, self.cfg.aqua
        dk = acfg.head_dim
        if aqua is not None and aqua.enabled:
            dk = aqua_lib.stored_dims(aqua, acfg.head_dim)
        return dk, acfg.head_dim

    def cache_slots(self, max_seq: int) -> int:
        """Slots per lane: ``max_seq``, cut to the window and the H2O
        budget where the config sets them."""
        return kv.cache_slots(max_seq, self.cfg.attention.window,
                              h2o_budget(self.cfg.aqua, max_seq))

    def init_decode_state(self, batch_size: int, max_seq: int,
                          device=None) -> DecodeState:
        """Empty lanes on the model's device (or ``device``, e.g. "meta"
        for shape-only byte accounting)."""
        cfg, acfg = self.cfg, self.cfg.attention
        device = self.device if device is None else device
        dk, dv = self._cache_dims()
        slots = self.cache_slots(max_seq)
        pg = self._paging
        if pg is not None:
            layers = kv.init_paged_cache(
                batch_size, acfg.num_kv_heads, pg.num_pages,
                kv.paged_pages(slots, pg.page_size), pg.page_size, dk, dv,
                self.dtype, device, num_layers=cfg.num_layers,
                kv_dtype=pg.kv_dtype,
                scale_granularity=pg.scale_granularity,
                hot_pages=pg.hot_pages)
        else:
            layers = kv.init_attn_cache(
                batch_size, acfg.num_kv_heads, slots, dk, dv, self.dtype,
                device, num_layers=cfg.num_layers,
                h2o=h2o_budget(cfg.aqua, max_seq) is not None)
        return DecodeState(layers=layers)

    def prefill(self, params, batch, max_seq: int, aqua_proj=None):
        """Prefill a (possibly ragged, ``batch["lengths"]``; full-cache
        policy only) prompt batch into a fresh contiguous cache of the
        config's slot policy. Returns (next-token logits (B, V) from each
        row's last valid token, DecodeState)."""
        cfg = self.cfg
        lengths = batch.get("lengths")
        x, auxes = self._run_layers(params, self._embed(params, batch),
                                    aqua_proj, lengths)
        layers = _stack_caches([attn.build_cache_from_prefill(
            a["k_cache"], a["v"], max_seq, lengths,
            window=cfg.attention.window, aqua=cfg.aqua, q_hat=a["q_hat"],
            head_dim=cfg.attention.head_dim, tp=self.tp) for a in auxes])
        if lengths is None:
            x_last = x[:, -1]
        else:
            idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
            x_last = x[torch.arange(x.shape[0], device=x.device), idx]
        return self._unembed(params, x_last), DecodeState(layers=layers)

    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor,
                    aqua_proj=None, write_mask=None):
        """tokens (B,) -> (logits (B, V) float32, state updated in place).
        A paged state with ``PagingSpec.kept_pages`` set decodes through
        hierarchical AQUA, the participating pages ranked per layer."""
        x = L.embed(params["embed"], tokens, self.dtype, self.tp)
        pg = self._paging
        sparsity = (None if pg is None or pg.kept_pages is None
                    else (pg.kept_pages, pg.pin_recent_pages))
        for i in range(self.cfg.num_layers):
            x = block_step(self.cfg, layer_params(params["layers"], i), x,
                           state.layers.layer(i), self._proj(aqua_proj, i),
                           write_mask=write_mask, token_sparsity=sparsity,
                           tp=self.tp)
        return self._unembed(params, x), state

    # -- paged lane surgery ---------------------------------------------
    def graft_paged(self, state: DecodeState, req_state: DecodeState,
                    lane: Optional[int], num_slots: int, row) -> DecodeState:
        """Copy logical slots [0, num_slots) of a B=1 contiguous prefill
        cache into the pages that ``row`` (NP,), the lane's page-table
        row, maps, layer by layer, and set ``lane``'s count (``lane``
        None: no count, a mesh rank's replica of the pool for a lane of
        another data rank)."""
        for i in range(self.cfg.num_layers):
            kv.paged_graft(state.layers.layer(i), req_state.layers.layer(i),
                           lane, num_slots, row, self.tp)
        return state

    # -- chunked prefill and prefix-shared admission ---------------------
    def prefill_chunk(self, params, batch, state: DecodeState, lane: int,
                      prefix_len: int, aqua_proj=None,
                      select_q_blk: Optional[int] = None,
                      logits: bool = True, row=None):
        """Advance ``lane``'s cache by one prefill chunk, in place: the
        chunk's tokens ``batch["tokens"]`` (1, T) (bucket-padded, valid
        count ``batch["lengths"]`` (1,)) sit at positions ``prefix_len +
        arange(T)`` and attend the prefix earlier chunks wrote (slots [0,
        prefix_len), read through the lane's stripe or, paged, its
        dequantized pages) plus themselves; then the chunk's K/V land from
        slot ``prefix_len`` on (``kvcache.lane_write_tail`` /
        ``paged_write_tail``; a paged cursor is page-aligned). Each layer
        reads its prefix before it writes. ``select_q_blk`` selects AQUA
        dim-blocks per kernel q-tile (``attention.chunk_attention``).
        Returns (next-token logits (1, V) from the chunk's last valid row
        — None with ``logits=False``, for a non-final chunk —, state).

        The same step is a prefix-shared admission
        (``prefill_with_prefix``, as the JAX package names it): there
        ``prefix_len`` pages' worth of slots are another prompt's
        read-only pages that the lane's row maps, the batch is the
        prompt's tail, and the engine passes ``select_q_blk=None``
        (per-query selection).

        Paged, the prefix is read from, and the chunk written to, the
        pages that ``row`` (NP,), the lane's page-table row, maps; ``lane``
        only takes the count (None: no count, a mesh rank's replica of the
        pool for a lane of another data rank)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        lengths = batch.get("lengths")
        t = tokens.shape[1]
        x = L.embed(params["embed"], tokens, self.dtype, self.tp)
        positions = (prefix_len + torch.arange(t, dtype=torch.int32,
                                               device=x.device))[None]
        paged = self._paging is not None
        tail_count = prefix_len + (t if lengths is None else lengths[0])
        for i in range(cfg.num_layers):
            p = layer_params(params["layers"], i)
            cache = state.layers.layer(i)
            if paged:
                pk, pv, ppos = kv.paged_lane_pages(cache, row,
                                                   dtype=self.dtype)
            else:
                pk, pv = cache.k[lane][None], cache.v[lane][None]
                ppos = cache.positions[lane][None]
            # only slots [0, prefix_len) are this prompt's: later slots of
            # a recycled lane still hold a previous tenant's positions
            ppos = torch.where(torch.arange(ppos.shape[1], device=x.device)
                               < prefix_len, ppos, torch.full_like(ppos, -1))
            h, k_t, v_t = attn.chunk_attention(
                p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                cfg.attention, cfg.aqua, self._proj(aqua_proj, i),
                prefix_k=pk, prefix_v=pv, prefix_positions=ppos,
                prefix_len=prefix_len, positions=positions, lengths=lengths,
                select_q_blk=select_q_blk, tp=self.tp)
            x = x + h
            x = x + ffn_apply(cfg, p["ffn"],
                              L.rms_norm(x, p["ln2"], cfg.norm_eps),
                              self.tp)[0]
            if paged:
                kv.paged_write_tail(cache, lane, k_t[0], v_t[0], positions[0],
                                    prefix_len // cache.page_size, tail_count,
                                    row, self.tp)
            else:
                kv.lane_write_tail(cache, lane, k_t[0], v_t[0], positions[0],
                                   prefix_len, tail_count)
        if not logits:
            return None, state
        if lengths is None:
            return self._unembed(params, x[:, t - 1]), state
        # the last valid row, gathered on the device (indexing by a 0-d
        # tensor would read it on the host)
        last = torch.clamp(lengths.long() - 1, 0, t - 1)
        return self._unembed(params, x.index_select(1, last)[:, 0]), state

    # a prefix-shared admission extends the lane's cache from its shared
    # prefix exactly as a chunk extends it from earlier chunks (JAX aliases
    # the two the other way round)
    prefill_with_prefix = prefill_chunk

    def reset_lane(self, state: DecodeState, lane: int,
                   max_seq: int) -> DecodeState:
        if self._paging is None:
            return super().reset_lane(state, lane, max_seq)
        for i in range(self.cfg.num_layers):
            kv.paged_reset_lane(state.layers.layer(i), lane)
        return state


# ---------------------------------------------------------------------------
# Whisper-style encoder-decoder
# ---------------------------------------------------------------------------


def init_decoder_block(gen: torch.Generator, cfg, dtype, device) -> dict:
    """A decoder block: self-attention, cross-attention (``xattn``, its
    norm ``ln_x``) and an ungated MLP."""
    return {
        "ln1": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "ln_x": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "attn": attn.init_attention_params(gen, cfg.d_model, cfg.attention,
                                           dtype, device),
        "xattn": attn.init_attention_params(gen, cfg.d_model, cfg.attention,
                                            dtype, device),
        "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                          gated=False),
    }


class EncDecLM(DenseLM):
    """Whisper-tiny family: a bidirectional, RoPE-free encoder over a
    batch's stub "frames" (B, n_frames, d_model) plus sinusoidal positions,
    and a causal decoder (a learned position table ``pos`` read at each
    token's position, clipped to ``max_positions``) whose blocks add
    cross-attention over the encoder's output. AQUA acts on the decoder's
    self-attention; the encoder's and the cross-attention run on the plain
    ``dense`` reference, as JAX runs them outside its kernels. Logits come
    from the embedding table.

    Serving: a contiguous decode state only (no paged form, as in JAX),
    whose ``extra["cross"]`` holds each lane's per-layer cross K/V (L, B,
    n_frames, KV, D), computed once at the lane's prefill and grafted with
    the lane. Admissions are monolithic at the prompt's exact length
    (``prefill`` takes no ``lengths``)."""

    supports_paging = False

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.enc_cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, causal=False,
                                               use_rope=False),
            family="dense", act="gelu", aqua=None)

    @property
    def tied_unembedding(self) -> bool:
        return True

    def init(self, gen: torch.Generator) -> dict:
        cfg, dt, dev = self.cfg, self.param_dtype, self.device
        return {
            "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                      dev),
            "pos": torch.randn(cfg.max_positions, cfg.d_model, generator=gen,
                               device=dev).mul_(0.01).to(dt),
            "enc_layers": _stack_layers(
                lambda: init_block(gen, self.enc_cfg, dt, dev),
                cfg.num_encoder_layers),
            "enc_ln": torch.ones(cfg.d_model, dtype=dt, device=dev),
            "dec_layers": _stack_layers(
                lambda: init_decoder_block(gen, cfg, dt, dev),
                cfg.num_layers),
            "ln_f": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder's output (B, n_frames, d_model) over ``frames``."""
        cfg = self.cfg
        x = frames.to(self.dtype)
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                       x.device).to(self.dtype)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for p in unstack_layers(params["enc_layers"],
                                cfg.num_encoder_layers):
            x, _ = block_forward(self.enc_cfg, p, x, positions, None)
        return L.rms_norm(x, params["enc_ln"], cfg.norm_eps)

    def _dec_block_fwd(self, p, x, enc_out, positions, proj):
        cfg = self.cfg
        h, aux = attn.prefill_attention(
            p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg.attention,
            cfg.aqua, proj, positions, return_aux=True)
        x = x + h
        x = x + attn.prefill_attention(
            p["xattn"], L.rms_norm(x, p["ln_x"], cfg.norm_eps),
            cfg.attention, None, None, positions, kv_x=enc_out)
        return x + L.mlp(p["ffn"], L.rms_norm(x, p["ln2"], cfg.norm_eps),
                         cfg.act), aux

    def _run_decoder(self, params, batch, enc_out, aqua_proj,
                     slim: bool = False):
        """The decoder over ``batch["tokens"]``: (x, each block's attention
        aux). ``slim`` keeps no aux and runs the blocks under
        :func:`remat` (the training forward; JAX checkpoints the
        decoder's scanned body, not the encoder's)."""
        tokens = batch["tokens"]
        s = tokens.shape[1]
        x = L.embed(params["embed"], tokens, self.dtype)
        x = x + params["pos"][:s].to(self.dtype)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        layers = unstack_layers(params["dec_layers"], self.cfg.num_layers)
        auxes = []
        for i in range(self.cfg.num_layers):
            args = (layers[i], x, enc_out, positions,
                    self._proj(aqua_proj, i))
            if slim:
                x = remat(self.cfg, self._dec_block_fwd, *args, pick=0)
            else:
                x, aux = self._dec_block_fwd(*args)
                auxes.append(aux)
        return x, auxes

    def forward(self, params, batch, aqua_proj=None, capture: bool = False):
        """Logits (B, S, V) float32 of ``batch["tokens"]`` given
        ``batch["frames"]``; with ``capture`` also {"qk": the decoder
        self-attention's (q, k) per layer}."""
        enc_out = self.encode(params, batch["frames"])
        x, auxes = self._run_decoder(params, batch, enc_out, aqua_proj,
                                     slim=not capture)
        logits = self._unembed(params, x)
        if capture:
            return logits, {"qk": [(a["q"], a["k"]) for a in auxes]}
        return logits

    def precompute_cross(self, params, enc_out: torch.Tensor):
        """Every decoder layer's cross K and V over the encoder's output:
        two (L, B, n_frames, KV, D) tensors."""
        xa = params["dec_layers"]["xattn"]
        ks, vs = [], []
        for i in range(self.cfg.num_layers):
            p = layer_params(xa, i)
            k = torch.einsum("bsm,mkd->bskd", enc_out,
                             p["wk"].to(enc_out.dtype))
            v = torch.einsum("bsm,mkd->bskd", enc_out,
                             p["wv"].to(enc_out.dtype))
            if self.cfg.attention.qkv_bias:
                k = k + p["bk"].to(k.dtype)
                v = v + p["bv"].to(v.dtype)
            ks.append(k)
            vs.append(v)
        return torch.stack(ks), torch.stack(vs)

    def init_decode_state(self, batch_size: int, max_seq: int,
                          device=None) -> DecodeState:
        """Empty contiguous lanes and zero cross K/V."""
        state = super().init_decode_state(batch_size, max_seq, device)
        cfg, acfg = self.cfg, self.cfg.attention
        shape = (cfg.num_layers, batch_size, cfg.frontend.num_embeds,
                 acfg.num_kv_heads, acfg.head_dim)
        dev = self.device if device is None else device
        state.extra["cross"] = (
            torch.zeros(shape, dtype=self.dtype, device=dev),
            torch.zeros(shape, dtype=self.dtype, device=dev))
        return state

    def prefill(self, params, batch, max_seq: int, aqua_proj=None):
        """Encode ``batch["frames"]``, prefill ``batch["tokens"]`` (B, S)
        at their exact length into a fresh contiguous cache, with the
        lanes' cross K/V. Returns (next-token logits (B, V) of the last
        token, DecodeState)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        cross = self.precompute_cross(params, enc_out)
        x, auxes = self._run_decoder(params, batch, enc_out, aqua_proj)
        layers = _stack_caches([attn.build_cache_from_prefill(
            a["k_cache"], a["v"], max_seq, None,
            window=cfg.attention.window, aqua=cfg.aqua, q_hat=a["q_hat"],
            head_dim=cfg.attention.head_dim) for a in auxes])
        return (self._unembed(params, x[:, -1]),
                DecodeState(layers=layers, extra={"cross": cross}))

    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor,
                    aqua_proj=None, write_mask=None):
        """tokens (B,) -> (logits (B, V) float32, state updated in place):
        the learned position of each lane's count, the decoder's
        self-attention over its cache, cross-attention over its
        ``extra["cross"]``."""
        cfg = self.cfg
        pos = torch.clamp(state.layers.count[0], 0,
                          cfg.max_positions - 1).long()
        x = (L.embed(params["embed"], tokens, self.dtype)
             + params["pos"][pos].to(self.dtype))
        cross_k, cross_v = state.extra["cross"]
        for i in range(cfg.num_layers):
            p = layer_params(params["dec_layers"], i)
            cache = state.layers.layer(i)
            y = x + attn.decode_attention(
                p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cache,
                cfg.attention, cfg.aqua, self._proj(aqua_proj, i),
                write_mask=write_mask)
            y = y + attn.decode_attention(
                p["xattn"], L.rms_norm(y, p["ln_x"], cfg.norm_eps), cache,
                cfg.attention, cross=(cross_k[i], cross_v[i]))
            x = y + L.mlp(p["ffn"], L.rms_norm(y, p["ln2"], cfg.norm_eps),
                          cfg.act)
        return self._unembed(params, x), state

    def prefill_chunk(self, *args, **kwargs):
        raise NotImplementedError(
            "encdec admissions are monolithic: the frames splice at prefill "
            "and the decoder's cache has no chunk-resumable form")

    prefill_with_prefix = prefill_chunk
