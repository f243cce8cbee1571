"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427) in PyTorch: port of
the JAX package's ``models/rglru.py``.

RG-LRU recurrent blocks beside local sliding-window attention blocks, the
layers following ``RGLRUConfig.block_pattern`` cyclically (recurrent,
recurrent, attention). The recurrence is a real-gated linear recurrence
computed with a log-depth associative scan (``mamba2.linear_scan``); the
attention layers are the port's transformer blocks (``init_block``,
``block_forward``, ``block_step``), so AQUA applies to them, and a
windowed attention's prefill runs the block-sparse kernel's window form.

Params keep the JAX package's tree: ``layers`` is a Python list of
per-layer dicts (recurrent blocks: ``wx``, ``wgate``, ``conv_w``,
``conv_b``, ``wr``, ``wi``, ``lam``, ``wout``, ``ln1``, ``ln2``, ``ffn``;
attention blocks: ``init_block``'s). ``wr``, ``wi`` and ``lam`` are
float32 whatever the param dtype, as JAX draws them; the gate products
run in the activation dtype, sigmoid and the scan in float32, as in JAX.

The decode state: JAX keeps a tuple of per-layer caches with lanes at
axis 0 and overrides ``insert_lane`` for it. The port stacks the
attention layers' caches into one ``AttnCache`` and the recurrent
layers' states into one ``RGLRUCache``, each with layers at axis 0 and
lanes at axis 1, in one ``HybridCache`` (``count``: the attention
stack's), so the base class's lane surgery, ``kvcache.reset_cache`` and
the step graph take it as they take a dense model's. Both stacks are in
model order; :meth:`HybridLM.stack_index` maps a layer to its row.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import attention as attn
from repro_torch.core import kvcache as kv
from repro_torch.core.h2o import h2o_budget
from repro_torch.core.kvcache import HybridCache, RGLRUCache
from repro_torch.models import layers as L
from repro_torch.models.base import DecodeState, remat
from repro_torch.models.mamba2 import linear_scan
from repro_torch.models.transformer import (DenseLM, _stack_caches,
                                            block_forward, block_step,
                                            init_block)

_C = 8.0  # RG-LRU exponent constant (Griffin §2.4)


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i_gate: torch.Tensor,
               lam: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """x, r, i_gate (B, S, W) float32; lam (W,). h_t = a_t h_{t-1} +
    sqrt(1 - a_t²) (i_t x_t), a_t = exp(-8 softplus(lam) r_t), from ``h0``
    (B, W) or zero. Returns (the hidden sequence (B, S, W), the final
    hidden (B, W))."""
    a = torch.exp(-_C * F.softplus(lam)[None, None, :] * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_gate * x)
    a_s, h = linear_scan(a, gated, 1)
    if h0 is not None:
        h = h + a_s * h0[:, None, :]
    return h, h[:, -1, :]


def rglru_step(x_t, r_t, i_t, lam, h_prev):
    """One step of the recurrence: (h, h)."""
    a = torch.exp(-_C * F.softplus(lam)[None, :] * r_t)
    h = a * h_prev + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i_t * x_t)
    return h, h


def init_recurrent_block(gen: torch.Generator, cfg, dtype, device) -> dict:
    """A recurrent block's random params in JAX's layouts (``wr``, ``wi``
    and ``lam`` float32; the MLP gated only for ``act == "silu"``)."""
    w = cfg.rglru.lru_width or cfg.d_model
    std = cfg.d_model ** -0.5
    normal = L._normal
    return {
        "ln1": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "wx": normal(gen, (cfg.d_model, w), std, dtype, device),
        "wgate": normal(gen, (cfg.d_model, w), std, dtype, device),
        "conv_w": normal(gen, (cfg.rglru.conv_width, w),
                         cfg.rglru.conv_width ** -0.5, dtype, device),
        "conv_b": torch.zeros(w, dtype=dtype, device=device),
        "wr": normal(gen, (w, w), w ** -0.5, torch.float32, device),
        "wi": normal(gen, (w, w), w ** -0.5, torch.float32, device),
        "lam": torch.full((w,), 1.0, dtype=torch.float32, device=device),
        "wout": normal(gen, (w, cfg.d_model), w ** -0.5, dtype, device),
        "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                          gated=cfg.act == "silu"),
    }


def _conv1d_causal(x, w, b):
    """Causal depthwise conv over the sequence: x (B, S, W), w (width,
    W), b (W,), in x's dtype."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(width)) + b


def _gates(p: dict, u: torch.Tensor):
    """The RG-LRU's recurrence and input gates: products in u's dtype,
    sigmoid in float32."""
    r = torch.sigmoid((u @ p["wr"].to(u.dtype)).float())
    i_g = torch.sigmoid((u @ p["wi"].to(u.dtype)).float())
    return r, i_g


def recurrent_block_forward(cfg, p: dict, x: torch.Tensor,
                            h0: Optional[torch.Tensor] = None):
    """A recurrent block over a sequence. Returns (y, (the last
    ``conv_width - 1`` raw (pre-conv) inputs, the final hidden))."""
    h_in = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    gate = L.act_fn("gelu")(h_in @ p["wgate"].to(x.dtype))
    u_raw = h_in @ p["wx"].to(x.dtype)
    u = _conv1d_causal(u_raw, p["conv_w"].to(x.dtype),
                       p["conv_b"].to(x.dtype))
    r, i_g = _gates(p, u)
    h, h_last = rglru_scan(u.float(), r, i_g, p["lam"], h0)
    x = x + (h.to(x.dtype) * gate) @ p["wout"].to(x.dtype)
    f = L.mlp(p["ffn"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)
    width = cfg.rglru.conv_width
    conv_tail = F.pad(u_raw, (0, 0, width - 1, 0))[:, -(width - 1):]
    return x + f, (conv_tail, h_last)


def recurrent_block_step(cfg, p: dict, x_t: torch.Tensor,
                         conv: torch.Tensor, state: torch.Tensor):
    """A recurrent block for one token per lane: (y, the new conv window,
    the new hidden)."""
    h_in = L.rms_norm(x_t, p["ln1"], cfg.norm_eps)
    gate = L.act_fn("gelu")(h_in @ p["wgate"].to(x_t.dtype))
    u_raw = h_in @ p["wx"].to(x_t.dtype)
    window = torch.cat([conv, u_raw[:, None, :]], dim=1)
    u = (torch.einsum("bwc,wc->bc", window, p["conv_w"].to(x_t.dtype))
         + p["conv_b"].to(x_t.dtype))
    r, i_g = _gates(p, u)
    h, _ = rglru_step(u.float(), r, i_g, p["lam"], state)
    x = x_t + (h.to(x_t.dtype) * gate) @ p["wout"].to(x_t.dtype)
    f = L.mlp(p["ffn"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)
    return x + f, window[:, 1:], h


class HybridLM(DenseLM):
    """The ``hybrid`` family (recurrentgemma-9b): layers of kind
    ``kinds[i]``, "recurrent" or "attention"; logits from the embedding
    table. AQUA projections are per attention layer (``num_attn_layers``
    of them, in model order). Contiguous decode state only (no paged form,
    as in JAX); admissions are monolithic at the prompt's exact length
    (``prefill`` is rectangular)."""

    supports_paging = False

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        pat = cfg.rglru.block_pattern
        self.kinds = tuple(pat[i % len(pat)] for i in range(cfg.num_layers))

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for k in self.kinds if k == "attention")

    def stack_index(self, i: int) -> int:
        """Layer ``i``'s row in its kind's stack (``HybridCache.attn`` or
        ``.rec``): the count of earlier layers of its kind."""
        return sum(1 for k in self.kinds[:i] if k == self.kinds[i])

    @property
    def tied_unembedding(self) -> bool:
        return True

    def init(self, gen: torch.Generator) -> dict:
        """Random params from ``gen`` in the JAX package's layouts, a list
        of per-layer dicts (the values differ from JAX's init)."""
        cfg, dt, dev = self.cfg, self.param_dtype, self.device
        return {
            "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                      dev),
            "layers": [init_recurrent_block(gen, cfg, dt, dev)
                       if kind == "recurrent"
                       else init_block(gen, cfg, dt, dev)
                       for kind in self.kinds],
            "ln_f": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }

    def _run(self, params, x, aqua_proj, on_attn=None, on_rec=None):
        """Every layer over the sequence ``x``; ``on_attn(aux)`` and
        ``on_rec(conv_tail, h_last)`` receive each layer's cache-form
        outputs. A layer whose outputs no callback takes runs under
        :func:`remat` (the training forward, as JAX checkpoints both
        kinds of block)."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        ai = 0
        for i, kind in enumerate(self.kinds):
            p = params["layers"][i]
            if kind == "recurrent":
                if on_rec is None:
                    x = remat(cfg, recurrent_block_forward, cfg, p, x, pick=0)
                else:
                    x, tail = recurrent_block_forward(cfg, p, x)
                    on_rec(*tail)
            else:
                args = (cfg, p, x, positions, self._proj(aqua_proj, ai))
                if on_attn is None:
                    x = remat(cfg, block_forward, *args, pick=0)
                else:
                    x, aux = block_forward(*args)
                    on_attn(aux)
                ai += 1
        return x

    def forward(self, params, batch, aqua_proj=None, capture: bool = False):
        """Logits (B, S, V) float32; with ``capture`` also {"qk": [(q, k)
        per attention layer]}, the calibration activations."""
        qk = []
        x = self._run(params, L.embed(params["embed"], batch["tokens"],
                                      self.dtype), aqua_proj,
                      on_attn=(lambda aux: qk.append((aux["q"], aux["k"])))
                      if capture else None)
        logits = self._unembed(params, x)
        return (logits, {"qk": qk}) if capture else logits

    def init_decode_state(self, batch_size: int, max_seq: int,
                          device=None) -> DecodeState:
        """Empty lanes on the model's device (or ``device``): the attention
        layers' contiguous caches (the window's ring) and the recurrent
        layers' zero states."""
        cfg = self.cfg
        dev = self.device if device is None else device
        dk, dv = self._cache_dims()
        n_rec = cfg.num_layers - self.num_attn_layers
        w = cfg.rglru.lru_width or cfg.d_model
        lead = (n_rec, batch_size)
        return DecodeState(layers=HybridCache(
            attn=kv.init_attn_cache(
                batch_size, cfg.attention.num_kv_heads,
                self.cache_slots(max_seq), dk, dv, self.dtype, dev,
                num_layers=self.num_attn_layers,
                h2o=h2o_budget(cfg.aqua, max_seq) is not None),
            rec=RGLRUCache(
                conv=torch.zeros(*lead, cfg.rglru.conv_width - 1, w,
                                 dtype=self.dtype, device=dev),
                state=torch.zeros(*lead, w, dtype=torch.float32, device=dev),
                count=torch.zeros(lead, dtype=torch.int32, device=dev))))

    def prefill(self, params, batch, max_seq: int, aqua_proj=None):
        """Prefill ``batch["tokens"]`` (B, S), rectangular, into a fresh
        state. Returns (next-token logits (B, V) of the last token,
        DecodeState)."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"], self.dtype)
        bsz, s = x.shape[:2]
        caches, convs, states = [], [], []
        x = self._run(
            params, x, aqua_proj,
            on_attn=lambda aux: caches.append(attn.build_cache_from_prefill(
                aux["k_cache"], aux["v"], max_seq, None,
                window=cfg.attention.window, aqua=cfg.aqua,
                q_hat=aux["q_hat"], head_dim=cfg.attention.head_dim)),
            on_rec=lambda tail, h: (convs.append(tail.to(self.dtype)),
                                    states.append(h)))
        rec = RGLRUCache(conv=torch.stack(convs), state=torch.stack(states),
                         count=torch.full((len(states), bsz), s,
                                          dtype=torch.int32,
                                          device=x.device))
        attn_stack = (_stack_caches(caches) if caches else
                      self.init_decode_state(bsz, max_seq,
                                             x.device).layers.attn)
        return self._unembed(params, x[:, -1]), DecodeState(
            layers=HybridCache(attn=attn_stack, rec=rec))

    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor,
                    aqua_proj=None, write_mask=None):
        """tokens (B,) -> (logits (B, V) float32, state updated in place):
        the attention layers insert into their caches under ``write_mask``
        (``block_step``), the recurrent layers' conv windows, hiddens and
        counts keep their old values where it is False, bit for bit."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens, self.dtype)
        cache = state.layers
        rec = cache.rec
        ai = ri = 0
        for i, kind in enumerate(self.kinds):
            p = params["layers"][i]
            if kind == "recurrent":
                x, conv, h = recurrent_block_step(cfg, p, x, rec.conv[ri],
                                                  rec.state[ri])
                new = RGLRUCache(conv=conv, state=h, count=rec.count[ri] + 1)
                self.freeze_rows(DecodeState(layers=new),
                                 DecodeState(layers=rec.layer(ri)),
                                 write_mask, batch_axis=0)
                ri += 1
            else:
                x = block_step(cfg, p, x, cache.attn.layer(ai),
                               self._proj(aqua_proj, ai),
                               write_mask=write_mask)
                ai += 1
        return self._unembed(params, x), state

    def prefill_chunk(self, *args, **kwargs):
        raise NotImplementedError(
            "hybrid admissions are monolithic: the recurrent state is not "
            "a slot cache (REASON_FAMILY_SURGERY)")

    prefill_with_prefix = prefill_chunk
