"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch: port
of the JAX package's ``models/mamba2.py``.

The chunked matmul form: intra-chunk attention-like blocks, then the
chunk-final states carried across chunks by a log-depth associative scan
(:func:`linear_scan`). Attention-free, so AQUA is inapplicable (the
engine serves it without projections, as in JAX); decode keeps O(1) state
per lane (:class:`~repro_torch.core.kvcache.SSMCache`) instead of a KV
cache.

Params keep the JAX package's tree (layers stacked on a leading axis, the
embedding tied to the unembedding); ``a_log``, ``dt_bias`` and ``d_skip``
are float32 whatever the param dtype, as JAX draws them. The scan runs in
float32 and the projections, convolution and gating in the activation
dtype, with JAX's casts. The decode state is one stacked ``SSMCache``
(layers at axis 0, lanes at axis 1), updated in place; a masked step
keeps the unwritten lanes' rows bit for bit (:meth:`LM.freeze_rows`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.kvcache import SSMCache
from repro_torch.models import layers as L
from repro_torch.models.base import LM, DecodeState, remat
from repro_torch.models.transformer import (_stack_layers, layer_params,
                                            unstack_layers)


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of h_t = a_t · h_{t-1} + b_t (h_{-1} = 0) along
    ``dim``, in log depth: (a_1 ⋯ a_t, h_t) for every t, by doubling
    offsets (Hillis-Steele) over the combine ``(a1, b1) ∘ (a2, b2) = (a1 ·
    a2, b1 · a2 + b2)`` that ``jax.lax.associative_scan`` takes. ``a``
    broadcasts against ``b`` on the trailing dims past ``dim``."""
    n = a.shape[dim]
    off = 1
    while off < n:
        a_prev, a_cur = a.narrow(dim, 0, n - off), a.narrow(dim, off, n - off)
        b_prev, b_cur = b.narrow(dim, 0, n - off), b.narrow(dim, off, n - off)
        b = torch.cat([b.narrow(dim, 0, off), b_prev * a_cur + b_cur], dim)
        a = torch.cat([a.narrow(dim, 0, off), a_prev * a_cur], dim)
        off *= 2
    return a, b


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l) -> (..., l, l); out[i, j] = sum a[j+1..i] for i >= j,
    -inf above the diagonal."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(n, n, dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int):
    """SSD forward from a zero state, in float32.

    x: (B, S, H, P); dt: (B, S, H); a_log: (H,) (negative decay); b, c:
    (B, S, G, N), G groups broadcast over the heads. Returns y (B, S, H,
    P) and the final state (B, H, P, N)."""
    bsz, s0, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    # pad to a chunk multiple; dt = 0 on the padding: decay 1,
    # contribution 0, so the states and the real outputs are unaffected
    s = -(-s0 // chunk) * chunk
    if s != s0:
        x = F.pad(x, (0, 0, 0, 0, 0, s - s0))
        b = F.pad(b, (0, 0, 0, 0, 0, s - s0))
        c = F.pad(c, (0, 0, 0, 0, 0, s - s0))
        dt = F.pad(dt, (0, 0, 0, s - s0))
    nc = s // chunk
    rep = h // g
    bh = b.repeat_interleave(rep, dim=2).reshape(bsz, nc, chunk, h, n)
    ch = c.repeat_interleave(rep, dim=2).reshape(bsz, nc, chunk, h, n)
    xd = (x * dt[..., None]).reshape(bsz, nc, chunk, h, p)
    a = (dt * a_log[None, None, :]).reshape(bsz, nc, chunk, h)  # log decay
    a_t = a.permute(0, 1, 3, 2)                 # (B, C, H, L)
    a_cum = torch.cumsum(a_t, dim=-1)

    # 1. intra-chunk (diagonal blocks)
    lmat = torch.exp(_segsum(a_t))              # (B, C, H, L, L)
    scores = torch.einsum("bclhn,bcshn->bchls", ch, bh) * lmat
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xd)
    # 2. chunk-final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (B, C, H, L)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", bh, decay_states, xd)
    # 3. inter-chunk recurrence: the associative scan over chunks
    chunk_decay = torch.exp(a_cum[..., -1])     # (B, C, H)
    _, st_all = linear_scan(chunk_decay[..., None, None], states, 1)
    final_state = st_all[:, -1]
    # the state entering chunk c is the scan's value at c - 1 (zero at 0)
    h_in = torch.cat([torch.zeros_like(st_all[:, :1]), st_all[:, :-1]], 1)
    # 4. off-diagonal contribution
    out_decay = torch.exp(a_cum).permute(0, 1, 3, 2)          # (B, C, L, H)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", ch, h_in, out_decay)

    y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s0]
    y = y + x[:, :s0] * d_skip[None, None, :, None]
    return y, final_state


def ssd_step(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """One decode step. state (B, H, P, N); x_t (B, H, P); dt_t (B, H);
    b_t, c_t (B, G, N). Returns (y_t, new state)."""
    rep = x_t.shape[1] // b_t.shape[1]
    bh = b_t.repeat_interleave(rep, dim=1)      # (B, H, N)
    ch = c_t.repeat_interleave(rep, dim=1)
    da = torch.exp(dt_t * a_log[None, :])       # (B, H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt_t, x_t, bh)
    state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, ch)
    return y + x_t * d_skip[None, :, None], state


class Mamba2LM(LM):
    """The ``ssm`` family (mamba2-370m): a stack of SSD blocks, no
    attention; logits from the embedding table."""

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        s = cfg.ssm
        self.d_inner = s.expand * cfg.d_model
        self.nheads = self.d_inner // s.head_dim
        self.conv_channels = self.d_inner + 2 * s.ngroups * s.state_dim

    @property
    def tied_unembedding(self) -> bool:
        return True

    def cache_slots(self, max_seq: int) -> int:
        """No slot cache: the state is O(1) per lane; the engine's slot
        count is the sequence budget."""
        return max_seq

    def _init_block(self, gen: torch.Generator, dtype, device) -> dict:
        cfg, s = self.cfg, self.cfg.ssm
        di, nh, cc = self.d_inner, self.nheads, self.conv_channels
        proj_out = 2 * di + 2 * s.ngroups * s.state_dim + nh
        normal = L._normal
        return {
            "ln": torch.ones(cfg.d_model, dtype=dtype, device=device),
            "in_proj": normal(gen, (cfg.d_model, proj_out),
                              cfg.d_model ** -0.5, dtype, device),
            "conv_w": normal(gen, (s.conv_width, cc), s.conv_width ** -0.5,
                             dtype, device),
            "conv_b": torch.zeros(cc, dtype=dtype, device=device),
            "a_log": torch.log(torch.linspace(1.0, 16.0, nh,
                                              dtype=torch.float32,
                                              device=device)),
            "dt_bias": torch.zeros(nh, dtype=torch.float32, device=device),
            "d_skip": torch.ones(nh, dtype=torch.float32, device=device),
            "out_norm": torch.ones(di, dtype=dtype, device=device),
            "out_proj": normal(gen, (di, cfg.d_model), di ** -0.5, dtype,
                               device),
        }

    def init(self, gen: torch.Generator) -> dict:
        """Random params from ``gen`` in the JAX package's layouts (the
        values differ from JAX's init for the same seed)."""
        cfg, dt, dev = self.cfg, self.param_dtype, self.device
        return {
            "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                      dev),
            "layers": _stack_layers(lambda: self._init_block(gen, dt, dev),
                                    cfg.num_layers),
            "ln_f": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }

    def _split(self, zxbcdt):
        s, di = self.cfg.ssm, self.d_inner
        gn = s.ngroups * s.state_dim
        return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
                zxbcdt[..., 2 * di + 2 * gn:])

    def _gates(self, p, xbc, dt_raw):
        """The SSD's inputs from the conv output: x (…, H, P), B and C (…,
        G, N) in float32, dt (…, H) float32, and the decay -exp(a_log)."""
        s, di = self.cfg.ssm, self.d_inner
        gn = s.ngroups * s.state_dim
        lead = xbc.shape[:-1]
        xh = xbc[..., :di].reshape(*lead, self.nheads, s.head_dim)
        b = xbc[..., di:di + gn].reshape(*lead, s.ngroups, s.state_dim)
        c = xbc[..., di + gn:].reshape(*lead, s.ngroups, s.state_dim)
        dt = F.softplus(dt_raw.float() + p["dt_bias"])
        return (xh.float(), b.float(), c.float(), dt,
                -torch.exp(p["a_log"]))

    def _out(self, p, y, z, dtype):
        cfg = self.cfg
        y = y.reshape(*y.shape[:-2], self.d_inner).to(dtype)
        y = L.rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
        return y @ p["out_proj"].to(dtype)

    def _block_seq(self, p, x):
        """One block over a sequence: (x + block(x), (the last
        ``conv_width - 1`` raw (pre-conv) inputs, the final SSD state))."""
        cfg, s = self.cfg, self.cfg.ssm
        h_in = L.rms_norm(x, p["ln"], cfg.norm_eps)
        z, xbc_raw, dt_raw = self._split(h_in @ p["in_proj"].to(x.dtype))
        w = p["conv_w"].to(x.dtype)
        pad = F.pad(xbc_raw, (0, 0, s.conv_width - 1, 0))
        conv = sum(pad[:, i:i + xbc_raw.shape[1], :] * w[i]
                   for i in range(s.conv_width))
        xbc = F.silu(conv + p["conv_b"].to(x.dtype))
        xh, b, c, dt, a = self._gates(p, xbc, dt_raw)
        y, final_state = ssd_chunked(xh, dt, a, b, c, p["d_skip"],
                                     s.chunk_size)
        # decode's conv window holds the last (w - 1) raw inputs
        return (x + self._out(p, y, z, x.dtype),
                (pad[:, -(s.conv_width - 1):], final_state))

    def _block_step(self, p, x_t, conv, state):
        """One block for one token per lane: (x, the new conv window, the
        new SSD state)."""
        cfg = self.cfg
        h_in = L.rms_norm(x_t, p["ln"], cfg.norm_eps)
        z, xbc_t, dt_raw = self._split(h_in @ p["in_proj"].to(x_t.dtype))
        window = torch.cat([conv, xbc_t[:, None, :]], dim=1)
        out = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(x_t.dtype))
        xbc = F.silu(out + p["conv_b"].to(x_t.dtype))
        xh, b, c, dt, a = self._gates(p, xbc, dt_raw)
        y, state = ssd_step(state, xh, dt, a, b, c, p["d_skip"])
        return x_t + self._out(p, y, z, x_t.dtype), window[:, 1:], state

    def _unembed(self, params, x):
        return L.unembed(params, "embed",
                         L.rms_norm(x, params["ln_f"], self.cfg.norm_eps))

    def forward(self, params, batch, aqua_proj=None, capture: bool = False):
        """Logits (B, S, V) float32 (no attention: nothing to capture)."""
        x = L.embed(params["embed"], batch["tokens"], self.dtype)
        for p in unstack_layers(params["layers"], self.cfg.num_layers):
            x = remat(self.cfg, self._block_seq, p, x, pick=0)
        logits = self._unembed(params, x)
        return (logits, {"qk": []}) if capture else logits

    def init_decode_state(self, batch_size: int, max_seq: int,
                          device=None) -> DecodeState:
        """Empty lanes: one stacked ``SSMCache`` (L, B, ...) on the model's
        device (or ``device``, e.g. "meta")."""
        cfg, s = self.cfg, self.cfg.ssm
        dev = self.device if device is None else device
        lead = (cfg.num_layers, batch_size)
        return DecodeState(layers=SSMCache(
            conv=torch.zeros(*lead, s.conv_width - 1, self.conv_channels,
                             dtype=self.dtype, device=dev),
            state=torch.zeros(*lead, self.nheads, s.head_dim, s.state_dim,
                              dtype=torch.float32, device=dev),
            count=torch.zeros(lead, dtype=torch.int32, device=dev)))

    def prefill(self, params, batch, max_seq: int, aqua_proj=None):
        """Prefill ``batch["tokens"]`` (B, S), rectangular, into a fresh
        state. Returns (next-token logits (B, V) of the last token,
        DecodeState)."""
        x = L.embed(params["embed"], batch["tokens"], self.dtype)
        bsz, s = x.shape[:2]
        convs, states = [], []
        for i in range(self.cfg.num_layers):
            x, (conv, state) = self._block_seq(
                layer_params(params["layers"], i), x)
            convs.append(conv.to(self.dtype))
            states.append(state)
        count = torch.full((self.cfg.num_layers, bsz), s, dtype=torch.int32,
                           device=x.device)
        return self._unembed(params, x[:, -1]), DecodeState(layers=SSMCache(
            conv=torch.stack(convs), state=torch.stack(states), count=count))

    def decode_step(self, params, state: DecodeState, tokens: torch.Tensor,
                    aqua_proj=None, write_mask=None):
        """tokens (B,) -> (logits (B, V) float32, state updated in place;
        lanes where ``write_mask`` is False keep their state bit for bit)."""
        x = L.embed(params["embed"], tokens, self.dtype)
        cache = state.layers
        convs, states = [], []
        for i in range(self.cfg.num_layers):
            x, conv, st = self._block_step(layer_params(params["layers"], i),
                                           x, cache.conv[i], cache.state[i])
            convs.append(conv)
            states.append(st)
        new = DecodeState(layers=SSMCache(conv=torch.stack(convs),
                                          state=torch.stack(states),
                                          count=cache.count + 1))
        self.freeze_rows(new, state, write_mask)
        return self._unembed(params, x), state
