"""The float32 prefill and flash kernels' arithmetic, emulated on the CPU.

``csrc/f32_tile.cuh`` runs every product of attention on TF32 tensor
cores as a three-pass split: x = hi + lo with hi = tf32(x) and lo =
tf32(x - hi) (``cvt.rna``: round to nearest, ties away from zero), and
a·b = lo_a·hi_b + hi_a·lo_b + hi_a·hi_b, per k-step of 8 into an
accumulator of its own, the small terms first, then added to the running
sum in float32. The online softmax runs in the log2
domain over 64-key tiles, each split into two 32-key halves: two streams
(a warp group each) with their own max, sum and output, merged at the
end. P is split the same way before P·V, whose products add up in an
accumulator of their own per tile, added to the output in float32. This
module emulates that arithmetic in plain PyTorch (TF32 rounding by
masking the low 13 bits of the float32's int32 view) and holds it to the
kernels' plain versions at their float32 limit, per element |out - ref|
<= 1e-5·|ref| + 1e-5 (``tests/test_torch_gpu.py``'s ``TOL``): the split
must stay within it, one TF32 pass (the control) must break it, and the
reading grows with the scores' scale. Shapes: a reduced width, one
(KV head, query head) pair of Qwen3-0.6B's served prefill (S 1024, head
dim 128, 96 selected dims), and one of head dim 256 (S 1024; the prefill
at 192 selected dims, flash at all 256: the depth the kernels reach). Inputs are standard normal draws from seeded
numpy generators, as in every GPU test and ``chip_smoke.py`` phase
(scores with a standard deviation near 1); q scaled by c scales the
scores by c. The split's reading grows with c and reaches the limit near
c = 6 at the served shape (scores with a standard deviation near 5).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import aqua_prefill as pk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops

RTOL = ATOL = 1e-5        # the float32 limit of the kernels' GPU tests
KEYS = 64                 # keys per tile of the kernels' walk
HALF = 32                 # keys of a tile per warp group
K_STEP = 8                # depth of one m16n8k8 product
NEG_INF = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero (the int32 view's magnitude bits plus half of the
    dropped 13 bits' unit, then those bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a (M, K) · b (K, N) as the kernel's scores accumulate: per k-step of
    8, lo_a·hi_b, hi_a·lo_b, then hi_a·hi_b (passes 3), or tf32(a)·tf32(b)
    alone (passes 1), into a fresh float32 accumulator, added to the
    running sum. (The kernel's P·V sums a tile's k-steps into one
    accumulator before adding it; the order differs from this one by
    float32 rounding only.)"""
    m, k, n = a.shape[0], a.shape[1], b.shape[1]

    def steps(x, y):        # (k / 8, m, n): each k-step's product
        return torch.bmm(x.reshape(m, k // K_STEP, K_STEP).transpose(0, 1),
                         y.reshape(k // K_STEP, K_STEP, n))
    (ah, al), (bh, bl) = split(a), split(b)
    step = steps(ah, bh)
    if passes == 3:
        step = steps(al, bh) + steps(ah, bl) + step
    acc = torch.zeros(m, n, dtype=torch.float32)
    for x in step:
        acc = acc + x
    return acc


def emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            visible: torch.Tensor, scale: float, passes: int) -> torch.Tensor:
    """One head: q (T, D) rows (zeros in the dims their tile did not
    select), k (S, D), v (S, Dv), visible (T, S) bool. Two streams of the
    online softmax in the log2 domain, over the first and the second
    32-key half of every 64-key tile, merged at the end; O / max(l,
    1e-30)."""
    t, s = q.shape[0], k.shape[0]
    streams = []
    for half in range(KEYS // HALF):
        o = torch.zeros(t, v.shape[1])
        m = torch.full((t, 1), NEG_INF)
        l = torch.zeros(t, 1)
        for k0 in range(half * HALF, s, KEYS):
            keys = slice(k0, min(k0 + HALF, s))
            x = product(q, k[keys].T, passes) * (scale * math.log2(math.e))
            x = torch.where(visible[:, keys], x, torch.full_like(x, NEG_INF))
            m_new = torch.maximum(m, x.max(dim=1, keepdim=True).values)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            m, l = m_new, l * corr + p.sum(dim=1, keepdim=True)
            o = o * corr + product(p, v[keys], passes)
        streams.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = streams
    m = torch.maximum(m0, m1)
    c0, c1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    return (o0 * c0 + o1 * c1) / torch.clamp(l0 * c0 + l1 * c1, min=1e-30)


@pytest.fixture(autouse=True)
def one_thread():
    """Small products one after another: one thread, so that test workers
    sharing the CPUs do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reading(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst |out - ref| over the per-element limit (<= 1 is within it)."""
    return ((out - ref).abs() / (RTOL * ref.abs() + ATOL)).max().item()


# (name, kernel, H, KV, S, D, q_blk): a reduced width, and one head pair
# of the served Qwen3-0.6B prefill (S 1024, 96 of 128 dims selected)
CASES = {
    "prefill-reduced": ("prefill", 4, 2, 200, 32, 16),
    "prefill-served": ("prefill", 2, 1, 1024, 128, 128),
    "flash-reduced": ("flash", 4, 2, 200, 32, None),
    "flash-served": ("flash", 2, 1, 1024, 128, None),
    # head_dim 256 (RecurrentGemma-9B's, as a float32 run computes it):
    # 192 of 256 dims selected, and flash at the full depth
    "prefill-wide": ("prefill", 2, 1, 1024, 256, 128),
    "flash-wide": ("flash", 2, 1, 1024, 256, None),
}


def _inputs(h, kvh, s, d, seed, score_scale):
    """q, k, v standard normal; q times ``score_scale``."""
    rng = np.random.default_rng(seed)
    q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((1, h, s, d), (1, kvh, s, d), (1, kvh, s, d))]
    return q * score_scale, k, v


def readings(case: str, score_scale: float = 1.0, passes=(3, 1)) -> dict:
    """Each emulation's reading against the kernel's plain version."""
    kind, h, kvh, s, d, q_blk = CASES[case]
    q, k, v = _inputs(h, kvh, s, d, seed=s + d, score_scale=score_scale)
    pos = torch.arange(s)
    visible = pos[:, None] >= pos[None, :]
    sm = d ** -0.5
    if kind == "prefill":
        lengths = torch.full((1,), s, dtype=torch.int32)
        block_idx, _, chunk = ops.prefill_blocks(q, lengths, 0.75, 8, q_blk)
        ref = pk.aqua_prefill_plain(q, k, v, block_idx, lengths,
                                    block_dims=8, q_blk=chunk, causal=True,
                                    scale=sm)
        sel = torch.zeros(1, h, block_idx.shape[2], d // 8)
        sel.scatter_(-1, block_idx.long(), 1.0)
        mask = sel.repeat_interleave(8, -1).repeat_interleave(chunk, 2)
        q = q * mask[:, :, :s]
    else:
        ref = fk.flash_attention_plain(q, k, v, causal=True)
    g = h // kvh
    out = {}
    for n in passes:
        emu = torch.stack([emulate(q[0, i], k[0, i // g], v[0, i // g],
                                   visible, sm, n) for i in range(h)])
        out[n] = reading(emu, ref[0])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_three_pass_split_holds_the_float32_limit(case):
    assert readings(case, passes=(3,))[3] <= 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_one_tf32_pass_breaks_the_float32_limit(case):
    """The control: the same walk with one TF32 product per step."""
    assert readings(case, passes=(1,))[1] > 1.0


@pytest.mark.parametrize("case", ["prefill-served", "flash-served"])
def test_split_reading_grows_with_the_score_scale(case):
    """The split's error in a score grows with the score: with q scaled 3x
    (scores with a standard deviation near 3) it reads more than at 1x and
    stays within the limit."""
    one, three = readings(case)[3], readings(case, score_scale=3.0)[3]
    assert one < three <= 1.0


def test_tf32_rounds_to_nearest_ties_away():
    unit = 2.0 ** -10               # TF32's unit in the last place at 1.0
    x = torch.tensor([1.0 + unit / 2, -(1.0 + unit / 2), 1.0 + unit / 4,
                      1.0 + 3 * unit / 4, 1.0, -2.5], dtype=torch.float32)
    want = torch.tensor([1.0 + unit, -(1.0 + unit), 1.0, 1.0 + unit, 1.0,
                         -2.5])
    assert torch.equal(tf32(x), want)
    # the split keeps 22 significant bits: |x - hi - lo| <= 2^-22 |x|
    x = torch.tensor([math.pi], dtype=torch.float32)
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert abs((hi.double() + lo.double() - x.double()).item()) \
        <= 2 ** -22 * math.pi


def test_split_reaches_the_limit_past_5x_scores():
    """Where the split stops holding: flash at the served shape reads
    within the limit with q scaled 4x and past it at 8x (it crosses near
    6x, as the prefill does)."""
    assert readings("flash-served", score_scale=4.0, passes=(3,))[3] < 1.0
    assert readings("flash-served", score_scale=8.0, passes=(3,))[3] > 1.0
