"""The float32 prefill and flash kernels' arithmetic, emulated on the CPU.

``csrc/f32_tile.cuh`` runs every product of attention on TF32 tensor
cores (``wgmma``) as a three-pass split: x = hi + lo with hi = tf32(x)
(``cvt.rna``: round to nearest, ties away from zero) and lo = x - hi,
which the tensor cores read at TF32 width (its low 13 bits dropped), and
a·b = lo_a·hi_b + hi_a·lo_b + hi_a·hi_b. A block of 64 query rows walks
its key tiles in ascending order (32 keys when the gathered depth and Dv
are at most 128, else 16) in one online softmax in the log2 domain. Its
two warpgroups split the depth: each sums its half of the k-steps (8 dims
each, the first half the larger) by k-groups of two k-steps, each
k-group's six products (three passes of two k-steps) chained into an
accumulator of their own, the small terms first, folded into the running
sum in float32; the two halves' sums are then added. P is split the same
way before P·V, whose products over a tile add up in an accumulator of
their own, added to the output (rescaled) in float32. The depth is the
block's union of selected dims: the prefill gathers the dims selected by
the ``q_blk`` tiles a 64-row block covers, each row zero where its own tile
did not select. This module emulates that arithmetic in plain PyTorch (TF32
by rounding or masking the float32's int32 view) and holds it to the
kernels' plain versions at their float32 limit, per element |out - ref|
<= 1e-5·|ref| + 1e-5 (``tests/test_torch_gpu.py``'s ``TOL``): the split
must stay within it, one TF32 pass (the control) must break it, and the
reading grows with the scores' scale. Shapes: a reduced width, one (KV
head, query head) pair of Qwen3-0.6B's served prefill (S 1024, head dim
128, 96 selected dims), and one of head dim 256 (S 1024; the prefill at
192 selected dims, flash at all 256: the depth the kernels reach). Inputs
are standard normal draws from seeded numpy generators, as in every GPU
test and ``chip_smoke.py`` phase (scores with a standard deviation near
1); q scaled by c scales the scores by c. The split's reading grows with c
and reaches the limit near c = 6 at the served shape (scores with a
standard deviation near 5).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import aqua_prefill as pk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops

RTOL = ATOL = 1e-5        # the float32 limit of the kernels' GPU tests
ROWS = 64                 # query rows of a block
K_STEP = 8                # depth of one k8 product
K_GROUP = 2               # k-steps of the scores a fresh accumulator sums
NEG_INF = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero (the int32 view's magnitude bits plus half of the
    dropped 13 bits' unit, then those bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """float32 as the tensor cores read it at TF32 width: its 13 low bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    """hi = tf32(x), and lo = x - hi as the products read it."""
    hi = tf32(x)
    return hi, tf32_read(x - hi)


def tile_keys(depth: int, dv: int) -> int:
    """Keys of a tile of the kernels' walk (``f32_tile::tile_keys``)."""
    return 32 if depth <= 128 and dv <= 128 else 16


def product(a: torch.Tensor, b: torch.Tensor, passes: int,
            group: int = K_GROUP) -> torch.Tensor:
    """a (M, K) · b (K, N) as the kernel accumulates: per k-step of 8,
    lo_a·hi_b, hi_a·lo_b, then hi_a·hi_b (passes 3), or hi_a·hi_b alone
    (passes 1), the k-steps of each k-group of ``group`` (the scores' two;
    a tile's P·V all of its own) summed into a fresh float32 accumulator,
    added to the running sum."""
    m, k, n = a.shape[0], a.shape[1], b.shape[1]

    def steps(x, y):        # (k / 8, m, n): each k-step's product
        return torch.bmm(x.reshape(m, k // K_STEP, K_STEP).transpose(0, 1),
                         y.reshape(k // K_STEP, K_STEP, n))
    (ah, al), (bh, bl) = split(a), split(b)
    step = steps(ah, bh)
    if passes == 3:
        step = steps(al, bh) + steps(ah, bl) + step
    acc = torch.zeros(m, n, dtype=torch.float32)
    for i in range(0, len(step), group):
        part = step[i]
        for x in step[i + 1:i + group]:
            part = part + x
        acc = acc + part
    return acc


def emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            visible: torch.Tensor, scale: float, passes: int) -> torch.Tensor:
    """One block of one head: q (R, depth) rows gathered to the block's
    union (zeros in the dims their tile did not select), k (S, depth)
    gathered alike, v (S, Dv), visible (R, S) bool. The online softmax in
    the log2 domain over the key tiles in ascending order, the scores the
    sum of the two halves of the k-steps; O / max(l, 1e-30)."""
    r, s, depth = q.shape[0], k.shape[0], q.shape[1]
    nk = tile_keys(depth, v.shape[1])
    cut = (depth // K_STEP + 1) // 2 * K_STEP      # the first half's dims
    o = torch.zeros(r, v.shape[1])
    m = torch.full((r, 1), NEG_INF)
    l = torch.zeros(r, 1)
    for k0 in range(0, s, nk):
        keys = slice(k0, min(k0 + nk, s))
        x = (product(q[:, :cut], k[keys, :cut].T, passes)
             + product(q[:, cut:], k[keys, cut:].T, passes))
        x = x * (scale * math.log2(math.e))
        x = torch.where(visible[:, keys], x, torch.full_like(x, NEG_INF))
        m_new = torch.maximum(m, x.max(dim=1, keepdim=True).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        m, l = m_new, l * corr + p.sum(dim=1, keepdim=True)
        o = o * corr + product(p, v[keys], passes, group=nk // K_STEP)
    return o / torch.clamp(l, min=1e-30)


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
        chunk, sel = s, torch.ones(1, h, 1, d // 8)
        ref = fk.flash_attention_plain(q, k, v, causal=True)
    g = h // kvh
    out = {}
    for n in passes:
        emu = torch.zeros(h, s, d)
        for i in range(h):
            for r0 in range(0, s, ROWS):
                r1 = min(r0 + ROWS, s)
                # the block's union: the dims its q_blk tiles select
                blocks = sel[0, i, r0 // chunk:(r1 - 1) // chunk + 1].amax(0)
                dims = (blocks > 0).repeat_interleave(8).nonzero()[:, 0]
                emu[i, r0:r1] = emulate(
                    q[0, i, r0:r1][:, dims], k[0, i // g, :r1][:, dims],
                    v[0, i // g, :r1], visible[r0:r1, :r1], sm, n)
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
