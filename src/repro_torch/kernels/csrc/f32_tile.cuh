// float32 tensor-core tile engine shared by aqua_prefill.cu and
// flash_attention.cu (their float32 routes; sm_90a).
//
// What bounds it: the operations. float32 outside the tensor cores peaks
// at 67 TFLOP/s; TF32 tensor cores at 495 TFLOP/s dense, but one TF32
// product keeps 11 of float32's 24 significand bits, and the routes are
// held to their plain float32 versions at 1e-5·|ref| + 1e-5. So every
// product runs as the three-pass split (CUTLASS's 3xTF32): each operand is
// split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (round to nearest,
// ties away, as cvt.rna), and a·b = lo_a·hi_b + hi_a·lo_b + hi_a·hi_b,
// three MMAs, the small terms first (lo_a·lo_b, ~2^-22 of a·b, is
// dropped). That keeps about 22 bits of each product, at 495 / 3 = 165
// TFLOP/s. The tensor cores add with truncation, not rounding, so a sum
// carried through many MMAs drifts toward zero: the scores' MMAs sum each
// k-step (8 dims) into an accumulator of their own, and P·V's each key
// tile, which a float32 add then folds into the running sum. (Scores
// carried through all their k-steps held randn inputs but broke the HF
// drive's float32 logit limit; PERF.md.) tests/test_torch_f32_split.py
// emulates this arithmetic on the CPU and holds it to the limit at randn
// inputs and with the scores 3x as large (near 6x, scores with a standard
// deviation near 5, it reaches the limit).
//
// A block of kThreads = 256 threads owns kRows = 64 query rows of one (b,
// h) and one kSlice = 128-column slice of the output (blockIdx.y; Dv up to
// kMaxDv = 256 takes two, each recomputing the scores, so each computes
// the same P bit for bit): kRowWarps = 4 warps of 16 rows (the m16 of mma.sync m16n8k8 tf32)
// in each of kGroups = 2 warp groups, and each group takes one 32-key half
// of every key tile, with its own running max, sum and output; the two
// merge at the end. Two groups halve a block's walk, whose longest (the
// causal diagonal's last rows) sets the time of a one-wave grid, and give
// each scheduler two warps. (wgmma takes tf32 only with both
// shared-memory operands K-major, and V, seq-major in the cache, is not.)
// Blocks are issued heaviest (last rows) first, heads fastest.
//
// - Q̂ is staged once in shared memory (cp.async), as float32: its
//   fragments are split as they are loaded, once per k-step of a key tile.
//   The depth is the sorted union of the dims that the block's rows read
//   (the prefill: the dims selected by the q_blk tiles it covers; flash:
//   all D); each row holds zeros in the union's dims its own tile did not
//   select, and a zero product adds exactly 0. The depth is padded with
//   zeros to a multiple of 8 (the k8 of the MMA).
// - Key tiles of kKeys = 64 keys walk in ascending order through
//   nst = 2 stages of shared memory (1 where two do not fit): K̂ gathered
//   to the union's dims and V rows, by cp.async of VEC float32s (16 bytes
//   where bases, strides and dim-blocks allow, else 4), zeros past S. Tile
//   j + 1 is copied while tile j is computed; one block barrier a tile.
//   Row strides are 4 mod 8 floats, so the fragment loads (K̂[key g][t],
//   V[key 2t][dim g]) are free of bank conflicts.
// - S = Q̂·K̂ᵀ per warp: 16 rows x 32 keys, 4 n-tiles of m16n8k8, each
//   pass issued as one batch of independent MMAs with no branch inside; a
//   half that no row of the warp sees is skipped by the warp.
// - The online softmax in registers, in the log2 domain: a thread holds
//   8 of the 32 keys of rows g and g + 8; the row max reduces over
//   the 4 threads of a quad with shuffles, the row sum is kept per thread
//   and reduced once at the end. No shared-memory round trip and no
//   block barrier around it.
// - O = O·corr + P·V: the score accumulator serves as the A fragment
//   directly, by permuting the 8 keys of each k-step: k-slot t is key 2t
//   and k-slot t + 4 key 2t + 1 (c0, c2, c1, c3 of the score fragment),
//   so each thread's B fragment reads V rows 2t and 2t + 1. P is split in
//   registers.
//
// Each row's arithmetic is two sequences O = O·corr_j + P_j·V_j over the
// halves it visits in ascending order, with the block's union as depth,
// and their merge: it does not depend on the block's other rows beyond
// that union, on which warp holds the row, or on the ring's timing.

#pragma once

#include <algorithm>
#include <climits>

#include "attn_tile.cuh"

namespace f32_tile {

using attn_tile::Strides;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowWarps = 4;           // warps of 16 rows
constexpr int kGroups = 2;             // warp groups, one half of each key tile each
constexpr int kWarps = kRowWarps * kGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kRowWarps;  // query rows per block
constexpr int kKeys = 64;              // keys per tile
constexpr int kHalf = kKeys / kGroups; // keys of a tile per group
constexpr int kKN = kHalf / 8;         // 8-key n-tiles of a warp's scores
constexpr int kMaxDepth = 256;         // gathered q·k depth
constexpr int kSlice = 128;            // value / output columns of a block
constexpr int kMaxDv = 256;            // value / output width, in slices
constexpr int kNT = kSlice / 8;        // 8-wide n-tiles of O
constexpr int kMaxTiles = 16;          // q_blk tiles a block may cover (q_blk >= 8)
constexpr int kMaxStages = 2;
// dynamic shared memory a block may use: 227 KB less the static arrays
constexpr int kSmemLimit = 232448 - 2048;

__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }
// a row of n floats, padded to 4 mod 8: conflict-free fragment loads
__host__ __device__ constexpr int row_stride(int n) { return pad8(n) + 4; }

// The problem a launch solves; the pointers of the prefill's selection
// are null for flash (every dim of every row, every key below S).
struct Problem {
  const float *q, *k, *v;
  float* out;
  const int* block_idx;  // (B, H, nqc, nb_sel) selected dim-blocks, or null
  const int* lengths;    // (B,) valid keys, or null (S)
  const int* kc_part;    // (B, nqc, kt) participating key chunks, or null
  int H, KV, Tq, S, q_offset, D, Dv, nb_sel, bd, q_blk, nqc, kt, k_blk;
  Strides qs, ks, vs, os;
  float scale_log2;
  int causal, window;
  // shared memory: row strides (floats), stages, unit words of a dim mask,
  // key chunks of the participation marks
  int qstr, kstr, vstr, nst, nuw, nkc;
};

// Widest union of selected dims a block can gather: one tile's selection
// when q_blk % kRows == 0, else the tiles a block of kRows rows can cover.
inline int union_width(const Problem& p) {
  if (p.block_idx == nullptr) return p.D;
  const int tiles = p.q_blk % kRows == 0   ? 1
                    : kRows % p.q_blk == 0 ? kRows / p.q_blk
                                           : (kRows - 1) / p.q_blk + 2;
  const int w = std::min(tiles, p.nqc) * p.nb_sel * p.bd;
  return w < p.D ? w : p.D;
}

// value slices of a launch: its grid's y
inline int slices(const Problem& p) { return (p.Dv + kSlice - 1) / kSlice; }

inline int smem_bytes(const Problem& p, int nst) {
  return 4 * (kRows * p.qstr + nst * kKeys * (p.kstr + p.vstr) + (kMaxTiles + 1) * p.nuw +
              p.nkc);
}

// Fill in the layout for copies of vec floats; false if the problem does
// not fit the engine.
inline bool plan(Problem& p, int vec) {
  const int w = union_width(p);
  if (w > kMaxDepth || p.Dv > kMaxDv || p.q_blk < 8) return false;
  p.qstr = p.kstr = row_stride(w);
  p.vstr = row_stride(std::min(p.Dv, kSlice));
  p.nuw = (p.D / vec + 31) / 32;
  p.nkc = p.kc_part != nullptr ? (p.S + p.k_blk - 1) / p.k_blk : 0;
  for (p.nst = kMaxStages; p.nst >= 1; --p.nst)
    if (smem_bytes(p, p.nst) <= kSmemLimit) return true;
  return false;
}

// global -> shared copy of BYTES (4, 8 or 16); src_bytes 0 writes zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16)
    attn_tile::cp_async16(dst, src, src_bytes);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     attn_tile::smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

// x rounded to TF32, to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds finite values: half a TF32 unit added to the magnitude's bits,
// the 13 bits below it cleared (two integer instructions)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a · b, m16n8k8, tf32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// One block: rows [row0, row0 + kRows) of head h of lane b against the key
// tiles its rows can see. VEC: floats per copy (4 needs 16-byte aligned
// bases, strides and dims that are multiples of 4, and dim-blocks of a
// multiple of 4 dims; the wrapper checks). kPart: the walk visits only the
// key chunks that some covered q-tile lists, and masks each row by its own
// tile's list. NDV > 0: the slice has NDV 8-wide n-tiles, fixed at
// compile time (16: 128 columns, every slice of Dv 128 and 256, the served
// widths); 0: ceil(its width / 8), at run time.
template <int VEC, bool kPart, int NDV>
__device__ __forceinline__ void attend(const Problem& p) {
  const int H = p.H;
  const int h = blockIdx.x % H, tile = gridDim.x / H - 1 - blockIdx.x / H;
  const int b = blockIdx.z, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / kRowWarps, rw = warp % kRowWarps;  // key half, row warp
  const int kv = h / (H / p.KV);
  const int row0 = tile * kRows, rlast = min(row0 + kRows, p.Tq) - 1;
  const bool dense = p.block_idx == nullptr;
  const int t_first = dense ? 0 : row0 / p.q_blk;
  const int ntile = dense ? 1 : rlast / p.q_blk - t_first + 1;   // <= kMaxTiles
  const int nunits = p.D / VEC;                                 // VEC-dim units of a row
  const int col0 = kSlice * blockIdx.y, dv = min(kSlice, p.Dv - col0);  // the value slice

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * p.qstr;
  float* Vs = Ks + p.nst * kKeys * p.kstr;
  uint32_t* tmask = reinterpret_cast<uint32_t*>(Vs + p.nst * kKeys * p.vstr);  // per tile
  uint32_t* umask = tmask + kMaxTiles * p.nuw;                                  // union
  uint32_t* marks = umask + p.nuw;  // kPart: per key chunk, the covered tiles listing it
  __shared__ int ucol[kMaxDepth];   // union position -> first dim of its unit
  __shared__ int nu_s;
  if (p.lengths != nullptr && p.lengths[b] <= 0) {
    attn_tile::empty_lane(p.v + b * p.vs.b + kv * p.vs.h + col0, p.vs.s, p.S, dv, Qs,
                          p.out + b * p.os.b + h * p.os.h + row0 * p.os.s + col0, p.os.h,
                          p.os.s, 1, rlast - row0 + 1);
    return;
  }

  // the selection: each covered tile's units and their union
  for (int e = tid; e < (kMaxTiles + 1) * p.nuw; e += kThreads) tmask[e] = 0;
  if (kPart)
    for (int e = tid; e < p.nkc; e += kThreads) marks[e] = 0;
  __syncthreads();
  auto set_bits = [&](uint32_t* m, int u0, int u1) {  // units [u0, u1)
    for (int w = u0 / 32; w * 32 < u1; ++w) {
      const int lo = max(u0, 32 * w) - 32 * w, hi = min(u1, 32 * w + 32) - 32 * w;
      atomicOr(&m[w], (hi == 32 ? ~0u : (1u << hi) - 1) & ~((1u << lo) - 1));
    }
  };
  if (dense) {
    if (tid == 0) {
      set_bits(tmask, 0, nunits);
      set_bits(umask, 0, nunits);
    }
  } else {
    const int* idx = p.block_idx + (((int64_t)b * H + h) * p.nqc + t_first) * p.nb_sel;
    for (int e = tid; e < ntile * p.nb_sel; e += kThreads) {
      const int d0 = idx[e] * p.bd;
      const int u0 = d0 / VEC, u1 = (d0 + p.bd + VEC - 1) / VEC;
      set_bits(tmask + e / p.nb_sel * p.nuw, u0, u1);
      set_bits(umask, u0, u1);
    }
  }
  if (kPart) {
    const int* parts = p.kc_part + ((int64_t)b * p.nqc + t_first) * p.kt;
    for (int e = tid; e < ntile * p.kt; e += kThreads) {
      const int kc = parts[e];
      if (kc >= 0 && kc < p.nkc) atomicOr(&marks[kc], 1u << (e / p.kt));
    }
  }
  __syncthreads();
  if (warp == 0) {  // compact the union's units, in ascending order
    int base = 0;
    for (int w0 = 0; w0 < p.nuw; w0 += 32) {
      const uint32_t m = w0 + lane < p.nuw ? umask[w0 + lane] : 0u;
      int incl = __popc(m);
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      int pos = base + incl - __popc(m);
      for (uint32_t r = m; r; r &= r - 1) ucol[pos++] = ((w0 + lane) * 32 + __ffs(r) - 1) * VEC;
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) nu_s = base;
  }
  __syncthreads();
  const int nu = nu_s, width = nu * VEC, depth = pad8(width);

  // zeros: the depth's padding in Q̂ and every K̂ stage, V's past Dv
  for (int r = warp; r < kRows; r += kWarps)
    for (int c = width + lane; c < depth; c += 32) Qs[r * p.qstr + c] = 0.f;
  for (int r = warp; r < p.nst * kKeys; r += kWarps) {
    for (int c = width + lane; c < depth; c += 32) Ks[r * p.kstr + c] = 0.f;
    for (int c = dv + lane; c < pad8(dv); c += 32) Vs[r * p.vstr + c] = 0.f;
  }
  // Q̂ rows: the row's own tile's units, zeros in the rest of the union
  const float* qb = p.q + b * p.qs.b + h * p.qs.h;
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    const uint32_t* sel = tmask + (dense ? 0 : row / p.q_blk - t_first) * p.nuw;
    for (int u = lane; u < nu; u += 32) {
      const int unit = ucol[u] / VEC;
      const bool on = row < p.Tq && ((sel[unit / 32] >> (unit % 32)) & 1);
      cp_async<4 * VEC>(Qs + r * p.qstr + u * VEC, on ? qb + row * p.qs.s + ucol[u] : qb,
                        on ? 4 * VEC : 0);
    }
  }

  const float* kb = p.k + b * p.ks.b + kv * p.ks.h;
  const float* vb = p.v + b * p.vs.b + kv * p.vs.h + col0;
  auto load = [&](int j, int st) {  // tile j into stage st
    float* K = Ks + st * kKeys * p.kstr;
    float* V = Vs + st * kKeys * p.vstr;
    for (int kk = warp; kk < kKeys; kk += kWarps) {
      const int pos = j * kKeys + kk;
      const bool ok = pos < p.S;
      for (int u = lane; u < nu; u += 32)
        cp_async<4 * VEC>(K + kk * p.kstr + u * VEC, ok ? kb + pos * p.ks.s + ucol[u] : kb,
                          ok ? 4 * VEC : 0);
      for (int c = lane * VEC; c < dv; c += 32 * VEC)
        cp_async<4 * VEC>(V + kk * p.vstr + c, ok ? vb + pos * p.vs.s + c : vb, ok ? 4 * VEC : 0);
    }
  };

  // the walk: 64-key tiles from the block's band to its causal bound and
  // lengths[b]; kPart: only those of chunks some covered tile lists
  const int klim = p.lengths != nullptr ? min(p.lengths[b], p.S) : p.S;
  const int kend = p.causal ? min(klim, p.q_offset + rlast + 1) : klim;
  const int ntk = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;
  const int kbeg = p.window > 0 ? max(0, p.q_offset + row0 - p.window + 1) : 0;
  const int j0 = kbeg / kKeys;
  auto chunk_marks = [&](int j) -> uint32_t { return marks[j * kKeys / p.k_blk]; };
  auto live = [&](int j) { return !kPart || chunk_marks(j) != 0; };
  auto next = [&](int j) {
    do ++j;
    while (j < ntk && !live(j));
    return j;
  };
  const int first = j0 >= ntk ? ntk : live(j0) ? j0 : next(j0);

  // this warp's rows: a row r sees the keys kp with lo[r] < kp <= hi[r]
  const int wrow = row0 + rw * 16;
  const bool idle = wrow > rlast;              // no row of the warp is stored
  const int rows[2] = {wrow + g, wrow + g + 8};
  const int wfirst = p.q_offset + wrow;        // the warp's first position
  const int whi = min(klim - 1, p.causal ? wfirst + 15 : INT_MAX);
  int hi[2], lo[2], rbit[2];
  for (int r = 0; r < 2; ++r) {
    const int qpos = p.q_offset + rows[r];
    hi[r] = min(klim - 1, p.causal ? qpos : INT_MAX);
    lo[r] = p.window > 0 ? qpos - p.window : INT_MIN;
    rbit[r] = dense ? 0 : min(rows[r], rlast) / p.q_blk - t_first;
  }
  uint32_t wbits = 0;  // covered tiles holding a row of the warp
  if (kPart && !idle)
    for (int r = wrow; r <= min(wrow + 15, rlast); ++r) wbits |= 1u << (r / p.q_blk - t_first);
  // the warp's half of tile j: keys [j * kKeys + grp * kHalf, + kHalf)
  auto skip = [&](int j) {  // no row of the warp sees a key of its half
    const int k0 = j * kKeys + grp * kHalf;
    return idle || k0 > whi || (p.window > 0 && k0 + kHalf - 1 <= wfirst - p.window) ||
           (kPart && (chunk_marks(j) & wbits) == 0);
  };
  auto masked = [&](int j) {  // some row of the warp masks a key of its half
    const int k0 = j * kKeys + grp * kHalf;
    return kPart || k0 + kHalf > klim || (p.causal && k0 + kHalf - 1 > wfirst) ||
           (p.window > 0 && k0 <= wfirst + 15 - p.window);
  };

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int nks = depth / 8, ndv = pad8(dv) / 8;
  const float* qa = Qs + (rw * 16 + g) * p.qstr + t;

  // The products issue in batches of independent MMAs per pass (lo·hi of
  // every n-tile, then hi·lo, then hi·hi), with no branch inside a batch:
  // a warp's three passes into one accumulator are serially dependent.
  auto compute = [&](int j, int st) {
    if (skip(j)) return;
    const int k0 = j * kKeys + grp * kHalf;
    const float* K = Ks + (st * kKeys + grp * kHalf + g) * p.kstr + t;
    const float* V = Vs + (st * kKeys + grp * kHalf + 2 * t) * p.vstr + g;
    float s[kKN][4];
#pragma unroll
    for (int n = 0; n < kKN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t ah[4], al[4], bh[kKN][2], bl[kKN][2];
      const float* a = qa + ks * 8;
      split(a[0], ah[0], al[0]);
      split(a[8 * p.qstr], ah[1], al[1]);
      split(a[4], ah[2], al[2]);
      split(a[8 * p.qstr + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        const float* kp = K + n * 8 * p.kstr + ks * 8;
        split(kp[0], bh[n][0], bl[n][0]);
        split(kp[4], bh[n][1], bl[n][1]);
      }
      // one k-step's three passes into a fresh accumulator, added to the
      // scores in float32: the tensor cores' truncation stays relative to
      // one k-step's sum, not to the score's
      float d[kKN][4];
#pragma unroll
      for (int n = 0; n < kKN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
#pragma unroll
      for (int n = 0; n < kKN; ++n) mma(d[n], al, bh[n]);
#pragma unroll
      for (int n = 0; n < kKN; ++n) mma(d[n], ah, bl[n]);
#pragma unroll
      for (int n = 0; n < kKN; ++n) mma(d[n], ah, bh[n]);
#pragma unroll
      for (int n = 0; n < kKN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += d[n][e];
    }
    // scores -> log2 domain, masked; the online softmax
    const bool msk = masked(j);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kKN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kp = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * p.scale_log2;
        if (msk && !((!kPart || ((chunk_marks(j) >> rbit[r]) & 1)) && kp <= hi[r] && kp > lo[r]))
          x = kNegInf;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kKN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    // O = O·corr + P·V, P·V into an accumulator of its own per tile and
    // 8 output n-tiles (added to O in float32 once a tile), k-slot t is
    // key 2t, k-slot t + 4 key 2t + 1
#pragma unroll
    for (int d0 = 0; d0 < kNT; d0 += 8) {
      if (NDV > 0 ? d0 < NDV : d0 < ndv) {
        float pv[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[i][e] = 0.f;
#pragma unroll
        for (int n = 0; n < kKN; ++n) {
          uint32_t ah[4], al[4], bh[8][2], bl[8][2];
          split(s[n][0], ah[0], al[0]);
          split(s[n][2], ah[1], al[1]);
          split(s[n][1], ah[2], al[2]);
          split(s[n][3], ah[3], al[3]);
          const float* vp = V + n * 8 * p.vstr;
          // n-tiles past the width (NDV 0) multiply zeros: their
          // products are never stored
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool in = NDV > 0 || d0 + i < ndv;
            split(in ? vp[(d0 + i) * 8] : 0.f, bh[i][0], bl[i][0]);
            split(in ? vp[(d0 + i) * 8 + p.vstr] : 0.f, bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) mma(pv[i], al, bh[i]);
#pragma unroll
          for (int i = 0; i < 8; ++i) mma(pv[i], ah, bl[i]);
#pragma unroll
          for (int i = 0; i < 8; ++i) mma(pv[i], ah, bh[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[d0 + i][e] = o[d0 + i][e] * corr[e >> 1] + pv[i][e];
      }
    }
  };

  // the ring: tile j + 1's copies run beside tile j's products
  if (first < ntk) load(first, 0);
  attn_tile::cp_async_commit();
  for (int j = first, it = 0; j < ntk; ++it) {
    const int jn = next(j), st = p.nst == 2 ? it & 1 : 0;
    attn_tile::cp_async_wait<0>();
    __syncthreads();  // tile j in place; every warp done with the other stage
    if (p.nst == 2) {
      if (jn < ntk) load(jn, st ^ 1);
      attn_tile::cp_async_commit();
    }
    compute(j, st);
    if (p.nst == 1) {
      __syncthreads();
      if (jn < ntk) load(jn, 0);
      attn_tile::cp_async_commit();
    }
    j = jn;
  }
  attn_tile::cp_async_wait<0>();

  // the row sums over the quad; then group 1 hands its (m, l, O) to group
  // 0 through the stages' shared memory, which merges the two halves:
  // O = O_0·2^(m_0 - m) + O_1·2^(m_1 - m), m = max(m_0, m_1), and the same
  // for l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // every warp done with the stages
  float* xfer = Ks;  // [value][thread of a group]: conflict-free
  const int gt = tid % (kThreads / kGroups), gn = kThreads / kGroups;
  const int nxo = NDV > 0 ? NDV : ndv;
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xfer[r * gn + gt] = m[r];
      xfer[(2 + r) * gn + gt] = l[r];
    }
#pragma unroll
    for (int dn = 0; dn < kNT; ++dn)
      if (dn < nxo)
#pragma unroll
        for (int e = 0; e < 4; ++e) xfer[(4 + dn * 4 + e) * gn + gt] = o[dn][e];
  }
  __syncthreads();
  if (grp == 1) return;
  float c0[2], c1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xfer[r * gn + gt], mm = fmaxf(m[r], m1);
    c0[r] = exp2f(m[r] - mm);
    c1[r] = exp2f(m1 - mm);
    l[r] = l[r] * c0[r] + xfer[(2 + r) * gn + gt] * c1[r];
  }
  // out = O / max(l, 1e-30); zeros for a row that saw no key
  float* ob = p.out + b * p.os.b + h * p.os.h + col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = ob + rows[r] * p.os.s;
#pragma unroll
    for (int dn = 0; dn < kNT; ++dn)
      if (dn < nxo)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = dn * 8 + 2 * t + e;
          const float x = o[dn][2 * r + e] * c0[r] + xfer[(4 + dn * 4 + 2 * r + e) * gn + gt] * c1[r];
          if (c < dv) orow[c] = x / denom;
        }
  }
}

}  // namespace f32_tile
