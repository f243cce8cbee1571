// Tensor-core tile engine for wide heads, shared by the bf16 routes of
// aqua_prefill.cu and flash_attention.cu at head dims the warp-specialized
// engine (attn_tile.cuh) does not take: a q·k depth (the prefill's union
// of selected dims, or flash's D) or a value width Dv above 128, up to 256
// (RecurrentGemma's head_dim 256). sm_90a.
//
// A block of kThreads = 256 threads (8 warps x 16 rows) owns kRows = 128
// query rows of one (b, h) and walks kKeys = 64-key tiles, in ascending
// order, through two shared-memory stages that cp.async fills (16-byte
// copies, zeros past S): while the warps compute on one stage, the next
// tile's copies land in the other. Per tile and warp:
//
// - S = Q·Kᵀ with mma.sync m16n8k16 (bf16 in, f32 accumulate), both
//   operands by ldmatrix from shared memory, over the block's union of
//   8-dim chunks (flash: every chunk of D) padded to a k-step of 16 dims.
// - The online softmax of attn_tile.cuh (softmax_tile: the same log2
//   domain, masks and rounding), in registers.
// - O += P·V with mma.sync, P from the S accumulators split into P_hi =
//   bf16(P) and P_lo = bf16(P - P_hi) (two products into the same
//   accumulator, as the warp-specialized engine does to hold the
//   outputs to one bf16 ulp), V by ldmatrix.trans. O is 16 rows x 256
//   columns of f32: 128 registers a thread.
//
// A warp skips a tile that masks all of its 16 rows (past its causal
// bound, or before its rows' window): such a tile would add exactly
// nothing. The per-row arithmetic is O = O·corr_j + P_j·V_j over the
// row's visited tiles in ascending order, as in the plain version.
//
// What bounds it: operations (the prefill's S²/2 · H · (union + Dv)
// multiply-adds at prompt lengths), run on mma.sync at 8 warps a block,
// one block a SM (192 KB of shared memory): a simple kernel, not the
// warp-specialized design, whose 64-row wgmma accumulators at Dv 256 would
// take the consumers past their register budget.
//
// Shared memory: Q̂ (kRows rows), two K̂ stages and two V stages (kKeys
// rows each), every row 32 chunks of 16 bytes (256 dims) with chunk c of
// row r at c ^ (r % 8): ldmatrix reads 8 rows of one chunk without bank
// conflicts.

#pragma once

#include <climits>

#include "attn_tile.cuh"

namespace wide_tile {

using attn_tile::bf16;
using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;
using attn_tile::kNegInf;
using attn_tile::smem_u32;
using attn_tile::softmax_tile;
using attn_tile::split_pair;
using attn_tile::Strides;

constexpr int kThreads = 256;          // 8 warps
constexpr int kRows = 128;             // query rows per block, 16 per warp
constexpr int kKeys = 64;              // keys per tile
constexpr int kChunks = 32;            // 16-byte chunks of a staged row: 256 dims
constexpr int kRowElems = kChunks * 8;
constexpr int kNT = kChunks;           // 8-wide n-tiles of O (Dv <= 256)
constexpr int kMaxTiles = 16;          // q_blk tiles a block covers (q_blk >= 8)

struct Problem {
  const bf16 *q, *k, *v;
  bf16* out;
  const int* block_idx;  // (B, H, NQC, NB_sel) selected dim-blocks, or null: every dim
  const int* lengths;    // (B,) valid keys, or null: S
  const int* kc_part;    // (B, NQC, KT) participating k_blk-key chunks, or null
  int kt, k_blk;
  int H, KV, Tq, S, q_offset, D, Dv, nb_sel, bd, q_blk, nqc;
  Strides qs, ks, vs, os;
  float scale_log2;
  int causal, window;
};

// element offset of chunk c of row r in a staged tile
__device__ __forceinline__ int sw(int r, int c) { return r * kRowElems + ((c ^ (r & 7)) << 3); }

__device__ __forceinline__ void ldsm4(uint32_t (&x)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&x)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_u32(p)));
}
// d (16x8, f32) += a (16x16 bf16) · b (16x8 bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Dynamic shared memory of a launch: Q̂, two K̂ and two V stages, the
// participating walk's marks, 128 bytes of alignment.
inline int smem_bytes(const Problem& p) {
  const int nkc = p.kc_part ? (p.S + p.k_blk - 1) / p.k_blk : 0;
  return 128 + (kRows + 4 * kKeys) * kRowElems * 2 + (nkc + 1) / 2 * 4;
}

// One block: 128 query rows of head blockIdx.x % H (row blocks heaviest
// first), batch row blockIdx.z.
__device__ __forceinline__ void attend(const Problem& p) {
  const int H = p.H;
  const int h = blockIdx.x % H, tile = gridDim.x / H - 1 - blockIdx.x / H;
  const int b = blockIdx.z, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kv = h / (H / p.KV);
  const int row0 = tile * kRows;
  const int rlast = min(row0 + kRows, p.Tq) - 1;
  const bool sel_dims = p.block_idx != nullptr;
  const int q_blk = sel_dims ? p.q_blk : kRows;
  const int t_first = row0 / q_blk;
  const int ntile = rlast / q_blk - t_first + 1;
  const bool part = p.kc_part != nullptr;
  const int nkc = part ? (p.S + p.k_blk - 1) / p.k_blk : 0;

  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  bf16* Ks = Qs + kRows * kRowElems;          // two stages
  bf16* Vs = Ks + 2 * kKeys * kRowElems;      // two stages
  uint32_t* marks = reinterpret_cast<uint32_t*>(Vs + 2 * kKeys * kRowElems);
  __shared__ uint32_t tile_dims[kMaxTiles][8];  // per covered q-tile: its selected dims
  __shared__ uint32_t union_chunks;             // 8-dim chunks holding a selected dim
  __shared__ int uc[kChunks];                   // union position -> 8-dim chunk

  if (tid < kMaxTiles * 8) tile_dims[tid / 8][tid % 8] = sel_dims ? 0u : ~0u;
  if (tid == 0) union_chunks = sel_dims ? 0u : (p.D / 8 == 32 ? ~0u : (1u << (p.D / 8)) - 1);
  if (part)
    for (int e = tid; e < (nkc + 1) / 2; e += kThreads) marks[e] = 0;
  __syncthreads();
  if (sel_dims) {
    auto bits = [](int lo, int hi) {  // bits [lo, hi) of a word, 0 <= lo < hi <= 32
      return (hi == 32 ? ~0u : (1u << hi) - 1) & ~((1u << lo) - 1);
    };
    const int* idx = p.block_idx + (((int64_t)b * H + h) * p.nqc + t_first) * p.nb_sel;
    for (int e = tid; e < ntile * p.nb_sel; e += kThreads) {
      const int d0 = idx[e] * p.bd, d1 = d0 + p.bd;
      for (int w = d0 / 32; w * 32 < d1; ++w)
        atomicOr(&tile_dims[e / p.nb_sel][w],
                 bits(max(d0, 32 * w) - 32 * w, min(d1, 32 * w + 32) - 32 * w));
      atomicOr(&union_chunks, bits(d0 / 8, (d1 + 7) / 8));
    }
  }
  if (part) {
    const int* parts = p.kc_part + ((int64_t)b * p.nqc + t_first) * p.kt;
    for (int e = tid; e < ntile * p.kt; e += kThreads) {
      const int kc = parts[e];
      if (kc >= 0 && kc < nkc) atomicOr(&marks[kc >> 1], 1u << ((kc & 1) * 16 + e / p.kt));
    }
  }
  __syncthreads();
  const uint32_t um = union_chunks;
  const int nu = __popc(um);
  const int nks = (nu + 1) / 2, nck = 2 * nks;  // k-steps of 16 dims
  if (tid < 32 && ((um >> tid) & 1)) uc[__popc(um & ((1u << tid) - 1))] = tid;
  const int nvc = p.Dv / 8, nvp = (nvc + 1) / 2;  // V chunks, 16-dim pairs of them
  // padding no copy writes: Q̂ and K̂ chunks nu .. nck - 1, V chunks nvc ..
  // 2·nvp - 1 (zero products add exactly 0)
  if (nu < nck) {
    for (int r = tid; r < kRows; r += kThreads)
      *reinterpret_cast<uint4*>(Qs + sw(r, nu)) = make_uint4(0, 0, 0, 0);
    for (int r = tid; r < 2 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(Ks + sw(r, nu)) = make_uint4(0, 0, 0, 0);
  }
  if (nvc < 2 * nvp)
    for (int r = tid; r < 2 * kKeys; r += kThreads)
      *reinterpret_cast<uint4*>(Vs + sw(r, nvc)) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // Q̂ rows: each row's own tile's selected dims, zeros in the rest of
  // the union (rows past Tq: zeros)
  const bf16* qb = p.q + b * p.qs.b + h * p.qs.h;
  for (int e = tid; e < kRows * nu; e += kThreads) {
    const int r = e / nu, u = e - r * nu, c = uc[u], row = row0 + r;
    const uint32_t sel =
        row < p.Tq ? (tile_dims[row / q_blk - t_first][c / 4] >> (c % 4 * 8)) & 0xffu : 0u;
    bf16* dst = Qs + sw(r, u);
    const bf16* src = qb + (int64_t)row * p.qs.s + c * 8;
    if (sel == 0xffu || sel == 0u) {
      cp_async16(dst, sel ? src : qb, sel ? 16 : 0);
    } else {
      uint4 x = *reinterpret_cast<const uint4*>(src);
      uint16_t* el = reinterpret_cast<uint16_t*>(&x);
      for (int i = 0; i < 8; ++i)
        if (!((sel >> i) & 1)) el[i] = 0;
      *reinterpret_cast<uint4*>(dst) = x;
    }
  }
  cp_async_commit();

  const int klim = p.lengths ? max(0, min(p.lengths[b], p.S)) : p.S;
  const int kend = p.causal ? min(klim, p.q_offset + rlast + 1) : klim;
  const int ntk = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;
  const int kbeg = p.window > 0 ? max(0, p.q_offset + row0 - p.window + 1) : 0;
  auto chunk_marks = [&](int j) -> uint32_t {
    const int c = j * kKeys / p.k_blk;
    return (marks[c >> 1] >> ((c & 1) * 16)) & 0xffffu;
  };
  auto live = [&](int j) { return !part || chunk_marks(j) != 0; };
  auto next = [&](int j) {
    do ++j;
    while (j < ntk && !live(j));
    return j;
  };
  const int j0 = kbeg / kKeys;
  const int first = j0 >= ntk ? ntk : live(j0) ? j0 : next(j0);

  const bf16* kb = p.k + b * p.ks.b + kv * p.ks.h;
  const bf16* vb = p.v + b * p.vs.b + kv * p.vs.h;
  // the copies of key tile j into stage st: K̂'s union chunks, V's chunks
  auto load = [&](int j, int st) {
    bf16* kst = Ks + st * kKeys * kRowElems;
    bf16* vst = Vs + st * kKeys * kRowElems;
    const int k0 = j * kKeys;
    for (int e = tid; e < kKeys * nu; e += kThreads) {
      const int n = e / nu, u = e - n * nu, key = k0 + n;
      const bool in = key < p.S;
      cp_async16(kst + sw(n, u), in ? kb + (int64_t)key * p.ks.s + uc[u] * 8 : kb, in ? 16 : 0);
    }
    for (int e = tid; e < kKeys * nvc; e += kThreads) {
      const int n = e / nvc, c = e - n * nvc, key = k0 + n;
      const bool in = key < p.S;
      cp_async16(vst + sw(n, c), in ? vb + (int64_t)key * p.vs.s + c * 8 : vb, in ? 16 : 0);
    }
  };

  const int g = lane >> 2, t4 = lane & 3;
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const int qpos[2] = {p.q_offset + rows[0], p.q_offset + rows[1]};
  const int rbit[2] = {min(rows[0], rlast) / q_blk - t_first,
                       min(rows[1], rlast) / q_blk - t_first};
  const int warp_first = p.q_offset + row0 + warp * 16;
  const int warp_last = warp_first + 15;
  // a row r sees the keys kp with lo[r] < kp <= hi[r], and (part) in a
  // chunk its tile lists
  const int hi[2] = {min(klim - 1, p.causal ? qpos[0] : INT_MAX),
                     min(klim - 1, p.causal ? qpos[1] : INT_MAX)};
  const int lo[2] = {p.window > 0 ? qpos[0] - p.window : INT_MIN,
                     p.window > 0 ? qpos[1] - p.window : INT_MIN};
  auto masked = [&](int j) {
    const int k0 = j * kKeys;
    return part || k0 + kKeys > klim || (p.causal && k0 + kKeys - 1 > warp_first) ||
           (p.window > 0 && k0 <= warp_last - p.window);
  };
  // every row of the warp is masked out of tile j
  auto skip = [&](int j) {
    const int k0 = j * kKeys;
    return (p.causal && k0 > warp_last) || (p.window > 0 && k0 + kKeys - 1 <= warp_first - p.window);
  };

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale_log2 = p.scale_log2;

  if (first < ntk) load(first, 0);
  cp_async_commit();
  int it = 0;
  for (int j = first; j < ntk; ++it) {
    const int nxt = next(j);
    if (nxt < ntk) load(nxt, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q̂ and tile j have landed
    __syncthreads();
    if (!skip(j)) {
      const bf16* kst = Ks + (it & 1) * kKeys * kRowElems;
      const bf16* vst = Vs + (it & 1) * kKeys * kRowElems;
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const int mi = lane >> 3, r8 = lane & 7;
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t a[4];
        ldsm4(a, Qs + sw(warp * 16 + (mi & 1) * 8 + r8, 2 * ks + (mi >> 1)));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          ldsm4(bb, kst + sw(16 * np + (mi >> 1) * 8 + r8, 2 * ks + (mi & 1)));
          mma16816(s[2 * np], a, bb[0], bb[1]);
          mma16816(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      float corr[2];
      const int jj = j;
      softmax_tile(s, m, l, corr, scale_log2, masked(jj), [&](int r, int kk) {
        const int kp = jj * kKeys + kk;
        return (!part || ((chunk_marks(jj) >> rbit[r]) & 1)) && kp <= hi[r] && kp > lo[r];
      });
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          if (np < nvp) {
            uint32_t bb[4];
            ldsm4_t(bb, vst + sw(16 * kk + (mi & 1) * 8 + r8, 2 * np + (mi >> 1)));
            mma16816(o[2 * np], ph, bb[0], bb[1]);
            mma16816(o[2 * np], pl, bb[0], bb[1]);
            mma16816(o[2 * np + 1], ph, bb[2], bb[3]);
            mma16816(o[2 * np + 1], pl, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // stage it & 1 is free for tile it + 2
    j = nxt;
  }
  cp_async_wait<0>();

  // finalize and store this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* ob = p.out + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + (int64_t)rows[r] * p.os.s + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      if (n < nvc)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

// Launch attend through `kernel` (a __global__ wrapper of it): grid of
// row blocks x heads, batch on z. `done` is the caller's record of the
// shared-memory limit it set per device (allow_smem): one per kernel, kept
// by the caller in its own translation unit (a static here would be one
// symbol that every library loading this header shares).
template <class Kernel>
inline int launch(Kernel kernel, const Problem& p, int B, cudaStream_t st, int (&done)[16]) {
  const int bytes = smem_bytes(p);
  cudaError_t err = attn_tile::allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tq + kRows - 1) / kRows * p.H, 1, B);
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace wide_tile
