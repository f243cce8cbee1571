// AQUA block-sparse prefill attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernel bodies of src/repro/kernels/aqua_prefill.py:
// _kernel (every key chunk) and, as the compile-time variant kPart,
// _part_kernel (only each q-tile's participating key chunks, hierarchical
// AQUA's prefill stage). Causal block attention in which every query of a
// q_blk chunk shares the chunk's NB_sel dim-blocks selected from its summed
// |q̂|. Keys at or past lengths[b] are masked; rows at or past it (a
// padded admission's pad rows, which an MoE routes) see every valid key,
// as in the Pallas kernel. A lane with lengths[b] = 0 gets the mean of its
// V over all S keys in every row, as the plain version and JAX's dense
// reference give (attn_tile::empty_lane; the Pallas kernel averages the
// keys of the tiles its causal band visits instead).
//
// Sliding window (window > 0; <= 0 means none, as in flash_attention.cu):
// a query at position qpos sees only keys kpos > qpos - window, on top of
// the causal and length masks (the Pallas kernels' `window`, with or
// without `causal`). The walk starts at the block's band: a key tile whose
// last key is at or before the block's first query position - window is
// never visited, so the bytes and operations of a block scale with the
// window, not with S; inside the band the mask is per row.
//
// Chunk-resumable form (q_offset): the T query rows are sequence positions
// [q_offset, q_offset + T) attending the S keys [0, S), q_offset + T <= S.
// Selection tiles anchor at the first query row (block_idx and kc_part
// index chunk-local q_blk tiles), the causal bound of a row is its global
// position. A chunk whose q_offset is a multiple of 128 has the same
// 128-row blocks as the monolithic call, which walk the same key tiles in
// the same order: its rows are bitwise the monolithic rows.
//
// Layout: q (B, H, T, D), k (B, KV, S, D), v (B, KV, S, Dv) addressed by
// element strides of their batch, head and sequence axes (the innermost
// dim must be contiguous), so the model's (B, S, KV, G, D) tensors are read
// in place without a transpose. out (B, H, T, Dv) is written the same way.
//
// Bound on the H100: operations at serving prompt lengths (S = 2048: ~S²/2
// · H · (NB_sel·bd + Dv) multiply-adds against ~S · KV · (D + Dv) bytes).
//
// bf16 route (every full-size drive), on the tensor cores, with the
// warp-specialized engine of attn_tile.cuh: one block of 384 threads per
// (b, h, 128 query rows, 128-column value slice), two consumer warpgroups
// of 64 rows and a producer warpgroup, over an mbarrier ring of four
// stages (three at a 256-dim union). A block gathers the
// sorted union of the 8-dim chunks holding a dim selected by the q_blk
// tiles it covers (one tile's selection when q_blk % 128 == 0 and bd % 8
// == 0, as on every served full-size path); each Q̂ row is staged once
// with zeros in the union's dims its own tile did not select (zero
// products add exactly 0), padded to a depth multiple of 16, and read by
// the products from shared memory. Per key tile the producer gathers the
// K̂ tile by TMA, one box of 64 keys x 1, 2, 4 or 8 chunks per power-of-two
// piece of each run of consecutive union chunks, from 5D tensor maps over
// the strided (B, KV, S, D / 8, 8) view, packed chunk-major into a dense
// 64 x depth tile (only the selected chunks are read; 16-byte cp.async
// copies by the producer warp took 1.6x as long: PERF.md, Findings), and the V
// tile's slice from a 4D map over the strided (B, KV, S, Dv) view (boxes of 64
// dims x 64 keys, 128-byte swizzle); zeros past S and past Dv. What bounds
// it on the card is the tensor-core time (~1.5x the bound's operations:
// P·V runs for P's hi and lo halves) and the softmax between the products:
// the consumers take turns on the tensor cores, so one warpgroup's softmax
// runs beside the other's products, and P·V of one tile beside the scores
// of the next. The served shapes (a 12-chunk union with Dv 128, an 8-chunk
// union with Dv 80) take kernels whose depth and P·V width are fixed at
// compile time, where the compiler keeps the products asynchronous; in the
// generic kernel it serializes them for want of registers and its
// consumers run free of each other instead (PERF.md, Findings). P·V is
// m64n128, or m64n64 + m64n16 for Dv 80 (head_dim 80), so no product runs
// on padding columns. The walk visits 64-key tiles in
// ascending order up to the block's causal bound and lengths[b]; blocks
// are issued heaviest (last rows) first. bf16 needs D % 8 == 0, D <= 256,
// 16-byte aligned bases and outer strides that are whole 16-byte units
// under 2^40 bytes (the wrapper checks).
//
// Wide heads (a Dv or a union of selected dims above 128, up to 256:
// RecurrentGemma-9B's head_dim 256 at k_ratio 0.75 keeps 192 dims a
// q-tile, up to 256 across a block's tiles) run on the same engine
// (aqua_prefill_bf16_wide): the union padded with zero chunks to a depth
// fixed at compile time (16, 24 or 32 chunks: the generic kernel's
// run-time depth costs it its asynchronous products), Dv cut into
// 128-column slices, one a block, each block recomputing the scores of its
// rows (every slice computes the same P bit for bit), P·V on m64n128. What
// bounds it: the tensor-core work, per (query, key) pair and head
// slices·union + 2·Dv multiply-adds (the scores once per slice, P·V for
// P's hi and lo halves: 896 at RecurrentGemma's shape, 2.0x the bound's
// 192 + 256), at one block a SM (~209 KB of shared memory: Q̂ 48 KB and
// four stages of a 24-chunk K̂ and two V boxes); the design keeps what the
// narrow kernels overlap (copies by TMA, one warpgroup's softmax beside
// the other's products). The kernels of union and value widths up to 128
// keep their template arguments.
//
// float32 route (what a served HF checkpoint runs: config_from_hf gives
// float32 params and activations; both bodies, _kernel and kPart's
// _part_kernel), on the tensor cores with the engine of f32_tile.cuh: wgmma
// on TF32 with every product split into three passes (hi = tf32(x), lo =
// x - hi), which hold the plain float32 version's 1e-5 limits that one
// TF32 pass misses by ~50x. What bounds it: the operations, each run as
// three TF32 products at 495 TFLOP/s, 165 TFLOP/s of float32 work
// (against 67 TFLOP/s of scalar float32). One block of two warpgroups
// computes each (row, key) score once for every output column, Dv up to
// 256 (no value slices on the grid): at depths and Dv up to 128 with
// q_blk % 128 == 0 and a grid of 1.5 waves or more, 128-row blocks whose
// warpgroups each own 64 rows; else 64-row blocks whose warpgroups split
// the depth of the scores (exchanging partial scores through shared
// memory) and the output columns. K̂ (the union of the covered q_blk
// tiles' selected dims, gathered by cp.async: 16-byte copies when bd, D
// and Dv are multiples of 4 and the views 16-byte aligned, else 4-byte)
// and V (landing row-major, then transposed: tf32 wgmma takes K-major
// operands only) are split into hi and lo once a block by the threads
// that copied them, into a ring of two stages at every depth (32-key
// tiles at depths and Dv up to 128, 16-key tiles past them); Q̂ is split
// once a key tile by the thread whose A fragment holds it, P once by the
// thread that holds it. It takes unions of at most 256 dims (always when
// D <= 256, or q_blk >= 64 with NB_sel·bd <= 128), Dv <= 256 and q_blk
// >= 8. A chunk whose q_offset is a multiple of 64 (and of q_blk) has the
// same blocks, or in the other form the same arithmetic of each row, as
// the monolithic call: its rows are bitwise the monolithic rows, as on
// the bf16 route.
//
// kPart: kc_part (B, NQC, KT) lists each q-tile's participating k_blk-key
// chunks, ascending (-1 = none), k_blk % 64 == 0. A block (of either
// route) marks, per key chunk, which of its q-tiles list it, visits the
// key tiles (64 keys bf16, 16 or 32 float32) of the marked chunks in
// ascending order and masks each row by its own tile's mark. Masks use the
// logical key positions, so dropped chunks cost no bytes and the identity
// list walks exactly the tiles of the dense walk (bitwise equal).

#include <algorithm>
#include <climits>

#include "attn_tile.cuh"
#include "f32_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::Strides;

struct Part {
  const int* kc_part;  // (B, NQC, KT) participating key chunks, or null
  int kt, k_blk;
};

// K̂ gather maps, boxes of 1, 2, 4 and 8 chunks (attn_tile::make_chunk_map)
struct KMaps {
  CUtensorMap m[4];
};

struct Args {
  const void *q, *k, *v;
  const int *block_idx, *lengths;
  void* out;
  int B, H, KV, Tq, S, q_offset, D, Dv, nb_sel, bd, q_blk, nqc;
  Strides qs, ks, vs, os;
  float scale;
  int causal, window;
  Part part;
  cudaStream_t st;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// One block of the bf16 route: 128 query rows of head blockIdx.x % H
// (row blocks heaviest first), value slice blockIdx.y (columns [128·y,
// 128·y + 128) of Dv), batch row blockIdx.z, over a ring of STAGES
// stages. NKS > 0 and KIND >= 0: every block walks NKS k-steps of Q̂·K̂ᵀ
// (its union padded with zero chunks) and P·V of width KIND (pv_tile),
// fixed at compile time; else each block's own union and Dv at run time.
// kSlices: Dv may pass 128 (the wide kernels); else the one slice is all
// of Dv and the code is the narrow kernels' own (flash_attention.cu's
// flash_block says why).
template <bool kPart, int NKS, int KIND, int STAGES, bool kSlices>
__device__ __forceinline__ void prefill_block(
    const KMaps& kmaps, const CUtensorMap& vmap, const bf16* __restrict__ q,
    const bf16* __restrict__ v, const int* __restrict__ block_idx,
    const int* __restrict__ lengths, bf16* __restrict__ out, int H, int KV, int Tq, int S,
    int q_offset, int Dv, int nb_sel, int bd, int q_blk, int nqc, Strides qst, Strides vst,
    Strides ost, float scale_log2, int causal, int window, Part part, int kstage) {
  using namespace attn_tile;
  // heaviest blocks first (the last rows walk the most key tiles), heads
  // fastest: a causal grid's long blocks do not start last
  const int h = blockIdx.x % H, tile = gridDim.x / H - 1 - blockIdx.x / H;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int kv = h / (H / KV);
  const int row0 = tile * kRows;
  const int rlast = min(row0 + kRows, Tq) - 1;
  const int t_first = row0 / q_blk;                 // the q_blk tiles this block covers
  const int ntile = rlast / q_blk - t_first + 1;    // <= 16: q_blk >= 8
  const int nkc = kPart ? (S + part.k_blk - 1) / part.k_blk : 0;
  // the value slice: columns [c0, c0 + dv) of V and out, in nvb 64-dim
  // boxes; a V stage holds vboxes (m64n128 reads two: a slice of one box
  // reads zeros in the second)
  const int c0 = kSlices ? kMaxDv * blockIdx.y : 0;
  const int dv = kSlices ? min(kMaxDv, Dv - c0) : Dv;
  const int nvb = (dv + 63) / 64, vboxes = kSlices ? 2 : nvb;

  // STAGES stages of V tiles (vboxes boxes) and K̂ tiles (kstage elements,
  // chunk-major), Q̂ staged once (kRows rows, as wide as a K̂ stage)
  extern __shared__ unsigned char smem_raw[];
  bf16* Vs = align1k(smem_raw);
  bf16* Ks = Vs + STAGES * vboxes * kBox;
  bf16* Qs = Ks + STAGES * kstage;
  // kPart: half-word c of the array (2 per word) marks which of the
  // block's q-tiles list key chunk c
  uint32_t* marks = reinterpret_cast<uint32_t*>(Qs + kstage * kRows / kKeys);
  if (lengths[b] <= 0) {
    empty_lane(v + b * vst.b + kv * vst.h + c0, vst.s, S, dv, reinterpret_cast<float*>(Ks),
               out + b * ost.b + h * ost.h + row0 * ost.s + c0, ost.h, ost.s, 1,
               rlast - row0 + 1);
    return;
  }
  __shared__ uint32_t tile_dims[16][8];  // per covered q-tile: its selected dims
  __shared__ uint32_t union_chunks;      // 8-dim chunks holding a selected dim
  __shared__ int uc[32];               // union position -> 8-dim chunk
  // the gather's boxes: union position | chunk << 8 | log2 of the width << 16
  __shared__ uint32_t pieces[16];
  __shared__ int npieces;
  __shared__ Ring<STAGES> ring;

  if (tid < 16 * 8) tile_dims[tid / 8][tid % 8] = 0;
  if (tid == 0) union_chunks = 0;
  if (tid == 0) ring.init(1);
  if (kPart)
    for (int e = tid; e < (nkc + 1) / 2; e += kThreads) marks[e] = 0;
  __syncthreads();
  auto bits = [](int lo, int hi) {  // bits [lo, hi) of a word, 0 <= lo < hi <= 32
    return (hi == 32 ? ~0u : (1u << hi) - 1) & ~((1u << lo) - 1);
  };
  const int* idx = block_idx + (((int64_t)b * H + h) * nqc + t_first) * nb_sel;
  for (int e = tid; e < ntile * nb_sel; e += kThreads) {
    const int d0 = idx[e] * bd, d1 = d0 + bd;  // the block's dims [d0, d1)
    for (int w = d0 / 32; w * 32 < d1; ++w)
      atomicOr(&tile_dims[e / nb_sel][w], bits(max(d0, 32 * w) - 32 * w, min(d1, 32 * w + 32) - 32 * w));
    atomicOr(&union_chunks, bits(d0 / 8, (d1 + 7) / 8));
  }
  if (kPart) {
    const int* parts = part.kc_part + ((int64_t)b * nqc + t_first) * part.kt;
    for (int e = tid; e < ntile * part.kt; e += kThreads) {
      const int kc = parts[e];
      if (kc >= 0 && kc < nkc) atomicOr(&marks[kc >> 1], 1u << ((kc & 1) * 16 + e / part.kt));
    }
  }
  __syncthreads();
  const uint32_t um = union_chunks;
  const int nu = __popc(um);                  // union width in 8-dim chunks
  const int nks = NKS > 0 ? NKS : (nu + 1) / 2, nck = 2 * nks;  // k-steps of 16 dims
  if (tid < 32 && ((um >> tid) & 1)) uc[__popc(um & ((1u << tid) - 1))] = tid;
  if (tid == 0) {  // runs of consecutive union chunks, in power-of-two pieces
    int n = 0;
    for (int c = 0, u = 0; c < 32;) {
      if (!((um >> c) & 1)) {
        ++c;
        continue;
      }
      int run = __ffs(~(um >> c)) - 1;        // the run's length
      if (run < 0) run = 32 - c;
      for (int w = 3; w >= 0; --w)
        for (; run >= (1 << w); run -= 1 << w, c += 1 << w, u += 1 << w)
          pieces[n++] = u | c << 8 | w << 16;
    }
    npieces = n;
  }
  if (nu < nck) {                             // padding: zero chunks
    for (int c = nu; c < nck; ++c) zero_chunk(Qs, nck, c, kRows);
    const int pad = (nck - nu) * kKeys;       // rows of K̂ padding per stage
    for (int e = tid; e < STAGES * pad; e += kThreads)
      *reinterpret_cast<uint4*>(Ks + e / pad * kstage + (nu * kKeys + e % pad) * 8) =
          make_uint4(0, 0, 0, 0);
  }
  if (kSlices && nvb < vboxes)                // the second V box of every stage: zeros
    for (int e = tid; e < STAGES * kBox / 8; e += kThreads)
      *reinterpret_cast<uint4*>(Vs + (e / (kBox / 8) * vboxes + 1) * kBox + e % (kBox / 8) * 8) =
          make_uint4(0, 0, 0, 0);
  if (nu < nck || (kSlices && nvb < vboxes)) fence_async_smem();
  __syncthreads();

  const int klim = min(lengths[b], S);
  const int kend = causal ? min(klim, q_offset + rlast + 1) : klim;
  const int ntk = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;
  // the band of the block's first row starts at key kbeg: tiles wholly
  // before it are masked for every row of the block
  const int kbeg = window > 0 ? max(0, q_offset + row0 - window + 1) : 0;
  const int j0 = kbeg / kKeys;
  auto chunk_marks = [&](int j) -> uint32_t {
    const int c = j * kKeys / part.k_blk;
    return (marks[c >> 1] >> ((c & 1) * 16)) & 0xffffu;
  };
  auto live = [&](int j) { return !kPart || chunk_marks(j) != 0; };
  auto next = [&](int j) {
    do ++j;
    while (j < ntk && !live(j));
    return j;
  };
  const int first = j0 >= ntk ? ntk : live(j0) ? j0 : next(j0);

  // the role of the thread's warpgroup, warp-uniform as the compiler sees
  // it (a shuffle from lane 0): only then does it give each side its own
  // register budget
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == kConsumers / 128) {
    producer_regs();
    if (tid == kConsumers)
      produce(first, ntk, next, ring, [&](int j, int st, uint32_t bar) {
        const int k0 = j * kKeys;
        mbar_expect(bar, nvb * kBoxBytes + nu * kKeys * 16);
        for (int x = 0; x < npieces; ++x) {
          const uint32_t pc = pieces[x];
          tma_load5(Ks + st * kstage + (pc & 0xff) * kKeys * 8, &kmaps.m[pc >> 16], bar, 0, k0,
                    (pc >> 8) & 0xff, kv, b);
        }
        for (int x = 0; x < nvb; ++x)
          tma_load(Vs + (st * vboxes + x) * kBox, &vmap, bar, c0 + 64 * x, k0, kv, b);
      });
  } else {
    consumer_regs();
    // Q̂ rows: each row's own tile's selected dims, zeros in the rest of
    // the union; staged once by both consumer warpgroups. A chunk wholly
    // in or out of the tile's selection is one cp.async (always so when bd
    // % 8 == 0); one partly in is loaded, masked and stored.
    const bf16* qb = q + b * qst.b + h * qst.h;
    for_chunks(kRows, nu, tid, kConsumers, [&](int r, int u) {
      const int c = uc[u], row = row0 + r;
      const uint32_t sel =
          row < Tq ? (tile_dims[row / q_blk - t_first][c / 4] >> (c % 4 * 8)) & 0xffu : 0u;
      bf16* dst = Qs + il(r, u, nck);
      const bf16* src = qb + row * qst.s + c * 8;
      if (sel == 0xffu || sel == 0u) {
        cp_async16(dst, sel ? src : qb, sel ? 16 : 0);
      } else {
        uint4 x = *reinterpret_cast<const uint4*>(src);
        uint16_t* e = reinterpret_cast<uint16_t*>(&x);
        for (int i = 0; i < 8; ++i)
          if (!((sel >> i) & 1)) e[i] = 0;
        *reinterpret_cast<uint4*>(dst) = x;
      }
    });
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();                  // Q is read by wgmma
    bar_sync(kConsumerBar, kConsumers);

    const int warp = tid >> 5, g = (tid & 31) >> 2;
    const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
    const int qpos[2] = {q_offset + rows[0], q_offset + rows[1]};
    // bit of each row's q-tile in a chunk's marks (rows past Tq: any bit)
    const int rbit[2] = {min(rows[0], rlast) / q_blk - t_first,
                         min(rows[1], rlast) / q_blk - t_first};
    const int warp_first = q_offset + row0 + warp * 16;
    // this warp's rows see keys past klim or the diagonal, keys before the
    // band of its last row, or a chunk some row's tile drops (a tile wholly
    // masked for a row adds exactly nothing)
    auto masked = [&](int j) {
      const int k0 = j * kKeys;
      return kPart || k0 + kKeys > klim || (causal && k0 + kKeys - 1 > warp_first) ||
             (window > 0 && k0 <= warp_first + 15 - window);
    };
    // a row r sees the keys kp with lo[r] < kp <= hi[r]: below lengths[b],
    // at or before its position (causal), inside its band (window)
    const int hi[2] = {min(klim - 1, causal ? qpos[0] : INT_MAX),
                       min(klim - 1, causal ? qpos[1] : INT_MAX)};
    const int lo[2] = {window > 0 ? qpos[0] - window : INT_MIN,
                       window > 0 ? qpos[1] - window : INT_MIN};
    auto valid = [&](int j, int r, int kk) {
      const int kp = j * kKeys + kk;
      return (!kPart || ((chunk_marks(j) >> rbit[r]) & 1)) && kp <= hi[r] && kp > lo[r];
    };

    float o[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // the consumers take turns in the fixed-shape kernels; in the generic
    // one the compiler serializes their products, and turns were slower
    // there (PERF.md, Findings)
    consume<true, (NKS > 0), NKS, KIND>(first, ntk, next, masked, valid, ring, Qs, nks, Ks,
                                        kstage, Vs, vboxes * kBox, pv_kind(dv), scale_log2, o, m,
                                        l);
    store_rows(out + b * ost.b + h * ost.h + c0, ost.s, rows, Tq, dv / 8, o, l);
  }
}

// Union widths and value widths up to 128 (every served head_dim but
// RecurrentGemma's): the four-stage ring.
template <bool kPart, int NKS, int KIND>
__global__ void __launch_bounds__(attn_tile::kThreads, 1) aqua_prefill_bf16(
    const __grid_constant__ KMaps kmaps, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const bf16* __restrict__ v, const int* __restrict__ block_idx,
    const int* __restrict__ lengths, bf16* __restrict__ out, int H, int KV, int Tq, int S,
    int q_offset, int Dv, int nb_sel, int bd, int q_blk, int nqc, Strides qst, Strides vst,
    Strides ost, float scale_log2, int causal, int window, Part part, int kstage) {
  prefill_block<kPart, NKS, KIND, attn_tile::kStages, false>(
      kmaps, vmap, q, v, block_idx, lengths, out, H, KV, Tq, S, q_offset, Dv, nb_sel, bd,
      q_blk, nqc, qst, vst, ost, scale_log2, causal, window, part, kstage);
}

// A union or a value width past 128, up to 256 (RecurrentGemma-9B's
// head_dim 256 keeps 192 dims a q-tile at k_ratio 0.75): a fixed depth of
// NKS k-steps, P·V on m64n128 per 128-column value slice, a ring of STAGES
// stages (four fit at NKS <= 12, three at 16).
template <bool kPart, int NKS, int STAGES>
__global__ void __launch_bounds__(attn_tile::kThreads, 1) aqua_prefill_bf16_wide(
    const __grid_constant__ KMaps kmaps, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const bf16* __restrict__ v, const int* __restrict__ block_idx,
    const int* __restrict__ lengths, bf16* __restrict__ out, int H, int KV, int Tq, int S,
    int q_offset, int Dv, int nb_sel, int bd, int q_blk, int nqc, Strides qst, Strides vst,
    Strides ost, float scale_log2, int causal, int window, Part part, int kstage) {
  prefill_block<kPart, NKS, 2, STAGES, true>(
      kmaps, vmap, q, v, block_idx, lengths, out, H, KV, Tq, S, q_offset, Dv, nb_sel, bd,
      q_blk, nqc, qst, vst, ost, scale_log2, causal, window, part, kstage);
}

// Widest union of 8-dim chunks holding a selected dim that a block of
// kRows rows can gather, padded to a whole k-step (an even count): one
// tile's selection when q_blk % kRows == 0.
int union_chunks(const Args& a) {
  const int tiles = a.q_blk % attn_tile::kRows == 0 ? 1 : attn_tile::kRows / a.q_blk + 2;
  // chunks one dim-block can touch
  const int per = a.bd % 8 == 0 ? a.bd / 8 : 8 % a.bd == 0 ? 1 : a.bd / 8 + 2;
  const int chunks = std::min(a.D / 8, std::min(tiles, a.nqc) * a.nb_sel * per);
  return (chunks + 1) / 2 * 2;
}

// Launch `kernel` (an instantiation of prefill_block with this NKS, KIND
// and STAGES): a grid of row blocks x heads, value slices on y, batch rows
// on z. `done` is the kernel's record of its shared-memory limit.
template <int NKS, int KIND, int STAGES, class Kernel>
int launch_bf16(Kernel kernel, const Args& a, int (&done)[16]) {
  using namespace attn_tile;
  // K̂ stages as wide as the widest union (or the fixed depth), V stages
  // in 64-dim boxes of a slice
  const int chunks = NKS > 0 ? 2 * NKS : union_chunks(a);
  const int kstage = kKeys * chunks * 8;
  const int vboxes = KIND == 2 ? 2 : (std::min(a.Dv, kMaxDv) + 63) / 64;
  const int nkc = a.part.kc_part != nullptr ? (a.S + a.part.k_blk - 1) / a.part.k_blk : 0;
  const int bytes =
      1024 + (STAGES * (vboxes * kBox + kstage) + kstage * kRows / kKeys) * (int)sizeof(bf16) +
      (nkc + 1) / 2 * 4;
  KMaps kmaps;
  CUtensorMap vmap;
  cudaError_t err = make_map(&vmap, a.v, a.B, a.KV, a.S, a.Dv, a.vs);
  for (int w = 0; w < 4 && err == cudaSuccess; ++w)
    err = make_chunk_map(&kmaps.m[w], a.k, a.B, a.KV, a.S, a.D, a.ks, 1 << w);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + kRows - 1) / kRows * a.H, (a.Dv + kMaxDv - 1) / kMaxDv, a.B);
  kernel<<<grid, kThreads, bytes, a.st>>>(
      kmaps, vmap, (const bf16*)a.q, (const bf16*)a.v, a.block_idx, a.lengths, (bf16*)a.out,
      a.H, a.KV, a.Tq, a.S, a.q_offset, a.Dv, a.nb_sel, a.bd, a.q_blk, a.nqc, a.qs, a.vs, a.os,
      a.scale * kLog2e, a.causal, a.window, a.part, kstage);
  return (int)cudaGetLastError();
}

template <bool kPart, int NKS, int KIND>
int launch_narrow(const Args& a) {
  static int done[16] = {0};
  return launch_bf16<NKS, KIND, attn_tile::kStages>(aqua_prefill_bf16<kPart, NKS, KIND>, a,
                                                     done);
}

template <bool kPart, int NKS, int STAGES>
int launch_wide(const Args& a) {
  static int done[16] = {0};
  return launch_bf16<NKS, 2, STAGES>(aqua_prefill_bf16_wide<kPart, NKS, STAGES>, a, done);
}

// The served shapes take kernels with depth and width fixed at compile
// time (one walk per kernel: a kernel holding several walks was slower): a
// 12-chunk union with Dv 128 (k_ratio 0.75 of head_dim 128) and an 8-chunk
// union with Dv 80 (Danube's head_dim 80); the other narrow ones the
// generic kernel. Past 128 every shape takes a fixed depth, its union
// padded with zero chunks to 16, 24 (RecurrentGemma's 192 selected dims)
// or 32 chunks, and P·V on m64n128: the generic kernel's run-time depth
// and width cost it its asynchronous products (ptxas C7511).
template <bool kPart>
int launch_shape(const Args& a) {
  const int uc = union_chunks(a), kind = attn_tile::pv_kind(a.Dv);
  if (uc * 8 > attn_tile::kNarrowDepth || a.Dv > attn_tile::kMaxDv) {
    if (uc <= 16) return launch_wide<kPart, 8, attn_tile::kStages>(a);
    if (uc <= 24) return launch_wide<kPart, 12, attn_tile::kStages>(a);
    return launch_wide<kPart, 16, 3>(a);
  }
  if (uc == 12 && kind == 2) return launch_narrow<kPart, 6, 2>(a);
  if (uc == 8 && kind == 1) return launch_narrow<kPart, 4, 1>(a);
  return launch_narrow<kPart, 0, -1>(a);
}

int dispatch_bf16(const Args& a) {
  if (a.bd <= 0 || a.D % 8 != 0 || a.D > attn_tile::kMaxDepth || a.Dv % 8 != 0 ||
      a.Dv > attn_tile::kMaxValue || a.q_blk % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return a.part.kc_part != nullptr ? launch_shape<true>(a) : launch_shape<false>(a);
}

// ---------------------------------------------------------------------------
// float32: tensor cores, three TF32 passes (f32_tile.cuh)
// ---------------------------------------------------------------------------

template <int VEC, bool kPart, int NK, int NV, bool kWide>
__global__ void __launch_bounds__(f32_tile::kThreads, 1)
    aqua_prefill_f32(const __grid_constant__ f32_tile::Problem p) {
  f32_tile::attend<VEC, kPart, NK, NV, kWide>(p);
}

template <int VEC, bool kPart, int NK, int NV, bool kWide>
int launch_f32(const f32_tile::Problem& p, int B, cudaStream_t st) {
  static int done[16] = {0};
  const int bytes = f32_tile::smem_bytes(p);
  cudaError_t err =
      attn_tile::allow_smem(aqua_prefill_f32<VEC, kPart, NK, NV, kWide>, bytes, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tq + p.rows - 1) / p.rows * p.H, 1, B);
  aqua_prefill_f32<VEC, kPart, NK, NV, kWide><<<grid, f32_tile::kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

// The form, key tile and column share that plan chose: the narrow form
// (128-row blocks, 32-key tiles, 64 or 128 columns: the served head_dim
// 128 at q_blk 128) or the wide one (64-row blocks; 32 keys and 64
// columns a warpgroup at a depth up to 128 with a smaller q_blk, else 16
// keys and 64 or 128 columns: head_dim 256); 4-byte copies for unaligned
// views
template <int VEC, bool kPart>
int launch_f32_tile(const f32_tile::Problem& p, int B, cudaStream_t st) {
  if (p.rows != f32_tile::kRows)
    return p.nv == 128 ? launch_f32<VEC, kPart, 32, 128, false>(p, B, st)
                       : launch_f32<VEC, kPart, 32, 64, false>(p, B, st);
  if (p.nv == 128) return launch_f32<VEC, kPart, 16, 128, true>(p, B, st);
  return p.nk == 32 ? launch_f32<VEC, kPart, 32, 64, true>(p, B, st)
                    : launch_f32<VEC, kPart, 16, 64, true>(p, B, st);
}

template <bool kPart>
int launch_f32_part(const f32_tile::Problem& p, int vec, int B, cudaStream_t st) {
  return vec == 1 ? launch_f32_tile<1, kPart>(p, B, st) : launch_f32_tile<4, kPart>(p, B, st);
}

// vec: floats per copy, 4 (16-byte copies: the wrapper found the bases
// and outer strides 16-byte aligned) or 1
int dispatch_f32(const Args& a, int vec) {
  if (vec == 4 && (a.D % 4 != 0 || a.Dv % 4 != 0 || a.bd % 4 != 0)) vec = 0;
  f32_tile::Problem p{};
  p.q = (const float*)a.q;
  p.k = (const float*)a.k;
  p.v = (const float*)a.v;
  p.out = (float*)a.out;
  p.block_idx = a.block_idx;
  p.lengths = a.lengths;
  p.kc_part = a.part.kc_part;
  p.H = a.H;
  p.KV = a.KV;
  p.Tq = a.Tq;
  p.S = a.S;
  p.q_offset = a.q_offset;
  p.D = a.D;
  p.Dv = a.Dv;
  p.nb_sel = a.nb_sel;
  p.bd = a.bd;
  p.q_blk = a.q_blk;
  p.nqc = a.nqc;
  p.kt = a.part.kt;
  p.k_blk = a.part.k_blk;
  p.qs = a.qs;
  p.ks = a.ks;
  p.vs = a.vs;
  p.os = a.os;
  p.scale_log2 = a.scale * f32_tile::kLog2e;
  p.causal = a.causal;
  p.window = a.window;
  if ((vec != 1 && vec != 4) || a.bd <= 0 || !f32_tile::plan(p, vec, a.B))
    return (int)cudaErrorInvalidValue;
  return p.kc_part != nullptr ? launch_f32_part<true>(p, vec, a.B, a.st)
                              : launch_f32_part<false>(p, vec, a.B, a.st);
}

}  // namespace

// Strides are in elements: {batch, head, seq} of q, k, v and out. Tq query
// rows at sequence offset q_offset attend S keys; D is q̂'s and K̂'s head
// dim. vec is the float32 route's copy width in floats: 4 (16-byte
// copies; the caller found every base and outer stride 16-byte aligned)
// or 1. window: keys kpos > qpos - window only (<= 0:
// none). kc_part: null, or (B, nqc, kt) int32 participating key chunks of
// k_blk keys (k_blk % 64 == 0). dtype: 0 = float32, 1 = bfloat16. Returns
// the cudaError_t of the launch.
extern "C" int aqua_prefill_launch(const void* q, const void* k, const void* v,
                                   const void* block_idx, const void* lengths, void* out,
                                   int B, int H, int KV, int Tq, int S, int q_offset, int D,
                                   int Dv, int nb_sel, int bd, int q_blk, int nqc, int vec,
                                   const long long* strides, float scale, int causal,
                                   int window, const void* kc_part, int kt, int k_blk,
                                   int dtype, void* stream) {
  if (H % KV != 0 || q_offset < 0 || q_offset + Tq > S ||
      (kc_part != nullptr && (k_blk <= 0 || k_blk % attn_tile::kKeys != 0)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.block_idx = (const int*)block_idx;
  a.lengths = (const int*)lengths;
  a.out = out;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Tq = Tq;
  a.S = S;
  a.q_offset = q_offset;
  a.D = D;
  a.Dv = Dv;
  a.nb_sel = nb_sel;
  a.bd = bd;
  a.q_blk = q_blk;
  a.nqc = nqc;
  a.qs = Strides{strides[0], strides[1], strides[2]};
  a.ks = Strides{strides[3], strides[4], strides[5]};
  a.vs = Strides{strides[6], strides[7], strides[8]};
  a.os = Strides{strides[9], strides[10], strides[11]};
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.part = Part{(const int*)kc_part, kt, k_blk};
  a.st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_f32(a, vec);
  return dispatch_bf16(a);
}
