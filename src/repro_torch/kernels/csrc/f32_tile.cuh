// float32 tensor-core tile engine shared by aqua_prefill.cu and
// flash_attention.cu (their float32 routes; sm_90a). It replaces the
// float32 forms of the Pallas TPU kernel bodies of
// src/repro/kernels/aqua_prefill.py (_kernel and, as kPart, _part_kernel)
// and src/repro/kernels/flash_attention.py (_kernel).
//
// What bounds it: the operations. float32 outside the tensor cores peaks
// at 67 TFLOP/s; TF32 tensor cores at 495 TFLOP/s dense, but one TF32
// product keeps 11 of float32's 24 significand bits, and the routes are
// held to their plain float32 versions at 1e-5·|ref| + 1e-5. So every
// product runs as a three-pass split (CUTLASS's 3xTF32): each operand is
// split as x = hi + lo, hi = tf32(x) (to nearest, ties away from zero, as
// cvt.rna.tf32.f32) and lo = x - hi (exact in float32; the tensor cores
// read its top 11 bits), and a·b = lo_a·hi_b + hi_a·lo_b + hi_a·hi_b,
// three products, the small terms first (lo_a·lo_b, ~2^-22 of a·b, is
// dropped): about 22 bits a product, at 495 / 3 = 165 TFLOP/s of float32
// work, the bound of these kernels. The tensor cores add with truncation,
// not rounding, so a sum carried through many products drifts toward
// zero: each k-group of the scores (two k-steps, 16 dims) chains its six
// products into a fresh accumulator that a float32 add folds into the
// running score, and each key tile's P·V into one folded into the output.
// (Scores carried through all their k-steps held randn inputs but broke
// the HF drive's float32 logit limit; PERF.md.) tests/test_torch_f32_split.py
// emulates this arithmetic on the CPU and holds it to the limit at randn
// inputs and with the scores 3x as large.
//
// A block is two warpgroups (kThreads = 256) and two forms share the code
// (the kWide template argument; plan picks):
//
// - narrow (depth and Dv up to 128, one selection a 128-row block, a grid
//   of 1.5 waves or more): 128 query rows, each warpgroup 64 of them with
//   all their output columns (NV = 64 or 128, a 128-column P·V in two
//   halves);
// - wide (everything else, up to a depth and Dv of 256): 64 query rows,
//   both warpgroups on the same rows; each computes the scores over its
//   half of the k-steps and the two halves meet through shared memory
//   behind a block barrier (both then hold the same scores bit for bit:
//   the same sum), each runs the same online softmax, and each computes
//   the P·V of its half of the output columns (NV = 64 or 128).
//
// Either way the scores split their k-steps in two halves (the first the
// larger) summed apart and then added, so a row's arithmetic is the same
// in both forms. What the design does about what held the mma.sync engine
// it replaces back at head_dim 256:
//
// 1. Two ring stages at every depth up to 256: key tiles of NK = 32 keys
//    at depths and Dv up to 128, else 16. Shared memory, in floats: Q̂
//    rows x (dmax + 4), per stage K̂ hi and lo NK·dmax each and V hi and
//    lo NK·(V columns) each, V's landing tile NK·(V columns + 4), the wide
//    form's score exchange 256·NK/2, and the selection masks: 217 KiB at
//    depth and Dv 256 (PERF.md reckons each form).
// 2. The scores of a (row, key) pair once a block for every output column
//    (no value slices on the grid).
// 3. Each shared operand split once a block: K̂ lands in place by cp.async
//    (4-dim chunks, chunk-major) and V row-major in its landing tile; after
//    its own copies complete, the thread that copied an element splits it
//    (K̂: hi over the raw value, lo beside it; V: transposed into the
//    stage, hi and lo), so the products read hi and lo ready. Q̂ is staged
//    once, raw; each element is split by the one thread whose A fragment
//    holds it, once a key tile, and that split feeds NK keys. P is split
//    once, in registers, by the thread that holds it.
// 4. wgmma for both products. Scores: m64nNKk8 tf32, A (Q̂ hi or lo) from
//    registers, B (K̂ hi or lo) from shared memory, K-major: the 4-dim
//    chunk c of key n at float (c·NK + n)·4, each 8-key x 16-byte core
//    matrix 128 contiguous bytes. P·V: m64nk8 over the warpgroup's
//    columns, A (P hi or lo) from the score accumulators' registers, B the
//    V tile transposed (tf32 wgmma takes only K-major operands): V[key][c]
//    in the 4-key chunk of its k-step and parity, column c, so that k-slot
//    s of a k-step holds key 2s (s < 4) or key 2(s - 4) + 1, the order in
//    which a thread's accumulator fragment (keys 2t, 2t + 1) is its A
//    fragment (k t, t + 4). Each lane transposes its 4 columns in an order
//    rotated by its lane, so that a warp's loads and stores hit 32 banks.
//    Four k-steps (two k-groups) make a wgmma group whose accumulators are
//    read only once it is done (a read while products run makes ptxas
//    serialize them all, C7514); a tile's P·V runs while the threads split
//    the next tile.
// 5. One block of 256 threads an SM (up to 217 KiB of shared memory and
//    255 registers a thread); what hides latency is the two warpgroups and
//    the asynchronous products beside the splits and the copies in flight.
//
// Blocks are issued heaviest (last rows) first, heads fastest. The depth
// is the sorted union of the dims that the block's rows read (the prefill:
// the dims selected by the q_blk tiles it covers; flash: all D); each row
// holds zeros in the union's dims its own tile did not select (a zero
// product adds exactly 0), padded with zeros to a multiple of 8 (the k8
// of the products). Key tiles walk in ascending order, zeros past S.
//
// Each row's arithmetic is the sequence O = O·corr_j + P_j·V_j over the
// key tiles it visits in ascending order: it depends on nothing but its
// own tile's selection, the block's union and those tiles (a tile whose
// keys a row cannot see leaves the row's sums exactly as they were), not
// on the form, on which warp holds the row or on the ring's timing. A
// chunk at a 64-aligned q_offset (and of q_blk) has the monolithic call's
// unions: its rows are the monolithic rows bit for bit.

#pragma once

#include <algorithm>
#include <climits>

#include "attn_tile.cuh"

namespace f32_tile {

using attn_tile::Strides;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kGroups = 2;              // warpgroups
constexpr int kThreads = 128 * kGroups;
constexpr int kRows = 64;               // query rows of a warpgroup: wgmma's m64
constexpr int kMaxDepth = 256;          // gathered q·k depth
constexpr int kMaxDv = 256;             // value / output width
constexpr int kMaxTiles = 16;           // q_blk tiles a block may cover (q_blk >= 8)
constexpr uint32_t kHiMask = 0xffffe000u;  // a float32's TF32 bits
// dynamic shared memory a block may use: 227 KB less the static arrays
constexpr int kSmemLimit = 232448 - 2048;

__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }

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
  // the block's query rows (kRows: the wide form; 2 kRows: the narrow);
  // shared memory: the padded depth bound (floats a row), keys a tile,
  // output columns a warpgroup, unit words of a dim mask, key chunks of the
  // participation marks
  int rows, dmax, nk, nv, nuw, nkc;
};

// Widest union of selected dims a block of kRows rows can gather (the
// narrow form's 128 rows gather one selection): one tile's selection when
// q_blk % kRows == 0, else the tiles it can cover.
inline int union_width(const Problem& p) {
  if (p.block_idx == nullptr) return p.D;
  const int tiles = p.q_blk % kRows == 0   ? 1
                    : kRows % p.q_blk == 0 ? kRows / p.q_blk
                                           : (kRows - 1) / p.q_blk + 2;
  const int w = std::min(tiles, p.nqc) * p.nb_sel * p.bd;
  return w < p.D ? w : p.D;
}

// keys a tile: 32 where the depth and Dv are at most 128, else 16
inline int tile_keys(int dmax, int dv) { return dmax <= 128 && dv <= 128 ? 32 : 16; }
// The narrow form (depth and Dv at most 128, one selection a 128-row block:
// flash, or q_blk % 128 == 0, and a grid of at least 1.5 waves of 128-row
// blocks): 128-row blocks, each warpgroup 64 rows with all their output
// columns (NV = Dv padded to 64 or 128). The wide form: 64-row blocks, the
// warpgroups splitting the depth of the scores and the output columns (NV
// = 64 or 128 each); under 1.5 waves its twice as many blocks finish
// sooner (a causal grid's longest block sets the time). A row's arithmetic
// is the same in both.
inline bool narrow(const Problem& p, int dmax, int B, int sms) {
  const long long blocks = (long long)(p.Tq + 2 * kRows - 1) / (2 * kRows) * p.H * B;
  return dmax <= 128 && p.Dv <= 128 &&
         (p.block_idx == nullptr || p.q_blk % (2 * kRows) == 0) && 2 * blocks >= 3LL * sms;
}

// a Q̂ row's floats in shared memory: 4 mod 8, so the A fragments' loads
// (rows g, dims t) hit 32 banks
__host__ __device__ inline int q_stride(int dmax) { return dmax + 4; }

// Q̂, K̂ and V stages (hi, lo), V's landing tile, the wide form's score
// exchange, the masks
inline int smem_bytes(const Problem& p) {
  const bool wide = p.rows == kRows;
  const int vc = wide ? 2 * p.nv : p.nv;
  return 4 * (p.rows * q_stride(p.dmax) + 4 * p.nk * p.dmax + p.nk * (5 * vc + 4) +
              (wide ? kThreads * p.nk / 2 : 0) + (kMaxTiles + 1) * p.nuw + p.nkc);
}

// The card's SM count (of the current device; cached for the first 16)
inline int sm_count() {
  static int sms[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 16 && sms[dev] > 0) return sms[dev];
  int n = 132;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 16) sms[dev] = n;
  return n;
}

// Fill in the layout for copies of vec floats over B lanes; false if the
// problem does not fit the engine.
inline bool plan(Problem& p, int vec, int B) {
  const int w = union_width(p);
  if (w > kMaxDepth || p.Dv > kMaxDv || p.q_blk < 8) return false;
  p.dmax = pad8(w);
  const bool nar = narrow(p, p.dmax, B, sm_count());
  p.rows = nar ? 2 * kRows : kRows;
  p.nv = nar ? (p.Dv <= 64 ? 64 : 128) : (p.Dv <= 128 ? 64 : 128);
  p.nk = tile_keys(p.dmax, p.Dv);
  p.nuw = (p.D / vec + 31) / 32;
  p.nkc = p.kc_part != nullptr ? (p.S + p.k_blk - 1) / p.k_blk : 0;
  return smem_bytes(p) <= kSmemLimit;
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
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & kHiMask);
}

// wgmma shared-memory descriptor of an unswizzled K-major operand: lbo
// the byte stride between core matrices along K, sbo along M/N
__device__ __forceinline__ uint64_t desc(const float* p, int lbo, int sbo) {
  return ((attn_tile::smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x N, f32) (+)= a · b, tf32: a this warp's 16 rows x 8 from
// registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)),
// b 8 x N from shared memory, K-major; ACC 0 overwrites d
template <int ACC>
__device__ __forceinline__ void wgmma16(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t b) {
  if constexpr (ACC == 0)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <int ACC>
__device__ __forceinline__ void wgmma32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t b) {
  if constexpr (ACC == 0)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),
          "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <int ACC>
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b) {
  if constexpr (ACC == 0)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),
          "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),
          "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
          "=f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <int ACC>
__device__ __forceinline__ void wgmma128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t b) {
  if constexpr (ACC == 0)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),
          "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),
          "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
          "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]),
          "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]),
          "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]),
          "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
          "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]),
          "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <int N, int ACC>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16)
    wgmma16<ACC>(d, a, b);
  else if constexpr (N == 32)
    wgmma32<ACC>(d, a, b);
  else if constexpr (N == 64)
    wgmma64<ACC>(d, a, b);
  else
    wgmma128<ACC>(d, a, b);
}

// One block: rows [row0, row0 + kRows) of head h of lane b against the key
// tiles its rows can see. VEC: floats per copy (4 needs 16-byte aligned
// bases, strides and dims that are multiples of 4, and dim-blocks of a
// multiple of 4 dims; the wrapper checks). kPart: the walk visits only the
// key chunks that some covered q-tile lists, and masks each row by its own
// tile's list. NK: keys a tile; NV: output columns a warpgroup; kWide:
// the wide form (plan's tile_keys, narrow and nv).
template <int VEC, bool kPart, int NK, int NV, bool kWide>
__device__ __forceinline__ void attend(const Problem& p) {
  constexpr int kSN = NK / 2;   // score accumulators a thread
  constexpr int kON = NV / 2;   // output accumulators a thread
  constexpr int kKS = NK / 8;   // k-steps of a tile's P·V
  constexpr int kVC = kWide ? 2 * NV : NV;  // V columns of a stage
  constexpr int kRB = kWide ? kRows : 2 * kRows;  // the block's rows
  const int H = p.H;
  const int h = blockIdx.x % H, tile = gridDim.x / H - 1 - blockIdx.x / H;
  const int b = blockIdx.z, tid = threadIdx.x, lane = tid & 31;
  // warpgroup (uniform to the compiler: wgmma needs it), warp of its 16 rows
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kv = h / (H / p.KV);
  const int row0 = tile * kRB, rlast = min(row0 + kRB, p.Tq) - 1;
  const bool dense = p.block_idx == nullptr;
  const int t_first = dense ? 0 : row0 / p.q_blk;
  const int ntile = dense ? 1 : rlast / p.q_blk - t_first + 1;   // <= kMaxTiles
  const int nunits = p.D / VEC;                                 // VEC-dim units of a row
  const int qstr = q_stride(p.dmax);

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kRB x qstr
  float* Ks = Qs + kRB * qstr;                  // 2 stages x (hi, lo) x NK x dmax
  float* Vs = Ks + 4 * NK * p.dmax;             // 2 stages x (hi, lo) x NK x kVC
  float* Vl = Vs + 4 * NK * kVC;                // NK x (kVC + 4): a V tile as it lands
  float* xs = Vl + NK * (kVC + 4);              // kWide: kThreads x kSN partial scores
  uint32_t* tmask = reinterpret_cast<uint32_t*>(xs + (kWide ? kThreads * kSN : 0));
  uint32_t* umask = tmask + kMaxTiles * p.nuw;                          // union
  uint32_t* marks = umask + p.nuw;  // kPart: per key chunk, the covered tiles listing it
  __shared__ int ucol[kMaxDepth];   // union position -> first dim of its unit
  __shared__ int nu_s;
  if (p.lengths != nullptr && p.lengths[b] <= 0) {
    attn_tile::empty_lane(p.v + b * p.vs.b + kv * p.vs.h, p.vs.s, p.S, p.Dv, Qs,
                          p.out + b * p.os.b + h * p.os.h + row0 * p.os.s, p.os.h, p.os.s, 1,
                          rlast - row0 + 1);
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
  if (tid < 32) {  // compact the union's units, in ascending order
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
  const int nu = nu_s, width = nu * VEC, depth = pad8(width), nks = depth / 8, nch = depth / 4;

  // Q̂ rows: the row's own tile's units, zeros in the rest of the union and
  // in the depth's padding
  const float* qb = p.q + b * p.qs.b + h * p.qs.h;
  for (int r = tid >> 5; r < kRB; r += kThreads / 32) {
    const int row = row0 + r;
    const uint32_t* sel = tmask + (dense ? 0 : min(row, rlast) / p.q_blk - t_first) * p.nuw;
    for (int u = lane; u < nu; u += 32) {
      const int unit = ucol[u] / VEC;
      const bool on = row < p.Tq && ((sel[unit / 32] >> (unit % 32)) & 1);
      cp_async<4 * VEC>(Qs + r * qstr + u * VEC, on ? qb + row * p.qs.s + ucol[u] : qb,
                        on ? 4 * VEC : 0);
    }
    for (int c = width + lane; c < depth; c += 32) Qs[r * qstr + c] = 0.f;
  }

  // The copies of tile j and their split, by items fixed per thread (one
  // key, chunks or columns a constant stride apart; offsets computed
  // once). K̂ lands in place (stage st): 4-dim chunks, a warp's 32 copies 8
  // keys x 4 chunks (two sectors a key, 8 distinct 16-byte bank groups a
  // quarter warp). V lands row-major in Vl (rows of vls floats, 4 mod 32),
  // a warp's 32 copies 4 keys x 8 chunks of 4 columns (128 bytes a key),
  // and the split writes it transposed, each lane taking its 4 columns in
  // an order rotated by vr, so that a warp's 32 loads and 32 stores each
  // hit 32 banks.
  const float* kb = p.k + b * p.ks.b + kv * p.ks.h;
  const float* vb = p.v + b * p.vs.b + kv * p.vs.h;
  const int wid = tid >> 5;
  constexpr int kChStep = 32 / kKS;         // K̂ chunks between a thread's items
  constexpr int kColStep = 128 / kKS;       // V columns between a thread's items
  constexpr int kVQ = NK * kVC / 1024;      // V items a thread
  constexpr int vls = kVC + 4;              // floats of a landing row
  const int kkey = (lane & 7) + 8 * (wid % kKS), kch0 = (lane >> 3) + 4 * (wid / kKS);
  const int nkq = kch0 < nch ? (nch - kch0 + kChStep - 1) / kChStep : 0;
  constexpr int kKQ = 4;                    // K̂ items a thread, at most (depth 256)
  // VEC 4: the first dim of each of this thread's K̂ chunks (one unit each)
  int kcol[kKQ];
#pragma unroll
  for (int q = 0; q < kKQ; ++q) kcol[q] = VEC == 4 && q < nkq ? ucol[kch0 + q * kChStep] : 0;
  const int koff = (kch0 * NK + kkey) * 4;  // the first chunk in a stage's half
  // V: key 8kk + 2pos + par, columns vcol0 + q·kColStep (the first nvq
  // below Dv); transposed, (key, column c) sits in chunk 2kk + par, slot pos
  const int vpos = lane >> 3, vr = (lane >> 1) & 3, vkk = (wid >> 1) % kKS;
  const int vkey = 8 * vkk + 2 * vpos + (wid & 1);
  const int vcol0 = 4 * ((lane & 1) + 2 * vr) + 32 * ((wid >> 1) / kKS);
  const int nvq = vcol0 < p.Dv ? min(kVQ, (p.Dv - vcol0 + kColStep - 1) / kColStep) : 0;
  const int vloff = vkey * vls + vcol0;
  const int vtoff = (2 * vkk + (wid & 1)) * kVC * 4 + vcol0 * 4 + vpos;
  auto load = [&](int j, int st) {
    const int kp = j * NK + kkey, vp = j * NK + vkey;
    const float* ksrc = kb + kp * p.ks.s;
    float* kd = Ks + st * 2 * NK * p.dmax + koff;
#pragma unroll
    for (int q = 0; q < kKQ; ++q)
      if (q < nkq)
#pragma unroll
        for (int i = 0; i < 4; i += VEC) {
          const int c = (kch0 + q * kChStep) * 4 + i;
          const bool ok = kp < p.S && c < width;
          const int col = VEC == 4 ? kcol[q] : ucol[c];
          cp_async<4 * VEC>(kd + q * kChStep * NK * 4 + i, ok ? ksrc + col : kb,
                            ok ? 4 * VEC : 0);
        }
    const float* vsrc = vb + vp * p.vs.s + vcol0;
    float* vd = Vl + vloff;
#pragma unroll
    for (int q = 0; q < kVQ; ++q)
      if (q < nvq)
#pragma unroll
        for (int i = 0; i < 4; i += VEC) {
          const bool ok = vp < p.S && (VEC == 4 || vcol0 + q * kColStep + i < p.Dv);
          cp_async<4 * VEC>(vd + q * kColStep + i, ok ? vsrc + q * kColStep + i : vb,
                            ok ? 4 * VEC : 0);
        }
  };
  // after this thread's copies of a tile landed: K̂ hi over each value and
  // lo beside it (the stage's second half); V transposed into the stage,
  // hi and lo
  // (in rounds, each round's loads ahead of its stores: the compiler
  // keeps shared-memory loads behind earlier stores, so interleaved they
  // would wait out each load's latency in turn; rounds of kKB K̂ chunks
  // and of kVQ V values bound the registers)
  constexpr int kKB = kWide && NV == 128 ? 2 : kKQ;
  auto split = [&](int st) {
    float4* kx = reinterpret_cast<float4*>(Ks + st * 2 * NK * p.dmax + koff);
#pragma unroll
    for (int q0 = 0; q0 < kKQ; q0 += kKB) {
      float4 kx4[kKB];
#pragma unroll
      for (int q = 0; q < kKB; ++q)
        if (q0 + q < nkq) kx4[q] = kx[(q0 + q) * kChStep * NK];
#pragma unroll
      for (int q = 0; q < kKB; ++q)
        if (q0 + q < nkq) {
          const float4 v = kx4[q];
          const float4 hi = make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w));
          kx[(q0 + q) * kChStep * NK] = hi;
          kx[(q0 + q) * kChStep * NK + NK * p.dmax / 4] =
              make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w);
        }
    }
    const float* vl = Vl + vloff;
    float* vt = Vs + st * 2 * NK * kVC + vtoff;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = (i + vr) & 3;
      float vx[kVQ];
#pragma unroll
      for (int q = 0; q < kVQ; ++q)
        if (q < nvq) vx[q] = vl[q * kColStep + e];
#pragma unroll
      for (int q = 0; q < kVQ; ++q)
        if (q < nvq) {
          const float hi = tf32_hi(vx[q]);
          vt[(q * kColStep + e) * 4] = hi;
          vt[(q * kColStep + e) * 4 + NK * kVC] = vx[q] - hi;
        }
    }
  };

  // the walk: NK-key tiles from the block's band to its causal bound and
  // lengths[b]; kPart: only those of chunks some covered tile lists
  const int klim = p.lengths != nullptr ? min(p.lengths[b], p.S) : p.S;
  const int kend = p.causal ? min(klim, p.q_offset + rlast + 1) : klim;
  const int ntk = kend > 0 ? (kend + NK - 1) / NK : 0;
  const int kbeg = p.window > 0 ? max(0, p.q_offset + row0 - p.window + 1) : 0;
  const int j0 = kbeg / NK;
  auto chunk_marks = [&](int j) -> uint32_t { return marks[j * NK / p.k_blk]; };
  auto live = [&](int j) { return !kPart || chunk_marks(j) != 0; };
  auto next = [&](int j) {
    do ++j;
    while (j < ntk && !live(j));
    return j;
  };
  const int first = j0 >= ntk ? ntk : live(j0) ? j0 : next(j0);
  // some row of the block masks a key of tile j
  auto masked = [&](int j) {
    const int k0 = j * NK;
    return kPart || k0 + NK > klim || (p.causal && k0 + NK - 1 > p.q_offset + row0) ||
           (p.window > 0 && k0 <= p.q_offset + rlast - p.window);
  };

  // this thread's rows (the narrow form: each warpgroup its own 64): a row
  // r sees the keys kp with lo[r] < kp <= hi[r]
  const int wrow = (kWide ? 0 : kRows * wg) + 16 * warp;  // the warp's first row
  const int rows[2] = {row0 + wrow + g, row0 + wrow + g + 8};
  int hi[2], lo[2], rbit[2];
  for (int r = 0; r < 2; ++r) {
    const int qpos = p.q_offset + rows[r];
    hi[r] = min(klim - 1, p.causal ? qpos : INT_MAX);
    lo[r] = p.window > 0 ? qpos - p.window : INT_MIN;
    rbit[r] = dense ? 0 : min(rows[r], rlast) / p.q_blk - t_first;
  }

  // V's columns past Dv stay zero in every stage (the split writes none)
  if (p.Dv < kVC)
    for (int e = tid; e < 4 * NK * kVC; e += kThreads)
      if (e / 4 % kVC >= p.Dv) Vs[e] = 0.f;
  if (first < ntk) load(first, 0);
  attn_tile::cp_async_commit();
  attn_tile::cp_async_wait<0>();
  if (first < ntk) split(0);
  attn_tile::fence_async_smem();

  // P·V in kPH passes of kPN columns (the narrow form's 128 columns in two
  // halves: a 128-column accumulator beside O spills)
  constexpr int kPH = !kWide && NV == 128 ? 2 : 1, kPN = NV / kPH;
  float o[kON], pv[kPN / 2];
#pragma unroll
  for (int i = 0; i < kON; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // the two halves of the k-steps of the scores (the first the larger):
  // the wide form's warpgroups take one each
  const int half = (nks + 1) / 2, kb0 = wg ? half : 0, ke0 = wg ? nks : half;
  const float* qa = Qs + (wrow + g) * qstr + t;  // A fragments: rows g, g + 8
  float* xo = xs + tid * 4;                 // this thread's partial scores, float4 s
  const float* xi = xs + (tid ^ 128) * 4;   // its partner's

  for (int j = first, it = 0; j < ntk; ++it) {
    // tile j split and in place (each writer fenced its stores for the
    // products); every warp done with the other stage and with Vl
    __syncthreads();
    const int st = it & 1, jn = next(j);
    if (jn < ntk) load(jn, st ^ 1);
    attn_tile::cp_async_commit();

    // S over the k-steps (the wide form: this warpgroup's half): the three
    // passes of each pair of k-steps (a k-group: 16 dims) chained into a
    // fresh accumulator, folded in float32 into s (the first half) or s2
    // (the second); a wgmma group's accumulators are read only once the
    // group is done (a read while products run makes the compiler
    // serialize them, ptxas C7514)
    float s[kSN], s2[kSN], d0[kSN], d1[kSN];
#pragma unroll
    for (int i = 0; i < kSN; ++i) s[i] = s2[i] = 0.f;
    {
      const float* K = Ks + st * 2 * NK * p.dmax;
      const uint64_t dh = desc(K, NK * 16, 128), dl = desc(K + NK * p.dmax, NK * 16, 128);
      // k-steps a wgmma group: two k-groups, or one in the narrow form at
      // 128 columns (two cost it spills)
      constexpr int kGK = !kWide && NV == 128 ? 2 : 4;
      uint32_t ah[kGK][4], al[kGK][4];
      // k-step ks: the A fragment from Q̂ (rows g, g + 8; dims t, t + 4),
      // and its three passes against chunks 2ks, 2ks + 1 of the K̂ tile
      // (32·NK bytes a k-step), into d (fresh: overwriting it)
      auto issue = [&](float (&d)[kSN], int i, int ks, bool fresh) {
        const float* a = qa + 8 * ks;
        const float x[4] = {a[0], a[8 * qstr], a[4], a[8 * qstr + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xh = tf32_hi(x[e]);
          ah[i][e] = __float_as_uint(xh);
          al[i][e] = __float_as_uint(x[e] - xh);
        }
        attn_tile::wg_fence();
        const uint64_t off = (uint64_t)(ks * NK * 2);
        if (fresh)
          wgmma<NK, 0>(d, al[i], dh + off);
        else
          wgmma<NK, 1>(d, al[i], dh + off);
        wgmma<NK, 1>(d, ah[i], dl + off);
        wgmma<NK, 1>(d, ah[i], dh + off);
      };
      // the k-steps [kb, ke) into sum, k-groups from kb: a wgmma group of
      // kGK k-steps
      auto range = [&](int kb, int ke, float (&sum)[kSN]) {
        for (int ks = kb; ks < ke; ks += kGK) {
          const int n = min(kGK, ke - ks);  // k-steps of this wgmma group
          issue(d0, 0, ks, true);
          if (n > 1) issue(d0, 1, ks + 1, false);
          if (kGK > 2 && n > 2) issue(d1, 2 % kGK, ks + 2, true);
          if (kGK > 2 && n > 3) issue(d1, 3 % kGK, ks + 3, false);
          attn_tile::wg_commit();
          attn_tile::wg_wait<0>();
          attn_tile::hold(d0);
#pragma unroll
          for (int i = 0; i < kSN; ++i) sum[i] += d0[i];
          if (kGK > 2 && n > 2) {
            attn_tile::hold(d1);
#pragma unroll
            for (int i = 0; i < kSN; ++i) sum[i] += d1[i];
          }
        }
      };
      if (kWide) {
        range(kb0, ke0, s);
      } else {
        range(0, half, s);
        range(half, nks, s2);
      }
    }
    // the two halves of the depth: s = first + second (the wide form: own
    // + partner's, the same sum, so the same bits, in both warpgroups)
    if (kWide) {
#pragma unroll
      for (int i = 0; i < kSN; i += 4)
        *reinterpret_cast<float4*>(xo + i * kThreads) =
            make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kSN; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(xi + i * kThreads);
        s2[i] = x.x;
        s2[i + 1] = x.y;
        s2[i + 2] = x.z;
        s2[i + 3] = x.w;
      }
    }
#pragma unroll
    for (int i = 0; i < kSN; ++i) s[i] += s2[i];

    // scores -> log2 domain, masked; the online softmax
    const bool msk = masked(j);
    const uint32_t cm = kPart ? chunk_marks(j) : 0u;
    const int k0 = j * NK;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kSN; ++i) {
      const int r = (i >> 1) & 1, kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      float x = s[i] * p.scale_log2;
      if (msk && !((!kPart || ((cm >> rbit[r]) & 1)) && kp <= hi[r] && kp > lo[r])) x = kNegInf;
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = attn_tile::fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // P, split in registers: k-step kk's A fragment is the accumulator of
    // keys 8kk.. permuted (k-slot t: key 2t, k-slot t + 4: key 2t + 1)
    uint32_t ph[kKS][4], pl[kKS][4];
#pragma unroll
    for (int i = 0; i < kSN; ++i) {
      const float x = attn_tile::fast_exp2(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += x;
      const float xh = tf32_hi(x);
      const int slot = ((i >> 1) & 1) + 2 * (i & 1);  // c0, c1, c2, c3 -> a0, a2, a1, a3
      ph[i >> 2][slot] = __float_as_uint(xh);
      pl[i >> 2][slot] = __float_as_uint(x - xh);
    }
    // P·V of this warpgroup's columns into a fresh accumulator, issued
    // asynchronously; the next tile's split runs beside the first pass
#pragma unroll
    for (int hh = 0; hh < kPH; ++hh) {
      const float* V = Vs + st * 2 * NK * kVC + ((kWide ? wg * NV : 0) + hh * kPN) * 4;
      const uint64_t dh = desc(V, kVC * 16, 128), dl = desc(V + NK * kVC, kVC * 16, 128);
      attn_tile::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        const uint64_t off = (uint64_t)(kk * kVC * 2);  // two chunks of kVC x 16 bytes
        if (kk == 0)
          wgmma<kPN, 0>(pv, pl[kk], dh + off);
        else
          wgmma<kPN, 1>(pv, pl[kk], dh + off);
        wgmma<kPN, 1>(pv, ph[kk], dl + off);
        wgmma<kPN, 1>(pv, ph[kk], dh + off);
      }
      attn_tile::wg_commit();
      if (hh == 0) {
        attn_tile::cp_async_wait<0>();
        if (jn < ntk) split(st ^ 1);
        attn_tile::fence_async_smem();
      }
      attn_tile::wg_wait<0>();
      attn_tile::hold(pv);
      attn_tile::hold(ph);
      attn_tile::hold(pl);
#pragma unroll
      for (int i = 0; i < kPN / 2; ++i)
        o[hh * kPN / 2 + i] = o[hh * kPN / 2 + i] * corr[(i >> 1) & 1] + pv[i];
    }
    j = jn;
  }
  attn_tile::cp_async_wait<0>();

  // out = O / max(l, 1e-30) over the quad's row sums; zeros for a row
  // that saw no key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* ob = p.out + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = ob + rows[r] * p.os.s;
#pragma unroll
    for (int i = 2 * r; i < kON; i += 4)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = (kWide ? wg * NV : 0) + 8 * (i >> 2) + 2 * t + e;
        if (c < p.Dv) orow[c] = o[i + e] / denom;
      }
  }
}

}  // namespace f32_tile
