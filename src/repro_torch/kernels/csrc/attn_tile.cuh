// Warp-specialized tensor-core tile engine shared by aqua_prefill.cu and
// flash_attention.cu (their bf16 routes; sm_90a).
//
// A block of kThreads = 384 threads owns kRows = 128 query rows and walks
// kKeys = 64-key tiles through a ring of shared-memory stages (kStages = 4
// for q·k depths up to 128; a kernel's template argument, 3 or 4, for
// depths up to kMaxDepth = 256):
//
// - Warpgroup 2 is the producer. Its registers are lowered with setmaxnreg
//   and one thread of it owns every copy of a stage: it waits until the
//   stage is empty, then fills it, all by TMA tensor copies
//   that complete on the stage's full mbarrier by their bytes: V tiles
//   (and flash's K tiles) as boxes of 64 dims x 64 keys with a 128-byte
//   swizzle; the prefill's K̂ gather of selected 8-dim chunks as one box of
//   1, 2, 4 or 8 chunks x 64 keys per power-of-two piece of each run of
//   consecutive selected chunks.
// - Warpgroups 0 and 1 are the consumers, 64 rows each (4 warps x 16
//   rows), with raised registers. Each waits on a stage's full barrier,
//   computes, and releases the stage on its empty barrier (one arrive per
//   warpgroup) once the wgmmas that read it are done. The walk over key
//   tiles has no block-wide barrier.
// - The consumers take turns on the tensor cores: named barriers (bar.sync
//   1 + wg, 256) order their wgmma issues, so one warpgroup's softmax runs
//   while the other's wgmmas run (consume's kTurns; the prefill's generic
//   kernel runs its consumers free, see consume). Inside a warpgroup, P·V
//   of tile j is issued with the scores of tile j + 1 and runs beside their
//   softmax.
// - Value slices: a block computes kMaxDv = 128 columns of the output, the
//   slice blockIdx.y of a wider Dv (up to 256: head_dim 256), with V read
//   from the slice's first column. Every slice walks the same key tiles
//   with the same Q̂ and K̂, so computes the same P bit for bit: the output
//   is one full-width computation's, at the cost of the scores once per
//   slice. The P·V accumulator stays 64 rows x 128 columns, which with the
//   scores and P fits the consumers' registers (a 256-column one would
//   take 128 registers a thread alone).
//
// Per tile and consumer warpgroup (qk_issue, softmax_tile, pv_issue):
//
// - S = Q·Kᵀ with wgmma m64n64k16 (bf16 in, f32 accumulate), both operands
//   read from shared memory through descriptors: Q, staged once, as A and
//   the K tile as B. (Q's fragments held in registers would push the
//   consumers past the 168 registers the compiler allots a thread of a
//   three-warpgroup block, and it would spill them around every product.)
//   bf16 x bf16 products are exact in f32, so S is the f32 dot product up
//   to the accumulation order.
// - The online softmax in registers, in the log2 domain: a thread holds
//   two rows (g and g + 8 of its warp's 16) x 16 keys; row max and row sum
//   reduce over the 4 threads of a quad with shuffles. The row sum l is
//   kept per thread from the f32 probabilities and reduced once at the end.
// - O += P·V with wgmma, P from registers (the accumulator fragments of S
//   repack as the A operand) and the V tile as a transposed (MN-major) B in
//   the swizzled layout: m64n128 for Dv > 80, m64n64 + m64n16 for Dv <= 80
//   (head_dim 80), m64n64 for Dv <= 64. P is split into P_hi = bf16(P) and
//   P_lo = bf16(P - P_hi), two wgmmas into the same accumulator: P rounded
//   once to bf16 misses the one-bf16-ulp limit of the outputs (PERF.md,
//   Findings), the split holds P to ~2^-16.
//
// Each row's arithmetic is the plain sequence O = O·corr_j + P_j·V_j over
// the block's tiles in ascending order: it does not depend on the overlap,
// on which consumer holds the row, on the slice, or on the timing of the
// ring.
//
// Layouts in shared memory: TMA boxes are 64 rows (keys) of 128 bytes,
// 16-byte chunk c of row r at chunk c ^ (r % 8) of its 1024-byte group
// (the wgmma B128 layout); boxes start on 1024-byte boundaries. The
// gathered K̂ is chunk-major and unswizzled: chunk u of key n at byte
// u·1024 + n·16, so each 8-key x 16-byte core matrix is 128 contiguous
// bytes. Q is interleaved (unswizzled): the 16-byte chunk c of row n sits
// at byte (n / 8)·nc·128 + c·128 + (n % 8)·16 for a tile nc chunks wide.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = 384;         // and the producer warpgroup
constexpr int kStages = 4;            // ring depth of the narrow kernels
// setmaxnreg: the launch gives each thread 168 registers; the producer
// warpgroup drops to 40 and the consumers rise to 232 (128 x 40 + 256 x
// 232 = 384 x 168). The compiler fits all of the kernel in 168.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRows = 128;            // query rows per block, 16 per consumer warp
constexpr int kKeys = 64;             // keys per tile
constexpr int kNarrowDepth = 128;     // q·k depth of the narrow kernels (padded to 16)
constexpr int kMaxDepth = 256;        // q·k depth of any kernel (padded to 16)
constexpr int kMaxDv = 128;           // value / output columns of a block: a slice
constexpr int kMaxValue = 256;        // value / output width, in slices of kMaxDv
constexpr int kNT = kMaxDv / 8;       // 8-wide n-tiles of O
constexpr int kBox = 64 * kKeys;      // elements of a TMA box: 64 keys x 64 dims
constexpr int kBoxBytes = 2 * kBox;   // 8 KB, a multiple of the swizzle's 1 KB

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory from its first 1024-byte boundary (the
// launch asks for 1 KB more): swizzled boxes start on one.
__device__ __forceinline__ bf16* align1k(unsigned char* p) {
  return reinterpret_cast<bf16*>(p + ((1024 - (smem_u32(p) & 1023)) & 1023));
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, named barriers, register reallocation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// A wait on the ring lasts at most one stage's copies or one tile's
// products by the other role, microseconds; the longest launch (the
// window form at S 8192) takes under 2 ms. A wait past kHangNs of the
// card's wall clock can only be a ring that never completes (a wrong
// count or parity): it traps, a launch failure in place of a hung card.
// The bound is in time, not spins, because try_wait suspends the thread
// for a time of the hardware's choosing.
constexpr uint64_t kHangNs = 4000000000ull;  // 4 s
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_ns() - t0 > kHangNs) __trap();
}

// TMA copy of the box at coordinates (c0 dim, c1 key, c2 head, c3 batch)
// of a 4D tensor map, completing on the mbarrier at `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ... and of a 5D one: (c0 element, c1 key, c2 8-dim chunk, c3 head, c4
// batch)
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map, uint32_t bar, int c0,
                                          int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// named barriers: 1 and 2 order the consumers' wgmma issues, 3 joins the
// two consumer warpgroups (Q staged)
constexpr int kSchedBar = 1, kConsumerBar = 3;

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// The ring of N stages' barriers: full[s] completes when stage s holds its
// tile (the producer's arrivals and the copies' bytes), empty[s] when both
// consumer warpgroups are done with it.
template <int N>
struct Ring {
  uint64_t full[N], empty[N];

  // one thread, before the block's last barrier ahead of the split
  __device__ __forceinline__ void init(int full_arrivals) {
    for (int s = 0; s < N; ++s) {
      mbar_init(&full[s], full_arrivals);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ __forceinline__ uint32_t full_bar(int it) { return smem_u32(&full[it % N]); }
  __device__ __forceinline__ uint32_t empty_bar(int it) { return smem_u32(&empty[it % N]); }
};

// The producer's side of the walk over a block's live key tiles j = first,
// next(first), ... (next returns a value >= end past the last): for the
// it-th tile, wait until its stage is empty (the release of tile it - N),
// then issue(j, stage, full barrier) fills it.
template <int N, class Next, class Issue>
__device__ __forceinline__ void produce(int first, int end, Next next, Ring<N>& ring,
                                        Issue issue) {
  int it = 0;
  for (int j = first; j < end; j = next(j), ++it) {
    if (it >= N) mbar_wait(ring.empty_bar(it), (it / N - 1) & 1);
    issue(j, it % N, ring.full_bar(it));
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Offset in elements of the 16-byte chunk c of row n in an interleaved
// tile nc chunks wide.
__device__ __forceinline__ int il(int n, int c, int nc) {
  return ((n >> 3) * nc + c) * 64 + (n & 7) * 8;
}

// wgmma shared-memory descriptor (PTX's leading and stride byte offsets)
// of an unswizzled operand: lbo is the byte stride between core matrices
// along K, sbo along M/N
__device__ __forceinline__ uint64_t wg_desc(const bf16* p, int lbo, int sbo) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// ... and of a 128-byte swizzled one (layout type 1): K-major, sbo is the
// stride between 8-row groups (lbo unused); MN-major, lbo is the stride
// between 64-element atoms along M/N and sbo between 8-row groups along K
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p, int lbo, int sbo) {
  return wg_desc(p, lbo, sbo) | (1ull << 62);
}

// d (64xN, f32) (+)= a · b: a from registers (this warp's 16 rows x 16,
// the m16n8k16 A fragment), b 16 x N from shared memory (kTransB: stored
// MN-major); acc = 0 overwrites d
template <int kTransB>
__device__ __forceinline__ void wgmma16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
}
// d (64x64, f32) += a · b, both from shared memory, K-major
__device__ __forceinline__ void wgmma64_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b));
}
template <int kTransB>
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
}
template <int kTransB>
__device__ __forceinline__ void wgmma128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTransB));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving register reads or writes across the
// asynchronous wgmma that owns these registers
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}
// shared-memory writes of the generic proxy (cp.async, stores) that this
// thread has observed become visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-huge = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) -> hi = bf16(a, b), lo = bf16(a - hi, b - hi): hi + lo holds the
// f32 pair to ~2^-16 relative
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// S (+)= Q·Kᵀ over NKS k-steps of 16 dims: straight-line wgmmas (a branch
// between two of them would make the compiler fence each one). kd is the
// K tile's descriptor, qd Q's (interleaved: a k-step two chunks, 256
// bytes, 16 descriptor units on). kGather: the K tile is the chunk-major
// gather, a k-step 2 KB (128 units) on; else 128-byte swizzled boxes of 64
// dims, a k-step 32 bytes (2 units) on inside a box and the next box 8 KB
// (512 units) on.
template <int NKS, bool kGather>
__device__ __forceinline__ void qk_tile(float (&sf)[32], uint64_t qd, uint64_t kd) {
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks)
    wgmma64_ss(sf, qd + 16 * ks, kd + (kGather ? 128 * ks : (ks >> 2) * 512 + (ks & 3) * 2));
}

// O += (P_hi + P_lo)·V over 64 keys; vd is the V tile's descriptor (its
// first swizzled box): 16 keys are 2 KB (128 units) on, the second box 8 KB
// (512 units). kKind 0: Dv <= 64, one m64n64; 1: Dv <= 80, m64n64 and
// m64n16 on the second box; 2: Dv <= 128, one m64n128 over both boxes.
template <int kKind>
__device__ __forceinline__ void pv_tile(float (&o)[kNT][4], const uint32_t (&ph)[4][4],
                                        const uint32_t (&pl)[4][4], uint64_t vd) {
  float(&o128)[64] = *reinterpret_cast<float(*)[64]>(&o[0][0]);
  float(&o64)[32] = *reinterpret_cast<float(*)[32]>(&o[0][0]);
  float(&o16)[8] = *reinterpret_cast<float(*)[8]>(&o[8][0]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = vd + kk * 128;
    if (kKind == 2) {
      wgmma128<1>(o128, ph[kk], d, 1);
      wgmma128<1>(o128, pl[kk], d, 1);
    } else {
      wgmma64<1>(o64, ph[kk], d, 1);
      wgmma64<1>(o64, pl[kk], d, 1);
      if (kKind == 1) {
        wgmma16<1>(o16, ph[kk], d + 512, 1);
        wgmma16<1>(o16, pl[kk], d + 512, 1);
      }
    }
  }
}

// the P·V width of a Dv-wide output (pv_tile's kKind)
__host__ __device__ inline int pv_kind(int dv) { return dv <= 64 ? 0 : dv <= 80 ? 1 : 2; }

// S = Q·Kᵀ for one key tile (Ks: the chunk-major gather of 2·nks chunks
// when kGather, else swizzled boxes), issued asynchronously as one wgmma
// group; NKS > 0 fixes nks at compile time, else nks <= 8 (a depth up to
// kNarrowDepth: the generic kernels, which walk depths of 16 to 128 dims).
template <bool kGather, int NKS>
__device__ __forceinline__ void qk_issue(float (&s)[8][4], uint64_t qd, int nks, const bf16* Ks) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  float(&sf)[32] = *reinterpret_cast<float(*)[32]>(&s[0][0]);
  hold(sf);
  wg_fence();
  const uint64_t kd = kGather ? wg_desc(Ks, kKeys * 16, 128) : sw128_desc(Ks, 16, 1024);
  if constexpr (NKS > 0) {
    qk_tile<NKS, kGather>(sf, qd, kd);
    wg_commit();
    return;
  }
  switch (nks) {
    case 1: qk_tile<1, kGather>(sf, qd, kd); break;
    case 2: qk_tile<2, kGather>(sf, qd, kd); break;
    case 3: qk_tile<3, kGather>(sf, qd, kd); break;
    case 4: qk_tile<4, kGather>(sf, qd, kd); break;
    case 5: qk_tile<5, kGather>(sf, qd, kd); break;
    case 6: qk_tile<6, kGather>(sf, qd, kd); break;
    case 7: qk_tile<7, kGather>(sf, qd, kd); break;
    default: qk_tile<8, kGather>(sf, qd, kd); break;
  }
  wg_commit();
}

// O += P·V for one key tile (Vs: swizzled boxes), issued asynchronously as
// one wgmma group; KIND >= 0 fixes kind at compile time.
template <int KIND>
__device__ __forceinline__ void pv_issue(float (&o)[kNT][4], const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4], const bf16* Vs, int kind) {
  float(&of)[kNT * 4] = *reinterpret_cast<float(*)[kNT * 4]>(&o[0][0]);
  hold(of);
  wg_fence();
  const uint64_t vd = sw128_desc(Vs, kBoxBytes, 1024);
  if constexpr (KIND >= 0) {
    pv_tile<KIND>(o, ph, pl, vd);
    wg_commit();
    return;
  }
  switch (kind) {
    case 0: pv_tile<0>(o, ph, pl, vd); break;
    case 1: pv_tile<1>(o, ph, pl, vd); break;
    default: pv_tile<2>(o, ph, pl, vd); break;
  }
  wg_commit();
}

// The online softmax of one tile's scores s (in place: s becomes P, in
// the log2 domain): when masked, valid(r, kk) says whether the thread's
// row r (0: g, 1: g + 8) sees the tile's key kk, otherwise every key is
// seen. The scaled score is one rounded product either way (__fmul_rn is
// never contracted), so a tile gives the same bits masked with every key
// valid as unmasked. Updates m and this thread's partial row sum l;
// returns in corr the factor that rescales the rows' earlier output.
template <class Valid>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2, bool masked,
                                             Valid valid) {
  const int t4 = threadIdx.x & 3;
  float mx[2] = {kNegInf, kNegInf};
  if (masked) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x =
            valid(r, 8 * j + 2 * t4 + (e & 1)) ? __fmul_rn(s[j][e], scale_log2) : kNegInf;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = __fmul_rn(s[j][e], scale_log2);
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = fast_exp2(s[j][e] - m[r]);
      s[j][e] = p;
      sum[r] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// O *= corr per row, then P (in s) split into the A fragments of P·V: the
// S fragments of keys 16kk .. 16kk + 15 are P's A fragment for k-step kk.
__device__ __forceinline__ void rescale_split(float (&o)[kNT][4], const float (&corr)[2],
                                              const float (&s)[8][4], uint32_t (&ph)[4][4],
                                              uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    o[n][0] *= corr[0];
    o[n][1] *= corr[0];
    o[n][2] *= corr[1];
    o[n][3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_pair(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
    split_pair(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
    split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
    split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
  }
}

// A consumer warpgroup's side of the walk over the block's live key tiles
// j = first, next(first), ... (as produce walks them): Q is staged in Qs
// (kRows x 2·nks chunks, interleaved); the it-th tile's K (kGather: the
// chunk-major gather, 2·nks chunks; else swizzled boxes) and V (swizzled
// boxes) sit in stage it % N of the ring at Ks + stage·kstage and Vs +
// stage·vstage. masked(j) and valid(j, r, kk) give tile j's masks
// (softmax_tile); each warpgroup accumulates its 64 rows into o, m and l.
//
// kTurns: the warpgroups take turns on the tensor cores. Warpgroup w waits
// on named barrier kSchedBar + w before it issues wgmmas and arrives on the
// other's after; warpgroup 1 arrives once up front, so warpgroup 0 issues
// first, and skips its last arrival, so both barriers end balanced. Both
// warpgroups walk the same tiles. Turns pay only while the compiler keeps
// the products asynchronous: where the consumers' registers run short it
// serializes them (ptxas C7511), a warpgroup then holds its turn until its
// products end, and free-running warpgroups are faster (PERF.md, Findings).
// No branch lies between a wgmma and the wait that ends it, so the P·V of
// one tile stays overlapped with the next tile's scores and softmax.
//
// NKS > 0 and KIND >= 0 fix nks and the P·V width (pv_tile's kKind) at
// compile time. A walk that picks its products at run time between issue
// points costs the consumers registers, and the compiler may then
// serialize their products (ptxas C7511); flash and the prefill have a
// kernel per served shape (a kernel holding several walks was slower), and
// every depth past kNarrowDepth takes a kernel of fixed depth.
template <bool kGather, bool kTurns, int NKS = 0, int KIND = -1, int N, class Next, class Masked,
          class Valid>
__device__ __forceinline__ void consume(int first, int end, Next next, Masked masked, Valid valid,
                                        Ring<N>& ring, const bf16* Qs, int nks, const bf16* Ks,
                                        int kstage, const bf16* Vs, int vstage,
                                        int kind, float scale_log2, float (&o)[kNT][4],
                                        float (&m)[2], float (&l)[2]) {
  if (first >= end) return;
  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 127) == 0;
  auto my_turn = [&] {
    if (kTurns) bar_sync(kSchedBar + wg, kConsumers);
  };
  auto pass_turn = [&] {
    if (kTurns) bar_arrive(kSchedBar + (wg ^ 1), kConsumers);
  };
  auto wait_full = [&](int it) { mbar_wait(ring.full_bar(it), (it / N) & 1); };
  // this warpgroup's 64 rows of Q: a core matrix (8 rows x 16 bytes) 128
  // bytes on along K, 2·nks of them along M
  const uint64_t qd = wg_desc(Qs + il(64 * wg, 0, 2 * nks), 128, nks * 256);
  if (wg == 1) pass_turn();

  float s[8][4], corr[2];
  uint32_t ph[4][4], pl[4][4];
  float(&sv)[32] = *reinterpret_cast<float(*)[32]>(&s[0][0]);
  float(&of)[kNT * 4] = *reinterpret_cast<float(*)[kNT * 4]>(&o[0][0]);
  int j = first, it = 0;
  int nxt = next(j);
  wait_full(0);
  my_turn();
  qk_issue<kGather, NKS>(s, qd, nks, Ks);
  pass_turn();
  wg_wait<0>();
  hold(sv);
  softmax_tile(s, m, l, corr, scale_log2, masked(j),
               [&](int r, int kk) { return valid(j, r, kk); });
  rescale_split(o, corr, s, ph, pl);
  // Every tile but the last: P·V of tile it runs while tile it + 1's
  // scores go through the softmax.
  while (nxt < end) {
    const int st = it % N, sn = (it + 1) % N;
    wait_full(it + 1);
    my_turn();
    qk_issue<kGather, NKS>(s, qd, nks, Ks + sn * kstage);
    pv_issue<KIND>(o, ph, pl, Vs + st * vstage, kind);
    pass_turn();
    wg_wait<1>();                     // the scores; P·V may run on
    hold(sv);
    softmax_tile(s, m, l, corr, scale_log2, masked(nxt),
                 [&](int r, int kk) { return valid(nxt, r, kk); });
    wg_wait<0>();
    hold(of);
    hold(ph);
    hold(pl);
    if (leader) mbar_arrive(ring.empty_bar(it));
    rescale_split(o, corr, s, ph, pl);
    j = nxt;
    nxt = next(nxt);
    ++it;
  }
  my_turn();
  pv_issue<KIND>(o, ph, pl, Vs + it % N * vstage, kind);   // the last tile
  if (wg == 0) pass_turn();
  wg_wait<0>();
  hold(of);
  hold(ph);
  hold(pl);
  if (leader) mbar_arrive(ring.empty_bar(it));
}

// Finalize and store this warp's rows: row r of the thread (0: g, 1: g +
// 8) at sequence row rows[r] (skipped when >= nrows), nvt 8-wide n-tiles,
// out row stride ost_s elements.
__device__ __forceinline__ void store_rows(bf16* ob, long long ost_s, const int (&rows)[2],
                                           int nrows, int nvt, const float (&o)[kNT][4],
                                           float (&l)[2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= nrows) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + rows[r] * ost_s + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n < nvt)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    }
  }
}

// Calls f(row, chunk) for thread t's share (of nt threads, n <= nt) of a
// rows x n grid of 16-byte chunks (element e = row·n + chunk for e = t, t +
// nt, ...), stepping the pair without a division per element.
template <class F>
__device__ __forceinline__ void for_chunks(int rows, int n, int t, int nt, F f) {
  const int dr = nt / n, dc = nt - dr * n;
  int r = t / n, c = t - r * n;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

// Zero-fill the 16-byte chunk c of n rows of an interleaved tile nc
// chunks wide: padding that no copy writes. Every thread of the block
// takes part, before the block's barrier ahead of the split.
__device__ __forceinline__ void zero_chunk(bf16* base, int nc, int c, int n) {
  for (int r = threadIdx.x; r < n; r += kThreads)
    *reinterpret_cast<uint4*>(base + il(r, c, nc)) = make_uint4(0, 0, 0, 0);
}

// Set a kernel's dynamic shared-memory limit once per device (outside any
// stream capture after the first launch).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int (&done)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 16) done[dev] = bytes;
  return err;
}

// A TMA tensor map of a bf16 tensor: rank dims (innermost first), byte
// strides of dims 1.., boxes of `box`, zeros outside the tensor. The
// encoder, cuTensorMapEncodeTiled, is fetched through the runtime's
// entry-point query, so nothing links against libcuda.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Byte strides of the key, head and batch axes of a (B, KV, S, dim) view
// with element strides st; the stride of an axis of size 1 is never used
// and is given the packed value. Needs a 16-byte aligned base and strides
// that are whole 16-byte units under 2^40 bytes (the wrappers check).
inline void byte_strides(cuuint64_t (&out)[3], int B, int KV, int S, int dim, Strides st) {
  out[0] = S == 1 ? (cuuint64_t)dim * 2 : (cuuint64_t)st.s * 2;
  out[1] = KV == 1 ? out[0] * S : (cuuint64_t)st.h * 2;
  out[2] = B == 1 ? out[1] * KV : (cuuint64_t)st.b * 2;
}

// The 4D map of K or V tiles: boxes of 64 dims x 64 keys in the 128-byte
// swizzle (zeros past S and past dim).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int KV, int S, int dim,
                            Strides st) {
  cuuint64_t bs[3];
  byte_strides(bs, B, KV, S, dim, st);
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)S, (cuuint64_t)KV, (cuuint64_t)B};
  const cuuint32_t box[4] = {64, kKeys, 1, 1};
  return encode_map(map, base, 4, dims, bs, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The 5D map of the K̂ gather: the view as (B, KV, S, dim / 8 chunks, 8),
// the chunk axis 16 bytes on, boxes of 8 elements x 64 keys x `chunks`
// chunks, which land chunk-major (zeros past S).
inline cudaError_t make_chunk_map(CUtensorMap* map, const void* base, int B, int KV, int S,
                                  int dim, Strides st, int chunks) {
  cuuint64_t bs[3];
  byte_strides(bs, B, KV, S, dim, st);
  const cuuint64_t dims[5] = {8, (cuuint64_t)S, (cuuint64_t)dim / 8, (cuuint64_t)KV,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {bs[0], 16, bs[1], bs[2]};
  const cuuint32_t box[5] = {8, kKeys, (cuuint32_t)chunks, 1, 1};
  return encode_map(map, base, 5, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// ---------------------------------------------------------------------------
// A lane of length 0
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void put_f32(bf16* p, float x) { *p = __float2bfloat16(x); }

// A block whose lane has length 0 sees no key: each of its rows gets the
// mean of V over all S keys, what the plain versions and JAX's dense
// reference give (a softmax over scores all masked to NEG_INF is
// uniform). vb: the lane's V at the block's first column (key stride vs);
// ob: its first output row and column, `heads` heads oh apart of `rows`
// rows os apart; dv columns. `scratch`: dv floats of shared memory that
// nothing else uses. Every thread of the block calls it, then returns.
template <class T>
__device__ __forceinline__ void empty_lane_inline(const T* __restrict__ vb, long long vs, int S,
                                                  int dv, float* scratch, T* __restrict__ ob,
                                                  long long oh, long long os, int heads,
                                                  int rows) {
  for (int c = threadIdx.x; c < dv; c += blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < S; ++k) sum += to_f32(vb[k * vs + c]);
    scratch[c] = sum / S;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < heads * rows * dv; e += blockDim.x) {
    const int c = e % dv, r = e / dv % rows, hh = e / dv / rows;
    put_f32(ob + hh * oh + r * os + c, scratch[c]);
  }
}

// The same, not inlined: a cold path that must not change the register
// allocation of the kernels it sits in (the generic bf16 flash inlines it
// instead: a call there cost its wgmma pipeline a C7511).
template <class T>
__device__ __noinline__ void empty_lane(const T* __restrict__ vb, long long vs, int S, int dv,
                           float* scratch, T* __restrict__ ob, long long oh, long long os,
                           int heads, int rows) {
  empty_lane_inline(vb, vs, S, dv, scratch, ob, oh, os, heads, rows);
}

}  // namespace attn_tile
