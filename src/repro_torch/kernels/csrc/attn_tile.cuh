// Tensor-core tile machinery shared by aqua_prefill.cu and flash_attention.cu
// (their bf16 routes; sm_90a).
//
// A block of kThreads = 256 threads (two warpgroups of 4 warps) owns kRows
// = 128 query rows, 16 per warp, and walks kKeys = 64-key tiles staged in
// shared memory, which both warpgroups read. Per tile and warpgroup
// (qk_issue, softmax_tile, pv_issue):
//
// - S = Q·Kᵀ with wgmma m64n64k16 (bf16 in, f32 accumulate): Q's A
//   fragments stay in registers for the whole walk, the K tile is B, read
//   from shared memory through a descriptor. bf16 x bf16 products are exact
//   in f32, so S is the f32 dot product up to the accumulation order.
// - The online softmax in registers, in the log2 domain: a thread holds
//   two rows (g and g + 8 of its warp's 16) x 16 keys; row max and row sum
//   reduce over the 4 threads of a quad with shuffles. The row sum l is
//   kept per thread from the f32 probabilities and reduced once at the end.
// - O += P·V with wgmma m64n64k16, P from registers (the accumulator
//   fragments of S repack as the A operand) and the V tile as a transposed
//   (MN-major) B from shared memory, in 64-wide slices of the output. P is
//   split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), two wgmmas into the
//   same accumulator: P rounded once to bf16 misses the one-bf16-ulp limit
//   of the outputs (PERF.md, Findings), the split holds P to ~2^-16.
//
// The walk over a block's key tiles (walk) keeps a three-stage cp.async
// ring of K and V tiles and overlaps, per warpgroup, the P·V wgmmas of one
// tile with the scores and softmax of the next.
//
// Tiles live in shared memory in the interleaved (unswizzled) layout that
// wgmma reads: the 16-byte chunk c of row n sits at byte (n / 8)·nc·128 +
// c·128 + (n % 8)·16 for a tile nc chunks wide, so each 8-row x 16-byte
// core matrix is 128 contiguous bytes (and ldmatrix's eight rows hit
// distinct banks). They are staged with 16-byte cp.async copies (a src
// size of 0 fills zeros: keys past the end, unselected dims, padding).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;
constexpr int kRows = 128;           // query rows per block, 16 per warp
constexpr int kKeys = 64;            // keys per tile
constexpr int kMaxDepth = 128;       // q·k depth (padded to 16)
constexpr int kMaxDv = 128;          // value / output width
constexpr int kKS = kMaxDepth / 16;  // k-steps of S = Q·Kᵀ
constexpr int kNT = kMaxDv / 8;      // 8-wide n-tiles of O

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// wgmma shared-memory descriptor of an unswizzled operand (PTX's leading
// and stride byte offsets): lbo is the byte stride between core matrices
// along K, sbo along M/N, for a K-major operand and for an MN-major one
// (read with the transpose bit) alike
__device__ __forceinline__ uint64_t wg_desc(const bf16* p, int lbo, int sbo) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64x64, f32) (+)= a · b: a from registers (this warp's 16 rows x 16,
// the m16n8k16 A fragment), b 16 x 64 from shared memory (kTransB: stored
// MN-major); acc = 0 overwrites d
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
// shared-memory writes of this thread (cp.async, stores) become visible to
// wgmma's reads (the async proxy); a barrier then publishes them
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

// Q fragments of this warp's 16 rows for nks k-steps, from an interleaved
// tile Qs nc chunks wide
__device__ __forceinline__ void load_q(uint32_t (&qf)[kKS][4], const bf16* Qs, int nc,
                                       int nks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp * 16 + (lane & 15), half = lane >> 4;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    if (ks < nks) ldsm_x4(qf[ks], Qs + il(row, 2 * ks + half, nc));
  }
}

// S (+)= Q·Kᵀ over NKS k-steps of 16 dims: straight-line wgmmas (a branch
// between two of them would make the compiler fence each one). kd is the
// K tile's descriptor; a k-step is 256 bytes (16 descriptor units) on.
template <int NKS>
__device__ __forceinline__ void qk_tile(float (&sf)[32], const uint32_t (&qf)[kKS][4],
                                        uint64_t kd) {
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) wgmma64<0>(sf, qf[ks], kd + 16 * ks, 1);
}

// O += (P_hi + P_lo)·V over 64 keys for NC 64-wide output slices; vd is
// the V tile's descriptor (ncv chunks wide): 16 keys are 2·ncv core
// matrices on, a slice is 8 core matrices (8 descriptor units each) on.
template <int NC>
__device__ __forceinline__ void pv_tile(float (&o)[kNT][4], const uint32_t (&ph)[4][4],
                                        const uint32_t (&pl)[4][4], uint64_t vd, int ncv) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float(&oc)[32] = *reinterpret_cast<float(*)[32]>(&o[8 * c][0]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = vd + (2 * kk * ncv + 8 * c) * 8;
      wgmma64<1>(oc, ph[kk], d, 1);
      wgmma64<1>(oc, pl[kk], d, 1);
    }
  }
}

// S = Q·Kᵀ for one key tile (Ks: kKeys x 2·nks chunks, interleaved),
// issued asynchronously as one wgmma group.
__device__ __forceinline__ void qk_issue(float (&s)[8][4], const uint32_t (&qf)[kKS][4], int nks,
                                         const bf16* Ks) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  float(&sf)[32] = *reinterpret_cast<float(*)[32]>(&s[0][0]);
  hold(sf);
  wg_fence();
  const uint64_t kd = wg_desc(Ks, 128, nks * 256);
  switch (nks) {
    case 1: qk_tile<1>(sf, qf, kd); break;
    case 2: qk_tile<2>(sf, qf, kd); break;
    case 3: qk_tile<3>(sf, qf, kd); break;
    case 4: qk_tile<4>(sf, qf, kd); break;
    case 5: qk_tile<5>(sf, qf, kd); break;
    case 6: qk_tile<6>(sf, qf, kd); break;
    case 7: qk_tile<7>(sf, qf, kd); break;
    default: qk_tile<8>(sf, qf, kd); break;
  }
  wg_commit();
}

// O += P·V for one key tile (Vs: kKeys x ncv chunks, interleaved, ncv a
// multiple of 8), issued asynchronously as one wgmma group.
__device__ __forceinline__ void pv_issue(float (&o)[kNT][4], const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4], const bf16* Vs, int ncv) {
  float(&of)[kNT * 4] = *reinterpret_cast<float(*)[kNT * 4]>(&o[0][0]);
  hold(of);
  wg_fence();
  const uint64_t vd = wg_desc(Vs, ncv * 128, 128);
  static_assert(kNT == 16, "two 64-wide output slices");
  if (ncv > 8)
    pv_tile<2>(o, ph, pl, vd, ncv);
  else
    pv_tile<1>(o, ph, pl, vd, ncv);
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

// The walk over a block's live key tiles j = first, next(first), ...
// (next returns a value >= end past the last), with a three-stage
// cp.async ring of K and V tiles (kstage and vstage elements per stage)
// and the tensor work pipelined across tiles: while P·V of tile j runs,
// the scores of the following tile are computed and put through the
// softmax. Per tile the arithmetic is the plain sequence O = O·corr_j +
// P_j·V_j, so the result does not depend on the overlap. The caller has
// issued Q's copies into Qs (kRows x 2·nks chunks, interleaved);
// load(j, stage) issues tile j's copies; masked(j) and valid(j, r, kk)
// give tile j's masks (softmax_tile). Each warpgroup accumulates its 64
// rows into o, m and l.
template <class Next, class Load, class Masked, class Valid>
__device__ __forceinline__ void walk(int first, int end, Next next, Load load, Masked masked,
                                     Valid valid, const bf16* Qs, int nks, const bf16* Ks,
                                     int kstage, const bf16* Vs, int vstage, int ncv,
                                     float scale_log2, float (&o)[kNT][4], float (&m)[2],
                                     float (&l)[2]) {
  const int j = first;
  int nxt = j < end ? next(j) : end;
  int sj = 0, sn = 1, sf = 2;       // stages of the current tile, nxt and the free one
  if (j < end) load(j, sj);
  cp_async_commit();                // with Q's copies
  if (nxt < end) load(nxt, sn);
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();
  uint32_t qf[kKS][4];
  load_q(qf, Qs, 2 * nks, nks);
  if (j >= end) return;

  float s[8][4], corr[2];
  uint32_t ph[4][4], pl[4][4];
  float(&sv)[32] = *reinterpret_cast<float(*)[32]>(&s[0][0]);
  float(&of)[kNT * 4] = *reinterpret_cast<float(*)[kNT * 4]>(&o[0][0]);
  qk_issue(s, qf, nks, Ks + sj * kstage);
  wg_wait<0>();
  hold(sv);
  softmax_tile(s, m, l, corr, scale_log2, masked(j),
               [&](int r, int kk) { return valid(j, r, kk); });
  rescale_split(o, corr, s, ph, pl);
  // Every tile but the last: P·V of the current tile runs while the next
  // tile's scores go through the softmax. No branch lies between a wgmma
  // and the wait that ends it, so the compiler keeps the two overlapped.
  while (nxt < end) {
    // tile nxt has landed for every thread, and every warpgroup is done
    // with the tile before the current one, whose stage takes tile nxt2
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    const int nxt2 = next(nxt);
    if (nxt2 < end) load(nxt2, sf);
    cp_async_commit();
    qk_issue(s, qf, nks, Ks + sn * kstage);
    pv_issue(o, ph, pl, Vs + sj * vstage, ncv);
    wg_wait<1>();                   // the scores; P·V may run on
    hold(sv);
    softmax_tile(s, m, l, corr, scale_log2, masked(nxt),
                 [&](int r, int kk) { return valid(nxt, r, kk); });
    wg_wait<0>();
    hold(of);
    hold(ph);
    hold(pl);
    rescale_split(o, corr, s, ph, pl);
    nxt = nxt2;
    const int t = sj;
    sj = sn;
    sn = sf;
    sf = t;
  }
  pv_issue(o, ph, pl, Vs + sj * vstage, ncv);  // the last tile
  wg_wait<0>();
  hold(of);
  hold(ph);
  hold(pl);
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

// Calls f(row, chunk) for this thread's share of a rows x n grid of
// 16-byte chunks (element e = row·n + chunk for e = threadIdx.x, +
// kThreads, ...), stepping the pair without a division per element.
template <class F>
__device__ __forceinline__ void for_chunks(int rows, int n, F f) {
  const int dr = kThreads / n, dc = kThreads - dr * n;
  int r = threadIdx.x / n, c = threadIdx.x - r * n;
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
// chunks wide: padding that cp.async never writes.
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

}  // namespace attn_tile
