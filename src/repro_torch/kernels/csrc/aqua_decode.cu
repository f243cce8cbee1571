// AQUA block-sparse decode attention for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernel bodies of src/repro/kernels/aqua_decode.py:
// _kernel (contiguous cache), _paged_kernel (page pool), _paged_quant_kernel
// (int8 pool, scale-folded) and _paged_part_kernel / _paged_part_quant_kernel
// (only the participating pages of hierarchical AQUA, full precision and
// int8). For each (lane b, query head h): the partial score q̂·K̂ over only
// the NB_sel dim-blocks that |q̂| selected, masked at positions >= lengths[b],
// then a fused online softmax and the product with V.
//
// Layout: K̂ and V are read in the cache's own seq-major layout,
// k (P, KV, ps, D) and v (P, KV, ps, Dv). A contiguous cache (B, KV, S, D)
// is the same with P = B, ps = S and no page table (page = b). A position
// pos of lane b lives in page max(page_table[b, pos / ps], 0) at offset
// pos % ps. Heads are laid out (KV, G): kv = h / G.
//
// int8 pools: k and v hold int8 and k_scale / v_scale (P, SH) float32 one
// scale per page (SH = 1) or per page and kv head (SH = KV, s_stride = 1).
// The key scale folds into the score (dot · scale · k_scale[page]), the value
// scale into the softmax weight of the row (p · v_scale[page]), so no page is
// dequantized. A 256-position split spans several pages: the scales are
// looked up per position, through that position's page. The output is
// float32, as the Pallas call emits it for int8 pools.
//
// Participating pages (part_idx (B, KP), logical page ids): the walk covers
// KP·ps virtual positions; virtual position vp maps to logical position
// part_idx[b, vp / ps]·ps + vp % ps, valid iff below lengths[b]. Validity is
// tested per position (the tail page is partial, pages past the tail are
// padding), and every one of the KP·ps / split splits is written and merged.
//
// Bound on the H100: bytes. Per step the kernel must read, per lane, the
// selected dim-blocks of every valid K̂ row plus every valid V row (of the
// participating pages only). Design (split-sequence, two launches): the
// partial kernel runs one block of 128 threads per (split of kSplit
// positions, h, b), so a batch of 8 lanes still fills the card. Each thread
// scores one token of a 128-token tile from the selected blocks only
// (k_ratio of the K̂ row bytes; bd = 8 bf16 values are 16 contiguous bytes),
// the block reduces the tile's max and sum, and each thread accumulates one
// or two output dims over the tile's V rows (coalesced across threads; the
// participating walk skips rows of zero weight, its invalid positions).
// The participating walk and int8 are compile-time variants, so the
// full-precision walk over every page pays nothing for them. Splits at or past
// lengths[b] exit at once when every page is walked, so only positions below
// lengths[b] are read. Each split writes its running (max, sum, acc) in
// float32 to scratch; the combine kernel merges the splits of each (b, h)
// with the same online-softmax algebra. Math in float32. A lane with no
// valid position writes zeros (the Pallas kernel writes the mean of the V
// slots it visited; callers never read such lanes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxSel = 256;   // NB_sel * bd
constexpr int kMaxDv = 2 * kThreads;
constexpr int kSplit = 256;    // positions per partial block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < kThreads / 32; ++i) v = fmaxf(v, red[i]);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < kThreads / 32; ++i) v += red[i];
  return v;
}

struct Pages {
  const int* table;    // (B, np_lane) or null: contiguous cache
  const int* part;     // (B, kp) participating logical pages, or null
  const float* ks;     // (P, sh) int8 key scales, or null
  const float* vs;     // (P, sh) int8 value scales, or null
  int ps, np_lane, kp, sh, s_stride;
};

// Partial pass: one block per (split, h, b). Scratch layout per (b, h,
// split): [m, l, acc[0..Dv)] in float32. kPart walks participating pages;
// int8 K/V (KT = int8_t) read scales. Both are compile-time, so the
// full-precision walk over every page compiles as it did without them.
template <typename QT, typename KT, bool kPart>
__global__ void __launch_bounds__(kThreads) aqua_decode_partial(
    const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const int* __restrict__ block_idx, Pages pg, const int* __restrict__ lengths,
    float* __restrict__ scratch, int H, int KV, int D, int Dv, int nb_sel, int bd,
    int nsplit, float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int ps = pg.ps;
  const int len = min(lengths[b], pg.table ? ps * pg.np_lane : ps);
  // virtual positions walked: every logical position, or the KP pages
  const int vlen = kPart ? pg.kp * ps : len;
  const int begin = split * kSplit;
  if (begin >= vlen) return;  // the combine pass reads only splits below vlen
  const int end = min(vlen, begin + kSplit);
  const int kv = h / (H / KV);
  const int nsel = nb_sel * bd;

  __shared__ float qs[kMaxSel];
  __shared__ int dim[kMaxSel];
  __shared__ float p_s[kThreads];
  __shared__ int64_t row_s[kThreads];
  __shared__ float red[kThreads / 32];

  const int* idx = block_idx + ((int64_t)b * H + h) * nb_sel;
  for (int e = t; e < nsel; e += kThreads) {
    const int d = idx[e / bd] * bd + e % bd;
    dim[e] = d;
    qs[e] = to_f(q[((int64_t)b * H + h) * D + d]);
  }
  __syncthreads();

  float m = kNegInf, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int base = begin; base < end; base += kThreads) {
    const int vp = base + t;
    float s = kNegInf, vscale = 1.f;
    bool valid = vp < end;  // every position below end, unless kPart
    if (valid) {
      int lp = vp / ps;
      const int off = vp - lp * ps;
      if constexpr (kPart) {
        lp = pg.part[(int64_t)b * pg.kp + lp];
        valid = lp * ps + off < len;
      }
      if (valid) {
        const int page = pg.table ? max(pg.table[(int64_t)b * pg.np_lane + lp], 0) : b;
        const int64_t row = ((int64_t)page * KV + kv) * ps + off;
        row_s[t] = row;
        const KT* kr = k + row * D;
        float dot = 0.f;
        for (int e = 0; e < nsel; ++e) dot += qs[e] * to_f(kr[dim[e]]);
        float sc = scale;
        if constexpr (kQuant) {
          const int64_t si = (int64_t)page * pg.sh + kv * pg.s_stride;
          sc = scale * pg.ks[si];
          vscale = pg.vs[si];
        }
        s = dot * sc;
      }
    }
    const float m_new = fmaxf(m, block_max(s, red));
    // a tile of the participating walk may hold no valid position, so its
    // max can stay NEG_INF: invalid positions get weight 0 explicitly
    const float p = (!kPart || valid) ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    p_s[t] = kQuant ? p * vscale : p;
    l = l * corr + block_sum(p, red);  // block_sum syncs: p_s, row_s visible
    m = m_new;
    const int n = min(kThreads, end - base);
    float a0 = 0.f, a1 = 0.f;
    for (int i = 0; i < n; ++i) {
      const float pi = p_s[i];
      if constexpr (kPart) {
        if (pi == 0.f) continue;     // invalid position (uniform branch)
      }
      const KT* vr = v + row_s[i] * Dv;
      if (t < Dv) a0 += pi * to_f(vr[t]);
      if (t + kThreads < Dv) a1 += pi * to_f(vr[t + kThreads]);
    }
    acc0 = acc0 * corr + a0;
    acc1 = acc1 * corr + a1;
    __syncthreads();  // p_s / row_s are rewritten by the next tile
  }
  float* sc = scratch + (((int64_t)b * H + h) * nsplit + split) * (Dv + 2);
  if (t == 0) {
    sc[0] = m;
    sc[1] = l;
  }
  if (t < Dv) sc[2 + t] = acc0;
  if (t + kThreads < Dv) sc[2 + t + kThreads] = acc1;
}

// Combine pass: one block per (h, b) merges the splits the partial pass
// wrote: those below lengths[b], or all of them over participating pages.
template <typename OT>
__global__ void __launch_bounds__(kThreads) aqua_decode_combine(
    const float* __restrict__ scratch, const int* __restrict__ lengths,
    OT* __restrict__ out, int H, int Dv, int nsplit, int walk_all) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int n = walk_all ? nsplit : min((lengths[b] + kSplit - 1) / kSplit, nsplit);
  const float* sc = scratch + ((int64_t)b * H + h) * nsplit * (Dv + 2);
  float m = kNegInf;
  for (int i = 0; i < n; ++i) m = fmaxf(m, sc[i * (Dv + 2)]);
  float l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* si = sc + i * (Dv + 2);
    const float w = expf(si[0] - m);
    l += w * si[1];
    if (t < Dv) acc0 += w * si[2 + t];
    if (t + kThreads < Dv) acc1 += w * si[2 + t + kThreads];
  }
  const float denom = fmaxf(l, 1e-30f);
  OT* o = out + ((int64_t)b * H + h) * Dv;
  if (t < Dv) o[t] = from_f<OT>(acc0 / denom);
  if (t + kThreads < Dv) o[t + kThreads] = from_f<OT>(acc1 / denom);
}

template <typename QT, typename KT, typename OT>
int launch(const void* q, const void* k, const void* v, const int* bi, const Pages& pg,
           const int* ln, void* out, float* scratch, int B, int H, int KV, int D, int Dv,
           int nb_sel, int bd, int nsplit, float scale, cudaStream_t st) {
  if (pg.part)
    aqua_decode_partial<QT, KT, true><<<dim3(nsplit, H, B), kThreads, 0, st>>>(
        (const QT*)q, (const KT*)k, (const KT*)v, bi, pg, ln, scratch, H, KV, D, Dv,
        nb_sel, bd, nsplit, scale);
  else
    aqua_decode_partial<QT, KT, false><<<dim3(nsplit, H, B), kThreads, 0, st>>>(
        (const QT*)q, (const KT*)k, (const KT*)v, bi, pg, ln, scratch, H, KV, D, Dv,
        nb_sel, bd, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  aqua_decode_combine<OT><<<dim3(H, B), kThreads, 0, st>>>(scratch, ln, (OT*)out, H, Dv,
                                                           nsplit, pg.part != nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// Positions per partial block: the wrapper sizes the float32 scratch as
// B * H * nsplit * (Dv + 2) with nsplit = ceil(positions walked / split).
extern "C" int aqua_decode_split() { return kSplit; }

// dtype: 0 = float32, 1 = bfloat16 (of q; of k, v and out too unless
// quantized). page_table may be null (contiguous cache: P = B, ps = S).
// k_scale / v_scale non-null: k and v are int8 with (P, sh) scales, out is
// float32. part_idx non-null: (B, kp) participating logical pages. Returns
// the cudaError_t of the launches.
extern "C" int aqua_decode_launch(const void* q, const void* k, const void* v,
                                  const void* block_idx, const void* page_table,
                                  const void* part_idx, const void* k_scale,
                                  const void* v_scale, const void* lengths, void* out,
                                  void* scratch, int B, int H, int KV, int D, int Dv,
                                  int nb_sel, int bd, int ps, int np_lane, int kp, int sh,
                                  int nsplit, float scale, int dtype, void* stream) {
  if (nb_sel * bd > kMaxSel || Dv > kMaxDv || H % KV != 0) return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if ((part_idx || k_scale) && !page_table) return (int)cudaErrorInvalidValue;
  if (B == 0 || nsplit == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int* bi = (const int*)block_idx;
  const int* ln = (const int*)lengths;
  float* sc = (float*)scratch;
  const Pages pg{(const int*)page_table, (const int*)part_idx, (const float*)k_scale,
                 (const float*)v_scale, ps, np_lane, kp, sh, sh > 1 ? 1 : 0};
  if (k_scale) {
    if (dtype == 0)
      return launch<float, int8_t, float>(q, k, v, bi, pg, ln, out, sc, B, H, KV, D, Dv,
                                          nb_sel, bd, nsplit, scale, st);
    return launch<__nv_bfloat16, int8_t, float>(q, k, v, bi, pg, ln, out, sc, B, H, KV,
                                                D, Dv, nb_sel, bd, nsplit, scale, st);
  }
  if (dtype == 0)
    return launch<float, float, float>(q, k, v, bi, pg, ln, out, sc, B, H, KV, D, Dv,
                                       nb_sel, bd, nsplit, scale, st);
  return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
      q, k, v, bi, pg, ln, out, sc, B, H, KV, D, Dv, nb_sel, bd, nsplit, scale, st);
}
