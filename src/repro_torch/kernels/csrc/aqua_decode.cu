// AQUA block-sparse decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/aqua_decode.py:_kernel
// (contiguous cache) and :_paged_kernel (page pool): for each (lane b,
// query head h) the partial score q̂·K̂ over only the NB_sel dim-blocks that
// |q̂| selected, masked at positions >= lengths[b], then a fused online
// softmax and the product with V.
//
// Layout: K̂ and V are read in the cache's own seq-major layout,
// k (P, KV, ps, D) and v (P, KV, ps, Dv). A contiguous cache (B, KV, S, D)
// is the same with P = B, ps = S and no page table (page = b). A position
// pos of lane b lives in page max(page_table[b, pos / ps], 0) at offset
// pos % ps. Heads are laid out (KV, G): kv = h / G.
//
// Bound on the H100: bytes. Per step the kernel must read, per lane, the
// selected dim-blocks of every valid K̂ row plus every valid V row. Design
// (split-sequence, two launches): the partial kernel runs one block of 128
// threads per (split of kSplit positions, h, b), so a batch of 8 lanes
// still fills the card. Each thread scores one token of a 128-token tile
// from the selected blocks only (k_ratio of the K̂ row bytes; bd = 8 bf16
// values are 16 contiguous bytes), the block reduces the tile's max and
// sum, and each thread accumulates one or two output dims over the tile's
// V rows (coalesced across threads). Splits at or past lengths[b] exit at
// once, so only positions below lengths[b] are read. Each split writes its
// running (max, sum, acc) in float32 to scratch; the combine kernel merges
// the splits of each (b, h) with the same online-softmax algebra. Math in
// float32. A lane with lengths[b] = 0 writes zeros (the Pallas kernel
// writes the mean of the V slots it visited; callers never read such
// lanes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxSel = 256;   // NB_sel * bd
constexpr int kMaxDv = 2 * kThreads;
constexpr int kSplit = 256;    // positions per partial block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
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

// Partial pass: one block per (split, h, b). Scratch layout per (b, h,
// split): [m, l, acc[0..Dv)] in float32.
template <typename T>
__global__ void __launch_bounds__(kThreads) aqua_decode_partial(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ block_idx, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ scratch, int H, int KV,
    int D, int Dv, int nb_sel, int bd, int ps, int np_lane, int nsplit, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int len = min(lengths[b], page_table ? ps * np_lane : ps);
  const int begin = split * kSplit;
  if (begin >= len) return;  // the combine pass reads only splits below len
  const int end = min(len, begin + kSplit);
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
    const int pos = base + t;
    float s = kNegInf;
    if (pos < end) {
      const int lp = pos / ps;
      const int page = page_table ? max(page_table[(int64_t)b * np_lane + lp], 0) : b;
      const int64_t row = ((int64_t)page * KV + kv) * ps + (pos - lp * ps);
      row_s[t] = row;
      const T* kr = k + row * D;
      float dot = 0.f;
      for (int e = 0; e < nsel; ++e) dot += qs[e] * to_f(kr[dim[e]]);
      s = dot * scale;
    }
    const float m_new = fmaxf(m, block_max(s, red));
    const float p = expf(s - m_new);
    const float corr = expf(m - m_new);
    p_s[t] = p;
    l = l * corr + block_sum(p, red);  // block_sum syncs: p_s, row_s visible
    m = m_new;
    const int n = min(kThreads, end - base);
    float a0 = 0.f, a1 = 0.f;
    for (int i = 0; i < n; ++i) {
      const float pi = p_s[i];
      const T* vr = v + row_s[i] * Dv;
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

// Combine pass: one block per (h, b) merges the splits below lengths[b].
template <typename T>
__global__ void __launch_bounds__(kThreads) aqua_decode_combine(
    const float* __restrict__ scratch, const int* __restrict__ lengths,
    T* __restrict__ out, int H, int Dv, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int n = min((lengths[b] + kSplit - 1) / kSplit, nsplit);
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
  T* o = out + ((int64_t)b * H + h) * Dv;
  if (t < Dv) o[t] = from_f<T>(acc0 / denom);
  if (t + kThreads < Dv) o[t + kThreads] = from_f<T>(acc1 / denom);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* bi, const int* pt,
           const int* ln, void* out, float* scratch, int B, int H, int KV, int D,
           int Dv, int nb_sel, int bd, int ps, int np_lane, int nsplit, float scale,
           cudaStream_t st) {
  aqua_decode_partial<T><<<dim3(nsplit, H, B), kThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, bi, pt, ln, scratch, H, KV, D, Dv, nb_sel,
      bd, ps, np_lane, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  aqua_decode_combine<T><<<dim3(H, B), kThreads, 0, st>>>(scratch, ln, (T*)out, H, Dv,
                                                          nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Positions per partial block: the wrapper sizes the float32 scratch as
// B * H * nsplit * (Dv + 2) with nsplit = ceil(capacity / split).
extern "C" int aqua_decode_split() { return kSplit; }

// dtype: 0 = float32, 1 = bfloat16. page_table may be null (contiguous
// cache: P = B, ps = S). Returns the cudaError_t of the launches.
extern "C" int aqua_decode_launch(const void* q, const void* k, const void* v,
                                  const void* block_idx, const void* page_table,
                                  const void* lengths, void* out, void* scratch, int B,
                                  int H, int KV, int D, int Dv, int nb_sel, int bd,
                                  int ps, int np_lane, int nsplit, float scale, int dtype,
                                  void* stream) {
  if (nb_sel * bd > kMaxSel || Dv > kMaxDv || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* bi = (const int*)block_idx;
  const int* pt = (const int*)page_table;
  const int* ln = (const int*)lengths;
  float* sc = (float*)scratch;
  if (dtype == 0)
    return launch<float>(q, k, v, bi, pt, ln, out, sc, B, H, KV, D, Dv, nb_sel, bd, ps,
                         np_lane, nsplit, scale, st);
  return launch<__nv_bfloat16>(q, k, v, bi, pt, ln, out, sc, B, H, KV, D, Dv, nb_sel, bd,
                               ps, np_lane, nsplit, scale, st);
}
