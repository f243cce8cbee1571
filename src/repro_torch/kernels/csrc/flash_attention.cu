// Dense flash attention (causal or not, optional sliding window, GQA) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel:
// out[b, h, i] = softmax_j(q[b, h, i] . k[b, kv, j] / sqrt(D)) v[b, kv, j]
// with kv = h / G, the causal mask j <= i and, when window > 0, the
// sliding-window mask j > i - window. Online softmax in float32 with
// NEG_INF = -1e30 and the finalize acc / max(l, 1e-30), as the Pallas
// kernel. The same kernel serves the dense baseline (AQUA off) and
// per-dim AQUA prefill (block_dims = 1) on the masked q̂.
//
// Layout: q (B, H, S, D), k and v (B, KV, S, D), out (B, H, S, D),
// addressed by element strides of their batch, head and sequence axes
// (the innermost dim must be contiguous), so the model's (B, S, KV, G, D)
// tensors are read in place without a transpose.
//
// Bound on the H100: operations at prompt lengths (S = 2048: ~S²/2 · H ·
// 2D multiply-adds against ~S · KV · 2D bytes of K and V). Design, simple
// first (the same tiling as aqua_prefill.cu, with every dim): one block of
// 128 threads per (b, h, QR = 32 query rows). The block walks 64-key tiles
// from the window's first tile to its causal bound, stages the tile's K
// and V rows in shared memory as float32, computes the QR x 64 scores with
// float32 FMAs on register tiles, runs the online softmax one row per
// thread and accumulates the QR x D output on register tiles. Tensor
// cores (mma.sync / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kKT = 64;        // keys per tile
constexpr int kQR = 32;        // query rows per block
constexpr int kMaxD = kThreads;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

__host__ __device__ constexpr int smem_floats(int d) {
  // Qs[QR][D+1] + Ks[KT][D+1] + Vs[KT][D] + Ss[QR][KT+1] + M, L, C
  return kQR * (d + 1) + kKT * (d + 1) + kKT * d + kQR * (kKT + 1) + 3 * kQR;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int KV, int S, int D, Strides qst, Strides kst,
    Strides vst, Strides ost, float scale, int causal, int window) {
  // Register tiles: each thread scores RM rows x 4 keys (16 key groups x 8
  // row groups) and accumulates RP rows x 4 output dims (32 dim groups x 4
  // row groups).
  constexpr int RM = kQR / 8;
  constexpr int RP = kQR / 4;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int kv = h / (H / KV);
  const int row0 = tile * kQR;
  const int str = D + 1;          // odd row stride: conflict-free columns
  constexpr int sstr = kKT + 1;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kQR * str;
  float* Vs = Ks + kKT * str;
  float* Ss = Vs + kKT * D;
  float* M = Ss + kQR * sstr;
  float* L = M + kQR;
  float* C = L + kQR;

  if (t < kQR) {
    M[t] = kNegInf;
    L[t] = 0.f;
  }
  const T* qb = q + b * qst.b + h * qst.h;
  for (int e = t; e < kQR * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r * str + c] = row0 + r < S ? to_f(qb[(row0 + r) * qst.s + c]) : 0.f;
  }
  __syncthreads();

  // keys this block can see: [kbeg, kend)
  int kend = causal ? min(S, row0 + kQR) : S;
  int kbeg = 0;
  if (window > 0) kbeg = max(0, row0 - window + 1) / kKT * kKT;
  const T* kb = k + b * kst.b + kv * kst.h;
  const T* vb = v + b * vst.b + kv * vst.h;
  const int srg = t / 16, skg = t % 16;   // score tile: rows srg*RM.., keys skg+16j
  const int prg = t / 32, pdg = t % 32;   // value tile: rows prg*RP.., dims pdg+32j
  float acc[RP][4];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kKT) {
    for (int e = t; e < kKT * D; e += kThreads) {
      const int kk = e / D, c = e % D;
      const int pos = k0 + kk;
      Ks[kk * str + c] = pos < S ? to_f(kb[pos * kst.s + c]) : 0.f;
      Vs[e] = pos < S ? to_f(vb[pos * vst.s + c]) : 0.f;
    }
    __syncthreads();

    float sc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qv[RM], kv4[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(srg * RM + i) * str + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv4[j] = Ks[(skg + 16 * j) * str + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv4[j];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = srg * RM + i, kk = skg + 16 * j;
        const int qpos = row0 + r, kpos = k0 + kk;
        const bool valid = kpos < S && (!causal || qpos >= kpos) &&
                           (window <= 0 || kpos > qpos - window);
        Ss[r * sstr + kk] = valid ? sc[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    if (t < kQR) {
      float* sr = Ss + t * sstr;
      float mx = kNegInf;
      for (int kk = 0; kk < kKT; ++kk) mx = fmaxf(mx, sr[kk]);
      const float m_prev = M[t];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int kk = 0; kk < kKT; ++kk) {
        const float p = expf(sr[kk] - m_new);
        sr[kk] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      L[t] = L[t] * corr + sum;
      M[t] = m_new;
      C[t] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const float corr = C[prg * RP + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < kKT; ++kk) {
      float vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = pdg + 32 * j;
        vv[j] = d < D ? Vs[kk * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const float p = Ss[(prg * RP + i) * sstr + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += p * vv[j];
      }
    }
    __syncthreads();  // Ks / Vs / Ss are rewritten by the next tile
  }

  T* ob = out + b * ost.b + h * ost.h;
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int r = prg * RP + i;
    if (row0 + r >= S) continue;
    const float denom = fmaxf(L[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = pdg + 32 * j;
      if (d < D) ob[(row0 + r) * ost.s + d] = from_f<T>(acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
           int S, int D, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, int window, cudaStream_t st) {
  const int bytes = smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kQR - 1) / kQR, H, B);
  flash_kernel<T><<<grid, kThreads, bytes, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                 (T*)out, H, KV, S, D, qs, ks, vs, os,
                                                 scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: {batch, head, seq} of q, k, v and out. window
// <= 0 means no sliding window. dtype: 0 = float32, 1 = bfloat16. Returns
// the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int KV, int S, int D,
                                      const long long* strides, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (D > kMaxD || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, KV, S, D, qs, ks, vs, os, scale, causal,
                         window, st);
  return launch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, D, qs, ks, vs, os, scale,
                               causal, window, st);
}
