// AQUA block-sparse prefill attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernel bodies of src/repro/kernels/aqua_prefill.py:
// _kernel (every key chunk) and, as the compile-time variant kPart,
// _part_kernel (only each q-tile's participating key chunks, hierarchical
// AQUA's prefill stage). Causal block attention in which every query of a
// q_blk chunk shares the chunk's NB_sel dim-blocks selected from its summed
// |q̂|. Keys at or past lengths[b] are masked; no sliding window.
//
// Chunk-resumable form (q_offset): the T query rows are sequence positions
// [q_offset, q_offset + T) attending the S keys [0, S), q_offset + T <= S.
// Selection tiles anchor at the first query row (block_idx and kc_part
// index chunk-local q_blk tiles), the causal bound of a row is its global
// position. A q_blk-aligned chunk walks exactly the key tiles the matching
// rows of the monolithic call walk, in the same order.
//
// Layout: q (B, H, T, D), k (B, KV, S, D), v (B, KV, S, Dv) addressed by
// element strides of their batch, head and sequence axes (the innermost
// dim must be contiguous), so the model's (B, S, KV, G, D) tensors are read
// in place without a transpose. out (B, H, T, Dv) is written the same way.
//
// Bound on the H100: operations at this size (S = 2048: ~S²/2 · H ·
// (NB_sel·bd + Dv) multiply-adds against ~S · KV · (D + Dv) bytes read).
// Design, simple first: one block of 128 threads per (b, h, QR query rows),
// QR in {8, 16, 32} dividing q_blk so the rows share one selection. The
// block walks 64-key tiles up to its causal bound (tiles past the last row
// or past lengths[b] are skipped, as the TPU kernel skips dead tiles), stages
// the tile's selected K̂ dims (k_ratio of the K̂ bytes) and its V rows in
// shared memory as float32, computes the QR x 64 scores with float32 FMAs
// on register tiles, runs the online softmax one row per thread and
// accumulates the QR x Dv output on register tiles. bd = 8 is below the
// tensor cores' MMA depth; they are later work. A lane with lengths[b] = 0
// writes zeros (don't-care rows).
//
// kPart: kc_part (B, NQC, KT) lists each q-tile's participating k_blk-key
// chunks, ascending (-1 = none). The block reads its own q-tile's list and
// walks each listed chunk as k_blk / 64 tiles (k_blk % 64 == 0); the
// masks use the logical key positions, so dropped chunks cost no bytes and
// the identity list walks exactly the tiles of the dense walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kKT = 64;          // keys per tile
constexpr int kMaxSel = 128;     // NB_sel * bd
constexpr int kMaxDv = kThreads;

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

__host__ __device__ constexpr int smem_floats(int qr, int nsel, int dv) {
  // Qs[qr][nsel+1] + Ks[KT][nsel+1] + Vs[KT][dv] + Ss[qr][KT+1] + M, L, C
  return qr * (nsel + 1) + kKT * (nsel + 1) + kKT * dv + qr * (kKT + 1) + 3 * qr;
}

struct Part {
  const int* kc_part;  // (B, NQC, KT) participating key chunks, or null
  int kt, k_blk;
};

template <typename T, int QR, bool kPart>
__global__ void __launch_bounds__(kThreads) aqua_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ block_idx, const int* __restrict__ lengths,
    T* __restrict__ out, int H, int KV, int Tq, int S, int q_offset, int Dv,
    int nb_sel, int bd, int q_blk, int nqc, Strides qst, Strides kst,
    Strides vst, Strides ost, float scale, int causal, Part part) {
  // Register tiles: each thread scores RM rows x 4 keys (16 key groups x 8
  // row groups) and accumulates RP rows x 4 output dims (32 dim groups x 4
  // row groups), so each shared-memory load feeds several FMAs.
  constexpr int RM = QR / 8;
  constexpr int RP = QR / 4;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int kv = h / (H / KV);
  const int row0 = tile * QR;
  const int nsel = nb_sel * bd;
  const int str = nsel + 1;        // odd row stride: conflict-free columns
  constexpr int sstr = kKT + 1;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + QR * str;
  float* Vs = Ks + kKT * str;
  float* Ss = Vs + kKT * Dv;
  float* M = Ss + QR * sstr;
  float* L = M + QR;
  float* C = L + QR;
  __shared__ int dim[kMaxSel];

  const int* idx = block_idx + (((int64_t)b * H + h) * nqc + row0 / q_blk) * nb_sel;
  for (int e = t; e < nsel; e += kThreads) dim[e] = idx[e / bd] * bd + e % bd;
  if (t < QR) {
    M[t] = kNegInf;
    L[t] = 0.f;
  }
  __syncthreads();

  const T* qb = q + b * qst.b + h * qst.h;
  for (int e = t; e < QR * nsel; e += kThreads) {
    const int r = e / nsel, c = e % nsel;
    Qs[r * str + c] = row0 + r < Tq ? to_f(qb[(row0 + r) * qst.s + dim[c]]) : 0.f;
  }

  const int len = lengths[b];
  int kend = min(len, S);
  if (causal) kend = min(kend, q_offset + row0 + QR);
  const T* kb = k + b * kst.b + kv * kst.h;
  const T* vb = v + b * vst.b + kv * vst.h;
  const int srg = t / 16, skg = t % 16;   // score tile: rows srg*RM.., keys skg+16j
  const int prg = t / 32, pdg = t % 32;   // value tile: rows prg*RP.., dims pdg+32j
  float acc[RP][4];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // the walk: every 64-key tile below kend, or (kPart) the tiles of this
  // q-tile's participating chunks below kend; the loop bounds and skips
  // are uniform over the block, so the barriers below are safe
  const int per_chunk = kPart ? part.k_blk / kKT : 1;
  const int* parts = kPart ? part.kc_part + ((int64_t)b * nqc + row0 / q_blk) * part.kt
                           : nullptr;
  const int n_iter = kPart ? part.kt * per_chunk : (kend + kKT - 1) / kKT;
  for (int it = 0; it < n_iter; ++it) {
    int k0 = it * kKT;
    if (kPart) {
      const int kc = parts[it / per_chunk];
      if (kc < 0) continue;
      k0 = kc * part.k_blk + (it % per_chunk) * kKT;
      if (k0 >= kend) continue;
    }
    for (int e = t; e < kKT * nsel; e += kThreads) {
      const int kk = e / nsel, c = e % nsel;
      const int pos = k0 + kk;
      Ks[kk * str + c] = pos < S ? to_f(kb[pos * kst.s + dim[c]]) : 0.f;
    }
    for (int e = t; e < kKT * Dv; e += kThreads) {
      const int kk = e / Dv, d = e % Dv;
      const int pos = k0 + kk;
      Vs[e] = pos < S ? to_f(vb[pos * vst.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < nsel; ++c) {
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
        const int qpos = q_offset + row0 + r, kpos = k0 + kk;
        const bool valid = kpos < len && (!causal || qpos >= kpos);
        Ss[r * sstr + kk] = valid ? sc[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    if (t < QR) {
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
        vv[j] = d < Dv ? Vs[kk * Dv + d] : 0.f;
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
    if (row0 + r >= Tq) continue;
    const float denom = fmaxf(L[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = pdg + 32 * j;
      if (d < Dv) ob[(row0 + r) * ost.s + d] = from_f<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int QR, bool kPart>
int launch(const void* q, const void* k, const void* v, const int* block_idx,
           const int* lengths, void* out, int B, int H, int KV, int Tq, int S,
           int q_offset, int Dv, int nb_sel, int bd, int q_blk, int nqc, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, int causal, Part part,
           cudaStream_t st) {
  const int bytes = smem_floats(QR, nb_sel * bd, Dv) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(aqua_prefill_kernel<T, QR, kPart>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + QR - 1) / QR, H, B);
  aqua_prefill_kernel<T, QR, kPart><<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, block_idx, lengths, (T*)out, H, KV, Tq, S,
      q_offset, Dv, nb_sel, bd, q_blk, nqc, qs, ks, vs, os, scale, causal, part);
  return (int)cudaGetLastError();
}

struct Args {
  const void *q, *k, *v;
  const int *block_idx, *lengths;
  void* out;
  int B, H, KV, Tq, S, q_offset, Dv, nb_sel, bd, q_blk, nqc;
  Strides qs, ks, vs, os;
  float scale;
  int causal;
  Part part;
  cudaStream_t st;
};

template <typename T, int QR>
int dispatch_part(const Args& a) {
  if (a.part.kc_part != nullptr)
    return launch<T, QR, true>(a.q, a.k, a.v, a.block_idx, a.lengths, a.out, a.B, a.H, a.KV,
                               a.Tq, a.S, a.q_offset, a.Dv, a.nb_sel, a.bd, a.q_blk, a.nqc,
                               a.qs, a.ks, a.vs, a.os, a.scale, a.causal, a.part, a.st);
  return launch<T, QR, false>(a.q, a.k, a.v, a.block_idx, a.lengths, a.out, a.B, a.H, a.KV,
                              a.Tq, a.S, a.q_offset, a.Dv, a.nb_sel, a.bd, a.q_blk, a.nqc,
                              a.qs, a.ks, a.vs, a.os, a.scale, a.causal, a.part, a.st);
}

template <typename T>
int dispatch_rows(int qr, const Args& a) {
  switch (qr) {
    case 32:
      return dispatch_part<T, 32>(a);
    case 16:
      return dispatch_part<T, 16>(a);
    case 8:
      return dispatch_part<T, 8>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements: {batch, head, seq} of q, k, v and out. Tq query
// rows at sequence offset q_offset attend S keys. qr is the number of query
// rows per block (8, 16 or 32, dividing q_blk). kc_part: null, or (B, nqc,
// kt) int32 participating key chunks of k_blk keys (k_blk % 64 == 0).
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int aqua_prefill_launch(const void* q, const void* k, const void* v,
                                   const void* block_idx, const void* lengths, void* out,
                                   int B, int H, int KV, int Tq, int S, int q_offset, int Dv,
                                   int nb_sel, int bd, int q_blk, int nqc, int qr,
                                   const long long* strides, float scale, int causal,
                                   const void* kc_part, int kt, int k_blk, int dtype,
                                   void* stream) {
  if (nb_sel * bd > kMaxSel || Dv > kMaxDv || H % KV != 0 || q_blk % qr != 0 ||
      q_offset < 0 || q_offset + Tq > S || (kc_part != nullptr && (k_blk <= 0 || k_blk % kKT != 0)))
    return (int)cudaErrorInvalidValue;
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
  a.part = Part{(const int*)kc_part, kt, k_blk};
  a.st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_rows<float>(qr, a);
  return dispatch_rows<__nv_bfloat16>(qr, a);
}
