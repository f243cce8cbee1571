// Dense flash attention (causal or not, optional sliding window, GQA) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel:
// out[b, h, i] = softmax_j(q[b, h, i] . k[b, kv, j] / sqrt(D)) v[b, kv, j]
// with kv = h / G, the causal mask j <= i, when window > 0 the
// sliding-window mask j > i - window, and when lengths is non-null the
// key mask j < lengths[b] (a bucket-padded admission: its pad rows i >=
// lengths[b] see every valid key, as JAX's dense reference with lengths
// computes them; an MoE routes those rows with the real ones; a lane of
// length 0 gets the mean of its V over all S keys in every row, as that
// reference and the plain version give: attn_tile::empty_lane). Online
// softmax in float32 with
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
// 2D multiply-adds against ~S · KV · 2D bytes of K and V).
//
// bf16 route (every full-size drive), on the tensor cores, with the
// warp-specialized engine of attn_tile.cuh: one block of 384 threads per
// 128 query rows, the same 64 rows of two heads of one KV group when the
// group size is even (a 64-row causal bound), else 128 rows of one head;
// two consumer warpgroups of 64 rows and a producer warpgroup. K and V
// 64-key tiles come by TMA from 4D tensor maps over the strided (B, KV, S,
// D) views (boxes of 64 dims x 64 keys, 128-byte swizzle, zeros past S and
// past D) into a four-stage mbarrier ring, so no consumer thread spends an
// instruction on a copy and no block barrier runs per tile. What bounds
// it on the card is the tensor-core time, ~1.5x the bound's operations
// (P·V runs twice, for P's hi and lo halves) and the softmax between the
// products: the consumers take turns on the tensor cores, so one
// warpgroup's softmax runs beside the other's products, and P·V of one
// tile beside the scores of the next. Q is staged once (cp.async) and
// read by the products from shared memory. Head dim 128 (every served
// model but Danube) takes a kernel with the depth and P·V width fixed at
// compile time (PERF.md, Findings). The block walks the tiles from its
// window's first tile to its causal bound; blocks are issued heaviest
// (last rows) first.
// D is padded with zeros to a multiple of 16 for Q·Kᵀ. bf16 needs D % 8 ==
// 0, 16-byte aligned bases and outer strides that are whole 16-byte units
// under 2^40 bytes (the wrapper checks).
//
// D above 128, up to 256 (RecurrentGemma-9B's 256 with AQUA off; 16 heads
// over one KV head, so two heads a block), runs on the same engine
// (flash_bf16_wide): a depth fixed at compile time (D padded with zeros to
// 192 or 256 dims), the output cut into 128-column slices, one a block,
// each block recomputing the scores of its rows (every slice computes the
// same P bit for bit), P·V on m64n128, three ring stages at depth 256
// (Q 64 KB and three of 32 KB of K and 16 KB of V fit in 227 KB; four do
// not). What bounds it: the tensor-core work, per (query, key) pair and
// head slices·D + 2·D multiply-adds (1,024 at D 256, 2.0x the bound's
// 512: the scores once per slice, P·V for P's hi and lo halves), with the
// copies and the softmax overlapped as at D <= 128. D <= 128 keeps the
// kernels above, from unchanged template arguments.
//
// float32 route (what a served HF checkpoint runs with AQUA off or with
// per-dim selection, the launcher's default block_dims 1: config_from_hf
// gives float32 params and activations), on the tensor cores with the
// engine of f32_tile.cuh: wgmma on TF32 with every product split into
// three passes, which hold the plain float32 version's 1e-5 limits that
// one TF32 pass misses by ~50x. What bounds it: the operations, each run
// as three TF32 products at 495 TFLOP/s, 165 TFLOP/s of float32 work
// (against 67 TFLOP/s of scalar float32). Each (row, key) score is
// computed once for every output column, D up to 256 (no value slices):
// D up to 128 in 128-row blocks over 32-key tiles (a grid of 1.5 waves
// or more; else 64-row blocks), D past 128 in 64-row blocks whose two
// warpgroups split the depth of the scores and the output columns, over
// 16-key tiles; two ring stages of K and V split into hi and lo once a
// block (16-byte cp.async copies when D is a multiple of 4 and the views
// 16-byte aligned, else 4-byte), the softmax in registers. D <= 256.

#include <algorithm>

#include "attn_tile.cuh"
#include "f32_tile.cuh"

namespace {

using attn_tile::bf16;
using attn_tile::Strides;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// One block of the bf16 route over a ring of STAGES stages: 128 query
// rows (of one or two heads, see below), value slice blockIdx.y (columns
// [128·y, 128·y + 128) of D), batch row blockIdx.z. NKS > 0 and KIND >= 0:
// the depth of Q·Kᵀ in k-steps and the P·V width (pv_tile) fixed at
// compile time; else taken from D at run time. kSlices: D may pass 128
// (the wide kernels); else the one slice is all of D and the code is the
// narrow kernels' own (a depth or box count folded to a constant, or a
// padding loop, moved their times by a few percent or cost the generic
// kernel its asynchronous products, ptxas C7511). kLen: lengths masks the
// keys, in instantiations of their own: with the key limit read at run
// time in every instantiation, the generic kernel took 0.171 ms at
// Danube's D 80 where it took 0.110 (chip_smoke.py's generic flash phase,
// PERF.md).
template <int NKS, int KIND, bool kLen, int STAGES, bool kSlices>
__device__ __forceinline__ void flash_block(const CUtensorMap& kmap, const CUtensorMap& vmap,
                                            const bf16* __restrict__ q,
                                            const bf16* __restrict__ v, bf16* __restrict__ out,
                                            const int* __restrict__ lengths, int H, int KV, int S,
                                            int D, Strides qst, Strides vst, Strides ost,
                                            float scale_log2, int causal, int window, int hpb) {
  using namespace attn_tile;
  // A block holds hpb heads of one KV group (2 when the group size is
  // even) x rpb = kRows / hpb rows each: a 64-row causal granularity with
  // 128 rows per key tile. Heaviest blocks first (the last rows walk the
  // most key tiles), head groups fastest: a causal grid's long blocks do
  // not start last.
  const int rpb = kRows / hpb, ng = H / hpb;
  const int h0 = blockIdx.x % ng * hpb, tile = gridDim.x / ng - 1 - blockIdx.x / ng;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int kv = h0 / (H / KV);
  const int row0 = tile * rpb;
  const int rlast = min(row0 + rpb, S) - 1;
  const int nd = D / 8;                         // 8-dim chunks
  // 16-dim steps of Q·Kᵀ (the wide kernels': their fixed depth)
  const int nks = kSlices ? NKS : (nd + 1) / 2, nck = 2 * nks;
  const int nkb = (nks + 3) / 4;                // 64-dim boxes of K
  // the value slice: columns [c0, c0 + dv) of V and out, in nvb 64-dim
  // boxes; a V stage holds vboxes (m64n128 reads two: a slice of one box
  // reads zeros in the second)
  const int c0 = kSlices ? kMaxDv * blockIdx.y : 0;
  const int dv = kSlices ? min(kMaxDv, D - c0) : D;
  const int nvb = (dv + 63) / 64, vboxes = kSlices ? 2 : nvb;

  // STAGES stages of K tiles (nkb boxes) and V tiles (vboxes boxes), Q
  // staged once (kRows x nck chunks, interleaved)
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = align1k(smem_raw);
  bf16* Vs = Ks + STAGES * nkb * kBox;
  bf16* Qs = Vs + STAGES * vboxes * kBox;
  __shared__ Ring<STAGES> ring;
  if (tid == 0) ring.init(1);
  // padding: zeros (the wide kernels pad D to their fixed depth, the
  // narrow ones one chunk at most)
  if (kSlices) {
    for (int c = nd; c < nck; ++c) zero_chunk(Qs, nck, c, kRows);
  } else if (nd & 1) {
    zero_chunk(Qs, nck, nd, kRows);
  }
  if (kSlices && nvb < vboxes) {                // the second V box of every stage: zeros
    for (int e = tid; e < STAGES * kBox / 8; e += kThreads)
      *reinterpret_cast<uint4*>(Vs + (e / (kBox / 8) * vboxes + 1) * kBox + e % (kBox / 8) * 8) =
          make_uint4(0, 0, 0, 0);
    fence_async_smem();
  }
  __syncthreads();

  // key tiles this block can see: [jbeg, jend), keys below klim
  const int klim = kLen ? max(0, min(lengths[b], S)) : S;
  // a lane of length 0: every row the mean of V over all S keys
  // (attn_tile::empty_lane; inlined in the generic kernel)
  if (kLen && klim == 0) {
    const bf16* vb = v + b * vst.b + kv * vst.h + c0;
    bf16* ob = out + b * ost.b + h0 * ost.h + row0 * ost.s + c0;
    float* scratch = reinterpret_cast<float*>(Ks);
    if (NKS > 0)
      empty_lane(vb, vst.s, S, dv, scratch, ob, ost.h, ost.s, hpb, rlast - row0 + 1);
    else
      empty_lane_inline(vb, vst.s, S, dv, scratch, ob, ost.h, ost.s, hpb, rlast - row0 + 1);
    return;
  }
  const int kend = kLen ? (causal ? min(klim, rlast + 1) : klim) : (causal ? rlast + 1 : S);
  const int jbeg = window > 0 ? max(0, row0 - window + 1) / kKeys : 0;
  const int jend = kLen ? max(jbeg, (kend + kKeys - 1) / kKeys) : (kend + kKeys - 1) / kKeys;
  auto next = [](int j) { return j + 1; };

  // the role of the thread's warpgroup, warp-uniform as the compiler sees
  // it (a shuffle from lane 0): only then does it give each side its own
  // register budget
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == kConsumers / 128) {
    producer_regs();
    if (tid == kConsumers)
      produce(jbeg, jend, next, ring, [&](int j, int st, uint32_t bar) {
        mbar_expect(bar, (nkb + nvb) * kBoxBytes);
        for (int x = 0; x < nkb; ++x)
          tma_load(Ks + (st * nkb + x) * kBox, &kmap, bar, 64 * x, j * kKeys, kv, b);
        for (int x = 0; x < nvb; ++x)
          tma_load(Vs + (st * vboxes + x) * kBox, &vmap, bar, c0 + 64 * x, j * kKeys, kv, b);
      });
  } else {
    consumer_regs();
    // Q (block row r: head h0 + r / rpb, sequence row row0 + r % rpb),
    // staged once by both consumer warpgroups
    const bf16* qb = q + b * qst.b + h0 * qst.h;
    for_chunks(kRows, nd, tid, kConsumers, [&](int r, int c) {
      const int row = row0 + r % rpb;
      const bool ok = row < S;
      const bf16* src = qb + r / rpb * qst.h + row * qst.s + c * 8;
      cp_async16(Qs + il(r, c, nck), ok ? src : qb, ok ? 16 : 0);
    });
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();                  // Q is read by wgmma
    bar_sync(kConsumerBar, kConsumers);

    const int warp = tid >> 5, g = (tid & 31) >> 2;
    const int h = h0 + warp * 16 / rpb;          // this warp's head and rows
    const int warp_first = row0 + warp * 16 % rpb;
    const int rows[2] = {warp_first + g, warp_first + g + 8};
    const int warp_last = min(warp_first + 15, rlast);
    // this warp's rows see keys past klim or the diagonal, or before some
    // row's window (a tile wholly masked for a row adds exactly nothing)
    auto masked = [&](int j) {
      const int k0 = j * kKeys;
      return k0 + kKeys > klim || (causal && k0 + kKeys - 1 > warp_first) ||
             (window > 0 && k0 <= warp_last - window);
    };
    auto valid = [&](int j, int r, int kk) {
      const int kp = j * kKeys + kk;
      return kp < klim && (!causal || rows[r] >= kp) && (window <= 0 || kp > rows[r] - window);
    };

    float o[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    consume<false, true, NKS, KIND>(jbeg, jend, next, masked, valid, ring, Qs, nks, Ks,
                                    nkb * kBox, Vs, vboxes * kBox, pv_kind(dv), scale_log2, o, m,
                                    l);
    store_rows(out + b * ost.b + h * ost.h + c0, ost.s, rows, S, dv / 8, o, l);
  }
}

// Head dims up to 128: the four-stage ring.
template <int NKS, int KIND, bool kLen>
__global__ void __launch_bounds__(attn_tile::kThreads, 1) flash_bf16(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const bf16* __restrict__ v, bf16* __restrict__ out,
    const int* __restrict__ lengths, int H, int KV, int S, int D, Strides qst, Strides vst,
    Strides ost, float scale_log2, int causal, int window, int hpb) {
  flash_block<NKS, KIND, kLen, attn_tile::kStages, false>(
      kmap, vmap, q, v, out, lengths, H, KV, S, D, qst, vst, ost, scale_log2, causal, window,
      hpb);
}

// Head dims past 128, up to 256 (RecurrentGemma-9B's 256 with AQUA off): a
// fixed depth of NKS k-steps (D padded with zeros to 192 or 256 dims), P·V
// on m64n128 per 128-column value slice, a ring of STAGES stages (four fit
// at NKS 12, three at 16).
template <int NKS, bool kLen, int STAGES>
__global__ void __launch_bounds__(attn_tile::kThreads, 1) flash_bf16_wide(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const bf16* __restrict__ v, bf16* __restrict__ out,
    const int* __restrict__ lengths, int H, int KV, int S, int D, Strides qst, Strides vst,
    Strides ost, float scale_log2, int causal, int window, int hpb) {
  flash_block<NKS, 2, kLen, STAGES, true>(kmap, vmap, q, v, out, lengths, H, KV, S, D, qst, vst,
                                          ost, scale_log2, causal, window, hpb);
}

// Launch `kernel` (an instantiation of flash_block with this NKS, KIND and
// STAGES): a grid of row blocks x head groups, value slices on y, batch
// rows on z. `done` is the kernel's record of its shared-memory limit.
template <int NKS, int KIND, int STAGES, class Kernel>
int launch_bf16(Kernel kernel, int (&done)[16], const void* q, const void* k, const void* v,
                void* out, const int* lengths, int B, int H, int KV, int S, int D, Strides qs,
                Strides ks, Strides vs, Strides os, float scale, int causal, int window,
                cudaStream_t st) {
  using namespace attn_tile;
  if (D % 8 != 0 || D > kMaxDepth) return (int)cudaErrorInvalidValue;
  const int nks = NKS > 0 ? NKS : (D / 8 + 1) / 2, nkb = (nks + 3) / 4;
  const int vboxes = KIND == 2 ? 2 : (std::min(D, kMaxDv) + 63) / 64;
  const int bytes = 1024 + (STAGES * (nkb + vboxes) * kBox + kRows * 2 * nks * 8) * 2;
  CUtensorMap kmap, vmap;
  cudaError_t err = make_map(&kmap, k, B, KV, S, D, ks);
  if (err == cudaSuccess) err = make_map(&vmap, v, B, KV, S, D, vs);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return (int)err;
  const int hpb = (H / KV) % 2 == 0 ? 2 : 1, rpb = kRows / hpb;
  const dim3 grid((S + rpb - 1) / rpb * (H / hpb), (D + kMaxDv - 1) / kMaxDv, B);
  kernel<<<grid, kThreads, bytes, st>>>(kmap, vmap, (const bf16*)q, (const bf16*)v, (bf16*)out,
                                        lengths, H, KV, S, D, qs, vs, os, scale * kLog2e, causal,
                                        window, hpb);
  return (int)cudaGetLastError();
}

template <int NKS, int KIND, bool kLen, class... Args>
int launch_narrow(Args... args) {
  static int done[16] = {0};
  return launch_bf16<NKS, KIND, attn_tile::kStages>(flash_bf16<NKS, KIND, kLen>, done, args...);
}

template <int NKS, bool kLen, int STAGES, class... Args>
int launch_wide(Args... args) {
  static int done[16] = {0};
  return launch_bf16<NKS, 2, STAGES>(flash_bf16_wide<NKS, kLen, STAGES>, done, args...);
}

// head_dim 128 (every served model but Danube and RecurrentGemma) takes a
// kernel with its depth and width fixed at compile time, other head dims
// up to 128 the generic one; past 128 every head dim takes a fixed depth
// (192 or 256 dims, zeros past D), as the prefill's wide kernels do.
template <bool kLen, class... Args>
int launch_shape(int D, Args... args) {
  if (D > attn_tile::kNarrowDepth)
    return D <= 192 ? launch_wide<12, kLen, attn_tile::kStages>(args...)
                    : launch_wide<16, kLen, 3>(args...);
  return D == 128 ? launch_narrow<8, 2, kLen>(args...) : launch_narrow<0, -1, kLen>(args...);
}

// ---------------------------------------------------------------------------
// float32: tensor cores, three TF32 passes (f32_tile.cuh)
// ---------------------------------------------------------------------------

template <int VEC, int NK, int NV, bool kWide>
__global__ void __launch_bounds__(f32_tile::kThreads, 1)
    flash_f32(const __grid_constant__ f32_tile::Problem p) {
  f32_tile::attend<VEC, false, NK, NV, kWide>(p);
}

template <int VEC, int NK, int NV, bool kWide>
int launch_f32(const f32_tile::Problem& p, int B, cudaStream_t st) {
  static int done[16] = {0};
  const int bytes = f32_tile::smem_bytes(p);
  cudaError_t err = attn_tile::allow_smem(flash_f32<VEC, NK, NV, kWide>, bytes, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tq + p.rows - 1) / p.rows * p.H, 1, B);
  flash_f32<VEC, NK, NV, kWide><<<grid, f32_tile::kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

// the form, key tile and column share that plan chose (as the prefill's
// launch_f32_tile; D is Dv: past 128 the wide form at 16 keys)
template <int VEC>
int launch_f32_tile(const f32_tile::Problem& p, int B, cudaStream_t st) {
  if (p.rows != f32_tile::kRows)
    return p.nv == 128 ? launch_f32<VEC, 32, 128, false>(p, B, st)
                       : launch_f32<VEC, 32, 64, false>(p, B, st);
  return p.nv == 128 ? launch_f32<VEC, 16, 128, true>(p, B, st)
                     : launch_f32<VEC, 32, 64, true>(p, B, st);
}

// vec: floats per copy, 4 (16-byte copies: the wrapper found the bases
// and outer strides 16-byte aligned) or 1
int dispatch_f32(const void* q, const void* k, const void* v, void* out, const int* lengths,
                 int B, int H, int KV, int S, int D, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, int causal, int window, int vec, cudaStream_t st) {
  if (vec == 4 && D % 4 != 0) vec = 0;
  f32_tile::Problem p{};
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.out = (float*)out;
  p.lengths = lengths;
  p.H = H;
  p.KV = KV;
  p.Tq = p.S = S;
  p.D = p.Dv = D;
  p.q_blk = f32_tile::kRows;
  p.nqc = 1;
  p.qs = qs;
  p.ks = ks;
  p.vs = vs;
  p.os = os;
  p.scale_log2 = scale * f32_tile::kLog2e;
  p.causal = causal;
  p.window = window;
  if ((vec != 1 && vec != 4) || !f32_tile::plan(p, vec, B)) return (int)cudaErrorInvalidValue;
  return vec == 1 ? launch_f32_tile<1>(p, B, st) : launch_f32_tile<4>(p, B, st);
}

}  // namespace

// Strides are in elements: {batch, head, seq} of q, k, v and out. window
// <= 0 means no sliding window; lengths (B,) valid keys per row, or null
// (every key below S). dtype: 0 = float32, 1 = bfloat16. vec is
// the float32 route's copy width in floats: 4 (16-byte copies; the caller
// found every base and outer stride 16-byte aligned) or 1. Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, const void* lengths, int B, int H, int KV,
                                      int S, int D,
                                      const long long* strides, float scale, int causal,
                                      int window, int dtype, int vec, void* stream) {
  if (H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t st = (cudaStream_t)stream;
  const int* ln = (const int*)lengths;
  if (dtype == 0)
    return dispatch_f32(q, k, v, out, ln, B, H, KV, S, D, qs, ks, vs, os, scale, causal, window,
                        vec, st);
  if (ln)
    return launch_shape<true>(D, q, k, v, out, ln, B, H, KV, S, D, qs, ks, vs, os, scale, causal,
                              window, st);
  return launch_shape<false>(D, q, k, v, out, ln, B, H, KV, S, D, qs, ks, vs, os, scale, causal,
                             window, st);
}
