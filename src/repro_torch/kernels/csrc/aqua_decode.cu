// AQUA block-sparse decode attention for Hopper (sm_90a).
//
// Replaces five Pallas TPU kernel bodies of src/repro/kernels/aqua_decode.py:
// _kernel (contiguous cache), _paged_kernel (page pool), _paged_quant_kernel
// (int8 pool, scale-folded) and _paged_part_kernel / _paged_part_quant_kernel
// (only the participating pages of hierarchical AQUA, full precision and
// int8). For each (lane b, query head h): the partial score q̂·K̂ over only
// the NB_sel dim-blocks that |q̂| selected, times scale, masked at positions
// >= lengths[b], then an online softmax in float32 and the product with V.
// A lane with no valid position (lengths[b] = 0: an idle lane of the decode
// step) writes what the Pallas kernel writes there, the mean of the V slots
// it visits: every slot of each page its table row maps, an unmapped entry
// read as page 0 (of the participating pages only; dequantized for int8
// pools). An MoE model routes idle lanes with the live ones, so their
// values decide which live tokens' experts are full; the combine pass
// computes this mean for such lanes alone.
//
// Layout: K̂ and V are read in the cache's own seq-major layout,
// k (P, KV, ps, D) and v (P, KV, ps, Dv). A contiguous cache (B, KV, S, D)
// is the same with P = B, ps = S and no page table (page = b). A position
// pos of lane b lives in page max(page_table[b, pos / ps], 0) at offset
// pos % ps. Heads are laid out (KV, G): kv = h / G.
//
// Bound on the H100: bytes. Per step the kernel must read, per lane and KV
// head, the union of its G heads' selected dim-blocks of every valid K̂ row
// plus every valid V row (of the participating pages only; one byte per
// element for int8 pools). Decode does ~2 operations per byte, far below
// the ~295 at which the card's arithmetic would bound it.
//
// Every route splits the sequence: a partial pass writes, per (b, h, split
// of `split` positions), its running (max, sum, acc[Dv]) in float32 to
// scratch (B, H, nsplit, Dv + 2), and a combine pass merges the splits of
// each (b, h) with the same online-softmax algebra. Splits at or past
// lengths[b] exit at once (when every page is walked). The launches hold no
// host sync and allocate nothing, so a CUDA graph can capture them.
//
// Group route (namespace gqa; bf16 q̂: _kernel, _paged_kernel, and as
// compile-time variants _paged_quant_kernel (kQuant), _paged_part_kernel
// (kPart) and _paged_part_quant_kernel (both)): one block of 4 warps per
// (split, KV head, lane) holds all G
// query heads of the group (up to 8; a larger group takes several blocks),
// so each K̂ piece and V row leaves device memory once per group, not G
// times. Each warp walks its own 16-position tiles of the split (tile j of
// warp j mod 4) through a private ring of two stages, so no block barrier
// runs per tile:
//
// - Copies: the TMA, completing on the stage's mbarrier; the lines go first
//   when L2 evicts (read once). bf16: one bulk copy per V row and one per
//   run of the K̂ row's staged chunks, the union of the group's selected
//   8-dim chunks with one-chunk holes filled (such a hole shares its 32-byte
//   sector with a union chunk: no extra device traffic, fewer copies). Rows
//   without a token are not copied. (16-byte cp.async copies stall each warp
//   for thousands of cycles at issue here: PERF.md, Findings.)
// - Scores and P·V on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate), positions x heads as M x N: S = K̂·q̂ᵀ with the K̂ tile as A
//   (ldmatrix) and q̂ as B in registers, each head's q̂ zero in the staged
//   dims it did not select (so block sizes 2 and 4, where a chunk holds
//   several blocks, and 16, 32, ..., where a block spans chunks, score
//   exactly the head's own blocks); O = Vᵀ·P with Vᵀ from ldmatrix.trans and
//   P transposed in registers (movmatrix), split into bf16 hi + lo (P
//   rounded once to bf16 misses the one-ulp limit). Decode does ~2
//   operations per byte, yet on FMAs it is bound by instruction issue
//   (a convert, G FMAs and shared-memory loads per element: PERF.md,
//   Findings); the tensor cores need several-fold fewer instructions.
// - The online softmax in registers, in the log2 domain (scale·log2 e
//   folded into the score): tile max per head by three shuffles, the sum
//   kept per lane and reduced once.
// - Set-up without barriers per warp: the length, the heads' selections and
//   the first tiles' pages go out together; the union is a warp OR-reduce;
//   the q̂ rows arrive by bulk copy with the first tiles.
// Every warp keeps its own running (max, sum, acc); at the end the block
// merges its four warps (one barrier) into the split's scratch entry.
//
// kQuant, the group route over int8 pools. An 8-dim int8 chunk is a
// quarter of a 32-byte sector, and at k_ratio 0.75 the group's union
// touches nearly every sector of a K̂ row, so staging the union would save
// almost no bytes: each row with a token is copied whole (one bulk copy of
// D bytes for K̂, one of Dv for V; D and Dv multiples of 16), into rows
// padded to an odd number of 16-byte units, where ldmatrix's eight rows fall
// on distinct banks. It reads 1.00-1.04x the bound's bytes at k_ratio 0.75
// (PERF.md). The int8 rows are converted exactly to bf16 in registers
// (|x| <= 128 is exact in bf16: a byte_perm into an f32 and one subtraction
// per element), so the mma and the result are the bf16 route's: ldmatrix
// reads a row as byte pairs, so a lane holds dims 4t..4t + 3 of a 16-dim
// chunk, and q̂'s B operand takes its dims in that order (the dot product
// is order-free); ldmatrix.trans hands a lane two dims of two positions of
// V, so output row g of a 16-dim slice is its dim 2g and row g + 8 its dim
// 2g + 1. (A first design converted each landed tile to bf16 in shared
// memory: the extra shared-memory round trip took a third of its time,
// PERF.md.) q̂ stays bf16 (quantizing it for an s8 mma would change the
// result). Each row's scales are looked up through its page when its copy
// is issued, so pages of 8 positions (a tile across two pages) and
// per-(page, kv head) scales take the same lookup.
//
// kPart, the group route's participating walk: rows without a token are not
// copied and get weight 0 explicitly (a tile may hold none, so its max may
// stay NEG_INF); a tile with none adds nothing; a split with none writes
// (NEG_INF, 0, 0) (its threads test the split's 256 positions at the
// block's one barrier). kQuant and kPart are independent template flags.
//
// float32 group route (namespace gqa32; float32 q̂ at full precision over
// every page: _kernel and _paged_kernel as every served HF checkpoint runs
// them; D and Dv multiples of 4, D <= 256): the group route's blocks, one
// of 4 warps per (split, KV head, lane) for up to 8 heads, each warp walking
// its own 8-position tiles (tile j of warp j mod 4) through a private ring
// of two stages, and the same scratch and combine pass. What differs:
// - Copies: whole rows. A tile lies in one page (pages of a multiple of 8
//   positions, or the contiguous cache), so its 8 K̂ rows are consecutive in
//   device memory: one bulk copy for them and one for its V rows, where
//   staging the union of 4-dim chunks took ~4 copies a row, and one SM's
//   copies, not device memory, set the served form's time (on the H100 the
//   union took 0.0293 ms where whole tiles take 0.0233, PERF.md). At G >= 2
//   and k_ratio 0.75 the union is ~94-100% of the row, so whole rows add
//   little traffic. Tiles across pages copy row by row.
// - Scores and P·V exactly in float32 on FFMA: ~2-4 FMAs per 4-byte element
//   read, so arithmetic does not bind it (the tensor cores would need the
//   three-TF32-pass split to hold the float32 limit). Lane (r, part) sums
//   row r over the chunks part, part + 4, ... of the row, each rotated by r
//   (a quarter warp's 16-byte loads from 8 rows fall on distinct banks),
//   with q̂ of each head zero in the dims it did not select (so the whole
//   row scores exactly the head's own blocks); the parts meet by shuffles.
//   P goes through shared memory ([row][head], read as broadcast vectors);
//   a lane owns 4 output dims (8 past Dv 128) of every head.
// - The heads' q̂ rows and selections go out first; the masked q̂ is staged
//   before the block's one barrier; the online softmax runs in registers
//   in the log2 domain and the block merges its warps at the end.
// kG (heads a block holds, rounded up to 1, 2, 4 or 8) and kWide (D or Dv
// past 128) are compile-time.
//
// Per-head route (float32 q̂ with int8 pools or participating pages, or at
// widths the float32 group route does not take; and the bf16 int8 and
// participating widths the group route does not take): one block of 128
// threads per (split of 256 positions, h, b); each thread scores one
// position of a 128-position tile from the selected blocks only (scalar
// loads), the block reduces the tile's max and sum, and each thread
// accumulates one or two output dims over the tile's V rows. The
// participating walk and int8 are compile-time variants, so the
// full-precision walk pays nothing for them.
//
// int8 pools (both routes): k and v hold int8 and k_scale / v_scale (P, SH)
// float32, one scale per page (SH = 1) or per page and kv head (SH = KV,
// s_stride = 1). The key scale folds into the score (dot · scale ·
// k_scale[page]), the value scale into the row's weight in P·V (p ·
// v_scale[page], not in the sum), so no page is dequantized. A split spans
// several pages: the scales are looked up per position, through that
// position's page. The output is float32, as the Pallas call emits it.
//
// Participating pages (both routes; part_idx (B, KP), logical page ids):
// the walk covers KP·ps virtual positions; virtual position vp maps to
// logical position part_idx[b, vp / ps]·ps + vp % ps, valid iff below
// lengths[b]. Validity is tested per position (the tail page is partial, a
// lane with fewer pages than KP walks pages past its tail), and every one
// of the KP·ps / split splits is written and merged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tile.cuh"

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

// Per-head route. Partial pass: one block per (split, h, b). Scratch
// layout per (b, h, split): [m, l, acc[0..Dv)] in float32, m in natural
// units (the max of dot·scale). kPart walks participating pages;
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

// The slots a lane with no valid position averages (the Pallas kernel's
// walk): v (P, KV, ps, Dv) of vtype 0 float32, 1 bf16 or 2 int8 (with its
// value scales vs (P, sh)); every page of the table row (page = b for a
// contiguous cache), or the participating ones.
struct Visited {
  const void* v;
  const int* table;    // (B, np) or null
  const int* part;     // (B, kp) or null
  const float* vs;     // (P, sh) or null
  int vtype, KV, ps, np, kp, sh, s_stride;
};

// A page's sums over its ps V rows of dims t and t + kThreads, eight rows
// in flight (independent sums, added pairwise at the end)
template <typename T>
__device__ __forceinline__ void page_sums(const T* __restrict__ v, int ps, int Dv, int t,
                                          float& p0, float& p1) {
  constexpr int kU = 8;
  float a[kU], c[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) a[u] = c[u] = 0.f;
  const bool on0 = t < Dv, on1 = t + kThreads < Dv;
  int r = 0;
  for (; r + kU <= ps; r += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (on0) a[u] += to_f(v[(int64_t)(r + u) * Dv + t]);
      if (on1) c[u] += to_f(v[(int64_t)(r + u) * Dv + t + kThreads]);
    }
  }
  for (; r < ps; ++r) {
    if (on0) a[0] += to_f(v[(int64_t)r * Dv + t]);
    if (on1) c[0] += to_f(v[(int64_t)r * Dv + t + kThreads]);
  }
#pragma unroll
  for (int w = kU / 2; w > 0; w /= 2)
#pragma unroll
    for (int u = 0; u < w; ++u) {
      a[u] += a[u + w];
      c[u] += c[u + w];
    }
  p0 = a[0];
  p1 = c[0];
}

// Combine pass (every route): one block per (h, b) merges the splits the
// partial pass wrote: those below lengths[b], or all of them over
// participating pages. A lane with lengths[b] = 0 takes the mean of its
// visited V slots instead (see the header).
template <typename OT>
__global__ void __launch_bounds__(kThreads) aqua_decode_combine(
    const float* __restrict__ scratch, const int* __restrict__ lengths,
    OT* __restrict__ out, int H, int Dv, int nsplit, int walk_all, const Visited e) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  if (lengths[b] <= 0) {
    // Rows of whole 16-byte units (bf16: Dv % 8 == 0, float32: Dv % 4 ==
    // 0; an aligned base): 16-byte loads, tpr threads a row and rpi rows
    // at a time; else (int8, other widths) two dims a thread. A page repeated in the walk
    // (every unmapped entry is page 0) is read once.
    __shared__ float red[8 * kThreads];
    const int kv = h / (H / e.KV);
    const int npg = e.part ? e.kp : e.table ? e.np : 1;
    const int epv = e.vtype == 1 ? 8 : 4;   // elements a 16-byte load
    const bool vec = e.vtype != 2 && Dv % epv == 0 &&
                     (reinterpret_cast<uintptr_t>(e.v) & 15) == 0;
    const int tpr = vec ? Dv / epv : 1, rpi = vec ? kThreads / tpr : 1;
    const int row = t / tpr, c = t % tpr;
    float sum[8], pg[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sum[k] = pg[k] = 0.f;
    int prev = -1;
    for (int i = 0; i < npg; ++i) {
      const int lp = e.part ? min(max(e.part[(int64_t)b * e.kp + i], 0), e.np - 1) : i;
      const int page = e.table ? max(e.table[(int64_t)b * e.np + lp], 0) : b;
      const float f = e.vs ? e.vs[(int64_t)page * e.sh + (e.s_stride ? kv : 0)] : 1.f;
      const int64_t base = ((int64_t)page * e.KV + kv) * e.ps * Dv;
      if (page != prev) {
        prev = page;
        if (vec) {
#pragma unroll
          for (int k = 0; k < 8; ++k) pg[k] = 0.f;
          if (row < rpi && e.vtype == 1) {
            const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(e.v) + base + c * 8;
#pragma unroll 4
            for (int r = row; r < e.ps; r += rpi) {
              const uint4 w = *reinterpret_cast<const uint4*>(vb + (int64_t)r * Dv);
              const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float2 y = __bfloat1622float2(x[k]);
                pg[2 * k] += y.x;
                pg[2 * k + 1] += y.y;
              }
            }
          } else if (row < rpi) {
            const float* vf = static_cast<const float*>(e.v) + base + c * 4;
#pragma unroll 4
            for (int r = row; r < e.ps; r += rpi) {
              const float4 w = *reinterpret_cast<const float4*>(vf + (int64_t)r * Dv);
              pg[0] += w.x;
              pg[1] += w.y;
              pg[2] += w.z;
              pg[3] += w.w;
            }
          }
        } else if (e.vtype == 0) {
          page_sums(static_cast<const float*>(e.v) + base, e.ps, Dv, t, pg[0], pg[1]);
        } else if (e.vtype == 1) {
          page_sums(static_cast<const __nv_bfloat16*>(e.v) + base, e.ps, Dv, t, pg[0], pg[1]);
        } else {
          page_sums(static_cast<const int8_t*>(e.v) + base, e.ps, Dv, t, pg[0], pg[1]);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) sum[k] += pg[k] * f;
    }
    const float n = (float)npg * e.ps;
    OT* o = out + ((int64_t)b * H + h) * Dv;
    if (vec) {
      if (row < rpi) {
        for (int k = 0; k < epv; ++k) red[row * Dv + c * epv + k] = sum[k];
      }
      __syncthreads();
      for (int d = t; d < Dv; d += kThreads) {
        float acc = 0.f;
        for (int r = 0; r < rpi; ++r) acc += red[r * Dv + d];
        o[d] = from_f<OT>(acc / n);
      }
    } else {
      if (t < Dv) o[t] = from_f<OT>(sum[0] / n);
      if (t + kThreads < Dv) o[t + kThreads] = from_f<OT>(sum[1] / n);
    }
    return;
  }
  const int n = walk_all ? nsplit : min((lengths[b] + kSplit - 1) / kSplit, nsplit);
  const int st = Dv + 2;
  const float* sc = scratch + ((int64_t)b * H + h) * nsplit * st;
  // Every thread reads every split's max and sum (broadcasts) and its own
  // dims' sums: the first kR splits in one round trip into registers (every
  // load in range, used only below n), the rest after. The max is exact in
  // any order; the sums run in split order.
  constexpr int kR = 16;
  const int d0 = 2 + min(t, Dv - 1), d1 = 2 + min(t + kThreads, Dv - 1);
  float mi[kR], li[kR], ai0[kR], ai1[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const float* si = sc + (int64_t)min(i, max(n - 1, 0)) * st;
    mi[i] = si[0];
    li[i] = si[1];
    ai0[i] = si[d0];
    ai1[i] = Dv > kThreads ? si[d1] : 0.f;
  }
  float m = kNegInf;
#pragma unroll
  for (int i = 0; i < kR; ++i)
    if (i < n) m = fmaxf(m, mi[i]);
#pragma unroll 8
  for (int i = kR; i < n; ++i) m = fmaxf(m, sc[(int64_t)i * st]);
  float l = 0.f, acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (i < n) {
      const float w = expf(mi[i] - m);
      l += w * li[i];
      acc0 += w * ai0[i];
      acc1 += w * ai1[i];
    }
  }
#pragma unroll 8
  for (int i = kR; i < n; ++i) {
    const float* si = sc + (int64_t)i * st;
    const float w = expf(si[0] - m);
    l += w * si[1];
    acc0 += w * si[d0];
    if (Dv > kThreads) acc1 += w * si[d1];
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
  else if constexpr (!std::is_same<KT, __nv_bfloat16>::value)  // bf16: the group route
    aqua_decode_partial<QT, KT, false><<<dim3(nsplit, H, B), kThreads, 0, st>>>(
        (const QT*)q, (const KT*)k, (const KT*)v, bi, pg, ln, scratch, H, KV, D, Dv,
        nb_sel, bd, nsplit, scale);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Visited e{v, pg.table, pg.part, pg.vs,
                  std::is_same<KT, float>::value ? 0 : std::is_same<KT, int8_t>::value ? 2 : 1,
                  KV, pg.ps, pg.np_lane, pg.kp, pg.sh, pg.s_stride};
  aqua_decode_combine<OT><<<dim3(H, B), kThreads, 0, st>>>(
      scratch, ln, (OT*)out, H, Dv, nsplit, pg.part != nullptr, e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Group route: one block per (split, KV head, lane) for all heads of the group
// ---------------------------------------------------------------------------

namespace gqa {

using bf16 = __nv_bfloat16;
using attn_tile::fast_exp2;
using attn_tile::ldsm_x4;
using attn_tile::smem_u32;
using attn_tile::split_pair;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;         // positions per warp tile: the m of the score mma
constexpr int kStages = 2;        // warp tiles in flight per warp
constexpr int kHeads = 8;         // query heads per block: the n of both mmas
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kStages * kRows == 32, "a warp's first tiles give each lane one row");
static_assert(2 * kWarps * kStages * kRows == kSplit, "two rows per thread cover a split");

struct Args {
  const bf16* q;
  const void* k;        // (P, KV, ps, D): bf16, or int8 (kQuant)
  const void* v;        // (P, KV, ps, Dv): the same type
  const int* block_idx;
  const int* table;     // (B, np_lane) or null: contiguous cache (page = b, ps = S)
  const int* part;      // (B, kp) participating logical pages (kPart)
  const float* ks;      // (P, sh) key scales (kQuant)
  const float* vs;      // (P, sh) value scales (kQuant)
  const int* lengths;
  float* scratch;       // (B, H, nsplit, Dv + 2)
  int H, KV, D, Dv, nb_sel, bd, ps, np_lane, kp, sh, s_stride;
  int nhg;              // blocks per KV head (groups of more than 8 heads)
  int nsplit;
  int kwa;              // staged K̂ row in 16-byte chunks: D / 8 rounded up to even
  float scale_log2;     // scale · log2 e
};

// An int8 row of n bytes (n % 16 == 0) in shared memory: padded to an odd
// number of 16-byte units, so ldmatrix's eight rows fall on distinct banks
__host__ __device__ inline int i8_stride(int n) { return 16 * ((n / 16 + 1) | 1); }
// Shared memory per warp, in bytes: kStages stages of kRows K̂ rows then kRows
// V rows, filled by the TMA in the padded layouts the tensor cores read
// (bf16: K̂ over the staged chunks; int8: whole rows)
__host__ __device__ inline int stage_bytes(bool quant, int kwa, int D, int Dv) {
  return quant ? kRows * (i8_stride(D) + i8_stride(Dv)) : kRows * (kwa * 8 + 8 + Dv + 8) * 2;
}
__host__ __device__ inline int warp_bytes(bool quant, int kwa, int D, int Dv) {
  return kStages * stage_bytes(quant, kwa, D, Dv);
}

// bits [lo, hi) of a word, 0 <= lo < hi <= 32
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  return (hi == 32 ? ~0u : (1u << hi) - 1) & ~((1u << lo) - 1);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16x8, f32) += a (16x16, bf16, row) · b (16x8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// TMA bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on the mbarrier at `bar`; its lines go first when L2 evicts
// (K̂ and V are read once; the splits' scratch stays for the combine pass)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
}

// the transposed 8x8 bf16 fragment (row g, cols 2t, 2t + 1 -> the same of
// the transpose)
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// bits [lo, hi) of word w of a bit set given as the range [d0, d1)
__device__ __forceinline__ uint32_t range_word(int d0, int d1, int w) {
  const int lo = min(max(d0 - 32 * w, 0), 32), hi = min(max(d1 - 32 * w, 0), 32);
  return lo < hi ? bit_range(lo, hi) : 0u;
}

// Two bytes of w (already biased: each byte x + 128) into a bf16 pair, exactly:
// under the exponent of 2^23 the byte reads as the f32 2^23 + x + 128, less
// 2^23 + 128 that is x, and as |x| <= 128 needs 8 significant bits its bf16 is
// the f32's upper half. s0 / s1 are byte_perm selectors of the two bytes (the
// first in the low half).
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w, uint32_t s0, uint32_t s1) {
  const float x0 = __uint_as_float(__byte_perm(w, 0x4B000000u, s0)) - 8388736.f;
  const float x1 = __uint_as_float(__byte_perm(w, 0x4B000000u, s1)) - 8388736.f;
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}
// The block's merge of its warps' running (m, l, acc[Dv]) per head, warp w's
// at wb + w·wstride as [head][Dv + 2] floats with m in log2 units, into the
// split's scratch entries of its ng heads (out: head 0's entry; heads
// head_stride floats apart), m in natural units. Follows a block barrier.
__device__ __forceinline__ void merge_warps(const float* wb, int wstride, int ng, int Dv,
                                            float* out, int64_t head_stride) {
  const int wst = Dv + 2;
  for (int e = threadIdx.x; e < ng * wst; e += kThreads) {
    const int hh = e / wst, i = e - hh * wst;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wb[w * wstride + hh * wst]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* r = wb + w * wstride + hh * wst;
      sum += fast_exp2(r[0] - mb) * r[i];
    }
    out[hh * head_stride + i] = i == 0 ? mb * kLn2 : sum;
  }
}

// kKS: most 16-dim k-steps of the union (8: D <= 128); kMT: most 16-wide
// slices of the output (8: Dv <= 128). kQuant: int8 K̂/V with per-page
// scales, float32 output; kPart: the walk over the participating pages.
// Fragment coordinates g = lane / 4, t = lane % 4: scores hold (positions
// g, g + 8) x (heads 2t, 2t + 1), the output (dims g, g + 8 of each slice)
// x (heads 2t, 2t + 1), and q̂'s B operand head g.
template <int kKS, int kMT, bool kQuant, bool kPart>
__global__ void __launch_bounds__(kThreads) decode_bf16(const Args a) {
  constexpr int kWords = kKS / 2;  // 32-dim words of a head's selected dims
  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / a.nhg, hg = blockIdx.y - kv * a.nhg;
  const int G = a.H / a.KV;
  const int h0 = kv * G + hg * kHeads, ng = min(kHeads, G - hg * kHeads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int D = a.D, Dv = a.Dv, vw = Dv / 8, nmt = (Dv + 15) / 16;
  const int kst = a.kwa * 8 + 8, vst = Dv + 8;  // row strides (+16 bytes: ldmatrix rows
                                                // fall on distinct banks)
  const int begin = split * kSplit;
  const int cap = a.table ? a.ps * a.np_lane : a.ps;  // positions the view holds
  // positions walked: every position of the view, or the kp participating
  // pages' (virtual position vp: page part[b, vp / ps], offset vp % ps)
  const int vcap = kPart ? a.kp * a.ps : cap;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stage_b = stage_bytes(kQuant, a.kwa, D, Dv);
  const int warp_b = warp_bytes(kQuant, a.kwa, D, Dv);
  unsigned char* wbase = smem_raw + warp * warp_b;
  const int rsk = i8_stride(D), rsv = i8_stride(Dv);  // int8 row strides in bytes
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw + kWarps * warp_b);  // the heads' q̂ rows
  __shared__ int uc_s[kWarps][32];            // per warp: K̂ position -> 8-dim chunk
  __shared__ uint64_t bar_s[kWarps][kStages];  // per warp and stage: copies landed
  __shared__ uint64_t q_bar;                   // q̂ rows landed

  // Reads that depend on nothing go out together: the length, head g's
  // selected blocks (lane t: entries t, t + 4, ...), and the page of this
  // lane's row of the warp's first tiles (lane 16 s + r: row r of tile s),
  // through its participating page (kPart: also the participating page of
  // the row 128 positions on, for the split's validity test and the
  // stage's next tile).
  const int raw_len = a.lengths[b];
  const int my_tile = warp + (lane >> 4) * kWarps;
  const int my_pos = begin + my_tile * kRows + (lane & 15);
  int my_page = b, my_lp = 0, my_lp2 = 0;
  if constexpr (kPart) {
    if (my_pos < vcap) my_lp = a.part[(int64_t)b * a.kp + my_pos / a.ps];
    if (my_pos + kSplit / 2 < vcap)
      my_lp2 = a.part[(int64_t)b * a.kp + (my_pos + kSplit / 2) / a.ps];
    my_page = max(a.table[(int64_t)b * a.np_lane + my_lp], 0);
  } else if (a.table && my_pos < cap) {
    my_page = max(a.table[(int64_t)b * a.np_lane + my_pos / a.ps], 0);
  }
  uint32_t dm[kWords];  // head g's selected dims
#pragma unroll
  for (int w = 0; w < kWords; ++w) dm[w] = 0;
  if (g < ng) {
    const int* idx = a.block_idx + ((int64_t)b * a.H + h0 + g) * a.nb_sel;
#pragma unroll 4
    for (int j = t; j < a.nb_sel; j += 4) {
      const int d0 = idx[j] * a.bd;
#pragma unroll
      for (int w = 0; w < kWords; ++w) dm[w] |= range_word(d0, d0 + a.bd, w);
    }
  }
  if (lane < kStages) mbar_init(smem_u32(&bar_s[warp][lane]));
  if (tid == 0) mbar_init(smem_u32(&q_bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const int len = min(raw_len, cap);
  // a position of the walk holds a token iff it lies below end and (kPart)
  // its logical position below len
  auto part_valid = [&](int vp, int lp, int end) {
    return vp < end && lp * a.ps + (vp - vp / a.ps * a.ps) < len;
  };
  // the only block barrier before the merge: barriers initialized, and
  // (kPart) whether any position of the split holds a token
  if constexpr (kPart) {
    const int vend = min(vcap, begin + kSplit);
    const bool any = part_valid(my_pos, my_lp, vend) ||
                     part_valid(my_pos + kSplit / 2, my_lp2, vend);
    if (!__syncthreads_or(any)) {
      // an empty entry for the combine pass, which merges every split
      const int wst = Dv + 2;
      for (int e = tid; e < ng * wst; e += kThreads) {
        const int hh = e / wst, i = e - hh * wst;
        a.scratch[(((int64_t)b * a.H + h0 + hh) * a.nsplit + split) * wst + i] =
            i == 0 ? kNegInf : 0.f;
      }
      return;
    }
  } else {
    __syncthreads();
    if (begin >= len) return;  // the combine pass reads only splits below len
  }
  const int end = min(kPart ? vcap : len, begin + kSplit);
  const int ntile = (end - begin + kRows - 1) / kRows;
  const uint64_t once = evict_first_policy();
  if (warp == 0) {  // the q̂ rows, one bulk copy per head
    if (lane == 0) mbar_expect(smem_u32(&q_bar), ng * D * 2);
    if (lane < ng)
      bulk_copy(qsm + lane * D, a.q + ((int64_t)b * a.H + h0 + lane) * D, D * 2,
                smem_u32(&q_bar), once);
  }

  // Head g's dims over its four lanes; the union of 8-dim chunks over the
  // warp. K̂ rows are staged over the union with its one-chunk holes filled
  // (the hole shares a 32-byte sector with a union chunk, so it costs no
  // device memory traffic, and a row is fewer bulk copies); q̂ is zero there.
  uint32_t cm = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    dm[w] |= __shfl_xor_sync(0xffffffffu, dm[w], 1);
    dm[w] |= __shfl_xor_sync(0xffffffffu, dm[w], 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) cm |= ((dm[w] >> (8 * j)) & 0xffu) ? 1u << (4 * w + j) : 0u;
  }
  const uint32_t un = __reduce_or_sync(0xffffffffu, cm);
  const uint32_t um = un | (~un & (un << 1) & (un >> 1));  // staged chunks
  const int nu = __popc(um);     // staged width in chunks
  const int nks = (nu + 1) / 2;  // 16-dim k-steps
  int* uc = uc_s[warp];
  if ((um >> lane) & 1) uc[__popc(um & ((1u << lane) - 1))] = lane;
  // bf16: an odd width's padding chunk of K̂ is zero (so is q̂'s)
  if (!kQuant && (nu & 1))
    *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(wbase + (lane / kRows) * stage_b) +
                              (lane % kRows) * kst + nu * 8) = make_uint4(0, 0, 0, 0);
  __syncwarp();

  // the element row of position vp of the walk, through its page
  auto row_of = [&](int vp, int page) -> long long {
    return ((long long)page * a.KV + kv) * a.ps + (vp - vp / a.ps * a.ps);
  };
  // bytes of a row's copies (bf16: the staged chunks and V; int8: whole
  // rows), summed over a tile's 16 lanes for row 0 to expect
  const int krow = kQuant ? D + Dv : nu * 16 + Dv * 2;
  // Row r of a tile (this lane's, element row ro) into stage st; `bytes` is
  // the tile's total, which row 0 expects. Rows without a token are not
  // copied. bf16: the row's V row and its staged K̂ chunks, one bulk copy
  // per run of them; V rows without a token are zeroed (their weight is 0,
  // and 0 · NaN is not 0). int8: the K̂ and V rows (any byte is a finite
  // value, so a row left from an earlier tile needs no zeroing).
  const uint32_t run_starts = um & ~(um << 1);
  auto issue = [&](int st, long long ro, int r, bool valid, int bytes) {
    const uint32_t bar = smem_u32(&bar_s[warp][st]);
    unsigned char* sb = wbase + st * stage_b;
    if (r == 0) mbar_expect(bar, bytes);
    if constexpr (kQuant) {
      if (valid) {
        bulk_copy(sb + r * rsk, static_cast<const int8_t*>(a.k) + ro * D, D, bar, once);
        bulk_copy(sb + kRows * rsk + r * rsv, static_cast<const int8_t*>(a.v) + ro * Dv, Dv,
                  bar, once);
      }
    } else {
      bf16* ks = reinterpret_cast<bf16*>(sb);
      bf16* vs = ks + kRows * kst;
      const bf16* kg = reinterpret_cast<const bf16*>(a.k);
      if (valid) {
        bulk_copy(vs + r * vst, reinterpret_cast<const bf16*>(a.v) + ro * Dv, Dv * 2, bar, once);
        for (uint32_t m = run_starts; m; m &= m - 1) {
          const int c0 = __ffs(m) - 1;
          const int n = __ffsll(~((unsigned long long)um >> c0)) - 1;  // run length
          const int u0 = __popc(um & ((1u << c0) - 1));
          bulk_copy(ks + r * kst + u0 * 8, kg + ro * D + c0 * 8, n * 16, bar, once);
        }
      } else {
        for (int c = 0; c < vw; ++c)
          *reinterpret_cast<uint4*>(vs + r * vst + c * 8) = make_uint4(0, 0, 0, 0);
        // a later copy into this stage is ordered after these stores
        if constexpr (kPart) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
    }
  };

  // lanes 16 s + r: row r of the warp's tile s. Per stage, the rows of its
  // tile that hold a token (kPart) and, int8, this lane's row's scales.
  const bool my_issue = my_tile < ntile;
  const bool my_valid = kPart ? part_valid(my_pos, my_lp, end) : my_pos < end;
  int my_bytes = my_issue && my_valid ? krow : 0;
#pragma unroll
  for (int o = 1; o < kRows; o <<= 1) my_bytes += __shfl_xor_sync(0xffffffffu, my_bytes, o);
  const uint32_t vb_first = __ballot_sync(0xffffffffu, my_issue && my_valid);
  uint32_t vb0 = vb_first & 0xffffu, vb1 = vb_first >> 16;
  float ksc0 = 1.f, ksc1 = 1.f, vsc0 = 1.f, vsc1 = 1.f;
  if constexpr (kQuant) {
    if (my_issue && my_valid) {
      const int64_t si = (int64_t)my_page * a.sh + kv * a.s_stride;
      if (lane >> 4) {
        ksc1 = a.ks[si];
        vsc1 = a.vs[si];
      } else {
        ksc0 = a.ks[si];
        vsc0 = a.vs[si];
      }
    }
  }
  if (my_issue)
    issue(lane >> 4, row_of(my_pos, my_page), lane & 15, my_valid, my_bytes);
  // kPart, lanes < 16: the participating page of this lane's row of the tile
  // each stage takes next (tiles warp + 8 and warp + 12: my_lp2 of lanes r
  // and 16 + r)
  int nlp0 = 0, nlp1 = 0;
  if constexpr (kPart) {
    nlp0 = my_lp2;
    nlp1 = __shfl_sync(0xffffffffu, my_lp2, (lane & 15) + kRows);
  }

  // q̂ of head g as the B operand of S = K̂·q̂ᵀ, zero where head g did not
  // select the dims. k-step ks, bf16: staged dims 16 ks + 2t, 2t + 1 (b0) and
  // + 8 (b1); int8: dims 16 ks + 4t, 4t + 1 (b0) and 4t + 2, 4t + 3 (b1),
  // the order in which ldmatrix hands out byte pairs of the K̂ rows
  mbar_wait(smem_u32(&q_bar), 0);
  uint32_t qf[kKS][2];
  const bf16* qrow = qsm + min(g, ng - 1) * D;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int u = 2 * ks + half;
      const int d = kQuant ? 16 * ks + 4 * t + 2 * half : uc[min(u, nu - 1)] * 8 + 2 * t;
      const bool in = kQuant ? 16 * ks < D : u < nu;
      const uint32_t x = in ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
      uint32_t bits = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        if (w == d / 32) bits = dm[w] >> (d % 32);
      if (!in || g >= ng) bits = 0;
      qf[ks][half] = x & (((bits & 1) ? 0xffffu : 0u) | ((bits & 2) ? 0xffff0000u : 0u));
    }
  }
  float o[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads 2t, 2t + 1 (log2 units)
  // ldmatrix row addresses: K̂ rows lane % 16, chunk + lane / 16; V^T
  // matrices (dims, positions) = (0-7, 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
  // int8 (in bytes): K̂ and V rows lane % 16, 16-byte chunk + lane / 16
  const int k_off = (lane & 15) * kst + (lane >> 4) * 8;
  const int v_off = ((lane & 7) + ((lane >> 4) << 3)) * vst + ((lane >> 3) & 1) * 8;
  const int k8_off = (lane & 15) * rsk + (lane >> 4) * 16;
  const int v8_off = kRows * rsk + (lane & 15) * rsv + (lane >> 4) * 16;

  // a tile lies in one page when pages hold whole tiles (or the cache is
  // contiguous): one lookup serves its rows
  const bool in_page = !a.table || a.ps % kRows == 0;
#pragma unroll 1
  for (int it = 0, jt = warp; jt < ntile; ++it, jt += kWarps) {
    const int st = it % kStages;
    // the tile that reuses this stage: this lane's row of it (lanes < 16),
    // its page looked up before the wait. kPart: its participating page
    // came with the stage's previous tile, and the participating page of
    // the stage's tile after it goes out now, so no lookup of the walk's
    // chain (part, table, then int8 scales) waits behind the wait.
    const int jn = jt + kStages * kWarps;
    const int npos = begin + jn * kRows + (lane & 15);
    const bool nrow = jn < ntile && lane < kRows;
    int npage = b;
    bool nvalid = nrow && npos < end;
    if constexpr (kPart) {
      const int nlp = st ? nlp1 : nlp0;
      nvalid = nvalid && part_valid(npos, nlp, end);
      if (nvalid) npage = max(a.table[(int64_t)b * a.np_lane + nlp], 0);
      const int fpos = npos + kStages * kWarps * kRows;
      const int flp = lane < kRows && fpos < end ? a.part[(int64_t)b * a.kp + fpos / a.ps] : 0;
      nlp0 = st ? nlp0 : flp;
      nlp1 = st ? flp : nlp1;
    } else if (nvalid && a.table && (in_page ? lane == 0 : true)) {
      npage = max(a.table[(int64_t)b * a.np_lane + npos / a.ps], 0);
    }
    mbar_wait(smem_u32(&bar_s[warp][st]), (it / kStages) & 1);
    __syncwarp();
    // this tile's valid rows (kPart), and int8 the scales of rows g and g + 8
    // (held by the lanes that issued them: 16 st + r for the first tiles)
    const uint32_t vb = st ? vb1 : vb0;
    float sk0 = a.scale_log2, sk1 = a.scale_log2, sv0 = 1.f, sv1 = 1.f;
    if constexpr (kQuant) {
      const int src = it < kStages ? kRows * st : 0;
      const float kk = st ? ksc1 : ksc0, vv = st ? vsc1 : vsc0;
      sk0 = a.scale_log2 * __shfl_sync(0xffffffffu, kk, src + g);
      sk1 = a.scale_log2 * __shfl_sync(0xffffffffu, kk, src + g + 8);
      sv0 = __shfl_sync(0xffffffffu, vv, src + g);
      sv1 = __shfl_sync(0xffffffffu, vv, src + g + 8);
    }
    // the tile that reuses this stage: its bytes, valid rows and (int8)
    // scales, then its copies
    auto issue_next = [&]() {
      if (jn >= ntile) return;
      if (in_page && !kPart) npage = __shfl_sync(0xffffffffu, npage, 0);
      int bytes = nvalid ? krow : 0;
#pragma unroll
      for (int o = 1; o < kRows; o <<= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
      if constexpr (kPart) {
        const uint32_t nb = __ballot_sync(0xffffffffu, nvalid);
        if (st)
          vb1 = nb;
        else
          vb0 = nb;
      }
      if constexpr (kQuant) {
        if (nvalid) {
          const int64_t si = (int64_t)npage * a.sh + kv * a.s_stride;
          if (st) {
            ksc1 = a.ks[si];
            vsc1 = a.vs[si];
          } else {
            ksc0 = a.ks[si];
            vsc0 = a.vs[si];
          }
        }
      }
      if (nrow) issue(st, row_of(npos, npage), lane, nvalid, bytes);
    };
    const unsigned char* sb = wbase + st * stage_b;
    const bf16* Kt = reinterpret_cast<const bf16*>(sb);
    const bf16* Vt = Kt + kRows * kst;

    // a tile of the participating walk may hold no token: nothing to add
    if (!kPart || vb != 0) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, s_odd[4] = {0.f, 0.f, 0.f, 0.f};  // two chains
      if constexpr (kQuant) {
        // int8 K̂: ldmatrix hands this lane 4 bytes of row g (matrices 0, 2)
        // and of row g + 8 (1, 3) of two k-steps, dims 4t..4t + 3 of each
        // 16-byte chunk; converted exactly, they are the A operand in q̂'s order
#pragma unroll
        for (int kp = 0; kp < kKS / 2; ++kp) {
          if (32 * kp < D) {
            uint32_t r[4];
            ldsm_x4(r, reinterpret_cast<const bf16*>(sb + k8_off + 32 * kp));
#pragma unroll
            for (int j = 0; j < 4; ++j) r[j] ^= 0x80808080u;
            const uint32_t a0[4] = {i8x2_bf16x2(r[0], 0x7650, 0x7651),
                                    i8x2_bf16x2(r[1], 0x7650, 0x7651),
                                    i8x2_bf16x2(r[0], 0x7652, 0x7653),
                                    i8x2_bf16x2(r[1], 0x7652, 0x7653)};
            mma16816(s, a0, qf[2 * kp][0], qf[2 * kp][1]);
            if (32 * kp + 16 < D) {
              const uint32_t a1[4] = {i8x2_bf16x2(r[2], 0x7650, 0x7651),
                                      i8x2_bf16x2(r[3], 0x7650, 0x7651),
                                      i8x2_bf16x2(r[2], 0x7652, 0x7653),
                                      i8x2_bf16x2(r[3], 0x7652, 0x7653)};
              mma16816(s_odd, a1, qf[2 * kp + 1][0], qf[2 * kp + 1][1]);
            }
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          if (ks < nks) {
            uint32_t af[4];
            ldsm_x4(af, Kt + k_off + ks * 16);
            if (ks % 2)
              mma16816(s_odd, af, qf[ks][0], qf[ks][1]);
            else
              mma16816(s, af, qf[ks][0], qf[ks][1]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += s_odd[e];
      bool ok0, ok1;
      if constexpr (kPart) {
        ok0 = (vb >> g) & 1;
        ok1 = (vb >> (g + 8)) & 1;
      } else {
        const int nval = min(kRows, end - (begin + jt * kRows));
        ok0 = g < nval;
        ok1 = g + 8 < nval;
      }
      const float s0 = ok0 ? s[0] * sk0 : kNegInf;
      const float s1 = ok0 ? s[1] * sk0 : kNegInf;
      const float s2 = ok1 ? s[2] * sk1 : kNegInf;
      const float s3 = ok1 ? s[3] * sk1 : kNegInf;
      float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // the logical walk's tiles each hold a token, so the new max is
      // finite; the participating walk's max may stay NEG_INF, so its rows
      // without a token get weight 0 explicitly
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float p0 = fast_exp2(s0 - mn0), p1 = fast_exp2(s1 - mn1);
      float p2 = fast_exp2(s2 - mn0), p3 = fast_exp2(s3 - mn1);
      if constexpr (kPart) {
        p0 = ok0 ? p0 : 0.f;
        p1 = ok0 ? p1 : 0.f;
        p2 = ok1 ? p2 : 0.f;
        p3 = ok1 ? p3 : 0.f;
      }
      l0 = l0 * c0 + p0 + p2;
      l1 = l1 * c1 + p1 + p3;
      // P (int8: times each row's value scale) split into bf16 hi + lo (P
      // rounded once misses the one-ulp limit), transposed into the B
      // operand of O = Vᵀ·P
      uint32_t ph0, pl0, ph1, pl1;
      split_pair(p0 * sv0, p1 * sv0, ph0, pl0);
      split_pair(p2 * sv1, p3 * sv1, ph1, pl1);
      const uint32_t bh0 = transpose8(ph0), bh1 = transpose8(ph1);
      const uint32_t bl0 = transpose8(pl0), bl1 = transpose8(pl1);
      uint32_t vf[kMT][4];  // the hi products of every slice, then the lo ones
      if constexpr (kQuant) {
        // int8 V: ldmatrix.trans hands this lane dims 2g, 2g + 1 of
        // positions 2t, 2t + 1 (matrices 0, 2) and 2t + 8, 2t + 9 (1, 3) of
        // two 16-dim slices; output row g of a slice is its dim 2g, row g + 8
        // its dim 2g + 1
#pragma unroll
        for (int mp = 0; mp < kMT / 2; ++mp) {
          if (2 * mp < nmt) {
            uint32_t r[4];
            ldsm_x4_t(r, reinterpret_cast<const bf16*>(sb + v8_off + 32 * mp));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              r[j] ^= 0x80808080u;
              vf[2 * mp + j / 2][2 * (j % 2)] = i8x2_bf16x2(r[j], 0x7650, 0x7652);
              vf[2 * mp + j / 2][2 * (j % 2) + 1] = i8x2_bf16x2(r[j], 0x7651, 0x7653);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt < nmt) {
          o[mt][0] *= c0;
          o[mt][1] *= c1;
          o[mt][2] *= c0;
          o[mt][3] *= c1;
          if constexpr (!kQuant) ldsm_x4_t(vf[mt], Vt + v_off + mt * 16);
          mma16816(o[mt], vf[mt], bh0, bh1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        if (mt < nmt) mma16816(o[mt], vf[mt], bl0, bl1);
    }
    __syncwarp();  // the stage is free for a later tile
    issue_next();
  }

  // this warp's sums over its lanes, then its (m, l, acc) per head into its
  // own shared memory ([head][Dv + 2] floats), then the block merges its warps
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int wst = Dv + 2;
  float* wr = reinterpret_cast<float*>(wbase);
  float* w0 = wr + 2 * t * wst;
  float* w1 = w0 + wst;
  if (g == 0) {
    w0[0] = m0;
    w0[1] = l0;
    w1[0] = m1;
    w1[1] = l1;
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    // output rows g and g + 8 of slice mt: dims g and g + 8 (int8: 2g, 2g + 1)
    const int d = mt * 16 + (kQuant ? 2 * g : g), d8 = kQuant ? d + 1 : d + 8;
    if (mt < nmt && d < Dv) {
      w0[2 + d] = o[mt][0];
      w1[2 + d] = o[mt][1];
    }
    if (mt < nmt && d8 < Dv) {
      w0[2 + d8] = o[mt][2];
      w1[2 + d8] = o[mt][3];
    }
  }
  __syncthreads();
  merge_warps(reinterpret_cast<const float*>(smem_raw), warp_b / 4, ng, Dv,
              a.scratch + (((int64_t)b * a.H + h0) * a.nsplit + split) * wst,
              (int64_t)a.nsplit * wst);
}

template <int kKS, int kMT, bool kQuant, bool kPart>
int launch(const Args& a, int B, void* out, cudaStream_t st) {
  static int done[16] = {0};
  const int bytes = kWarps * warp_bytes(kQuant, a.kwa, a.D, a.Dv) + kHeads * a.D * 2;
  auto kernel = decode_bf16<kKS, kMT, kQuant, kPart>;
  cudaError_t err = attn_tile::allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.nsplit, a.KV * a.nhg, B), kThreads, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // int8 pools give float32 outputs; the participating walk writes every split
  using OT = typename std::conditional<kQuant, float, bf16>::type;
  const Visited e{a.v, a.table, a.part, a.vs, kQuant ? 2 : 1, a.KV, a.ps, a.np_lane, a.kp,
                  a.sh, a.s_stride};
  aqua_decode_combine<OT><<<dim3(a.H, B), ::kThreads, 0, st>>>(
      a.scratch, a.lengths, (OT*)out, a.H, a.Dv, a.nsplit, kPart ? 1 : 0, e);
  return (int)cudaGetLastError();
}

template <bool kQuant, bool kPart>
int launch_variant(const Args& a, int B, void* out, cudaStream_t st) {
  if (a.D <= 128 && a.Dv <= 128) return launch<8, 8, kQuant, kPart>(a, B, out, st);
  return launch<16, 16, kQuant, kPart>(a, B, out, st);
}

}  // namespace gqa

// ---------------------------------------------------------------------------
// float32 group route: one block per (split, KV head, lane), exact float32 on
// FFMA
// ---------------------------------------------------------------------------

namespace gqa32 {

using attn_tile::fast_exp2;
using attn_tile::mbar_wait;  // traps after 4 s of the card's clock (a wrong count)
using attn_tile::smem_u32;
using gqa::bulk_copy;
using gqa::evict_first_policy;
using gqa::mbar_expect;
using gqa::mbar_init;
using gqa::range_word;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;             // positions per warp tile
constexpr int kStages = 2;           // warp tiles in flight per warp
constexpr int kParts = 32 / kRows;   // lanes that share a row's score
constexpr int kHeads = 8;            // query heads per block
static_assert(kStages * kRows <= 32, "a warp's first tiles give each lane at most one row");
static_assert(kWarps == gqa::kWarps, "the block merge is the group route's");

struct Args {
  const float* q;
  const float* k;        // (P, KV, ps, D)
  const float* v;        // (P, KV, ps, Dv)
  const int* block_idx;
  const int* table;      // (B, np_lane) or null: contiguous cache (page = b, ps = S)
  const int* lengths;
  float* scratch;        // (B, H, nsplit, Dv + 2)
  int H, KV, D, Dv, nb_sel, bd, ps, np_lane;
  int nhg;               // blocks per KV head (groups of more than 8 heads)
  int nsplit;
  float scale_log2;      // scale · log2 e
};

// Floats per warp: kStages stages of kRows K̂ rows then kRows V rows, whole
// rows as they lie in device memory
__host__ __device__ inline int warp_floats(int D, int Dv) { return kStages * kRows * (D + Dv); }
// Dynamic shared memory: the warps' rings, the heads' masked q̂ (kG x D) and
// each warp's tile of P (kRows x kG)
template <int kG>
__host__ __device__ inline int smem_bytes(int D, int Dv) {
  return 4 * (kWarps * warp_floats(D, Dv) + kG * D + kWarps * kRows * kG);
}

__device__ __forceinline__ float comp(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// kG: heads a block holds, rounded up to a power of two (1, 2, 4, 8; heads
// past the group's are zero in q̂ and not written). kWide: D or Dv past 128.
// Scores: lane (r = lane % kRows, part = lane / kRows) sums row r over the
// 4-dim chunks part, part + kParts, ... of the row, each rotated by r (so
// the rows of a quarter warp's 16-byte loads fall on distinct banks); P·V:
// lane owns output dims 4·lane .. 4·lane + 3 (and 128 on, kWide) of every
// head.
template <int kG, bool kWide>
__global__ void __launch_bounds__(kThreads) decode_f32(const Args a) {
  constexpr int kWords = kWide ? 8 : 4;  // 32-dim words of a head's selected dims
  constexpr int kCols = kWide ? 2 : 1;   // 4-dim output columns per lane
  constexpr int kQ = kWide ? 4 : 2;      // q̂ chunks this thread masks per head
  // partial sums per head's score (independent FMA chains) and the P·V
  // rows unrolled: at 8 heads fewer, or ptxas spills under the 168
  // registers that keep three blocks an SM
  constexpr int kP = kG >= 8 ? 1 : kG >= 4 ? 2 : 4;
  constexpr int kChunkUnroll = kG >= 8 ? 1 : 2;
  constexpr int kRowUnroll = kG >= 8 ? 4 : kRows;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / a.nhg, hg = blockIdx.y - kv * a.nhg;
  const int G = a.H / a.KV;
  const int h0 = kv * G + hg * kHeads, ng = min(kHeads, G - hg * kHeads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int D = a.D, Dv = a.Dv, nc = D / 4;
  const int begin = split * kSplit;
  const int cap = a.table ? a.ps * a.np_lane : a.ps;  // positions the view holds

  extern __shared__ __align__(16) float smem_f[];
  const int warp_f = warp_floats(D, Dv);
  float* wbase = smem_f + warp * warp_f;
  float* qm = smem_f + kWarps * warp_f;          // [head][D] masked q̂
  float* pw = qm + kG * D + warp * kRows * kG;   // this warp's P: [row][head]
  __shared__ uint64_t bar_s[kWarps][kStages];    // per warp and stage: copies landed

  // Reads that depend on nothing go out together: the length, head g's q̂
  // (chunks t + 4·warp + 16 j) and selected blocks (lane t: entries t, t +
  // 4, ...), and the page of this lane's row of the warp's first tiles
  // (lane kRows s + r: row r of tile s).
  const int raw_len = a.lengths[b];
  const int my_tile = warp + (lane / kRows) * kWarps;
  const int my_pos = begin + my_tile * kRows + lane % kRows;
  const bool first_row = lane < kStages * kRows;
  int my_page = b;
  if (a.table && first_row && my_pos < cap)
    my_page = max(a.table[(int64_t)b * a.np_lane + my_pos / a.ps], 0);
  float4 qx[kQ];
  uint32_t dm[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) dm[w] = 0;
  if (g < ng) {
    const float* qrow = a.q + ((int64_t)b * a.H + h0 + g) * D;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int c = t + 4 * warp + 16 * j;
      qx[j] = c < nc ? *reinterpret_cast<const float4*>(qrow + 4 * c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int* idx = a.block_idx + ((int64_t)b * a.H + h0 + g) * a.nb_sel;
#pragma unroll 4
    for (int j = t; j < a.nb_sel; j += 4) {
      const int d0 = idx[j] * a.bd;
#pragma unroll
      for (int w = 0; w < kWords; ++w) dm[w] |= range_word(d0, d0 + a.bd, w);
    }
  }
  if (lane < kStages) mbar_init(smem_u32(&bar_s[warp][lane]));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // head g's selected dims over its four lanes, then its q̂ zero in every dim
  // it did not select (and heads past the group's zero): the whole rows
  // then score exactly each head's own blocks
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    dm[w] |= __shfl_xor_sync(0xffffffffu, dm[w], 1);
    dm[w] |= __shfl_xor_sync(0xffffffffu, dm[w], 2);
  }
  if (g < kG) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int c = t + 4 * warp + 16 * j;
      if (c < nc) {
        uint32_t bits = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          if (w == c / 8) bits = dm[w] >> (4 * (c % 8));
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < ng) {
          x.x = (bits & 1) ? qx[j].x : 0.f;
          x.y = (bits & 2) ? qx[j].y : 0.f;
          x.z = (bits & 4) ? qx[j].z : 0.f;
          x.w = (bits & 8) ? qx[j].w : 0.f;
        }
        *reinterpret_cast<float4*>(qm + g * D + 4 * c) = x;
      }
    }
  }
  const int len = min(raw_len, cap);
  // the only block barrier before the merge: barriers initialized, q̂ staged
  __syncthreads();
  if (begin >= len) return;  // the combine pass reads only splits below len
  const int end = min(len, begin + kSplit);
  const int ntile = (end - begin + kRows - 1) / kRows;
  const uint64_t once = evict_first_policy();

  // the element row of position pos, through its page
  auto row_of = [&](int pos, int page) -> long long {
    return ((long long)page * a.KV + kv) * a.ps + (pos - pos / a.ps * a.ps);
  };
  auto rows_in = [&](int jt) { return min(kRows, end - (begin + jt * kRows)); };
  const int rbytes = (D + Dv) * 4;  // a row's K̂ and V bytes
  // n consecutive element rows from ro into stage st at row r: one bulk copy
  // of their K̂ rows, one of their V rows; row 0 expects the tile's bytes.
  // Rows without a token are neither copied nor read.
  auto issue = [&](int st, long long ro, int r, int n, int bytes) {
    const uint32_t bar = smem_u32(&bar_s[warp][st]);
    float* ks = wbase + st * kRows * (D + Dv);
    if (r == 0) mbar_expect(bar, bytes);
    bulk_copy(ks + r * D, a.k + ro * D, n * D * 4, bar, once);
    bulk_copy(ks + kRows * D + r * Dv, a.v + ro * Dv, n * Dv * 4, bar, once);
  };
  // a tile lies in one page when pages hold whole tiles (or the cache is
  // contiguous): its rows are consecutive in device memory, two copies in
  // all; else each row is copied on its own
  const bool in_page = !a.table || a.ps % kRows == 0;
  if (first_row && my_tile < ntile) {
    const int r = lane % kRows, n = rows_in(my_tile);
    if (in_page ? r == 0 : r < n)
      issue(lane / kRows, row_of(my_pos, my_page), r, in_page ? n : 1, n * rbytes);
  }

  const int r = lane % kRows, part = lane / kRows;
  const int rot = r % nc;
  float m[kG], l[kG];
  float4 acc[kCols][kG];
#pragma unroll
  for (int h = 0; h < kG; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 1
  for (int it = 0, jt = warp; jt < ntile; ++it, jt += kWarps) {
    const int st = it % kStages;
    // the tile that reuses this stage: its first row's page (lane 0), or
    // this lane's row's (lanes < kRows, tiles across pages), looked up
    // before the wait
    const int jn = jt + kStages * kWarps;
    const int npos = begin + jn * kRows + r;
    const int nrows = jn < ntile ? rows_in(jn) : 0;
    const bool nissue = lane < kRows && (in_page ? lane == 0 : r < nrows) && nrows > 0;
    int npage = b;
    if (nissue && a.table) npage = max(a.table[(int64_t)b * a.np_lane + npos / a.ps], 0);
    mbar_wait(smem_u32(&bar_s[warp][st]), (it / kStages) & 1);
    __syncwarp();
    const int nval = rows_in(jt);
    const float* Ks = wbase + st * kRows * (D + Dv);
    const float* Vs = Ks + kRows * D;

    // S = K̂·q̂ᵀ: kP partial sums per head, then the parts of a row summed
    // across lanes
    float sp[kG][kP];
#pragma unroll
    for (int h = 0; h < kG; ++h)
#pragma unroll
      for (int i = 0; i < kP; ++i) sp[h][i] = 0.f;
    const float* kr = Ks + r * D;
#pragma unroll kChunkUnroll
    for (int u = part; u < nc; u += kParts) {
      const int cc = u + rot < nc ? u + rot : u + rot - nc;
      const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * cc);
#pragma unroll
      for (int h = 0; h < kG; ++h) {
        const float4 qq = *reinterpret_cast<const float4*>(qm + h * D + 4 * cc);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sp[h][j % kP] = fmaf(comp(kk, j), comp(qq, j), sp[h][j % kP]);
      }
    }
    // the online softmax in the log2 domain; rows without a token (r >=
    // nval: not copied, so any bits) get NEG_INF, and every tile of the walk
    // holds a token, so the new max is finite
    float c[kG], p[kG];
#pragma unroll
    for (int h = 0; h < kG; ++h) {
      float s = sp[h][0];
#pragma unroll
      for (int i = 1; i < kP; ++i) s += sp[h][i];
#pragma unroll
      for (int o = kRows; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      s = r < nval ? s * a.scale_log2 : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 1; o < kRows; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[h], mx);
      c[h] = fast_exp2(m[h] - mn);
      m[h] = mn;
      p[h] = fast_exp2(s - mn);
      l[h] = l[h] * c[h] + (part == 0 ? p[h] : 0.f);
    }
    if (part == 0) {
#pragma unroll
      for (int h = 0; h < kG; ++h) pw[r * kG + h] = p[h];
    }
    __syncwarp();
    // O = O·corr + P·V over the tile's rows with a token
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int h = 0; h < kG; ++h) {
        acc[j][h].x *= c[h];
        acc[j][h].y *= c[h];
        acc[j][h].z *= c[h];
        acc[j][h].w *= c[h];
      }
#pragma unroll kRowUnroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (rr < nval) {
        float pr[kG];
        if constexpr (kG >= 4) {
#pragma unroll
          for (int h = 0; h < kG; h += 4) {
            const float4 x = *reinterpret_cast<const float4*>(pw + rr * kG + h);
            pr[h] = x.x;
            pr[h + 1] = x.y;
            pr[h + 2] = x.z;
            pr[h + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int h = 0; h < kG; ++h) pr[h] = pw[rr * kG + h];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = lane + 32 * j;
          if (4 * col < Dv) {
            const float4 vv = *reinterpret_cast<const float4*>(Vs + rr * Dv + 4 * col);
#pragma unroll
            for (int h = 0; h < kG; ++h) {
              acc[j][h].x = fmaf(pr[h], vv.x, acc[j][h].x);
              acc[j][h].y = fmaf(pr[h], vv.y, acc[j][h].y);
              acc[j][h].z = fmaf(pr[h], vv.z, acc[j][h].z);
              acc[j][h].w = fmaf(pr[h], vv.w, acc[j][h].w);
            }
          }
        }
      }
    }
    __syncwarp();  // the stage and P are free for a later tile
    if (nissue)
      issue(st, row_of(npos, npage), r, in_page ? nrows : 1, nrows * rbytes);
  }

  // this warp's sums over its lanes, then its (m, l, acc) per head into its
  // own shared memory ([head][Dv + 2] floats), then the block merges its warps
#pragma unroll
  for (int h = 0; h < kG; ++h)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
  const int wst = Dv + 2;
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < kG; ++h) {
      wbase[h * wst] = m[h];
      wbase[h * wst + 1] = l[h];
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = lane + 32 * j;
    if (4 * col < Dv) {
#pragma unroll
      for (int h = 0; h < kG; ++h) {
        float* w = wbase + h * wst + 2 + 4 * col;
        w[0] = acc[j][h].x;
        w[1] = acc[j][h].y;
        w[2] = acc[j][h].z;
        w[3] = acc[j][h].w;
      }
    }
  }
  __syncthreads();
  gqa::merge_warps(smem_f, warp_f, ng, Dv,
                   a.scratch + (((int64_t)b * a.H + h0) * a.nsplit + split) * wst,
                   (int64_t)a.nsplit * wst);
}

template <int kG, bool kWide>
int launch(const Args& a, int B, float* out, cudaStream_t st) {
  static int done[16] = {0};
  const int bytes = smem_bytes<kG>(a.D, a.Dv);
  auto kernel = decode_f32<kG, kWide>;
  cudaError_t err = attn_tile::allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.nsplit, a.KV * a.nhg, B), kThreads, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Visited e{a.v, a.table, nullptr, nullptr, 0, a.KV, a.ps, a.np_lane, 0, 1, 0};
  aqua_decode_combine<float><<<dim3(a.H, B), ::kThreads, 0, st>>>(a.scratch, a.lengths, out,
                                                                  a.H, a.Dv, a.nsplit, 0, e);
  return (int)cudaGetLastError();
}

template <bool kWide>
int launch_heads(const Args& a, int B, float* out, cudaStream_t st) {
  const int g = a.H / a.KV;
  if (g == 1) return launch<1, kWide>(a, B, out, st);
  if (g == 2) return launch<2, kWide>(a, B, out, st);
  if (g <= 4) return launch<4, kWide>(a, B, out, st);
  return launch<8, kWide>(a, B, out, st);  // 8 heads a block (nhg blocks a group)
}

}  // namespace gqa32

}  // namespace

// Positions per partial block (every route): the wrapper sizes the float32
// scratch as B * H * nsplit * (Dv + 2) with nsplit = ceil(positions walked
// / split).
extern "C" int aqua_decode_split() { return kSplit; }

// dtype: 0 = float32, 1 = bfloat16 (of q; of k, v and out too unless
// quantized). page_table may be null (contiguous cache: P = B, ps = S).
// k_scale / v_scale non-null: k and v are int8 with (P, sh) scales, out is
// float32. part_idx non-null: (B, kp) participating logical pages.
// route: 1 = the group route (bf16 q̂, with or without int8 and
// participating pages; D % 8 == 0, D <= 256, Dv % 8 == 0, 16-byte aligned
// bases, and for int8 D and Dv multiples of 16), 2 = the float32 group
// route (float32 q̂, no int8 pool, no participating pages; D and Dv
// multiples of 4, D <= 256, 16-byte aligned bases), 0 = the per-head route
// (float32 and bf16 calls the other two do not take).
// The wrapper chooses (kernels/aqua_decode.py::decode_route); shapes the
// chosen route does not take return cudaErrorInvalidValue.
// Returns the cudaError_t of the launches.
extern "C" int aqua_decode_launch(const void* q, const void* k, const void* v,
                                  const void* block_idx, const void* page_table,
                                  const void* part_idx, const void* k_scale,
                                  const void* v_scale, const void* lengths, void* out,
                                  void* scratch, int B, int H, int KV, int D, int Dv,
                                  int nb_sel, int bd, int ps, int np_lane, int kp, int sh,
                                  int nsplit, float scale, int dtype, int route,
                                  void* stream) {
  if (nb_sel * bd > kMaxSel || Dv > kMaxDv || H % KV != 0) return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if ((part_idx || k_scale) && !page_table) return (int)cudaErrorInvalidValue;
  if (B == 0 || nsplit == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int* bi = (const int*)block_idx;
  const int* ln = (const int*)lengths;
  float* sc = (float*)scratch;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D % 8 != 0 || D > 256 || Dv % 8 != 0) return (int)cudaErrorInvalidValue;
    if (k_scale && (D % 16 != 0 || Dv % 16 != 0)) return (int)cudaErrorInvalidValue;
    const int G = H / KV;
    const gqa::Args a{(const __nv_bfloat16*)q, k, v, bi, (const int*)page_table,
                      (const int*)part_idx, (const float*)k_scale, (const float*)v_scale,
                      ln, sc, H, KV, D, Dv, nb_sel, bd, ps, np_lane, kp, sh,
                      sh > 1 ? 1 : 0, (G + gqa::kHeads - 1) / gqa::kHeads, nsplit,
                      (D / 8 + 1) / 2 * 2, scale * attn_tile::kLog2e};
    if (k_scale && part_idx) return gqa::launch_variant<true, true>(a, B, out, st);
    if (k_scale) return gqa::launch_variant<true, false>(a, B, out, st);
    if (part_idx) return gqa::launch_variant<false, true>(a, B, out, st);
    return gqa::launch_variant<false, false>(a, B, out, st);
  }
  if (route == 2) {
    if (dtype != 0 || k_scale || part_idx) return (int)cudaErrorInvalidValue;
    if (D % 4 != 0 || Dv % 4 != 0 || D > 256) return (int)cudaErrorInvalidValue;
    const int G = H / KV;
    const gqa32::Args a{(const float*)q, (const float*)k, (const float*)v, bi,
                        (const int*)page_table, ln, sc, H, KV, D, Dv, nb_sel, bd, ps,
                        np_lane, (G + gqa32::kHeads - 1) / gqa32::kHeads, nsplit,
                        scale * attn_tile::kLog2e};
    if (D > 128 || Dv > 128) return gqa32::launch_heads<true>(a, B, (float*)out, st);
    return gqa32::launch_heads<false>(a, B, (float*)out, st);
  }
  // bf16 at full precision over every page runs the group route only
  if (dtype == 1 && !k_scale && !part_idx) return (int)cudaErrorInvalidValue;
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
