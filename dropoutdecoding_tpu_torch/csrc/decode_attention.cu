// K1 and K3: ensemble decode attention for Hopper (sm_90a), over a dense
// cache (K1) or an int8 cache with per-(token, head) scales (K3).
//
// K1 replaces the TPU kernel ensemble_decode_attention_fused
// (dropoutdecoding_tpu/ops/pallas_decode_attention.py:166, body _kernel_bf16
// :111) and its layered twin ensemble_decode_attention_layered (:533); K3
// replaces ensemble_decode_attention_int8kv_fused (:234, body _kernel :48)
// and its layered twin ensemble_decode_attention_int8kv_layered (:457,
// _kernel_layered_int8 :322).  In both, the layer index is a pointer offset
// into the full cache, taken by the Python wrapper.
//
// For each (b, m, h) with kv group g = h / G (G = H / KH, the repeat_kv
// interleave), the output is the softmax over the cache scores q.k_s/sqrt(D)
// of the slots where key_mask[b, m, s] is set, plus the member's own new
// token, applied to the values.  A member whose cache is fully masked still
// attends its own token.  Masked slots take no part in the sums; that equals
// the reference's -1e30 score, whose exp underflows to exactly 0 next to the
// always-present self score.  For an int8 cache the key scale multiplies the
// score after the dot, and the value scale the unnormalised probability
// before PV, as the reference does; the softmax denominator takes the
// unscaled probabilities.
//
// What bounds it on this card: the cache bytes, read once for all R = M x G
// query rows of a group (no repeat_kv copy): at the LLaVA-1.5 slice shape
// (620 of 1152 slots filled, 32 heads of 128) 10.2 MB in bf16, 3.1 us at
// 3.35 TB/s, and half of that in int8; the rows add 4 R D FLOPs a slot, far
// under the compute roof.  What held the version this replaces at 13-25
// times that: scores by one warp a slot with R dependent shuffle reductions,
// PV as R D / 128 serial fp32 sums a thread (so the time grew with R: 23 us at
// R = 1, 39 at 3, 90 at 12, while the bytes fell), three block-wide phases a
// tile with nothing overlapped, and a second launch that re-read every tile's
// partial.  The design:
//  - Tensor cores for both products (decode_mma_kernel: bf16 activations, D =
//    128).  Up to 16 query rows are the A tile of mma.sync m16n8k16, so a
//    tile's cost does not grow with R; more rows take more blocks (grid z).
//    The probabilities are rounded to bf16 for PV, as the TPU kernel rounds
//    them to the cache type.  An int8 tile is widened to bf16 in registers
//    (exact).
//  - A warp is its own pipeline.  A block takes a run of 64-slot tiles of one
//    (b, g); warp w takes slots 16 w .. 16 w + 15 of each, with its own
//    cp.async ring (K and V of a sub-tile are separate groups: QK^T starts
//    when K has landed, while V and the next sub-tile's K travel) and its own
//    online softmax in registers.  The loop has no block-wide barrier.  A
//    sub-tile no member attends is neither loaded nor computed; the block's
//    mask bytes are staged once, beside the tiles, not read a score.
//  - One launch.  The warps' states are merged through shared memory, the
//    block's (max, sum, acc) go to scratch, and the block of a (b, g, row
//    tile) that arrives last (an integer counter, reset by that block) merges
//    the pieces in split order with the self token and writes the output:
//    same bits every run, no float atomics.  Scratch and counters belong to
//    the caller, who keeps them between calls.
//  - fp32 activations, and head dims other than 128, keep fp32 FMAs
//    (decode_fma_kernel: the same walk, online softmax and merge, block-wide),
//    so that the card agrees with the CPU to summation order.
// What still bounds it (NVIDIA H100 80GB HBM3, 700 W: 14-18 us at 1152 slots,
// 24-26 at 3504, whatever the rows; PERF.md): a chain of global round trips of
// 1-2 us each, the launch, the mask, the walk (at 2.2 TB/s while it lasts),
// the pieces written and counted, the merge's two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;         // cache slots per tile
constexpr int kSub = kTile / kWarps;  // slots of a tile one warp takes (mma kernel)
constexpr int kMmaD = 128;        // head dim of the tensor-core kernel
constexpr int kMmaRows = 16;      // query rows per block of the tensor-core kernel
constexpr int kStages = 2;        // sub-tiles in flight per warp
constexpr int kMaxDPerLane = 8;   // D <= 256 (FMA kernel)
constexpr int kLdo = kMmaD + 4;   // fp32 row stride of the warps' PV sums in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

struct Args {
  const void* q;         // [B, M, H, D]
  const void* kc;        // [B, S, KH, D]
  const void* vc;        // [B, S, KH, D]
  const float* ks;       // [B, KH, S] key scales, or null
  const float* vs;       // [B, KH, S] value scales, or null
  const void* kn;        // [B, M, KH, D]
  const void* vn;        // [B, M, KH, D]
  const uint8_t* mask;   // [B, M, S]
  void* out;             // [B, M, H, D]
  float* part_m;         // [B*KH, nsplit, R]
  float* part_l;         // [B*KH, nsplit, R]
  float* part_acc;       // [B*KH, nsplit, R, D]
  int* counters;         // [B*KH, ceil(R / 16)], zero between launches
  int M, H, KH, S, D, tpb, nsplit;  // tpb: tiles a block walks
  float scale;
};

// Every thread of the block calls it after the block's piece is in scratch.
// True in the block of this counter that arrives last, which then sees every
// piece; that block leaves the counter zero for the next launch.
__device__ __forceinline__ bool arrive_last(int* counter, int expected, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

constexpr int kMaxSplits = 64;  // the merge keeps a row's pieces' weights two a lane

// The last block of (bg, rows [row0, row0 + nrows)) adds the pieces: one warp a
// row, kEach rows of a warp in flight together, lanes across the head dim in
// runs of V (4: 16-byte reads, or 1).  A global round trip costs 1-2 us here,
// so every read stands beside its neighbours, never behind one: a row's self
// score, its pieces' (max, sum) pairs, a piece a lane, and the partial PVs of
// its first kBatch pieces, whatever their weight will be, in one sweep; from
// the pairs, by shuffles, the pieces' rescaling weights with 1 / denominator
// folded in and the last piece that carries weight; then the remaining partial
// PVs, kBatch of each row in flight, all added in split order.
template <typename T, int V, int kEach, int kBatch>
__device__ __forceinline__ void merge_rows(const Args& a, int bg, int row0, int nrows) {
  const int b = bg / a.KH, g = bg % a.KH;
  const int G = a.H / a.KH, R = a.M * G, D = a.D, nsplit = a.nsplit;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kn = static_cast<const T*>(a.kn);
  const T* vn = static_cast<const T*>(a.vn);
  T* out = static_cast<T*>(a.out);
  const size_t base = (size_t)bg * nsplit * R;
  const size_t step = (size_t)R * D;  // from one piece's sums to the next's
  const int runs = D / V;             // V divides D

  for (int i0 = 0; i0 < nrows; i0 += kEach * kWarps) {
    bool has[kEach];
    int r[kEach];
    size_t o_at[kEach], n_at[kEach];  // the row in q and out; in the new K and V
    float p[kEach][kBatch][V];

    // The partial PVs of pieces [sp0, sp0 + kBatch) below `limit`, at the
    // lane's run of chunk c0.
    auto load_batch = [&](int c0, int sp0, const int (&limit)[kEach]) {
      const int d = (c0 + lane) * V;
#pragma unroll
      for (int k = 0; k < kEach; ++k)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool in = has[k] && c0 + lane < runs && sp0 + u < limit[k];
          const float* at = a.part_acc + (base + r[k]) * D + d + (size_t)(sp0 + u) * step;
          if constexpr (V == 4) {
            const float4 t = in ? __ldcg(reinterpret_cast<const float4*>(at))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            p[k][u][0] = t.x, p[k][u][1] = t.y, p[k][u][2] = t.z, p[k][u][3] = t.w;
          } else {
            p[k][u][0] = in ? __ldcg(at) : 0.f;
          }
        }
    };

    float w[kEach][2], self[kEach], ml[kEach][2][2];
    int every[kEach];
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      const int i = i0 + warp + kWarps * k;  // rows go round the warps
      has[k] = i < nrows;
      r[k] = row0 + min(i, nrows - 1);
      every[k] = nsplit;
      const int m = r[k] / G, h = g * G + (r[k] - m * G);
      o_at[k] = (((size_t)b * a.M + m) * a.H + h) * D;
      n_at[k] = (((size_t)b * a.M + m) * a.KH + g) * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int sp = lane + 32 * half;
        const bool in = has[k] && sp < nsplit;
        const size_t j = base + (size_t)(in ? sp : 0) * R + r[k];
        ml[k][half][0] = in ? __ldcg(a.part_m + j) : -INFINITY;
        ml[k][half][1] = in ? __ldcg(a.part_l + j) : 0.f;
      }
      self[k] = 0.f;
      if (has[k])
        for (int d = lane; d < D; d += 32) self[k] += to_f(q[o_at[k] + d]) * to_f(kn[n_at[k] + d]);
    }
    load_batch(0, 0, every);

    float e_self[kEach];
    int end[kEach], end_all = 0;
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      self[k] = warp_sum(self[k]) * a.scale;
      float mx = self[k];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (ml[k][half][1] > 0.f) mx = fmaxf(mx, ml[k][half][0]);
      mx = warp_max(mx);
      float denom = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        w[k][half] = ml[k][half][1] > 0.f ? expf(ml[k][half][0] - mx) : 0.f;
        denom += ml[k][half][1] * w[k][half];
      }
      denom = warp_sum(denom) + expf(self[k] - mx);
      e_self[k] = expf(self[k] - mx) / denom;
      w[k][0] /= denom;
      w[k][1] /= denom;
      const unsigned hi = __ballot_sync(0xffffffffu, w[k][1] != 0.f);
      const unsigned lo = __ballot_sync(0xffffffffu, w[k][0] != 0.f);
      end[k] = hi ? 64 - __clz(hi) : 32 - __clz(lo);  // one past the last piece with weight
      end_all = max(end_all, end[k]);
    }

    for (int c0 = 0; c0 < runs; c0 += 32) {  // the same trips for every lane: shuffles inside
      const int d = (c0 + lane) * V;
      const bool on = c0 + lane < runs;
      float acc[kEach][V], own[kEach][V];
#pragma unroll
      for (int k = 0; k < kEach; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[k][v] = 0.f;
          own[k][v] = has[k] && on ? to_f(vn[n_at[k] + d + v]) : 0.f;
        }
      for (int sp0 = 0; sp0 < end_all; sp0 += kBatch) {
        if (c0 > 0 || sp0 > 0) load_batch(c0, sp0, end);  // the first batch is in already
#pragma unroll
        for (int k = 0; k < kEach; ++k)
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {  // split order: the same sum every run
            const int sp = sp0 + u;
            const float wv = __shfl_sync(0xffffffffu, sp < 32 ? w[k][0] : w[k][1], sp & 31);
            if (sp < end[k] && wv != 0.f) {  // a piece without weight may hold anything
#pragma unroll
              for (int v = 0; v < V; ++v) acc[k][v] += wv * p[k][u][v];
            }
          }
      }
#pragma unroll
      for (int k = 0; k < kEach; ++k)
        if (has[k] && on) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            store_f(out + o_at[k] + d + v, acc[k][v] + e_self[k] * own[k][v]);
        }
    }
  }
}

// Up to a row a warp: eight pieces of it in flight; more rows: four rows of a
// warp with four pieces each.
template <typename T, int V>
__device__ __forceinline__ void merge_pieces(const Args& a, int bg, int row0, int nrows) {
  if (nrows <= kWarps) {
    merge_rows<T, V, 1, 8>(a, bg, row0, nrows);
  } else {
    merge_rows<T, V, 4, 4>(a, bg, row0, nrows);
  }
}

// ---- fp32 FMAs ----------------------------------------------------------------

// Copies n rows of D elements, row r at src + r * stride, into dense smem
// rows.  16-byte loads, U of them in flight per thread, when the rows are
// whole, aligned 16-byte words; element loads otherwise.
template <typename T>
__device__ __forceinline__ void load_rows(T* __restrict__ dst, const T* __restrict__ src,
                                          size_t stride, int n, int D) {
  constexpr int U = 8;
  if ((D * sizeof(T)) % 16 == 0 && (stride * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int vpr = D * sizeof(T) / 16;  // 16-byte words per row
    const int total = n * vpr;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int base = threadIdx.x; base < total; base += kThreads * U) {
      uint4 buf[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          const int r = i / vpr;
          buf[u] = reinterpret_cast<const uint4*>(src + r * stride)[i - r * vpr];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * kThreads;
        if (i < total) d4[i] = buf[u];
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int r = i / D;
      dst[i] = src[r * stride + (i - r * D)];
    }
  }
}

// Shared-memory layout of decode_fma_kernel, in bytes; elem is the size of a
// cache element.
struct FmaSmem {
  size_t q, acc, stat, p, ks, vs, k, v, total;
  __host__ __device__ FmaSmem(int R, int D, size_t elem) {
    q = 0;                                                   // [R, D] fp32, pre-scaled
    acc = align16(q + (size_t)R * D * sizeof(float));        // [R, D] fp32 running PV
    stat = align16(acc + (size_t)R * D * sizeof(float));     // [3, R] fp32: max, sum, rescale
    p = align16(stat + (size_t)3 * R * sizeof(float));       // [R, kTile] fp32
    ks = align16(p + (size_t)R * kTile * sizeof(float));     // [kTile] fp32 key scales
    vs = align16(ks + (size_t)kTile * sizeof(float));        // [kTile] fp32 value scales
    k = align16(vs + (size_t)kTile * sizeof(float));         // [kTile, D] C
    v = align16(k + (size_t)kTile * D * elem);               // [kTile, D] C
    total = align16(v + (size_t)kTile * D * elem);
  }
};

// T: activation type; C: cache element type (T for K1, int8_t for K3, whose
// ks / vs are then non-null).  Block (bg, split) walks tiles [split * tpb,
// (split + 1) * tpb) of its group with every query row.
// Four blocks an SM: the merge at the end may spill, the walk does not.
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads, 4) decode_fma_kernel(const Args a) {
  const int bg = blockIdx.x, split = blockIdx.y;
  const int b = bg / a.KH, g = bg % a.KH;
  const int M = a.M, S = a.S, D = a.D;
  const int G = a.H / a.KH, R = M * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const C* kc = static_cast<const C*>(a.kc);
  const C* vc = static_cast<const C*>(a.vc);
  const uint8_t* mask = a.mask;
  const bool scaled = a.ks != nullptr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int flag;
  const FmaSmem lay(R, D, sizeof(C));
  float* q_s = reinterpret_cast<float*>(smem_raw + lay.q);
  float* acc_s = reinterpret_cast<float*>(smem_raw + lay.acc);
  float* m_s = reinterpret_cast<float*>(smem_raw + lay.stat);
  float* l_s = m_s + R;
  float* alpha_s = l_s + R;
  float* p_s = reinterpret_cast<float*>(smem_raw + lay.p);
  float* ks_s = reinterpret_cast<float*>(smem_raw + lay.ks);
  float* vs_s = reinterpret_cast<float*>(smem_raw + lay.vs);
  C* k_s = reinterpret_cast<C*>(smem_raw + lay.k);
  C* v_s = reinterpret_cast<C*>(smem_raw + lay.v);

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int m = r / G, j = r - m * G;
    q_s[i] = to_f(q[(((size_t)b * M + m) * a.H + g * G + j) * D + d]) * a.scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int n_tiles = (S + kTile - 1) / kTile;
  const int t_end = min(n_tiles, (split + 1) * a.tpb);
  for (int t = split * a.tpb; t < t_end; ++t) {
    const int s0 = t * kTile;
    const int n = min(kTile, S - s0);
    // Skip the tile when no member attends any of its slots.
    int seen = 0;
    for (int i = tid; i < M * n; i += kThreads) {
      const int m = i / n, s = i - m * n;
      seen |= mask[((size_t)b * M + m) * S + s0 + s];
    }
    if (!__syncthreads_or(seen)) continue;

    // The group's K and V panels for this tile, every load in flight at once,
    // and for an int8 cache the tile's scale rows.
    const size_t row0 = (((size_t)b * S + s0) * a.KH + g) * D;
    load_rows(k_s, kc + row0, (size_t)a.KH * D, n, D);
    load_rows(v_s, vc + row0, (size_t)a.KH * D, n, D);
    if (scaled) {
      const size_t srow = ((size_t)b * a.KH + g) * S + s0;
      for (int s = tid; s < n; s += kThreads) {
        ks_s[s] = a.ks[srow + s];
        vs_s[s] = a.vs[srow + s];
      }
    }
    __syncthreads();

    // Scores: one warp per slot, lanes across D; every query row of the
    // group reads the slot's key once.
    for (int s = warp; s < n; s += kWarps) {
      const C* krow = k_s + s * D;
      float kv[kMaxDPerLane];
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        kv[i] = d < D ? to_f(krow[d]) : 0.f;
      }
      for (int r = 0; r < R; ++r) {
        const float* qr = q_s + r * D;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxDPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc += qr[d] * kv[i];
        }
        acc = warp_sum(acc);
        if (lane == 0) {
          const int m = r / G;
          const bool on = mask[((size_t)b * M + m) * S + s0 + s] != 0;
          p_s[r * kTile + s] = on ? (scaled ? acc * ks_s[s] : acc) : -INFINITY;
        }
      }
    }
    __syncthreads();

    // The running softmax statistics per row: one warp per row.  The sum
    // takes the unscaled exponentials; PV reads them times the value scale.
    for (int r = warp; r < R; r += kWarps) {
      float* pr = p_s + r * kTile;
      float mx = m_s[r];
      for (int s = lane; s < n; s += 32) mx = fmaxf(mx, pr[s]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int s = lane; s < n; s += 32) {
        const float sc = pr[s];
        const float e = sc == -INFINITY ? 0.f : expf(sc - mx);
        pr[s] = scaled ? e * vs_s[s] : e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_s[r] == -INFINITY ? 0.f : expf(m_s[r] - mx);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();

    // The running unnormalised PV.
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* pr = p_s + r * kTile;
      float acc = 0.f;
      for (int s = 0; s < n; ++s) acc += pr[s] * to_f(v_s[s * D + d]);
      acc_s[i] = acc_s[i] * alpha_s[r] + acc;
    }
    __syncthreads();
  }

  const size_t pbase = ((size_t)bg * a.nsplit + split) * R;
  for (int r = tid; r < R; r += kThreads) {
    a.part_m[pbase + r] = m_s[r];
    a.part_l[pbase + r] = l_s[r];
  }
  for (int i = tid; i < R * D; i += kThreads) a.part_acc[pbase * D + i] = acc_s[i];
  if (arrive_last(a.counters + (size_t)bg * ((R + kMmaRows - 1) / kMmaRows), a.nsplit, &flag)) {
    if (D % 4 == 0) {
      merge_pieces<T, 4>(a, bg, 0, R);
    } else {
      merge_pieces<T, 1>(a, bg, 0, R);
    }
  }
}

// ---- tensor cores ---------------------------------------------------------------

// d += a . b on one m16n8k16 tile (bf16 in, fp32 sums).  With group = lane / 4
// and t = lane % 4: a[0] is row group, columns 2t, 2t+1; a[1] row group+8;
// a[2], a[3] the same rows at columns 2t+8, 2t+9.  b0 is rows 2t, 2t+1 of
// column group, b1 rows 2t+8, 2t+9.  d[0], d[1] are row group, columns 2t,
// 2t+1; d[2], d[3] row group+8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 matrices of 16-bit elements: lane l gives the address of row l % 8
// of matrix l / 8 (16 bytes); lane (group, t) receives from matrix i, in r[i],
// the elements [group][2t] (low half) and [group][2t + 1]; with .trans the
// elements [2t][group] and [2t + 1][group].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from global to shared memory without passing through registers;
// with `in` false nothing is read and the 16 bytes are zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bytes i and j of w, int8 values biased by 128 (w = raw ^ 0x80808080), as two
// bf16 values (exact): a byte in the mantissa of 2^23 is 2^23 + byte.
template <int I, int J>
__device__ __forceinline__ uint32_t biased_bytes_bf16x2(uint32_t w) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + I)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + J)) - 8388736.f;
  return pack_bf16(lo, hi);
}

// Shared-memory layout of decode_mma_kernel, in bytes.  The warps' rings come
// first; when the walk is over, the warps' states and then the merge's weights
// take their place.
struct MmaSmem {
  size_t row, sub, ring, work, mask, total;
  __host__ __device__ MmaSmem(size_t elem, int M, int tpb) {
    row = kMmaD * elem + 16;                        // a K or V row, padded against bank conflicts
    sub = kSub * row;                               // a warp's K (or V) sub-tile
    ring = (size_t)kWarps * kStages * 2 * sub;      // [warp][stage][K, V]
    const size_t reduce = (size_t)kWarps * kMmaRows * (kLdo + 2) * sizeof(float);
    work = align16(ring > reduce ? ring : reduce);
    mask = work;                                    // [M, tpb * kTile] bytes
    total = align16(mask + (size_t)M * tpb * kTile);
  }
};

// C: cache element type, bf16 (K1) or int8_t (K3).  Block (bg, split, mt)
// walks tiles [split * tpb, (split + 1) * tpb) of its group with query rows
// [16 mt, 16 mt + 16).
// Three blocks an SM, which their shared memory allows too: the card then holds
// every block of the LLaVA-1.5 grid at once.
template <typename C>
__global__ void __launch_bounds__(kThreads, 3) decode_mma_kernel(const Args a) {
  constexpr bool kInt8 = sizeof(C) == 1;
  constexpr int D = kMmaD;
  const int bg = blockIdx.x, split = blockIdx.y;
  const int b = bg / a.KH, g = bg % a.KH;
  const int M = a.M, S = a.S;
  const int G = a.H / a.KH, R = M * G;
  const int row0 = blockIdx.z * kMmaRows, nrows = min(kMmaRows, R - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const int NS = a.tpb * kTile;       // slots this block walks
  const int s_base = split * NS;      // the first of them

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int flag;
  const MmaSmem lay(sizeof(C), M, a.tpb);
  uint8_t* mask_s = smem_raw + lay.mask;

  // The block's mask bytes, once; slots past S count as masked.
  for (int i = tid; i < M * NS; i += kThreads) {
    const int m = i / NS, s = s_base + (i - m * NS);
    mask_s[i] = s < S ? a.mask[((size_t)b * M + m) * S + s] : 0;
  }

  // This thread's rows of q as A fragments, one per 16 head dims.  For an
  // int8 cache the contraction index inside a k-step is permuted: a thread's
  // columns 2t, 2t+1, 2t+8, 2t+9 are head dims 4t .. 4t+3, the four bytes one
  // 32-bit read of a key row gives.
  uint32_t qa[D / 16][4];
  {
    const bf16* q = static_cast<const bf16*>(a.q);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + gr + 8 * half;
      const int m = r / G, j = r - m * G;
      const uint32_t* qrow =
          reinterpret_cast<const uint32_t*>(q + (((size_t)b * M + m) * a.H + g * G + j) * D);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c0 = kInt8 ? 8 * ks + 2 * tg : 8 * ks + tg;      // in 32-bit words
        const int c1 = kInt8 ? c0 + 1 : c0 + 4;
        qa[ks][half] = r < R ? __ldg(qrow + c0) : 0u;
        qa[ks][2 + half] = r < R ? __ldg(qrow + c1) : 0u;
      }
    }
  }
  // the members of this thread's two rows, for the mask
  const int r_lo = row0 + gr, r_hi = row0 + gr + 8;
  const uint8_t* mrow_lo = mask_s + (size_t)(r_lo < R ? r_lo / G : 0) * NS;
  const uint8_t* mrow_hi = mask_s + (size_t)(r_hi < R ? r_hi / G : 0) * NS;
  const bool on_lo = r_lo < R, on_hi = r_hi < R;
  __syncthreads();

  // Sub-tile j of this warp: slots s_base + j * kTile + warp * kSub + [0, kSub).
  // It is live when a member attends one of its slots.
  auto live = [&](int j) {
    int seen = 0;
    const int s = j * kTile + warp * kSub + (lane & (kSub - 1));
    for (int m = lane / kSub; m < M; m += 32 / kSub) seen |= mask_s[m * NS + s];
    return __any_sync(0xffffffffu, seen) != 0;
  };
  auto next_live = [&](int j) {
    while (j < a.tpb && !live(j)) ++j;
    return j;
  };

  const uint32_t ring = smem_u32(smem_raw) + warp * kStages * 2 * (uint32_t)lay.sub;
  const C* kc = static_cast<const C*>(a.kc);
  const C* vc = static_cast<const C*>(a.vc);
  constexpr int kChunks = D * sizeof(C) / 16;  // 16-byte words of a row
  // Starts the copies of sub-tile j into a stage: K as one group, V as the next.
  auto issue = [&](int j, int stage) {
    const int s0 = s_base + j * kTile + warp * kSub;
    const uint32_t k_s = ring + stage * 2 * (uint32_t)lay.sub;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const C* src = which ? vc : kc;
      const uint32_t dst = k_s + which * (uint32_t)lay.sub;
      for (int i = lane; i < kSub * kChunks; i += 32) {
        const int row = i / kChunks, c = i - row * kChunks;
        const bool in = s0 + row < S;
        const C* p = in ? src + (((size_t)b * S + s0 + row) * a.KH + g) * D + c * (16 / sizeof(C))
                        : src;
        cp_async16(dst + row * (uint32_t)lay.row + c * 16, p, in);
      }
      cp_async_commit();
    }
  };

  // The warp's running softmax over its slots: rows gr (lo) and gr + 8 (hi).
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[D / 8][4];  // n-tile n: head dims 8 n + 2t, 2t+1 (an int8 cache permutes them)
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  int j = next_live(0), stage = 0;
  const bool walked = j < a.tpb;
  if (walked) issue(j, 0);
  while (j < a.tpb) {
    const int jn = next_live(j + 1);
    if (jn < a.tpb) issue(jn, stage ^ 1);
    const int s_loc = j * kTile + warp * kSub;  // of the block's slots
    float ksc[4], vsc[4];  // scales of slots 2t, 2t+1, 2t+8, 2t+9 of the sub-tile
    if constexpr (kInt8) {
      const size_t srow = ((size_t)b * a.KH + g) * S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s_base + s_loc + 2 * tg + (i & 1) + 8 * (i >> 1);
        ksc[i] = s < S ? __ldg(a.ks + srow + s) : 0.f;
        vsc[i] = s < S ? __ldg(a.vs + srow + s) : 0.f;
      }
    }
    if (jn < a.tpb) cp_async_wait<3>(); else cp_async_wait<1>();  // K of sub-tile j is in
    __syncwarp();
    const uint32_t k_s = ring + stage * 2 * (uint32_t)lay.sub;
    const uint32_t v_s = k_s + (uint32_t)lay.sub;

    // scores of 16 rows x 16 slots: n-tile 0 slots 0-7, n-tile 1 slots 8-15
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      if constexpr (kInt8) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t w;
          asm volatile("ld.shared.u32 %0, [%1];\n"
                       : "=r"(w)
                       : "r"(k_s + (8 * nt + gr) * (uint32_t)lay.row + 16 * ks + 4 * tg));
          w ^= 0x80808080u;
          mma_bf16(sc[nt], qa[ks], biased_bytes_bf16x2<0, 1>(w), biased_bytes_bf16x2<2, 3>(w));
        }
      } else {
        uint32_t kb[4];  // (slots 0-7, dims 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
        ldmatrix_x4(kb, k_s + ((lane & 7) + 8 * (lane >> 4)) * (uint32_t)lay.row +
                            (16 * ks + 8 * ((lane >> 3) & 1)) * 2);
        mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
        mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
      }
    }

    // mask, running max, exponentials.  sc[nt][i]: row gr + 8 (i >> 1), slot
    // 8 nt + 2 tg + (i & 1) of the sub-tile
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s_loc + 8 * nt + 2 * tg + (i & 1);
        const bool hi = i >> 1;
        const bool on = hi ? (on_hi && mrow_hi[s]) : (on_lo && mrow_lo[s]);
        float v = sc[nt][i] * a.scale;
        if constexpr (kInt8) v *= ksc[2 * nt + (i & 1)];
        sc[nt][i] = on ? v : -INFINITY;
        if (hi) mx_hi = fmaxf(mx_hi, sc[nt][i]); else mx_lo = fmaxf(mx_lo, sc[nt][i]);
      }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = m_lo == -INFINITY ? 0.f : __expf(m_lo - mn_lo);
    const float al_hi = m_hi == -INFINITY ? 0.f : __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hi = i >> 1;
        const float e = sc[nt][i] == -INFINITY ? 0.f : __expf(sc[nt][i] - (hi ? mn_hi : mn_lo));
        if (hi) sum_hi += e; else sum_lo += e;
        sc[nt][i] = kInt8 ? e * vsc[2 * nt + (i & 1)] : e;
      }
    l_lo = l_lo * al_lo + sum_lo;  // this thread's slots; the quad is added after the walk
    l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al_lo;
      o[n][1] *= al_lo;
      o[n][2] *= al_hi;
      o[n][3] *= al_hi;
    }
    // the probabilities, rounded to bf16, are the A fragment of PV as they lie
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[0][0], sc[0][1]);
    pa[1] = pack_bf16(sc[0][2], sc[0][3]);
    pa[2] = pack_bf16(sc[1][0], sc[1][1]);
    pa[3] = pack_bf16(sc[1][2], sc[1][3]);

    if (jn < a.tpb) cp_async_wait<2>(); else cp_async_wait<0>();  // V of sub-tile j is in
    __syncwarp();
    if constexpr (kInt8) {
      // One .trans read of 16 slots x 32 dims, bytes taken as 16-bit pairs: a
      // register holds slots 2t, 2t+1 at dims 2 gr, 2 gr + 1 of a 16-dim span.
      // Bytes 0 and 2 are the B fragment of the span's even dims, 1 and 3 of its
      // odd dims: n-tile 4 it + 2 span + odd holds dims 32 it + 16 span + 2 j + odd.
#pragma unroll
      for (int it = 0; it < D / 32; ++it) {
        uint32_t vb[4];  // (slots 0-7, span 0), (8-15, span 0), (0-7, span 1), (8-15, span 1)
        ldmatrix_x4_trans(vb, v_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * (uint32_t)lay.row +
                                  32 * it + 16 * (lane >> 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) vb[i] ^= 0x80808080u;
#pragma unroll
        for (int span = 0; span < 2; ++span) {
          mma_bf16(o[4 * it + 2 * span], pa, biased_bytes_bf16x2<0, 2>(vb[2 * span]),
                   biased_bytes_bf16x2<0, 2>(vb[2 * span + 1]));
          mma_bf16(o[4 * it + 2 * span + 1], pa, biased_bytes_bf16x2<1, 3>(vb[2 * span]),
                   biased_bytes_bf16x2<1, 3>(vb[2 * span + 1]));
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < D / 16; ++it) {
        uint32_t vb[4];  // (slots 0-7, dims 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        ldmatrix_x4_trans(vb, v_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * (uint32_t)lay.row +
                                  (16 * it + 8 * (lane >> 4)) * 2);
        mma_bf16(o[2 * it], pa, vb[0], vb[1]);
        mma_bf16(o[2 * it + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane is done with the stage before it is filled again
    j = jn;
    stage ^= 1;
  }
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);

  const size_t pbase = ((size_t)bg * a.nsplit + split) * R + row0;
  const int mtiles = (R + kMmaRows - 1) / kMmaRows;
  int* counter = a.counters + (size_t)bg * mtiles + blockIdx.z;
  if (!__syncthreads_or(walked)) {
    // no member attends any slot of this block: an empty piece, which the
    // merge passes over without reading its sums
    if (tid < nrows) {
      a.part_m[pbase + tid] = -INFINITY;
      a.part_l[pbase + tid] = 0.f;
    }
    if (arrive_last(counter, a.nsplit, &flag)) merge_pieces<bf16, 4>(a, bg, row0, nrows);
    return;
  }

  // The warps' states through shared memory (the rings are done with): the
  // block's max and sum per row, the PV sums rescaled to it and added in warp
  // order.
  float* red_o = reinterpret_cast<float*>(smem_raw);             // [kWarps][16][kLdo]
  float* red_m = red_o + kWarps * kMmaRows * kLdo;               // [kWarps][16]
  float* red_l = red_m + kWarps * kMmaRows;                      // [kWarps][16]
  if (tg == 0) {
    red_m[warp * kMmaRows + gr] = m_lo;
    red_m[warp * kMmaRows + gr + 8] = m_hi;
    red_l[warp * kMmaRows + gr] = l_lo;
    red_l[warp * kMmaRows + gr + 8] = l_hi;
  }
  __syncthreads();
  float mb_lo = -INFINITY, mb_hi = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mb_lo = fmaxf(mb_lo, red_m[w * kMmaRows + gr]);
    mb_hi = fmaxf(mb_hi, red_m[w * kMmaRows + gr + 8]);
  }
  const float w_lo = m_lo == -INFINITY ? 0.f : __expf(m_lo - mb_lo);
  const float w_hi = m_hi == -INFINITY ? 0.f : __expf(m_hi - mb_hi);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the head dim of accumulator i of n-tile n
      const int d = kInt8 ? 32 * (n >> 2) + 16 * ((n >> 1) & 1) + 4 * tg + 2 * (i & 1) + (n & 1)
                          : 8 * n + 2 * tg + (i & 1);
      red_o[(warp * kMmaRows + gr + 8 * (i >> 1)) * kLdo + d] = o[n][i] * (i >> 1 ? w_hi : w_lo);
    }
  __syncthreads();
  if (tid < nrows) {
    float mb = -INFINITY, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, red_m[w * kMmaRows + tid]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_m[w * kMmaRows + tid];
      if (mw != -INFINITY) lb += red_l[w * kMmaRows + tid] * __expf(mw - mb);
    }
    a.part_m[pbase + tid] = mb;
    a.part_l[pbase + tid] = lb;
  }
  for (int e = tid; e < nrows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red_o[(w * kMmaRows + r) * kLdo + d];
    a.part_acc[(pbase + r) * D + d] = v;
  }
  if (arrive_last(counter, a.nsplit, &flag)) merge_pieces<bf16, 4>(a, bg, row0, nrows);
}

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory one Hopper block may use

template <typename T, typename C>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int R = a.M * (a.H / a.KH);
  const int n_tiles = (a.S + kTile - 1) / kTile;
  if (a.tpb < 1 || a.nsplit != (n_tiles + a.tpb - 1) / a.tpb || a.nsplit > kMaxSplits)
    return cudaErrorInvalidValue;
  // the tensor-core kernel: bf16 activations, D = 128, operands on 16-byte boundaries
  bool mma = false;
  if constexpr (sizeof(T) == 2) {
    mma = a.D == kMmaD && reinterpret_cast<uintptr_t>(a.kc) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.vc) % 16 == 0 && reinterpret_cast<uintptr_t>(a.q) % 4 == 0;
  }
  if (mma) {
    if constexpr (sizeof(T) == 2) {
      const size_t smem = MmaSmem(sizeof(C), a.M, a.tpb).total;
      if (smem > kMaxSmem) return cudaErrorInvalidValue;
      cudaError_t e = cudaFuncSetAttribute(decode_mma_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      decode_mma_kernel<C><<<dim3(B * a.KH, a.nsplit, (R + kMmaRows - 1) / kMmaRows), kThreads,
                             smem, stream>>>(a);
    }
  } else {
    const size_t smem = FmaSmem(R, a.D, sizeof(C)).total;
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(decode_fma_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    decode_fma_kernel<T, C><<<dim3(B * a.KH, a.nsplit), kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch_dtype(int dtype, const Args& a, int B, cudaStream_t stream) {
  if (dtype == 0) {
    if constexpr (sizeof(C) == 1) return launch<float, int8_t>(a, B, stream);
    else return launch<float, float>(a, B, stream);
  }
  if (dtype == 1) {
    if constexpr (sizeof(C) == 1) return launch<bf16, int8_t>(a, B, stream);
    else return launch<bf16, bf16>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  A block walks tiles_per_block tiles of 64
// slots, so a (b, g) is cut into nsplit = ceil(ceil(S / 64) / tiles_per_block)
// blocks, whose pieces go through part_m, part_l [B * KH, nsplit, R] and
// part_acc [B * KH, nsplit, R, D] float32 (R = M * H / KH); counters [B * KH,
// ceil(R / 16)] int32 must be zero at the first launch, and the kernel leaves
// them zero.  Returns a cudaError_t (0 = success).
extern "C" int dd_ensemble_decode_attention(
    int dtype, const void* q, const void* k_cache, const void* v_cache, const void* k_new,
    const void* v_new, const void* key_mask, void* out, void* part_m, void* part_l,
    void* part_acc, void* counters, int B, int M, int H, int KH, int S, int D,
    int tiles_per_block, int nsplit, float scale, void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr, k_new, v_new,
               static_cast<const uint8_t*>(key_mask), out, static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<float*>(part_acc),
               static_cast<int*>(counters), M, H, KH, S, D, tiles_per_block, nsplit, scale};
  return (int)launch_dtype<float>(dtype, a, B, static_cast<cudaStream_t>(stream));
}

// K3: the int8 cache q leaves [B, S, KH, D] and their scales [B, KH, S];
// q and the new K/V in the activation dtype.
extern "C" int dd_ensemble_decode_attention_int8kv(
    int dtype, const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* k_new, const void* v_new, const void* key_mask, void* out, void* part_m,
    void* part_l, void* part_acc, void* counters, int B, int M, int H, int KH, int S, int D,
    int tiles_per_block, int nsplit, float scale, void* stream) {
  if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{q, kq, vq, static_cast<const float*>(ks), static_cast<const float*>(vs), k_new,
               v_new, static_cast<const uint8_t*>(key_mask), out, static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<float*>(part_acc),
               static_cast<int*>(counters), M, H, KH, S, D, tiles_per_block, nsplit, scale};
  return (int)launch_dtype<int8_t>(dtype, a, B, static_cast<cudaStream_t>(stream));
}

extern "C" const char* dd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
