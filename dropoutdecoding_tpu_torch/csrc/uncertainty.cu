// K2: visual-token uncertainty statistics and the top-k projection table for
// Hopper (sm_90a).
//
// Replaces the TPU kernel vision_uncertainty_fused
// (dropoutdecoding_tpu/ops/pallas_uncertainty.py:101; bodies _pass_a_kernel
// :44, _pass_b_kernel :69, _pass_c_kernel :85) and the top-k table that the
// JAX engine leaves to XLA beside it (exact_top_k_ids,
// dropoutdecoding_tpu/engine/generate.py:334).  For logits x [B, L, V] fp32
// and row weights w [B, L] (1/n_valid on rows in the mean, else 0):
//
//   pass A, per row i:  m_i = max_v x_iv,  Z_i = sum_v e^(x_iv - m_i),
//                       A_i = sum_v e^(x_iv - m_i) x_iv,
//                       B_i = sum_v e^(2 (x_iv - m_i)),
//                       the k columns with the largest x_iv, in the order
//                       (value descending, index ascending)
//   pass B, per column: pavg_v = sum_i w_i e^(x_iv - m_i) / Z_i
//   pass C, per row i:  C_i = sum_v p_iv log(pavg_v + 1e-10)
//
// A last small launch (finish_kernel) turns these into alea, var, epis and
// their image means, which the first version left to a score of PyTorch
// launches on [B, L] tensors.
//
// What bounds it on this card: the logits bytes.  pavg needs every row's
// (m_i, Z_i) and C_i needs the finished pavg, so the tensor is seen twice:
// two reads is the floor of the formula (44 us at LLaVA-1.5's 576 x 32064
// fp32, 73.9 MB; 224 us at LLaVA-NeXT's 2928 rows), one read the byte bound.
//
// The resident route (a row and its alignment slack fit kResMaxSpan floats):
//   launch 1, ab_resident_kernel: a fixed number of blocks an image, block g
//     walking rows g, g + G, ...  A producer thread brings each row in as 8 KB
//     chunks of a ring of kSlots (bulk copies onto mbarriers); a row takes at
//     most 16 slots, so the next row's first chunks fly while this one is
//     worked on.  The 16 consumer warps take (1) each thread's max as the
//     chunks land, and from the sorted thread maxima the row's max and a
//     threshold tau that at least k logits reach; (2) one sweep over the
//     resident row: e = 2^((x - m) log2 e) written over x, Z, A, B summed, the
//     few logits >= tau appended to a candidate list; (3) a second sweep that
//     adds w / Z e into 64 column sums a thread (registers; one reciprocal a
//     row) and frees the ring four chunks at a time.  A row with w = 0 skips
//     (3).  A selector warp ranks the candidates of row r into its top-k while
//     the consumers are at row r + 1.  No atomics on sums: the block stores
//     its [V] line of partial sums once.
//   launch 2, pavg_merge_kernel: the G lines summed in a fixed order,
//     log(sum + 1e-10) stored once.
//   launch 3, cross_resident_kernel: the same blocks walk their rows in
//     reverse (what launch 1 read last may still be in L2) with log pavg in
//     shared memory; each of 16 warps takes its share of a row with 16-byte
//     loads and never waits for another warp; finish_kernel adds the pieces of
//     a row in a fixed order.
// Rows that start off the 16-byte grid (V = 32001) are copied as the aligned
// span around them; the sweeps then walk columns, not 16-byte groups.
//
// What the first version of launch 1 taught (one online pass with expf and a
// sorted top-k list a warp): the SM runs out of instruction slots long before it
// runs out of bytes.  A row is 5 us of memory for an SM; 37 instructions a
// logit were 8 us, and an insertion into a warp's list 150 cycles.  Hence the
// row's max first, one ex2 a logit, 16-byte shared-memory accesses, and a
// threshold that lets about twenty logits of 32064 through to a ranking.
//
// The streaming route (longer rows, or a base off the 16-byte grid) keeps
// three reads: stats_kernel, pavg_partial_kernel, pavg_reduce_kernel,
// cross_kernel; its table is a fourth, topk_stream_kernel, made of the two
// routines that rank a row of the resident route.
//
// Logits are finite by contract; among -inf logits both routes take the lower
// index first and never repeat one (jax.lax.top_k's answer, where k rounds of
// argmax repeat an index).  A row with more than kCandCap logits >= tau
// (thousands tied at the k-th value) is ranked again from global memory.
//
// Registers (ptxas -v, sm_90a): ab_resident_kernel has 18 warps, five on one
// of the SM's four partitions, so at most 96 registers a thread: 96 used (64
// of them column sums), 12 to 56 bytes spilled.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;      // streaming route
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // loads in flight per thread in pass A
constexpr int kRowsPerBlock = 32;  // rows per block in pass B
constexpr float kEps = 1e-10f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxTopK = 16;

constexpr int kResThreads = 512;   // consumer threads of the resident route
constexpr int kResWarps = kResThreads / 32;
constexpr int kResCols = 64;       // column sums a thread
constexpr int kResMaxSpan = 32768; // = kResThreads * kResCols floats a row
constexpr int kChunk = 2048;       // floats a ring slot (8 KB)
constexpr int kSlots = 27;         // ring slots: 216 KB
constexpr int kMergeSlices = 8;    // warps a block of pavg_merge_kernel
constexpr int kAbThreads = kResThreads + 64;  // + the producer's and the selector's warp
constexpr int kCandCap = 256;      // top-k candidates a row kept in shared memory
constexpr int kFinishThreads = 1024;
constexpr int kCrossThreads = 512;  // cross_resident_kernel
constexpr int kPieces = kCrossThreads / 32;  // pieces of a row's C, a warp each

static_assert(kResThreads * kResCols == kResMaxSpan, "a thread a column");
static_assert(kResMaxSpan / kChunk <= kSlots, "a row must fit the ring");
static_assert(kChunk == 4 * kResThreads, "one float4 a thread a chunk");

struct Stats {
  float m, z, a, b;
};

// Merge two online-softmax partials, rescaling to the larger max.
__device__ __forceinline__ Stats merge(Stats s, Stats t) {
  if (t.m == -INFINITY) return s;
  if (s.m == -INFINITY) return t;
  const float mn = fmaxf(s.m, t.m);
  const float fs = expf(s.m - mn), ft = expf(t.m - mn);
  return {mn, s.z * fs + t.z * ft, s.a * fs + t.a * ft, s.b * fs * fs + t.b * ft * ft};
}

__device__ __forceinline__ Stats warp_merge(Stats s) {
  for (int o = 16; o > 0; o >>= 1) {
    Stats t;
    t.m = __shfl_xor_sync(0xffffffffu, s.m, o);
    t.z = __shfl_xor_sync(0xffffffffu, s.z, o);
    t.a = __shfl_xor_sync(0xffffffffu, s.a, o);
    t.b = __shfl_xor_sync(0xffffffffu, s.b, o);
    s = merge(s, t);
  }
  return s;
}

// Adds four values to a thread's online statistics: one rescale a group.
__device__ __forceinline__ void take4(Stats& s, const float (&x)[4], const bool (&ok)[4]) {
  float tm = -INFINITY;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (ok[u]) tm = fmaxf(tm, x[u]);
  if (tm > s.m) {  // rescale the running sums to the new max
    const float f = expf(s.m - tm);  // 0 on the first group
    s = {tm, s.z * f, s.a * f, s.b * f * f};
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (ok[u]) {
      const float e = expf(x[u] - s.m);
      s.z += e;
      s.a += e * x[u];
      s.b += e * e;
    }
  }
}

// (av, ai) comes before (bv, bi): the larger value, then the lower index.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// A warp's sorted candidate list, entry j in lane j; (tv, ti) is entry k - 1.
struct TopK {
  float v;
  int i;
  float tv;
  int ti;
};

__device__ __forceinline__ TopK topk_empty() { return {-INFINITY, INT_MAX, -INFINITY, INT_MAX}; }

// Every lane offers (x, idx) where ok; all lanes of the warp call together.
__device__ __forceinline__ void topk_offer(TopK& t, float x, int idx, bool ok, int k) {
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(0xffffffffu, ok && before(x, idx, t.tv, t.ti));
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const float cv = __shfl_sync(0xffffffffu, x, src);
    const int ci = __shfl_sync(0xffffffffu, idx, src);
    if (!before(cv, ci, t.tv, t.ti)) continue;  // the list moved on
    // the entries that stay ahead of the candidate are a prefix of the lanes
    const int p = __popc(__ballot_sync(0xffffffffu, before(t.v, t.i, cv, ci)));
    const float uv = __shfl_up_sync(0xffffffffu, t.v, 1);
    const int ui = __shfl_up_sync(0xffffffffu, t.i, 1);
    if (lane == p) {
      t.v = cv;
      t.i = ci;
    } else if (lane > p) {
      t.v = uv;
      t.i = ui;
    }
    t.tv = __shfl_sync(0xffffffffu, t.v, k - 1);
    t.ti = __shfl_sync(0xffffffffu, t.i, k - 1);
  }
}

// ---- the resident route -----------------------------------------------------

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kResThreads) : "memory");
}

struct RowSpan {
  size_t a0;   // first float of the aligned span around the row
  int shift;   // the row's first column in the span (0..3)
  int chunks;  // ring slots the span takes
  int span;    // floats of the span (a multiple of 4)
};

__device__ __forceinline__ RowSpan row_span(size_t row, int V) {
  const size_t e0 = row * (size_t)V;
  RowSpan r;
  r.shift = (int)(e0 & 3);
  r.a0 = e0 - r.shift;
  r.span = (r.shift + V + 3) & ~3;
  r.chunks = (r.span + kChunk - 1) / kChunk;
  return r;
}

// 2^x, the hardware's approximation (2 ulp); exponents below -126 give 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 32 values of a warp sorted descending, lane 0 the largest (bitonic).
__device__ __forceinline__ float warp_sort_desc(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, v, j);
      const bool keep_max = ((lane & size) == 0) == ((lane & j) == 0);
      v = keep_max ? fmaxf(v, other) : fminf(v, other);
    }
  }
  return v;
}

// The first 16 lanes' values reduced into every lane, in a fixed order.
__device__ __forceinline__ float max16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);
}
__device__ __forceinline__ float sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// The selector's work for one row: the k first of n candidates in the order
// (value descending, index ascending), each by its rank among them all.
__device__ __forceinline__ void select_by_rank(const float2* cand, int n, int k,
                                               int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    const float2 own = c < n ? cand[c] : make_float2(0.f, 0.f);
    const int i = __float_as_int(own.y);
    int rank = 0;
#pragma unroll 4
    for (int d = 0; d < n; ++d) {
      const float2 q = cand[d];  // one address a warp: a broadcast
      rank += before(q.x, __float_as_int(q.y), own.x, i) ? 1 : 0;
    }
    if (c < n && rank < k) out[rank] = i;
  }
}

// A warp's sorted top-k of the columns [v0, v1) of a row in global memory.
__device__ __forceinline__ TopK warp_topk(const float* __restrict__ xr, int v0, int v1, int k) {
  const int lane = threadIdx.x & 31;
  TopK t = topk_empty();
  for (int c0 = v0; c0 < v1; c0 += 32 * 8) {  // eight loads in flight a lane
    float xs[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int v = c0 + 32 * u + lane;
      xs[u] = v < v1 ? xr[v] : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int v = c0 + 32 * u + lane;
      const bool ok = v < v1;
      if (__any_sync(0xffffffffu, ok && xs[u] >= t.tv)) topk_offer(t, xs[u], v, ok, k);
    }
  }
  return t;
}

// The selector's work for a row whose candidates overflowed their buffer
// (thousands of logits tied at the threshold): the whole row again.
__device__ __forceinline__ void select_from_row(const float* __restrict__ xr, int V, int k,
                                                int* __restrict__ out) {
  const TopK t = warp_topk(xr, 0, V, k);
  if ((threadIdx.x & 31) < k) out[threadIdx.x & 31] = t.i;
}

// Launch 1.  grid (G, B); warps 0..15 consume, warp 16 produces (one lane),
// warp 17 selects the top-k.  Per row: (1) each thread's max as the chunks
// land; from the sorted thread maxima the block's max m and a threshold tau
// that at least k logits reach, so that the top-k are among the logits >= tau,
// about twenty of 32064; (2) a sweep over the resident row: e = 2^((x - m)
// log2 e) written over x, Z, A, B summed, the logits >= tau appended to the
// candidates; (3) a second sweep adds w / Z e into the thread's 64 column
// sums and frees the ring.  The selector ranks the candidates of row r while
// the consumers are at row r + 1.  kAligned: V is a multiple of 4, every row
// starts on the 16-byte grid and a thread owns four neighbouring columns of
// every chunk; else it owns the columns tid + 512 j, wherever the row starts.
template <bool kAligned>
__global__ void __launch_bounds__(kAbThreads, 1) ab_resident_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float w_all,
    float* __restrict__ m_out, float* __restrict__ z_out, float* __restrict__ a_out,
    float* __restrict__ b_out, int* __restrict__ topk_out, float* __restrict__ part, int L,
    int V, int Vp, int k, size_t total) {
  extern __shared__ __align__(128) unsigned char smem_ab[];
  float* ring = reinterpret_cast<float*>(smem_ab);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSlots * kChunk);
  uint64_t* empty = full + kSlots;
  uint64_t* cand_full = empty + kSlots;   // [2]: a row's candidates are all in
  uint64_t* cand_empty = cand_full + 2;   // [2]: the selector is done with them
  float* red = reinterpret_cast<float*>(cand_empty + 2);  // [2][5][kResWarps]
  float2* cand = reinterpret_cast<float2*>(red + 2 * 5 * kResWarps);  // [2][kCandCap]: x, column
  int* cand_n = reinterpret_cast<int*>(cand + 2 * kCandCap);          // [2]

  const int G = gridDim.x, g = blockIdx.x, img = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrows = (L - g + G - 1) / G;

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kResWarps);
    }
    for (int p = 0; p < 2; ++p) {
      hopper::mbar_init(&cand_full[p], kResWarps);
      hopper::mbar_init(&cand_empty[p], 1);
      cand_n[p] = 0;
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kResWarps) {  // the producer
    if (lane != 0) return;
    const size_t total4 = total & ~(size_t)3;
    int slot = 0, phase = 0;
    for (int n = 0; n < nrows; ++n) {
      const RowSpan r = row_span((size_t)img * L + g + (size_t)n * G, V);
      for (int c = 0; c < r.chunks; ++c) {
        hopper::mbar_wait(&empty[slot], phase ^ 1);  // passes on the slot's first use
        float* dst = ring + slot * kChunk;
        const size_t src = r.a0 + (size_t)c * kChunk;
        size_t end = src + min(kChunk, r.span - c * kChunk);
        if (end > total4) {
          // the tensor ends off the 16-byte grid inside this span: its last
          // floats are copied one by one, the bulk copy stops before them
          for (size_t e = max(src, total4); e < total; ++e) dst[e - src] = x[e];
          end = max(src, total4);
        }
        const uint32_t bytes = (uint32_t)(end - src) * 4u;
        hopper::mbar_arrive_expect_tx(&full[slot], bytes);
        if (bytes) hopper::bulk_load(dst, x + src, bytes, &full[slot]);
        if (++slot == kSlots) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if (warp == kResWarps + 1) {  // the selector
    if (k == 0) return;
    for (int n = 0; n < nrows; ++n) {
      const int par = n & 1;
      const size_t row = (size_t)img * L + g + (size_t)n * G;
      hopper::mbar_wait(&cand_full[par], (n >> 1) & 1);
      const int count = cand_n[par];
      if (count <= kCandCap)
        select_by_rank(cand + par * kCandCap, count, k, topk_out + row * k);
      else
        select_from_row(x + row * (size_t)V, V, k, topk_out + row * k);
      __syncwarp();
      if (lane == 0) {
        cand_n[par] = 0;
        hopper::mbar_arrive(&cand_empty[par]);
      }
    }
    return;
  }

  float acc[kResCols];
#pragma unroll
  for (int j = 0; j < kResCols; ++j) acc[j] = 0.f;

  int slot = 0, phase = 0;
  for (int n = 0; n < nrows; ++n) {
    const size_t row = (size_t)img * L + g + (size_t)n * G;
    const RowSpan r = row_span(row, V);
    const int slot0 = slot;
    const int par = n & 1;
    float* rd = red + par * 5 * kResWarps;

    // (1) the thread's max, chunk by chunk as the copies land
    float tmax = -INFINITY;
    for (int c = 0; c < r.chunks; ++c) {
      hopper::mbar_wait(&full[slot], phase);
      const float4 q = reinterpret_cast<const float4*>(ring + slot * kChunk)[tid];
      const int t0 = c * kChunk + 4 * tid - r.shift;  // the column of q.x
      if (t0 >= 0 && t0 + 4 <= V) {
        tmax = fmaxf(fmaxf(tmax, fmaxf(q.x, q.y)), fmaxf(q.z, q.w));
      } else {  // the row's ends: the span's columns outside it are not its logits
        const float xs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if ((unsigned)(t0 + u) < (unsigned)V) tmax = fmaxf(tmax, xs[u]);
      }
      if (++slot == kSlots) {
        slot = 0;
        phase ^= 1;
      }
    }
    if (k > 0) {
      const float sorted = warp_sort_desc(tmax);
      if (lane == 0) rd[warp] = sorted;
      if (lane == k - 1) rd[kResWarps + warp] = sorted;
    } else {
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      if (lane == 0) rd[warp] = tmax;
    }
    consumer_sync();
    const float m = max16(lane < kResWarps ? rd[lane] : -INFINITY);
    // at least k logits are >= a warp's k-th largest thread max, and >= the
    // k-th largest of the sixteen warps' maxima: tau is the larger bound
    float tau = INFINITY;
    if (k > 0) {
      tau = max16(lane < kResWarps ? rd[kResWarps + lane] : -INFINITY);
      const float ranked = warp_sort_desc(lane < kResWarps ? rd[lane] : -INFINITY);
      tau = fmaxf(tau, __shfl_sync(0xffffffffu, ranked, k - 1));
    }

    // (2) e over x, the statistics, the candidates; first the selector must be
    // done with the candidates of row n - 2 (the wait passes for n < 2)
    if (k > 0) hopper::mbar_wait(&cand_empty[par], ((n >> 1) & 1) ^ 1);
    const float shift_m = -m * kLog2e;
    const int base = slot0 * kChunk + r.shift;
    float z = 0.f, a = 0.f, b = 0.f;
    if (kAligned) {  // a thread's four neighbouring columns of every chunk, two chunks a turn
#pragma unroll
      for (int c0 = 0; c0 < kResCols / 4; c0 += 2) {
        float4 q[2];
        float4* at[2];
        bool in[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          int sl = slot0 + c0 + u;
          if (sl >= kSlots) sl -= kSlots;
          at[u] = reinterpret_cast<float4*>(ring + sl * kChunk) + tid;
          in[u] = (c0 + u) * kChunk + 4 * tid < V;
          if (in[u]) q[u] = *at[u];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (in[u]) {
            float4 e;
            e.x = ex2(fmaf(q[u].x, kLog2e, shift_m));
            e.y = ex2(fmaf(q[u].y, kLog2e, shift_m));
            e.z = ex2(fmaf(q[u].z, kLog2e, shift_m));
            e.w = ex2(fmaf(q[u].w, kLog2e, shift_m));
            *at[u] = e;
            z += (e.x + e.y) + (e.z + e.w);
            a = fmaf(e.x, q[u].x, fmaf(e.y, q[u].y, fmaf(e.z, q[u].z, fmaf(e.w, q[u].w, a))));
            b = fmaf(e.x, e.x, fmaf(e.y, e.y, fmaf(e.z, e.z, fmaf(e.w, e.w, b))));
            if (fmaxf(fmaxf(q[u].x, q[u].y), fmaxf(q[u].z, q[u].w)) >= tau) {
              const float xs[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
              const int v0 = (c0 + u) * kChunk + 4 * tid;
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                if (xs[t] >= tau) {
                  const int at_c = atomicAdd(&cand_n[par], 1);
                  if (at_c < kCandCap)
                    cand[par * kCandCap + at_c] = make_float2(xs[t], __int_as_float(v0 + t));
                }
              }
            }
          }
        }
      }
    } else {  // a thread's columns tid + 512 j, wherever the row starts
#pragma unroll
      for (int jb = 0; jb < kResCols; jb += 4) {  // four loads in flight, then their stores
        float xs[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = tid + kResThreads * (jb + u);
          int at = base + v;
          if (at >= kSlots * kChunk) at -= kSlots * kChunk;
          xs[u] = v < V ? ring[at] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = tid + kResThreads * (jb + u);
          if (v < V) {
            int at = base + v;
            if (at >= kSlots * kChunk) at -= kSlots * kChunk;
            const float e = ex2(fmaf(xs[u], kLog2e, shift_m));
            ring[at] = e;
            z += e;
            a = fmaf(e, xs[u], a);
            b = fmaf(e, e, b);
            if (xs[u] >= tau) {
              const int at_c = atomicAdd(&cand_n[par], 1);
              if (at_c < kCandCap)
                cand[par * kCandCap + at_c] = make_float2(xs[u], __int_as_float(v));
            }
          }
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      z += __shfl_xor_sync(0xffffffffu, z, o);
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    __syncwarp();  // the warp's candidates are written
    if (lane == 0) {
      rd[2 * kResWarps + warp] = z;
      rd[3 * kResWarps + warp] = a;
      rd[4 * kResWarps + warp] = b;
      if (k > 0) hopper::mbar_arrive(&cand_full[par]);
    }
    consumer_sync();
    // every warp adds the sixteen partials the same way: the same bits
    const float zs = sum16(lane < kResWarps ? rd[2 * kResWarps + lane] : 0.f);
    if (warp == 0) {
      const float as = sum16(lane < kResWarps ? rd[3 * kResWarps + lane] : 0.f);
      const float bs = sum16(lane < kResWarps ? rd[4 * kResWarps + lane] : 0.f);
      if (lane == 0) {
        m_out[row] = m;
        z_out[row] = zs;
        a_out[row] = as;
        b_out[row] = bs;
      }
    }

    // (3) the column sums, from the e this thread wrote; a row out of the mean
    // adds nothing.  Chunk c is done when the columns below 2048 (c + 1) are.
    const float wi = w != nullptr ? w[row] : w_all;
    const float scale = wi * (1.f / zs);
    // the slots were written by these threads and are next written by a bulk copy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (kAligned) {  // four chunks a turn: their loads fly together, then their slots go
#pragma unroll
      for (int c0 = 0; c0 < kResCols / 4; c0 += 4) {
        float4 e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          int sl = slot0 + c0 + u;
          if (sl >= kSlots) sl -= kSlots;
          e[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (wi != 0.f && (c0 + u) * kChunk + 4 * tid < V)
            e[u] = reinterpret_cast<const float4*>(ring + sl * kChunk)[tid];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[4 * (c0 + u) + 0] = fmaf(scale, e[u].x, acc[4 * (c0 + u) + 0]);
          acc[4 * (c0 + u) + 1] = fmaf(scale, e[u].y, acc[4 * (c0 + u) + 1]);
          acc[4 * (c0 + u) + 2] = fmaf(scale, e[u].z, acc[4 * (c0 + u) + 2]);
          acc[4 * (c0 + u) + 3] = fmaf(scale, e[u].w, acc[4 * (c0 + u) + 3]);
        }
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            int sl = slot0 + c0 + u;
            if (sl >= kSlots) sl -= kSlots;
            if (c0 + u < r.chunks) hopper::mbar_arrive(&empty[sl]);
          }
        }
      }
    } else {
#pragma unroll
      for (int jb = 0; jb < kResCols; jb += 8) {
        if (wi != 0.f) {
          float es[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int v = tid + kResThreads * (jb + u);
            int at = base + v;
            if (at >= kSlots * kChunk) at -= kSlots * kChunk;
            es[u] = v < V ? ring[at] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[jb + u] = fmaf(scale, es[u], acc[jb + u]);
        }
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int c = jb >> 2; c < (jb >> 2) + 2; ++c) {
            if (c < r.chunks) {
              int sl = slot0 + c;
              if (sl >= kSlots) sl -= kSlots;
              hopper::mbar_arrive(&empty[sl]);
            }
          }
        }
      }
    }
  }

  float* line = part + ((size_t)img * G + g) * Vp;
  if (kAligned) {
#pragma unroll
    for (int c = 0; c < kResCols / 4; ++c) {
      const int v0 = c * kChunk + 4 * tid;
      if (v0 < V)
        *reinterpret_cast<float4*>(line + v0) =
            make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kResCols; ++j) {
      const int v = tid + kResThreads * j;
      if (v < Vp) line[v] = v < V ? acc[j] : 0.f;
    }
  }
}

// Launch 2.  grid (ceil(Vp / 4 / 32), B), 32 x kMergeSlices threads: a warp a
// slice of the G lines, a lane four columns; slices then lines in a fixed order.
__global__ void __launch_bounds__(32 * kMergeSlices) pavg_merge_kernel(
    const float* __restrict__ part, float* __restrict__ log_pavg, int G, int Vp) {
  __shared__ float4 sums[kMergeSlices][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int q = blockIdx.x * 32 + lane;
  const int img = blockIdx.y;
  const bool in = 4 * q < Vp;
  float4 s = {0.f, 0.f, 0.f, 0.f};
  if (in) {
    const float4* p = reinterpret_cast<const float4*>(part + (size_t)img * G * Vp) + q;
    const int per = (G + kMergeSlices - 1) / kMergeSlices;
    const int g1 = min(G, (slice + 1) * per);
#pragma unroll 8
    for (int g = slice * per; g < g1; ++g) {
      const float4 t = p[(size_t)g * (Vp / 4)];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
  }
  sums[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && in) {
    for (int j = 1; j < kMergeSlices; ++j) {
      const float4 t = sums[j][lane];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const float4 o = {logf(s.x + kEps), logf(s.y + kEps), logf(s.z + kEps), logf(s.w + kEps)};
    reinterpret_cast<float4*>(log_pavg + (size_t)img * Vp)[q] = o;
  }
}

// Launch 3.  grid (G, B), kCrossThreads threads, log pavg [Vp] in shared memory.
// Vec = 4: rows on the 16-byte grid, 16-byte loads; Vec = 1: any V.
template <int Vec>
__global__ void __launch_bounds__(kCrossThreads, 1) cross_resident_kernel(
    const float* __restrict__ x, const float* __restrict__ m,
    const float* __restrict__ log_pavg, float* __restrict__ cpart, int L, int V, int Vp) {
  extern __shared__ __align__(128) unsigned char smem_c[];
  float* lp = reinterpret_cast<float*>(smem_c);
  const int G = gridDim.x, g = blockIdx.x, img = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrows = (L - g + G - 1) / G;
  {
    const float4* src = reinterpret_cast<const float4*>(log_pavg + (size_t)img * Vp);
    for (int q = tid; q < Vp / 4; q += kCrossThreads) reinterpret_cast<float4*>(lp)[q] = src[q];
  }
  __syncthreads();

  // a warp takes the columns [v0, v1) of every row of the block, last row first
  const int units = (V + Vec - 1) / Vec;
  const int per = (units + kPieces - 1) / kPieces;
  const int u0 = warp * per, u1 = min(units, u0 + per);
  for (int n = nrows - 1; n >= 0; --n) {
    const size_t row = (size_t)img * L + g + (size_t)n * G;
    const float* xr = x + row * (size_t)V;
    const float mi = -m[row] * kLog2e;
    float acc = 0.f;
    if (Vec == 4) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      const float4* lp4 = reinterpret_cast<const float4*>(lp);
#pragma unroll 8
      for (int u = u0 + lane; u < u1; u += 32) {
        const float4 q = __ldcs(x4 + u);
        const float4 p = lp4[u];
        acc = fmaf(ex2(fmaf(q.x, kLog2e, mi)), p.x, acc);
        acc = fmaf(ex2(fmaf(q.y, kLog2e, mi)), p.y, acc);
        acc = fmaf(ex2(fmaf(q.z, kLog2e, mi)), p.z, acc);
        acc = fmaf(ex2(fmaf(q.w, kLog2e, mi)), p.w, acc);
      }
    } else {
#pragma unroll 8
      for (int u = u0 + lane; u < u1; u += 32)
        acc = fmaf(ex2(fmaf(__ldcs(xr + u), kLog2e, mi)), lp[u], acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) cpart[row * kPieces + warp] = acc;
  }
}

// ---- the streaming route ----------------------------------------------------

__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;  // valid in thread 0
}

// Pass A: one block per row.  Each thread keeps an online (m, Z, A, B) over
// its columns, taking kUnroll loads at a time and rescaling once per group;
// the block merges the threads' partials.
__global__ void __launch_bounds__(kThreads) stats_kernel(
    const float* __restrict__ x, float* __restrict__ m_out, float* __restrict__ z_out,
    float* __restrict__ a_out, float* __restrict__ b_out, int V) {
  const size_t row = blockIdx.x;
  const float* xr = x + row * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Stats s = {-INFINITY, 0.f, 0.f, 0.f};
  for (int v0 = threadIdx.x; v0 < V; v0 += kThreads * kUnroll) {
    float xs[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      ok[u] = v < V;
      xs[u] = ok[u] ? xr[v] : -INFINITY;
    }
    take4(s, xs, ok);
  }
  s = warp_merge(s);
  __shared__ Stats red[kWarps];
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats r = red[0];
    for (int w = 1; w < kWarps; ++w) r = merge(r, red[w]);
    m_out[row] = r.m;
    z_out[row] = r.z;
    a_out[row] = r.a;
    b_out[row] = r.b;
  }
}

// The streaming route's table: a block a row, the row read once more.  Each
// warp lists the top-k of its share of the columns; warp 0 ranks the lists as
// the resident route's selector ranks its candidates (an empty entry ranks
// behind every logit).
__global__ void __launch_bounds__(kThreads) topk_stream_kernel(
    const float* __restrict__ x, int* __restrict__ topk_out, int V, int k) {
  __shared__ float2 cand[kWarps * kMaxTopK];
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = ((V + kWarps - 1) / kWarps + 31) & ~31;
  const int v0 = min(V, warp * per);
  const TopK t = warp_topk(x + row * V, v0, min(V, v0 + per), k);
  if (lane < k) cand[warp * k + lane] = make_float2(t.v, __int_as_float(t.i));
  __syncthreads();
  if (warp == 0) select_by_rank(cand, kWarps * k, k, topk_out + row * k);
}

// Pass B, part 1: one thread per vocabulary column and block of kRowsPerBlock
// rows; writes that block's weighted column sums.
__global__ void __launch_bounds__(kThreads) pavg_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ m, const float* __restrict__ z,
    const float* __restrict__ w, float w_all, float* __restrict__ part, int L, int V) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kRowsPerBlock;
  const int i1 = min(i0 + kRowsPerBlock, L);
  if (v >= V) return;
  const float* xb = x + (size_t)b * L * V;
  float acc = 0.f;
#pragma unroll 8
  for (int i = i0; i < i1; ++i) {
    const size_t r = (size_t)b * L + i;
    acc += (w != nullptr ? w[r] : w_all) * (expf(xb[(size_t)i * V + v] - m[r]) / z[r]);
  }
  part[((size_t)b * gridDim.y + blockIdx.y) * V + v] = acc;
}

// Pass B, part 2: sums the row blocks' partials in a fixed order (no
// atomics: the result is deterministic) and stores log(p_avg + 1e-10),
// which is all pass C reads.
__global__ void __launch_bounds__(kThreads) pavg_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ log_pavg, int nblocks, int V) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (v >= V) return;
  float acc = 0.f;
  for (int j = 0; j < nblocks; ++j) acc += part[((size_t)b * nblocks + j) * V + v];
  log_pavg[(size_t)b * V + v] = logf(acc + kEps);
}

// Pass C: one block per row.
__global__ void __launch_bounds__(kThreads) cross_kernel(
    const float* __restrict__ x, const float* __restrict__ m, const float* __restrict__ z,
    const float* __restrict__ log_pavg, float* __restrict__ c_out, int L, int V) {
  const size_t row = blockIdx.x;
  const size_t b = row / L;
  const float* xr = x + row * V;
  const float* lp = log_pavg + b * V;
  const float mi = m[row];
  float acc = 0.f;
#pragma unroll 4
  for (int v = threadIdx.x; v < V; v += kThreads) acc += expf(xr[v] - mi) * lp[v];
  __shared__ float red[kWarps];
  const float t = block_sum(acc, red);
  if (threadIdx.x == 0) c_out[row] = t / z[row];
}

// The last launch of both routes.  grid B, kFinishThreads threads: per row alea =
// log Z + m - A / Z, var = (B / Z^2 - 1/V) / (V - 1), epis = -alea - C (C the
// sum of its kPieces pieces in order where cpart is given, else c[row]);
// per image their means over the rows with w != 0, summed in a fixed order
// and divided by n.  tok [3, B, L] and img [3, B]: var, epis, alea.
__global__ void __launch_bounds__(kFinishThreads) finish_kernel(
    const float* __restrict__ m, const float* __restrict__ z, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c, const float* __restrict__ cpart,
    const float* __restrict__ w, const float* __restrict__ n, float n_all,
    float* __restrict__ tok, float* __restrict__ img, int B, int L, float inv_v,
    float inv_v1) {
  __shared__ float red[3][kFinishThreads / 32];
  const int image = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sum[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < L; i += kFinishThreads) {
    const size_t row = (size_t)image * L + i;
    float ci;
    if (cpart != nullptr) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kPieces; ++j) s += cpart[row * kPieces + j];
      ci = s / z[row];
    } else {
      ci = c[row];
    }
    const float zi = z[row];
    const float alea = logf(zi) + m[row] - a[row] / zi;
    const float f[3] = {(b[row] / (zi * zi) - inv_v) * inv_v1, -alea - ci, alea};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      tok[((size_t)t * B + image) * L + i] = f[t];
      if (w == nullptr || w[row] != 0.f) sum[t] += f[t];
    }
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    for (int o = 16; o > 0; o >>= 1) sum[t] += __shfl_xor_sync(0xffffffffu, sum[t], o);
    if (lane == 0) red[t][warp] = sum[t];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float s = 0.f;
    for (int j = 0; j < kFinishThreads / 32; ++j) s += red[threadIdx.x][j];
    img[threadIdx.x * B + image] = s / (n != nullptr ? n[image] : n_all);
  }
}

constexpr size_t kAbSmem = (size_t)kSlots * kChunk * 4 + (2 * kSlots + 4) * 8 +
                           2 * 5 * kResWarps * 4 + 2 * kCandCap * 8 + 2 * 4;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// x [B, L, V] fp32; w [B, L] and n [B] fp32 (the row weights and the rows in
// the mean; both null: every row is in it, w = 1 / L and n = L); stats [5, B, L] fp32 scratch (m, Z, A, B, C); tok [3, B, L] and
// img [3, B] fp32 out (var, epis, alea per row and their image means); topk
// [B, L, k] int32 out (k = 0: no table, the pointer is not read).  route 0,
// resident: G blocks an image, scratch = part [B, G, Vp] + log pavg [B, Vp]
// + C pieces [B, L, 16] with Vp = V rounded up to 4.  route 1, streaming:
// scratch [B, ceil(L / 32) + 1, V].  phases: bit 0 passes A and B, bit 1 the
// merge of the partial lines, bit 2 pass C, bit 3 the finish (15 is the
// function; a timer takes them apart).  Returns a cudaError_t (0 = success).
extern "C" int dd_vision_uncertainty(const void* x, const void* w, const void* n, void* stats,
                                     void* scratch, void* tok, void* img, void* topk, int B,
                                     int L, int V, int k, int route, int G, int phases,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const size_t rows = (size_t)B * L;
  const float w_all = 1.f / (float)L;
  if ((w == nullptr) != (n == nullptr)) return (int)cudaErrorInvalidValue;
  float* mf = static_cast<float*>(stats);
  float* zf = mf + rows;
  float* af = zf + rows;
  float* bf = af + rows;
  float* cf = bf + rows;
  int* tk = static_cast<int*>(topk);
  if (k < 0 || k > kMaxTopK || k > V || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const float* cpart = nullptr;
  if (route == 0) {
    const int Vp = (V + 3) & ~3;
    if (G < 1 || G > L || Vp + (V % 4 ? 4 : 0) > kResMaxSpan ||
        (reinterpret_cast<uintptr_t>(x) & 15))
      return (int)cudaErrorInvalidValue;
    float* part = static_cast<float*>(scratch);          // [B, G, Vp]
    float* log_pavg = part + (size_t)B * G * Vp;         // [B, Vp]
    float* pieces = log_pavg + (size_t)B * Vp;           // [B, L, 16]
    cpart = pieces;
    if (phases & 1) {
      auto kernel = V % 4 == 0 ? ab_resident_kernel<true> : ab_resident_kernel<false>;
      if ((e = allow_smem(kernel, kAbSmem)) != cudaSuccess) return (int)e;
      kernel<<<dim3(G, B), kAbThreads, kAbSmem, st>>>(xf, wf, w_all, mf, zf, af, bf, tk, part, L,
                                                     V, Vp, k, rows * V);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (phases & 2) {
      pavg_merge_kernel<<<dim3((Vp / 4 + 31) / 32, B), 32 * kMergeSlices, 0, st>>>(
          part, log_pavg, G, Vp);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (phases & 4) {
      const size_t bytes = (size_t)Vp * 4;
      if (V % 4 == 0) {
        if ((e = allow_smem(cross_resident_kernel<4>, bytes)) != cudaSuccess) return (int)e;
        cross_resident_kernel<4><<<dim3(G, B), kCrossThreads, bytes, st>>>(
            xf, mf, log_pavg, pieces, L, V, Vp);
      } else {
        if ((e = allow_smem(cross_resident_kernel<1>, bytes)) != cudaSuccess) return (int)e;
        cross_resident_kernel<1><<<dim3(G, B), kCrossThreads, bytes, st>>>(
            xf, mf, log_pavg, pieces, L, V, Vp);
      }
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  } else {
    const int nblocks = (L + kRowsPerBlock - 1) / kRowsPerBlock;
    const int vblocks = (V + kThreads - 1) / kThreads;
    float* part = static_cast<float*>(scratch);               // [B, nblocks, V]
    float* log_pavg = part + (size_t)B * nblocks * V;         // [B, V]
    if (phases & 1) {
      stats_kernel<<<B * L, kThreads, 0, st>>>(xf, mf, zf, af, bf, V);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      if (k > 0) {
        topk_stream_kernel<<<B * L, kThreads, 0, st>>>(xf, tk, V, k);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      }
      pavg_partial_kernel<<<dim3(vblocks, nblocks, B), kThreads, 0, st>>>(xf, mf, zf, wf, w_all,
                                                                           part, L, V);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (phases & 2) {
      pavg_reduce_kernel<<<dim3(vblocks, B), kThreads, 0, st>>>(part, log_pavg, nblocks, V);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (phases & 4) {
      cross_kernel<<<B * L, kThreads, 0, st>>>(xf, mf, zf, log_pavg, cf, L, V);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  if (phases & 8) {
    finish_kernel<<<B, kFinishThreads, 0, st>>>(
        mf, zf, af, bf, cf, cpart, wf, static_cast<const float*>(n), (float)L,
        static_cast<float*>(tok), static_cast<float*>(img), B, L, (float)(1.0 / V),
        (float)(1.0 / (V - 1)));
    e = cudaGetLastError();
  }
  return (int)e;
}
