// K5: causal flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_prefill_attention
// (dropoutdecoding_tpu/ops/pallas_attention.py:66, body _kernel :37), which
// kept a head's whole K/V in VMEM and padded S to its 512-row query block.
// For each (b, s, h), with kv group g = h / G (G = H / KH, the repeat_kv
// interleave), it computes
//
//   out[b, s, h] = softmax_t(where(key_mask[b, t] & t <= s,
//                                  q[b, s, h] . k[b, t, g] / sqrt(D), -1e30)) . v[b, :, g]
//
// over q [B, S, H, D] and k, v [B, S, KH, D], read in place: no transpose,
// pad or repeat_kv copy, and the ragged end of S is masked here.
//
// What bounds it on this card: tensor-core FLOPs.  At the LLaVA-NeXT prefill
// (S = 2950, H = 32, KH = 8, D = 128) one layer's causal work is
// 4 (S^2 / 2) D H = 71 GFLOP, 72 us at 989 TFLOP/s bf16, while q, k, v and
// out are about 60 MB, 18 us at 3.35 TB/s.  Measured times and the
// predictions made before them are in PERF.md.
//
// Three kernels behind one entry; the caller names the route and the entry
// refuses one the call cannot take.
//
// flash_wgmma_kernel (bf16, D = 128; flash-attention 3's shape, simple where
// it can be).  What held the mma.sync kernel below at 93 TFLOP/s: mma.sync
// itself, no load pipeline at all (every key tile loaded between two
// __syncthreads while the tensor cores wait), scalar shared loads for the B
// fragments, K/V re-read for every 64 query rows, expf on every score.  The
// design:
//  - A block owns 128 query rows of one head: two consumer warpgroups of 64
//    rows and a producer warp (setmaxnreg 240 / 24, no spills).  Q (32 KB) is
//    loaded once; K and V tiles of 128 keys (32 KB each) go through a ring of
//    two stages.  All of it is TMA over 4-D tensor maps of [B, S, heads, D]
//    with a box of one head, so q, k and v are read in place, GQA included,
//    and rows past S arrive as zeros.  A third stage changed no time.
//  - S = Q K^T is wgmma m64n128k16 with both operands in shared memory (a
//    tile [rows][D], D contiguous, is K-major as it lies).  O += P V takes P
//    from registers: the score accumulator, after the softmax, rounded to
//    bf16, is the A fragment of the second product warp by warp; V's tile has
//    the head dim contiguous, so it is the MN-major B operand (transpose bit
//    set, blocks of 64 columns a sub-tile apart).
//  - Softmax in base 2: scale . log2(e) is folded into one multiply-add and
//    the exponent is ex2.approx; the running max and sum are per row, the
//    output accumulator is rescaled when the max grows.
//  - Per key tile two flags from the key mask, computed by the block before
//    it starts: a tile with no attendable key is skipped by producer and
//    consumers alike (the NeXT prompt pads 588 of 2950 keys), and only a tile
//    with a masked key, or the diagonal one, pays for masking.  A row whose
//    every key is masked still reaches the uniform epilogue (sum = 0).
//  - Grid (head, query tile, batch), the longest query tiles first: the 32
//    heads of one query tile run together, equal in work, and the four heads
//    of a KV group find their K and V tiles in L2.  768 blocks of 1-24 tiles
//    on 132 SMs, one block an SM: the shortest run last, so the tail is
//    about one tile of 73 a SM.
//  - The softmax of one tile is not overlapped with the wgmmas of the next
//    inside a warpgroup (that takes a second score accumulator); the two
//    warpgroups overlap only as they drift apart.
//
// flash_bf16_kernel (bf16, D = 16, 32, 64; flash-attention 2, simple): one
// block of four warps per (64-row query tile, query head, b), the longest
// tiles launched first; each warp owns 16 query rows, held as mma A fragments
// for the whole run.  The block walks 64-key tiles from key 0 up to its tile's
// diagonal and skips the tiles above it.  K and V tiles are staged in shared
// memory with 16-byte loads, rows padded by 16 bytes so that fragment reads
// fall in 32 distinct banks.  QK^T and PV run as mma.sync m16n8k16 bf16 with
// fp32 sums; the softmax is online in fp32.  The score fragments of two
// adjacent 8-key tiles are, rounded to bf16, the A fragment of the PV
// product, so P never leaves registers.
//
// Masking: a masked key takes no part in the sums.  When a row has one
// attendable key, that equals the reference's -1e30, whose exp underflows
// to exactly 0.  A row with none (its keys 0..s all masked) scores -1e30
// everywhere in the reference, whose softmax is then uniform over all S
// keys; an epilogue computes that average of V, so no row is NaN.
//
// Rounding: the reference rounds the normalised probabilities to bf16
// before PV; here the unnormalised exp terms are rounded, and the sum that
// divides at the end is taken in fp32 before rounding.  The two differ at
// bf16 level.
//
// flash_f32_kernel: fp32 activations run a scalar kernel of the same
// structure (fp32 FMAs, no tensor cores, 32-row query tiles, 16-key tiles):
// the narrow card-vs-CPU token check runs it.  Head dims 16, 32, 64 and 128
// are instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr int kBQ = 64;        // query rows per block (bf16 kernel)
constexpr int kBK = 64;        // keys per tile (bf16 kernel)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two fp32 values rounded to one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a . b on one m16n8k16 tile: a is 16x16 bf16 (row fragment), b 16x8
// bf16 (column fragment), d 16x8 fp32.  Fragment layouts (PTX ISA, with
// group = lane / 4 and t = lane % 4): a[0] holds row group, columns 2t and
// 2t+1; a[1] row group+8; a[2] and a[3] the same rows at columns 2t+8 and
// 2t+9.  b0 holds rows 2t, 2t+1 of column group, b1 rows 2t+8, 2t+9.  d[0],
// d[1] are row group, columns 2t, 2t+1; d[2], d[3] row group+8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The reference's output for a row with no attendable key: its softmax is
// uniform over all S keys, with the probability rounded to the value type
// before PV and the sum in fp32.  Reads the whole V column; reached only
// when a row's keys 0..s are all masked.
template <typename T>
__device__ float uniform_row_value(const T* vb, size_t stride, int S, int d) {
  const float p = round_to(1.f / S, vb);
  float acc = 0.f;
  for (int t = 0; t < S; ++t) acc += p * to_f(vb[(size_t)t * stride + d]);
  return acc;
}

// Copies the 64 rows r0 .. r0+63 of a bf16 panel (row r at src + r * stride,
// D values) into shared rows of ld elements, 16 bytes per load; rows at or
// past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, size_t stride,
                                          int r0, int limit) {
  constexpr int kVec = D / 8;  // 16-byte words per row
  for (int i = threadIdx.x; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec, c = i - r * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) val = reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride)[c];
    reinterpret_cast<uint4*>(dst + r * ld)[c] = val;
  }
}

template <int D>
constexpr size_t bf16_smem_bytes() {
  return (size_t)(kBQ + 2 * kBK) * (D + 8) * sizeof(bf16) + kBK;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(
    const bf16* __restrict__ q,              // [B, S, H, D]
    const bf16* __restrict__ k,              // [B, S, KH, D]
    const bf16* __restrict__ v,              // [B, S, KH, D]
    const uint8_t* __restrict__ key_mask,    // [B, S], or null (every key)
    bf16* __restrict__ out,                  // [B, S, H, D]
    int S, int H, int KH, float scale) {
  constexpr int LD = D + 8;          // shared row stride, in elements
  constexpr int KSTEPS = D / 16;     // QK^T k-steps over D
  constexpr int DTILES = D / 8;      // PV n-tiles over D
  constexpr int NT = kBK / 8;        // QK^T n-tiles over a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBQ, LD]
  bf16* k_s = q_s + kBQ * LD;                     // [kBK, LD]
  bf16* v_s = k_s + kBK * LD;                     // [kBK, LD]
  uint8_t* m_s = reinterpret_cast<uint8_t*>(v_s + kBK * LD);  // [kBK] attendable

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const size_t kv_stride = (size_t)KH * D;
  const bf16* kb = k + ((size_t)b * S * KH + g) * D;
  const bf16* vb = v + ((size_t)b * S * KH + g) * D;
  const uint8_t* mb = key_mask ? key_mask + (size_t)b * S : nullptr;

  load_tile<D>(q_s, LD, q + ((size_t)b * S * H + h) * D, (size_t)H * D, q0, S);
  __syncthreads();
  uint32_t qf[KSTEPS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const bf16* p = q_s + warp * 16 * LD + ks * 16 + tg * 2;
    qf[ks][0] = ld_u32(p + gr * LD);
    qf[ks][1] = ld_u32(p + (gr + 8) * LD);
    qf[ks][2] = ld_u32(p + gr * LD + 8);
    qf[ks][3] = ld_u32(p + (gr + 8) * LD + 8);
  }

  const int row0 = q0 + warp * 16 + gr;  // this thread's rows: row0, row0 + 8
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  const int last = min(q0 + kBQ, S) - 1;  // the tile's last query row
  for (int k0 = 0; k0 <= last; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(k_s, LD, kb, kv_stride, k0, S);
    load_tile<D>(v_s, LD, vb, kv_stride, k0, S);
    for (int c = threadIdx.x; c < kBK; c += kThreads) {
      const int t = k0 + c;
      m_s[c] = t < S && (mb == nullptr || mb[t] != 0);
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = k_s + (nt * 8 + gr) * LD + tg * 2;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma_bf16(s[nt], qf[ks], ld_u32(kr + ks * 16), ld_u32(kr + ks * 16 + 8));
    }

    // scale and mask (key mask, causal, ragged end); the tile's row maxima
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nt * 8 + tg * 2 + (i & 1);
        const bool ok = m_s[c] && k0 + c <= row0 + (i >> 1) * 8;
        s[nt][i] = ok ? s[nt][i] * scale : -INFINITY;
        tmax[i >> 1] = fmaxf(tmax[i >> 1], s[nt][i]);
      }

    // online softmax: new running max, rescale what was summed before
    float base[2];  // what the exps subtract; 0 while a row has no key yet
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = tmax[r];
      m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));  // the quad shares the row
      m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
      const float m_new = fmaxf(mx[r], m);
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(mx[r] - base[r]);  // 0 while the row had no key
      mx[r] = m_new;
      sum[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // p = exp(s - max) in fp32 for the sums, rounded to bf16 for PV
    uint32_t pf[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = expf(s[nt][i] - base[i >> 1]);  // masked: 0
      sum[0] += p[0] + p[1];
      sum[1] += p[2] + p[3];
      pf[nt][0] = pack_f32x2(p[0], p[1]);
      pf[nt][1] = pack_f32x2(p[2], p[3]);
    }

    // acc += P V; k-step j spans keys 16j .. 16j+15, score n-tiles 2j, 2j+1
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {pf[2 * j][0], pf[2 * j][1], pf[2 * j + 1][0], pf[2 * j + 1][1]};
      const bf16* vr = v_s + (j * 16 + tg * 2) * LD + gr;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const bf16* vp = vr + dt * 8;
        mma_bf16(acc[dt], a, pack_bf16x2(vp[0], vp[LD]), pack_bf16x2(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
    sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    bf16* orow = out + ((size_t)(b * S + row) * H + h) * D + tg * 2;
    if (sum[r] > 0.f) {
      const float inv = 1.f / sum[r];
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_f32x2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    } else {
      for (int dt = 0; dt < DTILES; ++dt) {
        const int d = dt * 8 + tg * 2;
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_f32x2(uniform_row_value(vb, kv_stride, S, d),
                       uniform_row_value(vb, kv_stride, S, d + 1));
      }
    }
  }
}

// fp32: the same walk with scalar fp32 FMAs.  32 query rows per block, four
// threads per row; a thread scores keys c4, c4+4, ... of each 16-key tile and
// owns output columns c4, c4+4, ...  Shared rows of Q and K are padded to
// D+1 so that the rows a warp reads at once fall in distinct banks.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ key_mask, float* __restrict__ out, int S, int H, int KH,
    float scale) {
  constexpr int BQ = 32, BK = 16, LD = D + 1, PER = D / 4;
  __shared__ float q_s[BQ * LD], k_s[BK * LD], v_s[BK * D], p_s[BQ * (BK + 1)];
  __shared__ uint8_t m_s[BK];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KH);
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int row = q0 + r;
  const size_t kv_stride = (size_t)KH * D;
  const float* kb = k + ((size_t)b * S * KH + g) * D;
  const float* vb = v + ((size_t)b * S * KH + g) * D;
  const uint8_t* mb = key_mask ? key_mask + (size_t)b * S : nullptr;

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D;
    q_s[rr * LD + d] = q0 + rr < S ? q[((size_t)(b * S + q0 + rr) * H + h) * D + d] : 0.f;
  }
  float mx = -INFINITY, sum = 0.f, acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  const int last = min(q0 + BQ, S) - 1;
  for (int k0 = 0; k0 <= last; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      const bool in = k0 + t < S;
      const size_t off = (size_t)(k0 + t) * kv_stride + d;
      k_s[t * LD + d] = in ? kb[off] : 0.f;
      v_s[t * D + d] = in ? vb[off] : 0.f;
    }
    for (int c = threadIdx.x; c < BK; c += kThreads)
      m_s[c] = k0 + c < S && (mb == nullptr || mb[k0 + c] != 0);
    __syncthreads();

    float s[BK / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int c = c4 + 4 * jj;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += q_s[r * LD + d] * k_s[c * LD + d];
      s[jj] = m_s[c] && k0 + c <= row ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));  // four lanes per row
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
    const float m_new = fmaxf(mx, tmax);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(mx - base);
    mx = m_new;
    sum *= alpha;
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[j] *= alpha;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const float p = expf(s[jj] - base);
      sum += p;
      p_s[r * (BK + 1) + c4 + 4 * jj] = p;
    }
    __syncwarp();  // a row's four lanes share a warp
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = p_s[r * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < PER; ++j) acc[j] += p * v_s[c * D + c4 + 4 * j];
    }
  }

  sum += __shfl_xor_sync(kFull, sum, 1);
  sum += __shfl_xor_sync(kFull, sum, 2);
  if (row >= S) return;
  float* orow = out + ((size_t)(b * S + row) * H + h) * D;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int d = c4 + 4 * j;
    orow[d] = sum > 0.f ? acc[j] / sum : uniform_row_value(vb, kv_stride, S, d);
  }
}

// ---- warpgroup tensor cores (bf16, D = 128) ------------------------------------

constexpr int kWgBQ = 128;        // query rows per block: 64 per consumer warpgroup
constexpr int kWgBK = 128;        // keys per tile
constexpr int kWgD = 128;         // head dim
constexpr int kWgStages = 2;      // K/V ring
constexpr int kWgThreads = 384;   // two consumer warpgroups and the producer's
constexpr int kWgMaxTiles = 512;  // key tiles whose flags a block keeps: S <= 65536
// a sub-tile: 128 rows of 64 head-dim values, 128 bytes a row, swizzled
constexpr int kWgSub = 128 * 64 * (int)sizeof(bf16);
constexpr int kWgTile = 2 * kWgSub;  // 128 rows of Q, K or V
constexpr int kWgSmem = kWgTile * (1 + 2 * kWgStages) + 1024;  // and room to align
constexpr uint8_t kLive = 1, kHoles = 2;  // a key tile has an attendable key, a masked key

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Block (h, i, b) owns the 128 query rows of tile n - 1 - i (the longest
// first) of head h.  Blocks that run together are the 32 heads of one query
// tile: equal work, and the four heads of a KV group read the same K and V
// tiles from L2.
__global__ void __launch_bounds__(kWgThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,  // [B, S, H, D], box [128 rows][1][64]
    const __grid_constant__ CUtensorMap k_map,  // [B, S, KH, D], the same box
    const __grid_constant__ CUtensorMap v_map,
    const bf16* __restrict__ v,               // for rows without a key
    const uint8_t* __restrict__ key_mask,     // [B, S], or null (every key)
    bf16* __restrict__ out,                   // [B, S, H, D]
    int S, int H, int KH, float scale_log2) {
  extern __shared__ unsigned char wg_smem[];
  __shared__ uint64_t q_full, full[kWgStages], empty[kWgStages];
  __shared__ uint8_t flags[kWgMaxTiles];
  unsigned char* q_s = hopper::align_1024(wg_smem);
  unsigned char* kv_s = q_s + kWgTile;  // [stage][K, V]

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * kWgBQ;
  const int n_tiles = qt + 1;  // key tiles 0 .. qt; the last holds the diagonal
  const int g = h / (H / KH);
  const uint8_t* mb = key_mask ? key_mask + (size_t)b * S : nullptr;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      hopper::mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  // What each key tile holds, from the key mask: a tile without an attendable
  // key is skipped by producer and consumers alike, and only a tile with a
  // masked key, or the diagonal one, pays for masking.
  for (int j = threadIdx.x >> 5; j < n_tiles; j += kWgThreads / 32) {
    bool live = false, holes = false;
    for (int c = lane; c < kWgBK; c += 32) {
      const int t = j * kWgBK + c;
      if (t < S) {
        const bool on = mb == nullptr || mb[t] != 0;
        live |= on;
        holes |= !on;
      }
    }
    live = __any_sync(kFull, live);
    holes = __any_sync(kFull, holes);
    if (lane == 0) flags[j] = (live ? kLive : 0) | (holes ? kHoles : 0);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 2 * 128) {
      hopper::mbar_arrive_expect_tx(&q_full, kWgTile);
      hopper::tma_load_4d(q_s, &q_map, &q_full, 0, h, q0, b);
      hopper::tma_load_4d(q_s + kWgSub, &q_map, &q_full, 64, h, q0, b);
      int n = 0;  // live tiles so far
      for (int j = 0; j < n_tiles; ++j) {
        if (!(flags[j] & kLive)) continue;
        const int stage = n % kWgStages;
        hopper::mbar_wait(&empty[stage], ((n / kWgStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * kWgTile);
        unsigned char* k_s = kv_s + stage * 2 * kWgTile;
        hopper::tma_load_4d(k_s, &k_map, &full[stage], 0, g, j * kWgBK, b);
        hopper::tma_load_4d(k_s + kWgSub, &k_map, &full[stage], 64, g, j * kWgBK, b);
        hopper::tma_load_4d(k_s + kWgTile, &v_map, &full[stage], 0, g, j * kWgBK, b);
        hopper::tma_load_4d(k_s + kWgTile + kWgSub, &v_map, &full[stage], 64, g, j * kWgBK,
                            b);
        ++n;
      }
    }
  } else {
    hopper::reg_alloc<240>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int gr = lane >> 2, tg = lane & 3;
    const int row0 = q0 + wg * 64 + warp * 16 + gr;  // this thread's rows: row0, row0 + 8

    // running maximum (of score * scale_log2) and sum per row, and the output
    // accumulator: o[4j + 2r + i] is row r, head-dim column 8j + 2 tg + i
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    float o[kWgD / 2];
#pragma unroll
    for (int i = 0; i < kWgD / 2; ++i) o[i] = 0.f;

    // this warpgroup's 64 query rows of both sub-tiles
    const uint32_t qa = hopper::smem_u32(q_s) + wg * 64 * 128;
    hopper::mbar_wait(&q_full, 0);
    int n = 0;
    for (int j = 0; j < n_tiles; ++j) {
      if (!(flags[j] & kLive)) continue;
      const int stage = n % kWgStages;
      hopper::mbar_wait(&full[stage], (n / kWgStages) & 1);
      ++n;
      const uint32_t ka = hopper::smem_u32(kv_s + stage * 2 * kWgTile), va = ka + kWgTile;

      // scores: 64 rows x 128 keys; s[4c + 2r + i] is row r, key 8c + 2 tg + i
      float s[kWgBK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgD / 16; ++ks) {
        const uint32_t off = (ks >> 2) * kWgSub + (ks & 3) * 32;
        hopper::wgmma_m64n128k16_ss(s, hopper::smem_desc(qa + off, 16, 1024),
                                    hopper::smem_desc(ka + off, 16, 1024), ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::keep(s);

      if (j == qt || (flags[j] & kHoles)) {  // key mask, causal, ragged end
#pragma unroll
        for (int i = 0; i < kWgBK / 2; ++i) {
          const int t = j * kWgBK + 8 * (i >> 2) + 2 * tg + (i & 1);
          const bool ok =
              t <= row0 + ((i >> 1) & 1) * 8 && t < S && (mb == nullptr || mb[t] != 0);
          s[i] = ok ? s[i] : -INFINITY;
        }
      }

      // online softmax in base 2: new running max, rescale what was summed
      float base[2];  // what the exponents subtract; 0 while a row has no key yet
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = -INFINITY;
#pragma unroll
        for (int c = 0; c < kWgBK / 8; ++c)
          m = fmaxf(m, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));  // the quad shares the row
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
        const float m_new = fmaxf(mx[r], m * scale_log2);
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2_approx(mx[r] - base[r]);  // 0 while the row had no key
        mx[r] = m_new;
        sum[r] *= alpha;
#pragma unroll
        for (int c = 0; c < kWgD / 8; ++c) {
          o[4 * c + 2 * r] *= alpha;
          o[4 * c + 2 * r + 1] *= alpha;
        }
      }

      // p = 2^(s * scale_log2 - max) in fp32 for the sums, rounded to bf16 as
      // the A fragments of P V: k-step ks (keys 16 ks ..) takes p[4 ks .. 4 ks + 3]
      uint32_t p[kWgBK / 4];
#pragma unroll
      for (int c = 0; c < kWgBK / 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = exp2_approx(fmaf(s[4 * c + 2 * r], scale_log2, -base[r]));
          const float p1 = exp2_approx(fmaf(s[4 * c + 2 * r + 1], scale_log2, -base[r]));
          sum[r] += p0 + p1;
          p[2 * c + r] = pack_f32x2(p0, p1);
        }

      // o += P V: V's tile has the head dim contiguous, so it is the MN-major B
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgBK / 16; ++ks) {
        const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3]};
        hopper::wgmma_m64n128k16_rs<1>(
            o, a, hopper::smem_desc(va + ks * 16 * 128, kWgSub, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::keep(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    }

    const size_t kv_stride = (size_t)KH * kWgD;
    const bf16* vb = v + ((size_t)b * S * KH + g) * kWgD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float total = sum[r];
      total += __shfl_xor_sync(kFull, total, 1);
      total += __shfl_xor_sync(kFull, total, 2);
      const int row = row0 + r * 8;
      if (row >= S) continue;
      bf16* orow = out + ((size_t)(b * S + row) * H + h) * kWgD + tg * 2;
      if (total > 0.f) {
        const float inv = 1.f / total;
#pragma unroll
        for (int c = 0; c < kWgD / 8; ++c)
          *reinterpret_cast<uint32_t*>(orow + c * 8) =
              pack_f32x2(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      } else {
        for (int c = 0; c < kWgD / 8; ++c) {
          const int d = c * 8 + tg * 2;
          *reinterpret_cast<uint32_t*>(orow + c * 8) =
              pack_f32x2(uniform_row_value(vb, kv_stride, S, d),
                         uniform_row_value(vb, kv_stride, S, d + 1));
        }
      }
    }
  }
}

// The tensor maps of q and of k, v: 4-D, so that a box ends at the end of a
// sequence and what lies past it arrives as zeros.
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int S, int heads) {
  const uint64_t dims[4] = {kWgD, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t row = kWgD * sizeof(bf16);
  const uint64_t strides[3] = {row, heads * row, (uint64_t)S * heads * row};
  const uint32_t box[4] = {64, 1, kWgBK, 1};
  return hopper::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* key_mask,
                         void* out, int B, int S, int H, int KH, float scale,
                         cudaStream_t stream) {
  if ((S + kWgBK - 1) / kWgBK > kWgMaxTiles) return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = head_map(&q_map, q, B, S, H);
  if (err == cudaSuccess) err = head_map(&k_map, k, B, S, KH);
  if (err == cudaSuccess) err = head_map(&v_map, v, B, S, KH);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWgSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kWgBQ - 1) / kWgBQ, B);
  flash_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      q_map, k_map, v_map, static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<bf16*>(out), S, H, KH, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* key_mask,
                   void* out, int B, int S, int H, int KH, float scale, cudaStream_t stream) {
  const uint8_t* mask = static_cast<const uint8_t*>(key_mask);
  if (dtype == 0) {
    const dim3 grid((S + 31) / 32, H, B);
    flash_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<float*>(out), S, H, KH, scale);
    return cudaGetLastError();
  }
  if (dtype == 1) {
    constexpr size_t smem = bf16_smem_bytes<D>();
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    flash_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<bf16*>(out), S, H, KH, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim D in {16, 32, 64, 128};
// key_mask [B, S] bytes (0 = masked) or null.  route: 0 = the mma.sync kernel
// (bfloat16) or the scalar one (float32), 1 = the warpgroup kernel (bfloat16,
// D = 128, S <= 65536); the caller picks it, and a route the call cannot take
// is refused.  Returns a cudaError_t.
extern "C" int dd_flash_prefill_attention(int dtype, const void* q, const void* k,
                                          const void* v, const void* key_mask, void* out, int B,
                                          int S, int H, int KH, int D, float scale, int route,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (dtype != 1 || D != kWgD) return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(q, k, v, key_mask, out, B, S, H, KH, scale, st);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16>(dtype, q, k, v, key_mask, out, B, S, H, KH, scale, st);
    case 32: return (int)launch<32>(dtype, q, k, v, key_mask, out, B, S, H, KH, scale, st);
    case 64: return (int)launch<64>(dtype, q, k, v, key_mask, out, B, S, H, KH, scale, st);
    case 128: return (int)launch<128>(dtype, q, k, v, key_mask, out, B, S, H, KH, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
