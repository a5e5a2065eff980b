// K7: the grouped-expert SwiGLU product for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs no mixture of experts.  It
// was added for the MLA + MoE decoder (models/mla_moe.py, Kimi-VL-A3B's
// language model), whose decode forwards replay from a CUDA graph
// (engine/decode_graphs.py): a per-expert loop in Python has shapes that
// depend on the routing and reads the group sizes back, which a graph cannot
// hold.  So the routing's rows arrive sorted by expert, the group bounds stay
// in device memory (offsets [E + 1] int32), and the grid is fixed: a block
// per (output tile, expert), and the blocks of an expert that no row chose
// exit at once.  Two launches behind one entry:
//
//   gated: h[a, :] = silu(x[a] . Wg[e]) * (x[a] . Wu[e])   bf16, [A, I]
//   down:  y[a, :] = h[a] . Wd[e]                          fp32, [A, D]
//
// for every row a of expert e's group offsets[e] .. offsets[e + 1] - 1, W in
// the port's layout ([E, in, out], x @ W); fp32 sums, h rounded to bf16 once.
//
// What bounds it on this card: the expert bytes.  A decode forward of the
// Kimi-VL-A3B cell has 32 or 96 rows x 6 picks over 64 experts, so nearly
// every expert is touched and its three 2048 x 1408 bf16 matrices (17.3 MB)
// stream once: 1.1 GB a layer, 28.8 GB over 26 layers, 8.6 ms at 3.35 TB/s,
// against 2 x 3 x 2048 x 1408 x (192 or 576) x 26 = 90-270 GFLOP (under 0.3
// ms of the tensor cores).  The design:
//  - A block is 64 output channels of one expert over the whole contraction
//    (so no sum crosses a block), four warps of 16 channels each.  The
//    weights are the mma's A operand (m16n8k16, the 16 rows are channels:
//    ldmatrix.trans of the [k][n] tile), up to 32 of the expert's rows its B
//    operand (four n-tiles of 8): few rows fill whole tiles.  An expert with
//    more rows walks them 32 at a time, the weight tile read again each time.
//  - Stages of 64 contraction rows (the gate and up tiles, or the down tile,
//    and the 32 x rows) travel to shared memory by cp.async through a ring of
//    three, continued from one 32-row chunk to the next; rows past the group
//    are zero-filled.  Rows are padded to 144 bytes, so ldmatrix and the B
//    fragment reads meet no bank conflict.
//  - The gated launch's epilogue applies silu(g) * u to the fp32 sums in
//    registers and writes bf16; the down launch writes its fp32 sums, which
//    the caller weights and adds in the routing's order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileN = 64;   // output channels a block
constexpr int kKC = 64;      // contraction rows a stage
constexpr int kRows = 32;    // x rows a chunk: four mma n-tiles of 8
constexpr int kNT = kRows / 8;
constexpr int kStages = 3;
constexpr int kThreads = 128;  // four warps, 16 channels each
constexpr int kLdW = kTileN + 8;  // bf16 elements a padded weight-tile row (144 bytes)
constexpr int kLdX = kKC + 8;     // bf16 elements a padded x-tile row

template <bool kGated>
struct Smem {
  static constexpr int kW = kKC * kLdW;  // one weight tile, elements
  static constexpr int kX = kRows * kLdX;
  static constexpr int kStage = (kGated ? 2 : 1) * kW + kX;
  static constexpr int kBytes = kStages * kStage * (int)sizeof(bf16);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; with `in` false nothing is read and
// the 16 bytes are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8; lane (group, t) receives from matrix i the elements
// [2t][group] and [2t + 1][group].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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

// One launch of K7: grid (N / kTileN, E), kThreads threads.  x [A, K] bf16
// sorted by expert; w0 (gate, or down) and w1 (up; gated only) [E, K, N];
// out [A, N]: bf16 silu(x w0) * (x w1) when gated, else fp32 x w0.
template <bool kGated>
__global__ void __launch_bounds__(kThreads) moe_grouped_kernel(
    const bf16* __restrict__ x, const int* __restrict__ offsets, const bf16* __restrict__ w0,
    const bf16* __restrict__ w1, void* __restrict__ out, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  using S = Smem<kGated>;

  const int e = blockIdx.y;
  const int n0 = blockIdx.x * kTileN;
  const int r_lo = offsets[e], r_hi = offsets[e + 1];
  if (r_hi <= r_lo) return;  // an expert no row chose
  const int nk = K / kKC;
  const int total = ((r_hi - r_lo + kRows - 1) / kRows) * nk;
  const size_t wstride = (size_t)K * N;
  const bf16* g0 = w0 + (size_t)e * wstride + n0;
  const bf16* g1 = kGated ? w1 + (size_t)e * wstride + n0 : nullptr;

  auto load = [&](int it) {
    bf16* st = smem + (it % kStages) * S::kStage;
    const int k0 = (it % nk) * kKC;
    const int row0 = r_lo + (it / nk) * kRows;
    for (int c = threadIdx.x; c < kKC * (kTileN / 8); c += kThreads) {
      const int r = c / (kTileN / 8), col = (c % (kTileN / 8)) * 8;
      cp_async16(st + r * kLdW + col, g0 + (size_t)(k0 + r) * N + col, true);
      if constexpr (kGated)
        cp_async16(st + S::kW + r * kLdW + col, g1 + (size_t)(k0 + r) * N + col, true);
    }
    bf16* xs = st + (kGated ? 2 : 1) * S::kW;
    for (int c = threadIdx.x; c < kRows * (kKC / 8); c += kThreads) {
      const int r = c / (kKC / 8), col = (c % (kKC / 8)) * 8;
      const bool in = row0 + r < r_hi;
      cp_async16(xs + r * kLdX + col, x + (size_t)(in ? row0 + r : r_lo) * K + k0 + col, in);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, t = lane & 3;
  // ldmatrix.trans addresses: matrix j = lane / 8 is (k half j >> 1, channel half j & 1)
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = warp * 16 + (((lane >> 3) & 1) << 3);

  float acc0[kNT][4], acc1[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc0[j][q] = acc1[j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is free for it + kStages - 1
    if (it + kStages - 1 < total) load(it + kStages - 1);
    cp_async_commit();

    const bf16* st = smem + (it % kStages) * S::kStage;
    const bf16* xs = st + (kGated ? 2 : 1) * S::kW;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t a0[4], a1[4];
      ldmatrix_x4_trans(a0, smem_u32(st + (ks * 16 + a_row) * kLdW + a_col));
      if constexpr (kGated)
        ldmatrix_x4_trans(a1, smem_u32(st + S::kW + (ks * 16 + a_row) * kLdW + a_col));
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const bf16* xr = xs + (j * 8 + group) * kLdX + ks * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
        mma_bf16(acc0[j], a0, b0, b1);
        if constexpr (kGated) mma_bf16(acc1[j], a1, b0, b1);
      }
    }

    if (it % nk == nk - 1) {  // the chunk's sums are whole: write its rows
      const int row0 = r_lo + (it / nk) * kRows;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + j * 8 + 2 * t + (q & 1);
          const int ch = n0 + warp * 16 + group + ((q >> 1) << 3);
          if (row < r_hi) {
            if constexpr (kGated) {
              const float g = acc0[j][q];
              reinterpret_cast<bf16*>(out)[(size_t)row * N + ch] =
                  __float2bfloat16(g / (1.f + __expf(-g)) * acc1[j][q]);
            } else {
              reinterpret_cast<float*>(out)[(size_t)row * N + ch] = acc0[j][q];
            }
          }
          acc0[j][q] = acc1[j][q] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <bool kGated>
cudaError_t launch(const void* x, const int* offsets, const void* w0, const void* w1, void* out,
                   int K, int N, int E, cudaStream_t stream) {
  // above 48 KB only as dynamic shared memory; set once, before any capture
  static cudaError_t attr = cudaFuncSetAttribute(
      moe_grouped_kernel<kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<kGated>::kBytes);
  if (attr != cudaSuccess) return attr;
  moe_grouped_kernel<kGated><<<dim3(N / kTileN, E), kThreads, Smem<kGated>::kBytes, stream>>>(
      static_cast<const bf16*>(x), offsets, static_cast<const bf16*>(w0),
      static_cast<const bf16*>(w1), out, K, N);
  return cudaGetLastError();
}

}  // namespace

// x [A, D] bf16 sorted by expert, offsets [E + 1] int32 (expert e's rows are
// offsets[e] .. offsets[e + 1] - 1, offsets[E] = A), w_gate / w_up [E, D, I]
// and w_down [E, I, D] bf16, h [A, I] bf16 scratch, y [A, D] fp32 out.  D and
// I multiples of 64; every pointer 16-byte aligned.  Returns a cudaError_t
// (0 = success).
extern "C" int dd_moe_grouped(const void* x, const void* offsets, const void* w_gate,
                              const void* w_up, const void* w_down, void* h, void* y, int A, int D,
                              int I, int E, void* stream) {
  if (D % kKC || I % kKC || D % kTileN || I % kTileN) return (int)cudaErrorInvalidValue;
  if (A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  cudaError_t err = launch<true>(x, off, w_gate, w_up, h, D, I, E, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<false>(h, off, w_down, nullptr, y, I, D, E, st);
}
