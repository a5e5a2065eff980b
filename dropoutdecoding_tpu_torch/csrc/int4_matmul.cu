// K6 / K6': packed group-wise int4 matmul for Hopper (sm_90a).
//
// Replaces the TPU kernels int4_matmul
// (dropoutdecoding_tpu/ops/pallas_int4_matmul.py:236, body _kernel :112) and
// int4_matmul_layered (:177), which unpack one group at a time in VMEM and
// pick among four unpack forms to trade vector against matrix-unit time.
// With x [R, D], q4 [D/2, E] int8 and s4 [N, E] fp32 (N = D / g groups; byte
// d of q4 holds contraction row d in its low nibble and row d + D/2 in its
// high nibble, two's complement; groups [0, N/2) scale the low half,
// [N/2, N) the high half) it computes
//
//   y[r, e] = sum_gi  s4[gi, e]       * (x[r, gi*g : (gi+1)*g] . lo[gi*g : (gi+1)*g, e])
//                   + s4[N/2 + gi, e] * (x[r, D/2 + gi*g : D/2 + (gi+1)*g] . hi[same rows, e])
//
// with fp32 dots, the fp32 scale applied to a group's fp32 partial, and the
// groups added in fp32.  All 16 nibble values decode, -8 included.  The
// layered form is the same kernel: a layer of a stacked [L, D/2, E] weight
// is contiguous, so the caller passes that layer's pointer and no copy is
// made.
//
// What bounds it on this card: at the decode forwards (R = 1 or 3) the
// packed bytes, read once: 26.8, 8.9, 47.9 and 23.9 MB for the fused qkv, o,
// fused gate/up and down projections of a 7B layer (8.0, 2.7, 14.3, 7.1 us at
// 3.35 TB/s).  At the prefill (R = 595) the tensor-core FLOPs: 2 R D E is
// 59.9, 20.0, 107.3 and 53.7 GFLOP (60.6, 20.2, 108.5, 54.3 us at 989
// TFLOP/s bf16).  Measured times and the predictions made before them are in
// PERF.md.
//
// Four kernels behind one entry; the caller names the route and the entry
// refuses one the shape cannot take.
//
// int4_wgmma_kernel (bf16 x, more than 16 rows: the prefill; E a multiple of
// 16, groups a multiple of 128, q4 16-byte aligned, which TMA needs).  What
// held the mma.sync tile below at 141-178 TFLOP/s there: mma.sync cannot
// reach the card's tensor rate; its unpack shared issue slots with its mmas
// (about four ALU instructions an mma) and was repeated by both warp rows and
// all ten row blocks; x was re-read from L2 for every 128 channels of a
// 64-row block; loads were issued by the warps that compute.  The design:
//  - The operands are swapped: y^T [E, R] = W^T . x^T, so the wgmma's 64 rows
//    are output channels and its N is x rows.  The weights are the A operand
//    from registers; an x tile [rows][k], k contiguous, is the K-major B
//    operand as TMA lays it in shared memory (128-byte swizzle).
//  - ldmatrix.trans on the byte tile, read as 16-bit elements, gives a thread
//    contraction rows 2t, 2t + 1 of an even and an odd channel in one
//    register; masked, xor-ed into bf16 values of 136 + n and less 136 (exact
//    in bf16) that is one register of a 16 x 16 A fragment whose rows are
//    channels 0, 2, .. 14, 1, 3, .. 15 of the warp's sixteen.  The epilogue
//    undoes the order: a thread's two accumulator rows are adjacent channels,
//    stored as one pair.  A warpgroup decodes 8 weights a thread for each
//    wgmma of 64 x 120 or 64 x 152 x 16: nothing is decoded twice in a block.
//  - The scale is per accumulator row: a step is one 128-row stretch of the
//    packed matrix inside one group; its low plane runs against x's first
//    half and its high plane against x's second half, eight wgmmas each into
//    one accumulator set (scale_d = 0 on the first), which the thread's two
//    (group, channel) scales add into the totals: the fp32 scale lands on an
//    fp32 partial, as in the twin.  Totals and one running set are 2 x ROWS / 2
//    registers a thread, so a block is 128 channels (two consumer warpgroups
//    of 64) by 120 or 152 rows; setmaxnreg gives consumers 240 registers, the
//    producer 24; no spills.
//  - A producer warp keeps two TMA rings full with mbarriers: four x tiles
//    (one step's 128 contraction rows of one half of x) and two byte tiles
//    (128 packed rows by 128 channels, swizzled so that ldmatrix meets no
//    bank conflict).  Rows of x past R and channels past E arrive as zeros
//    from the tensor maps, which the C entry encodes on the host for every
//    call and passes as __grid_constant__ parameters.  The bytes of a step go
//    to registers at once and free their tile.
//  - With 120 rows the registers allow two sets of A fragments: one plane's
//    are decoded while the other's wgmmas run.  With 152 rows one set.
//  - L2: a block reads 128 + 4 ROWS bytes a packed row for 512 ROWS FLOP (101
//    FLOP/B at 120 rows, 107 at 152); gate_up's 860 blocks move 1.07 GB
//    through L2 against 1.3 GB before.  Row tiles vary fastest in the grid, so
//    the five blocks of a channel tile run together and share its bytes, and
//    all resident blocks share x (4.9 MB).  256 channels a block halved the x
//    traffic and changed no time: L2 does not bound this kernel.
//  - An SM holds one block, so blocks run in waves of 132.  595 rows by 4096
//    channels are 160 blocks of 120 rows (two waves) or 128 of 152 rows (one):
//    the caller picks the row tile whose waves times rows is least.
//  - What still bounds it, at 500-540 TFLOP/s: each batch of eight wgmmas is
//    drained (wgmma.wait_group 0) before its sums can be scaled, and both
//    warpgroups tend to drain together.  Letting them take turns on a named
//    barrier pair changed nothing; a second accumulator set with per-wgmma
//    groups made ptxas serialize the wgmmas (C7514) and was slower.
//  No float atomics and one block per output tile: results are bit-equal run
//  to run.
//
// int4_tile_kernel (bf16 x, up to 16 rows: the decode forwards' 1 and 3; the same
// E, group and alignment conditions as above, since it reads through tensor
// maps).  What held the tile it replaces (16 rows by 128 channels, the
// contraction cut over 4-16 short-lived blocks, a second launch to add them) at
// 1.0-1.2 TB/s, as measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): not the
// layout, whose 64- to 256-byte row segments all stream at the same 1.7-2.0
// TB/s through a TMA ring; but that a
// global round trip costs 1-2 us on this card, so a launch is about 4 us old
// before its first bytes land and every hand-over between blocks (a fence, an
// arrival count, the pieces read back; or a second launch) adds 4-5 us; that
// the scales, read from global memory inside the loop, stalled every chunk; and
// that the decode, about 1.4 ALU instructions a nibble beside mma.sync tiles of
// which up to 8 x rows filled half, took as long as the load.  The design:
//  - No sum crosses a block.  A tile is 64 channels over the whole contraction,
//    and one persistent block an SM takes tiles b, b + blocks, ...: no scratch,
//    no counter, no fence, no second kernel, and the same bits every run.  (A
//    version that cut the (256-channel tile, chunk) list into equal spans, one a
//    block, and had the last block of a tile to arrive add the pieces lost 4-5
//    us at its end and 7-14 us wherever a fence met a full ring.)
//  - A producer warp issues the TMA loads of a stage against its mbarrier: four
//    dense byte boxes [128 packed rows][64 channels], the item's x (sixteen
//    boxes [8 or 16 rows][64 k] out of L2) and its groups' scales (two 256-byte
//    bulk copies a box), through a ring of four 50 KB stages that stays full
//    across tile boundaries.  Sixteen consumer warps wait on the stage's
//    mbarrier and free it with one arrival a warp; nothing in the loop is a
//    __syncthreads.
//  - Warp (q, c) takes box q of every item against channels 16 c .. 16 c + 15.
//    The operands are swapped as in the warpgroup kernel: the decoded weights
//    are the mma's 16-row A fragment (decode_fragment), x its 8-column B
//    fragment, so up to 8 rows of x fill whole tiles.  Each plane has its own
//    accumulator set, scaled into the warp's totals by the box's fp32 group
//    scales; when a tile is done the four quarters' totals are added in quarter
//    order through shared memory and written.
//  - What still bounds it: o and down have 64 tiles, so 64 of the 132 SMs
//    decode them (about 32 KB/us an SM); the first bytes land about 4 us after
//    the launch.
//  With a null s4 the consumers skip the decode and the mmas and a block writes
//  one word: the stream alone, for telling the memory pattern from the work.
//
// int4_mma_kernel (bf16 x on mma.sync m16n8k16, a 64-row by 128-channel tile
// of eight warps over the whole contraction): the shapes neither kernel above
// takes (E not a multiple of 16, a group that is no multiple of 128, an
// unaligned view), at any row count.  No model of the port produces one; the
// ragged check shape (E = 130, groups of 32) does.  A block walks its packed
// rows in chunks of up to 128 inside one group.  A chunk's bytes and the two
// matching x panels travel to shared memory with cp.async while the chunk
// before is used (two stages).  The same ldmatrix.trans read yields the
// k-pairs of an mma B fragment for the even channel, and 8 bits higher for
// the odd one.  The low plane runs against x's first half, then the high
// plane against its second half, each into one accumulator set that is scaled
// into the totals by the group's fp32 scales at the end of the chunk.
//
// int4_fma_kernel (fp32 x): fp32 FMAs, so that the card agrees with the CPU
// to summation order; the narrow card-against-CPU model check comes this way.
// A block owns 128 output channels, up to 4 rows of x and a range of packed
// rows; a lane owns 4 channels, one 32-bit word of a packed row, so a warp
// reads 128 contiguous bytes a row, 16 rows in flight.  Both nibbles of a byte
// become floats without a conversion instruction (the nibble, xor 8, is
// or-ed into the mantissa of 2^23 and 2^23 + 8 is subtracted) and are
// multiplied into fp32 sums, one set for each plane; when a warp's rows leave
// a group, the sums are scaled into the warp's totals.  Warps add their
// totals through shared memory in warp order, blocks through fp32 partials
// that int4_combine_kernel adds in split order.  More than 4 rows re-read the
// weights for every 4 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStep = 16;           // contraction rows per step; g must be a multiple
constexpr int kFmaThreads = 256;
constexpr int kFmaWarps = kFmaThreads / 32;
constexpr int kTileE = 128;         // channels per FMA block: 32 lanes x 4
constexpr int kRows = 4;            // x rows per FMA block
constexpr int kMaxBlockK = 1024;    // packed rows per FMA block

// out[i] = v, in float32 or rounded to bfloat16.
__device__ __forceinline__ void store(void* out, size_t i, float v, int out_f32) {
  if (out_f32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<bf16*>(out)[i] = __float2bfloat16(v);
  }
}

// The two's-complement nibble at bit `shift` of w, as a float: n ^ 8 is
// n + 8 as an unsigned value, which becomes the low mantissa bits of 2^23.
__device__ __forceinline__ float nibble_f(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u) - 8388616.f;
}

// Four channels of one packed row, starting at channel e.  With `aligned`
// (E a multiple of 4 and the matrix 4-byte aligned) a word is inside the row
// or outside it as a whole.
__device__ __forceinline__ uint32_t load_word(const int8_t* row, int e, int E, bool aligned) {
  if (aligned) return e < E ? __ldg(reinterpret_cast<const uint32_t*>(row + e)) : 0u;
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (e + c < E) w |= (uint32_t)(uint8_t)row[e + c] << (8 * c);
  return w;
}

template <int RC>
__global__ void __launch_bounds__(kFmaThreads) int4_fma_kernel(
    const float* __restrict__ x,     // [R, 2 * D2]
    const int8_t* __restrict__ q4,   // [D2, E]
    const float* __restrict__ s4,    // [2 * n2, E]
    float* __restrict__ out,         // [R, E]; written when partial is null
    float* __restrict__ partial,     // [splits, R, E], or null
    int R, int D2, int E, int n2, int g, int block_k, int aligned) {
  // x panels [2][RC][kMaxBlockK] during the sums, then warp totals
  // [kFmaWarps][RC][kTileE] (half the size)
  __shared__ __align__(16) float smem[2 * RC * kMaxBlockK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = blockIdx.x * kTileE;
  const int kb0 = blockIdx.y * block_k;
  const int nk = min(block_k, D2 - kb0);
  const int r0 = blockIdx.z * kRows;
  const size_t D = 2 * (size_t)D2;

  for (int i = tid; i < RC * nk; i += kFmaThreads) {
    const int r = i / nk, k = i - r * nk;
    const bool in = r0 + r < R;
    const float* xr = x + (size_t)(r0 + r) * D + kb0 + k;
    smem[r * kMaxBlockK + k] = in ? xr[0] : 0.f;
    smem[(RC + r) * kMaxBlockK + k] = in ? xr[D2] : 0.f;
  }
  __syncthreads();

  float y[RC][4], alo[RC][4], ahi[RC][4];
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) y[r][c] = alo[r][c] = ahi[r][c] = 0.f;

  const int e = e0 + lane * 4;
  const int chunks = nk / kStep;
  const int per = (chunks + kFmaWarps - 1) / kFmaWarps;
  const int c_end = min(chunks, (warp + 1) * per);
  for (int c = warp * per; c < c_end; ++c) {
    const int k = c * kStep;
    uint32_t w[kStep];
#pragma unroll
    for (int j = 0; j < kStep; ++j)
      w[j] = load_word(q4 + (size_t)(kb0 + k + j) * E, e, E, aligned);
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      float lo[4], hi[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        lo[ch] = nibble_f(w[j], 8 * ch);
        hi[ch] = nibble_f(w[j], 8 * ch + 4);
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float xl = smem[r * kMaxBlockK + k + j];
        const float xh = smem[(RC + r) * kMaxBlockK + k + j];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          alo[r][ch] = fmaf(xl, lo[ch], alo[r][ch]);
          ahi[r][ch] = fmaf(xh, hi[ch], ahi[r][ch]);
        }
      }
    }
    // the warp's rows leave the group, or end: scale the sums into the totals
    if (c + 1 == c_end || (kb0 + k + kStep) % g == 0) {
      const int gi = (kb0 + k) / g;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const bool in = e + ch < E;
        const float sl = in ? s4[(size_t)gi * E + e + ch] : 0.f;
        const float sh = in ? s4[(size_t)(n2 + gi) * E + e + ch] : 0.f;
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          y[r][ch] = fmaf(ahi[r][ch], sh, fmaf(alo[r][ch], sl, y[r][ch]));
          alo[r][ch] = ahi[r][ch] = 0.f;
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the x panels
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) smem[(warp * RC + r) * kTileE + lane * 4 + ch] = y[r][ch];
  __syncthreads();
  for (int i = tid; i < RC * kTileE; i += kFmaThreads) {
    const int r = i / kTileE, c = i - r * kTileE;
    if (r0 + r >= R || e0 + c >= E) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kFmaWarps; ++wi) v += smem[(wi * RC + r) * kTileE + c];
    const size_t idx = (size_t)(r0 + r) * E + e0 + c;
    if (partial != nullptr) {
      partial[(size_t)blockIdx.y * R * E + idx] = v;
    } else {
      out[idx] = v;
    }
  }
}

__global__ void int4_combine_kernel(const float* __restrict__ partial, void* __restrict__ out,
                                    int splits, size_t n, int out_f32) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[(size_t)s * n + i];
  store(out, i, v, out_f32);
}

// ---- tensor cores -----------------------------------------------------------

constexpr int kKC = 128;       // packed rows per staged chunk, at most
constexpr int kLDX = kKC + 8;  // x panel row stride in elements: fragment reads hit 32 banks
constexpr int kStages = 2;
constexpr int kSmallRows = 16;  // rows up to which the whole-tile kernel runs

// The shape of a block: WM x WN warps, each MT m-tiles of 16 rows by 32 channels.
template <int MT, int WM, int WN>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kBM = 16 * MT * WM;             // x rows per block
  static constexpr int kBN = 32 * WN;                  // channels per block
  static constexpr int kLDW = kBN + 16;                // byte tile row stride
  static constexpr int kPanel = kBM * kLDX;            // elements of one x panel
  // a stage: the two x panels, then the byte tile
  static constexpr int kStageBytes = 2 * kPanel * (int)sizeof(bf16) + kKC * kLDW;
};
// Tile<2, 2, 4> is the one shape built: 64 rows x 128 channels, eight warps.

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

// The nibbles at bits 0-3 and 16-19 of v as two bf16 values: n ^ 8 in the
// mantissa of 128 is 136 + n, and the bf16 subtraction of 136 is exact.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  uint32_t u = (v & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t c = 0x43084308u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&u),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Four 8x8 b16 matrices from shared memory as one A fragment: lanes 0-15 give
// the addresses of rows 0-15 at columns 0-7, lanes 16-31 at columns 8-15.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Sixteen packed rows by sixteen channels of the byte tile, transposed: lanes
// 0-15 give the addresses of rows 0-15 (16 bytes each).  Taking two adjacent
// bytes as one b16 element, lane (group, t) receives in r0 the bytes of rows
// 2t, 2t+1 at channels 2 group, 2 group + 1 (bits 0-7: row 2t, even channel;
// 8-15: row 2t, odd; 16-23: row 2t+1, even; 24-31: row 2t+1, odd) and in r1
// the same of rows 2t+8, 2t+9: the k-pairs of an mma B fragment for the even
// channels and, shifted by 8, for the odd ones.
__device__ __forceinline__ void ldmatrix_w(uint32_t& r0, uint32_t& r1, const uint8_t* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// 16 bytes from global to shared memory without passing through registers;
// with `in` false nothing is read and the 16 bytes are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// KC: the staged chunk's packed rows when known at compile time (the k-step
// loops then unroll, and fragment loads run ahead of the mmas), or 0 to take
// them from kc.  A block takes the whole contraction.
template <int KC, int MT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2) int4_mma_kernel(
    const bf16* __restrict__ x,      // [R, 2 * D2]
    const int8_t* __restrict__ q4,   // [D2, E]
    const float* __restrict__ s4,    // [2 * n2, E]
    void* __restrict__ out,          // [R, E], bf16 or float
    int R, int D2, int E, int n2, int g, int kc_arg, int out_f32, int aligned16) {
  extern __shared__ __align__(16) unsigned char stages[];  // [kStages][kStageBytes]
  using TL = Tile<MT, WM, WN>;
  constexpr int kThreads = TL::kThreads, kBM = TL::kBM, kBN = TL::kBN, kLDW = TL::kLDW;
  constexpr int kPanel = TL::kPanel, kStageBytes = TL::kStageBytes;
  const int kc = KC ? KC : kc_arg;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tg = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int r0 = blockIdx.x * kBM, e0 = blockIdx.y * kBN;
  const size_t D = 2 * (size_t)D2;
  const int vec = kc / 8;  // 16-byte words per x panel row

  // Starts the copies of chunk k0 into a stage: the two x panels (rows past R
  // zero) and the packed bytes (channels past E zero).
  auto load_chunk = [&](unsigned char* stage, int k0) {
    bf16* panels = reinterpret_cast<bf16*>(stage);
    uint8_t* w_s = stage + 2 * kPanel * sizeof(bf16);
    for (int i = tid; i < 2 * kBM * vec; i += kThreads) {
      const int half = i / (kBM * vec), rem = i - half * kBM * vec;
      const int row = rem / vec, c = rem - row * vec;
      const bool in = r0 + row < R;
      const bf16* src = in ? x + (size_t)(r0 + row) * D + (size_t)half * D2 + k0 + c * 8 : x;
      cp_async16(panels + half * kPanel + row * kLDX + c * 8, src, in);
    }
    if (aligned16) {
      for (int i = tid; i < kc * (kBN / 16); i += kThreads) {
        const int row = i / (kBN / 16), c = i - row * (kBN / 16);
        const bool in = e0 + c * 16 < E;
        const int8_t* src = in ? q4 + (size_t)(k0 + row) * E + e0 + c * 16 : q4;
        cp_async16(w_s + row * kLDW + c * 16, src, in);
      }
    } else {
      for (int i = tid; i < kc * kBN; i += kThreads) {
        const int row = i / kBN, c = i - row * kBN;
        w_s[row * kLDW + c] = e0 + c < E ? (uint8_t)q4[(size_t)(k0 + row) * E + e0 + c] : 0;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float y[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[mt][nt][i] = 0.f;

  // n-tile nt = 2p + q of this warp holds channels wn * 32 + p * 16 + 2j + q,
  // j = 0..7, so accumulator i of a thread is channel
  // wn * 32 + p * 16 + 4 tg + 2 (i & 1) + q
  const int col0 = e0 + wn * 32 + tg * 4;

  const int n_chunks = D2 / kc;
  load_chunk(stages, 0);
  for (int it = 0; it < n_chunks; ++it) {
    unsigned char* stage = stages + (it & 1) * kStageBytes;
    if (it + 1 < n_chunks) {  // the next chunk travels while this one is used
      load_chunk(stages + ((it + 1) & 1) * kStageBytes, (it + 1) * kc);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* w_s = stage + 2 * kPanel * sizeof(bf16);
    const int gi = it * kc / g;  // a chunk lies inside one group

    // the low plane against x's first half, then the high plane against its
    // second: one accumulator set, scaled into the totals after each plane
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const bf16* x_s = reinterpret_cast<const bf16*>(stage) + plane * kPanel;
      const float* srow = s4 + (size_t)(plane * n2 + gi) * E;
      float sc[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + (nt >> 1) * 16 + 2 * j + (nt & 1);
          sc[nt][j] = col < E ? srow[col] : 0.f;
        }
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
      for (int ks = 0; ks < kc / kStep; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_a(a[mt], x_s + ((wm * MT + mt) * 16 + (lane & 15)) * kLDX + ks * kStep +
                                (lane >> 4) * 8);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r0w, r1w;
          ldmatrix_w(r0w, r1w, w_s + (ks * kStep + (lane & 15)) * kLDW + wn * 32 + p * 16);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const uint32_t b0 = nibbles_bf16x2(r0w >> (8 * q + 4 * plane));
            const uint32_t b1 = nibbles_bf16x2(r1w >> (8 * q + 4 * plane));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][2 * p + q], a[mt], b0, b1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            y[mt][nt][i] = fmaf(acc[mt][nt][i], sc[nt][i & 1], y[mt][nt][i]);
    }
    __syncthreads();  // the stage is consumed before the chunk after next lands in it
  }

  const int gr = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (wm * MT + mt) * 16 + gr + (i >> 1) * 8;
        const int col = col0 + (nt >> 1) * 16 + 2 * (i & 1) + (nt & 1);
        if (row >= R || col >= E) continue;
        store(out, (size_t)row * E + col, y[mt][nt][i], out_f32);
      }
}

// ---- whole tiles on mma.sync (the decode forwards) -------------------------------

// One register of ldmatrix_x4_trans over the byte tile holds, for channels 2
// group and 2 group + 1 of the warp's sixteen, packed rows 2t and 2t + 1 (bits
// 0-7: row 2t, even channel; 8-15: row 2t, odd; 16-23: row 2t + 1, even; 24-31:
// row 2t + 1, odd).  w0 is that of packed rows 0-7 of a k-step and w1 of rows
// 8-15, so the four values below are the A fragment of a 16 x 16 tile whose row
// `group` is channel 2 group and whose row group + 8 is channel 2 group + 1.
__device__ __forceinline__ void decode_fragment(uint32_t (&a)[4], uint32_t w0, uint32_t w1,
                                                int plane) {
  a[0] = nibbles_bf16x2(w0 >> (4 * plane));
  a[1] = nibbles_bf16x2(w0 >> (8 + 4 * plane));
  a[2] = nibbles_bf16x2(w1 >> (4 * plane));
  a[3] = nibbles_bf16x2(w1 >> (8 + 4 * plane));
}


constexpr int kTcChannels = 64;   // channels per tile
constexpr int kTcRows = 128;      // packed rows per byte box, the share of one warp quarter
constexpr int kTcBoxes = 4;       // byte boxes per item: 512 packed rows
constexpr int kTcConsumers = 512; // sixteen warps: four channel groups by four quarters
constexpr int kTcThreads = kTcConsumers + 32;  // and the producer's warp
constexpr int kTcBox = kTcRows * kTcChannels;  // one byte box [128 packed rows][64 channels], dense
constexpr int kTcMaxStages = 4;

// XR: x rows a stage carries, 8 or 16.  A stage: the four byte boxes; x as
// sixteen sub-tiles [XR][64 k] bf16 (rows of 128 bytes, swizzled): the item's 512
// contraction rows of x's first half, then of its second half; and the scales
// of the item's four groups for the tile's channels, fp32, [group][low plane,
// high plane][64].
template <int XR>
struct TcTile {
  static constexpr int kXSub = XR * 128;
  static constexpr int kX = kTcBoxes * kTcBox;                 // offset of x
  static constexpr int kScales = kX + 4 * kTcBoxes * kXSub;    // offset of the scales
  static constexpr int kStage = kScales + kTcBoxes * 2 * kTcChannels * (int)sizeof(float);
  static constexpr int kStages = XR == 8 ? 4 : 3;  // what fits beside the exchange
  // the sums of three quarters: 4 XR / 8 a thread
  static constexpr int kExchange = 3 * (kTcConsumers / 4) * (XR / 2) * (int)sizeof(float);
  static constexpr int kSmem = kStages * kStage + kExchange + 1024;  // + alignment
};

// All consumer threads, and only they: the producer's warp never joins.
__device__ __forceinline__ void tc_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// Block b takes the 64-channel tiles b, b + blocks, ..., each over the whole
// contraction in items of up to four byte boxes, so no sum crosses a block.
template <int XR>
__global__ void __launch_bounds__(kTcThreads, 1) int4_tile_kernel(
    const __grid_constant__ CUtensorMap x_map,  // bf16 [R, 2 * D2], box [XR][64], swizzled
    const __grid_constant__ CUtensorMap w_map,  // uint8 [D2, E], box [128][64], dense
    const float* __restrict__ s4,               // [2 * n2, E], or null: the stream alone
    void* __restrict__ out,                     // [R, E], bf16 or float
    int R, int D2, int E, int n2, int g, int out_f32) {
  using TL = TcTile<XR>;
  constexpr int kStages = TL::kStages;
  extern __shared__ unsigned char tc_smem[];
  __shared__ uint64_t full[kTcMaxStages], empty[kTcMaxStages];
  unsigned char* ring = hopper::align_1024(tc_smem);
  float* exchange = reinterpret_cast<float*>(ring + kStages * TL::kStage);
  const int n_boxes = D2 / kTcRows, items = (n_boxes + kTcBoxes - 1) / kTcBoxes;
  const int tiles = (E + kTcChannels - 1) / kTcChannels;
  const bool probe = s4 == nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);                   // the producer's expect_tx arrival
      hopper::mbar_init(&empty[s], kTcConsumers / 32);  // one lane of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // The producer: one thread keeps the ring full, across tile boundaries.
    // Rows of x past R and channels past E arrive as zeros.
    if (threadIdx.x == kTcConsumers) {
      int n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int it = 0; it < items; ++it, ++n) {
          const int e0 = tile * kTcChannels, k0 = it * kTcBoxes * kTcRows, s = n % kStages;
          const int nb = min(kTcBoxes, n_boxes - it * kTcBoxes);
          const int sc_bytes = probe ? 0 : min(kTcChannels, E - e0) * (int)sizeof(float);
          unsigned char* stage = ring + s * TL::kStage;
          hopper::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s],
                                        nb * (kTcBox + 4 * TL::kXSub + 2 * sc_bytes));
          for (int q = 0; q < nb; ++q) {
            hopper::tma_load_2d(stage + q * kTcBox, &w_map, &full[s], e0, k0 + q * kTcRows);
            if (sc_bytes) {
              const int gi = (k0 + q * kTcRows) / g;  // a box lies inside one group
              float* sc_s = reinterpret_cast<float*>(stage + TL::kScales) + q * 2 * kTcChannels;
              hopper::bulk_load(sc_s, s4 + (size_t)gi * E + e0, sc_bytes, &full[s]);
              hopper::bulk_load(sc_s + kTcChannels, s4 + (size_t)(n2 + gi) * E + e0, sc_bytes,
                                &full[s]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)  // the box's 128 k of either half of x, 64 a sub-tile
              hopper::tma_load_2d(stage + TL::kX + ((j >> 1) * 2 * kTcBoxes + 2 * q + (j & 1)) * TL::kXSub,
                                  &x_map, &full[s], (j >> 1) * D2 + k0 + q * kTcRows + (j & 1) * 64,
                                  0);
          }
        }
    }
    return;
  }

  // Warp (wq, wc) takes byte box wq of every item against channels [16 wc, 16
  // wc + 16) of the tile.  The operands are swapped, as in the warpgroup kernel:
  // an mma's 16 rows are channels (the weights its A fragment, decoded in
  // registers), its 8 columns x rows (x its B fragment), so that up to 8 rows of
  // x waste no half of a tile.  Accumulator i of n-tile nn is channel 16 wc + 2
  // gr + (i >> 1) of the tile, x row 8 nn + 2 tg + (i & 1).
  constexpr int NT = XR / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp >> 2, wc = warp & 3;
  const int gr = lane >> 2, tg = lane & 3;
  const int slot = wc * 32 + lane;  // of the 128 threads of a quarter
  float y[NT][4];
#pragma unroll
  for (int nn = 0; nn < NT; ++nn)
#pragma unroll
    for (int i = 0; i < 4; ++i) y[nn][i] = 0.f;
  float seen = 0.f;  // the probe's one word

  int n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e0 = tile * kTcChannels;
    for (int it = 0; it < items; ++it, ++n) {
      const int s = n % kStages;
      const int nb = min(kTcBoxes, n_boxes - it * kTcBoxes);
      const unsigned char* stage = ring + s * TL::kStage;
      hopper::mbar_wait(&full[s], (n / kStages) & 1);
      if (probe) {
        seen += (float)stage[tid];
      } else if (wq < nb) {
        float acc[2][NT][4];  // [plane][n-tile][i]
#pragma unroll
        for (int plane = 0; plane < 2; ++plane)
#pragma unroll
          for (int nn = 0; nn < NT; ++nn)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[plane][nn][i] = 0.f;
        const uint32_t w_s = hopper::smem_u32(stage + wq * kTcBox) + wc * 16;
        const uint32_t x_s = hopper::smem_u32(stage + TL::kX);
#pragma unroll
        for (int kk = 0; kk < kTcRows / 32; ++kk) {
          // 32 packed rows of the warp's 16 channels: k-steps 2 kk, 2 kk + 1 of the box
          uint32_t w[4];
          hopper::ldmatrix_x4_trans(w, w_s + (kk * 32 + lane) * kTcChannels);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ks = 2 * kk + h;  // of the box's eight
            uint32_t xb[2][NT][2];      // x as B fragments: [plane][n]{k 0-7, k 8-15 of the step}
#pragma unroll
            for (int plane = 0; plane < 2; ++plane) {
              const uint32_t sub =
                  x_s + (plane * 2 * kTcBoxes + 2 * wq + (ks >> 2)) * TL::kXSub;
              const int c = 2 * (ks & 3) + ((lane >> 3) & 1);
              if constexpr (NT == 2) {
                const int xr = (lane & 7) + 8 * (lane >> 4);
                uint32_t r[4];
                ldmatrix_x4(r, sub + xr * 128 + ((c ^ (xr & 7)) << 4));
                xb[plane][0][0] = r[0], xb[plane][0][1] = r[1];
                xb[plane][1][0] = r[2], xb[plane][1][1] = r[3];
              } else {
                const int xr = lane & 7;
                ldmatrix_x2(xb[plane][0][0], xb[plane][0][1], sub + xr * 128 + ((c ^ xr) << 4));
              }
            }
#pragma unroll
            for (int plane = 0; plane < 2; ++plane) {
              uint32_t a[4];
              decode_fragment(a, w[2 * h], w[2 * h + 1], plane);
#pragma unroll
              for (int nn = 0; nn < NT; ++nn)
                mma_bf16(acc[plane][nn], a, xb[plane][nn][0], xb[plane][nn][1]);
            }
          }
        }
        // the box's group scales of the thread's two channels; a channel past E
        // finds what the stage held before, and its sums are never stored
        const float* sc_s = reinterpret_cast<const float*>(stage + TL::kScales) +
                            wq * 2 * kTcChannels + wc * 16 + 2 * gr;
#pragma unroll
        for (int plane = 0; plane < 2; ++plane) {
          const float s0 = sc_s[plane * kTcChannels], s1 = sc_s[plane * kTcChannels + 1];
#pragma unroll
          for (int nn = 0; nn < NT; ++nn)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              y[nn][i] = fmaf(acc[plane][nn][i], i >> 1 ? s1 : s0, y[nn][i]);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    if (probe) continue;

    // The tile is done: the other quarters' sums join the first quarter's, in
    // quarter order.  The first barrier says the exchange's last reader is done,
    // the second that it is written.
    tc_consumer_sync();
    if (wq > 0) {
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          exchange[(((wq - 1) * NT + nn) * 4 + i) * (kTcConsumers / 4) + slot] = y[nn][i];
    }
    tc_consumer_sync();
    if (wq == 0) {
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = y[nn][i];
#pragma unroll
          for (int q = 0; q < 3; ++q) v += exchange[((q * NT + nn) * 4 + i) * (kTcConsumers / 4) + slot];
          const int row = 8 * nn + 2 * tg + (i & 1), col = e0 + wc * 16 + 2 * gr + (i >> 1);
          if (row < R && col < E) store(out, (size_t)row * E + col, v, out_f32);
        }
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[nn][i] = 0.f;
  }
  if (probe && tid == 0) static_cast<float*>(out)[blockIdx.x] = seen;
}

// ---- the stream alone (measurement) ----------------------------------------------

constexpr int kProbeMaxStages = 8;
constexpr int kProbeRows = 128;      // packed rows per TMA box
constexpr int kProbeConsumers = 512; // threads that wait for a stage and free it
constexpr int kProbeStage = 32768;   // bytes a stage

// Walks over q4 through a ring of `stages` stages of 32 KB, the consumers
// reading one byte a thread of each stage and nothing else; block b writes one
// float to words[b].  spans = 1: the list of (256-channel tile, 128-row chunk)
// pairs, the chunks of a tile adjacent, cut into one equal span a block, a stage
// two swizzled boxes [128 rows][128 channels]: 256 contiguous bytes a row.
// spans = 0: whole tiles of `width` channels (64 or 128), block b taking tiles b,
// b + blocks, ..., a stage 32 KB of dense boxes [128 rows][width].
__global__ void __launch_bounds__(kProbeConsumers + 32, 1) int4_stream_kernel(
    const __grid_constant__ CUtensorMap w_map, float* __restrict__ words, int D2, int E, int width,
    int stages, int spans) {
  extern __shared__ unsigned char probe_smem[];
  __shared__ uint64_t full[kProbeMaxStages], empty[kProbeMaxStages];
  unsigned char* ring = hopper::align_1024(probe_smem);
  const int box_bytes = kProbeRows * (spans ? 128 : width);
  const int boxes = kProbeStage / box_bytes;  // of a stage
  const int n_chunks = D2 / kProbeRows, tiles = (E + width - 1) / width;
  // the block's items: a span of the list, or its tiles' items one after another
  const int per_tile = spans ? n_chunks : (n_chunks + boxes - 1) / boxes;  // rows past D2: zeros
  const long long total = (long long)tiles * per_tile;
  const int i0 = spans ? (int)(blockIdx.x * total / gridDim.x) : 0;
  const int i1 = spans ? (int)((blockIdx.x + 1) * total / gridDim.x)
                       : ((tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * per_tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kProbeConsumers / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x == kProbeConsumers) {
    for (int i = i0, n = 0; i < i1; ++i, ++n) {
      const int tile = spans ? i / per_tile : blockIdx.x + (i / per_tile) * gridDim.x;
      const int it = i % per_tile, s = n % stages;
      hopper::mbar_wait(&empty[s], ((n / stages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&full[s], boxes * box_bytes);
      for (int b = 0; b < boxes; ++b)
        hopper::tma_load_2d(ring + s * kProbeStage + b * box_bytes, &w_map, &full[s],
                            spans ? tile * width + 128 * b : tile * width,
                            spans ? it * kProbeRows : (it * boxes + b) * kProbeRows);
    }
  } else if (threadIdx.x < kProbeConsumers) {
    float seen = 0.f;
    for (int i = i0, n = 0; i < i1; ++i, ++n) {
      const int s = n % stages;
      hopper::mbar_wait(&full[s], (n / stages) & 1);
      seen += (float)(ring + s * kProbeStage)[threadIdx.x * 16];
      __syncwarp();
      if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[s]);
    }
    if (threadIdx.x == 0) words[blockIdx.x] = seen;
  }
}

// ---- warpgroup tensor cores (the prefill) --------------------------------------

constexpr int kWgGroup = 128;    // packed rows per step: the group must be a multiple
constexpr int kWgChannels = 128; // channels per block: one 64-row wgmma per consumer warpgroup
constexpr int kWgThreads = 384;  // two consumer warpgroups and the producer's
constexpr int kWgXStages = 4;    // ring of x tiles, one per (step, plane)
constexpr int kWgWStages = 2;    // ring of byte tiles, one per step
constexpr int kWgWTile = kWgGroup * kWgChannels;  // [128 packed rows][128 channels], swizzled

// ROWS: x rows per block, the wgmma's N.  An x tile is two sub-tiles of
// [ROWS][64 k] bf16 (rows of 128 bytes, swizzled): one step's 128 contraction
// rows of one half of x.
template <int ROWS>
struct WgTile {
  static constexpr int kSub = ROWS * 64 * (int)sizeof(bf16);
  static constexpr int kXTile = 2 * kSub;
  static constexpr int kSmem = kWgXStages * kXTile + kWgWStages * kWgWTile + 1024;  // + alignment
  // 120 rows leave registers for two sets of A fragments, so that one plane's
  // are decoded while the other's wgmmas run; 152 rows for one set
  static constexpr int kSets = ROWS <= 120 ? 2 : 1;
};

template <int ROWS>
__device__ __forceinline__ void wgmma_rs(float (&d)[ROWS / 2], const uint32_t (&a)[4],
                                         uint64_t b_desc, int scale_d) {
  static_assert(ROWS == 120 || ROWS == 152, "instantiate the wgmma shape first");
  if constexpr (ROWS == 120) hopper::wgmma_m64n120k16_rs(d, a, b_desc, scale_d);
  if constexpr (ROWS == 152) hopper::wgmma_m64n152k16_rs(d, a, b_desc, scale_d);
}

// The eight A fragments of one plane of a step, from the step's bytes.
__device__ __forceinline__ void decode_plane(uint32_t (&a)[8][4], const uint32_t (&w)[4][4],
                                             int plane) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    decode_fragment(a[ks], w[ks >> 1][2 * (ks & 1)], w[ks >> 1][2 * (ks & 1) + 1], plane);
}

// y^T [channels, rows] = W^T . x^T: the wgmma's 64 rows are output channels,
// its A operand the weights, decoded in registers, and its B operand an x tile
// in shared memory.  Block (i, j) owns x rows [ROWS i, ROWS (i + 1)) and
// channels [128 j, 128 (j + 1)) over the whole contraction, in steps of one
// 128-row stretch of the packed matrix: its low plane against x's first half,
// then its high plane against x's second half, eight wgmmas each into one
// accumulator set that the stretch's group scales add into the totals.
template <int ROWS>
__global__ void __launch_bounds__(kWgThreads, 1) int4_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map,  // bf16 [R, 2 * D2], box [ROWS][64]
    const __grid_constant__ CUtensorMap w_map,  // uint8 [D2, E], box [128][128]
    const float* __restrict__ s4,               // [2 * n2, E]
    void* __restrict__ out,                     // [R, E], bf16 or float
    int R, int D2, int E, int n2, int g, int out_f32) {
  using TL = WgTile<ROWS>;
  constexpr int kAcc = ROWS / 2, kSets = TL::kSets;
  extern __shared__ unsigned char wg_smem[];
  __shared__ uint64_t x_full[kWgXStages], x_empty[kWgXStages];
  __shared__ uint64_t w_full[kWgWStages], w_empty[kWgWStages];
  unsigned char* x_tiles = hopper::align_1024(wg_smem);
  unsigned char* w_tiles = x_tiles + kWgXStages * TL::kXTile;
  const int r0 = blockIdx.x * ROWS, e0 = blockIdx.y * kWgChannels;
  const int n_steps = D2 / kWgGroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgXStages; ++s) {
      hopper::mbar_init(&x_full[s], 1);   // the producer's expect_tx arrival
      hopper::mbar_init(&x_empty[s], 8);  // one lane of each consumer warp
    }
    for (int s = 0; s < kWgWStages; ++s) {
      hopper::mbar_init(&w_full[s], 1);
      hopper::mbar_init(&w_empty[s], 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // The producer: one thread keeps both rings full.  Rows of x past R and
    // channels past E arrive as zeros.
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 2 * 128) {
      for (int step = 0; step < n_steps; ++step) {
        const int k0 = step * kWgGroup;
        const int ws = step % kWgWStages;
        hopper::mbar_wait(&w_empty[ws], ((step / kWgWStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&w_full[ws], kWgWTile);
        hopper::tma_load_2d(w_tiles + ws * kWgWTile, &w_map, &w_full[ws], e0, k0);
#pragma unroll
        for (int plane = 0; plane < 2; ++plane) {
          const int n = 2 * step + plane, xs = n % kWgXStages;
          hopper::mbar_wait(&x_empty[xs], ((n / kWgXStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&x_full[xs], TL::kXTile);
          unsigned char* x_s = x_tiles + xs * TL::kXTile;
          hopper::tma_load_2d(x_s, &x_map, &x_full[xs], plane * D2 + k0, r0);
          hopper::tma_load_2d(x_s + TL::kSub, &x_map, &x_full[xs], plane * D2 + k0 + 64, r0);
        }
      }
    }
  } else {
    hopper::reg_alloc<240>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int gr = lane >> 2, tg = lane & 3;
    // this warp's 16 channels are 16-byte chunk `chunk` of a byte tile's rows;
    // this thread's accumulator rows are channels ch and ch + 1
    const int chunk = wg * 4 + warp;
    const int ch = e0 + chunk * 16 + 2 * gr;

    float y[kAcc], acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) y[i] = 0.f;
    uint32_t w[4][4];        // a step's 128 packed rows of the warp's channels
    uint32_t a[kSets][8][4];  // A fragments: of one plane, or of both

    // Takes step `step`'s bytes into registers and frees their tile at once.
    auto load_bytes = [&](int step) {
      const int ws = step % kWgWStages;
      hopper::mbar_wait(&w_full[ws], (step / kWgWStages) & 1);
      const uint32_t w_s = hopper::smem_u32(w_tiles + ws * kWgWTile);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int row = h * 32 + lane;
        hopper::ldmatrix_x4_trans(w[h], w_s + row * 128 + ((chunk ^ (row & 7)) << 4));
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&w_empty[ws]);
    };

    load_bytes(0);
    decode_plane(a[0], w, 0);
    for (int step = 0; step < n_steps; ++step) {
      const int gi = step * kWgGroup / g;  // a step lies inside one group
#pragma unroll
      for (int plane = 0; plane < 2; ++plane) {
        const int n = 2 * step + plane, xs = n % kWgXStages;
        hopper::mbar_wait(&x_full[xs], (n / kWgXStages) & 1);
        const uint32_t x_s = hopper::smem_u32(x_tiles + xs * TL::kXTile);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          wgmma_rs<ROWS>(acc, a[plane % kSets][ks],
                         hopper::smem_desc(x_s + (ks >> 2) * TL::kSub + (ks & 3) * 32, 16, 1024),
                         ks > 0);
        hopper::wgmma_commit();
        // while the tensor cores run: the scales, and with two fragment sets
        // the next batch's fragments
        const float* srow = s4 + (size_t)(plane * n2 + gi) * E;
        const float s0 = ch < E ? __ldg(srow + ch) : 0.f;
        const float s1 = ch < E ? __ldg(srow + ch + 1) : 0.f;
        if constexpr (kSets == 2) {
          if (plane == 0) {
            decode_plane(a[1], w, 1);
          } else if (step + 1 < n_steps) {
            load_bytes(step + 1);
            decode_plane(a[0], w, 0);
          }
        }
        hopper::wgmma_wait<0>();
        hopper::keep(acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&x_empty[xs]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) y[i] = fmaf(acc[i], (i & 2) ? s1 : s0, y[i]);
        if constexpr (kSets == 1) {
          if (plane == 0) {
            decode_plane(a[0], w, 1);
          } else if (step + 1 < n_steps) {
            load_bytes(step + 1);
            decode_plane(a[0], w, 0);
          }
        }
      }
    }

    // accumulators 4j .. 4j + 3 of a thread: (channel ch, x rows 8j + 2 tg and
    // the next), then (channel ch + 1, the same rows)
    if (ch < E) {
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + 8 * j + 2 * tg + i;
          if (row >= R) continue;
          const size_t idx = (size_t)row * E + ch;
          const float v0 = y[4 * j + i], v1 = y[4 * j + 2 + i];
          if (out_f32) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + idx) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
    }
  }
}

struct Call {
  const void* x;
  const int8_t* q4;
  const float* s4;
  void* out;
  float* partial;  // route 0: [splits, R, E], null unless splits > 1
  int R, D2, E, n2, g, block_k, splits, out_f32;
};

// Adds the splits' partial sums into the output, in split order.
cudaError_t combine(const Call& a, cudaStream_t stream) {
  if (a.partial == nullptr) return cudaSuccess;
  const size_t n = (size_t)a.R * a.E;
  int4_combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      a.partial, a.out, a.splits, n, a.out_f32);
  return cudaGetLastError();
}

template <int MT, int WM, int WN>
cudaError_t launch_mma(const Call& a, cudaStream_t stream) {
  using TL = Tile<MT, WM, WN>;
  int kc = kKC;  // the largest chunk that divides the group
  while (a.g % kc != 0) kc /= 2;
  const int aligned16 = a.E % 16 == 0 && reinterpret_cast<uintptr_t>(a.q4) % 16 == 0;
  const dim3 grid((a.R + TL::kBM - 1) / TL::kBM, (a.E + TL::kBN - 1) / TL::kBN);
  constexpr int smem = kStages * TL::kStageBytes;  // above the 48 KB a kernel gets unasked
  auto kernel = kc == kKC ? int4_mma_kernel<kKC, MT, WM, WN> : int4_mma_kernel<0, MT, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, TL::kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), a.q4, a.s4, a.out, a.R, a.D2, a.E, a.n2, a.g, kc, a.out_f32,
      aligned16);
  return cudaGetLastError();
}

// The tensor maps of x (box [rows][64 k], swizzled) and of the packed bytes (box
// [128 packed rows][channels]: 128 channels swizzled, or 64 dense), which want
// a 16-byte aligned base and row strides that are multiples of 16 bytes.
cudaError_t encode_maps(const Call& a, int x_rows, CUtensorMap* x_map, CUtensorMap* w_map,
                        int channels = 128) {
  if (a.E % 16 != 0 || reinterpret_cast<uintptr_t>(a.q4) % 16 != 0) return cudaErrorInvalidValue;
  {
    const uint64_t dims[2] = {2 * (uint64_t)a.D2, (uint64_t)a.R};
    const uint64_t strides[1] = {2 * (uint64_t)a.D2 * sizeof(bf16)};
    const uint32_t box[2] = {64, (uint32_t)x_rows};
    const cudaError_t err = hopper::encode_tiled(x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x,
                                                 dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const uint64_t dims[2] = {(uint64_t)a.E, (uint64_t)a.D2};
  const uint64_t strides[1] = {(uint64_t)a.E};
  const uint32_t box[2] = {(uint32_t)channels, 128};
  return hopper::encode_tiled(
      w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a.q4, dims, strides, box,
      channels == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// `blocks` persistent blocks, block b taking tiles b, b + blocks, ...; with
// a.s4 null the kernel only streams, and block b writes one float to a.out.
template <int XR>
cudaError_t launch_tiles(const Call& a, int blocks, cudaStream_t stream) {
  using TL = TcTile<XR>;
  const int tiles = (a.E + kTcChannels - 1) / kTcChannels;
  if (a.R > XR || a.g % kTcRows != 0 || blocks < 1 || blocks > tiles ||
      reinterpret_cast<uintptr_t>(a.s4) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  cudaError_t err = encode_maps(a, XR, &x_map, &w_map, kTcChannels);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(int4_tile_kernel<XR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::kSmem);
  if (err != cudaSuccess) return err;
  int4_tile_kernel<XR><<<blocks, kTcThreads, TL::kSmem, stream>>>(
      x_map, w_map, a.s4, a.out, a.R, a.D2, a.E, a.n2, a.g, a.out_f32);
  return cudaGetLastError();
}

cudaError_t launch_tiles_rows(const Call& a, int blocks, cudaStream_t stream) {
  return a.R <= 8 ? launch_tiles<8>(a, blocks, stream) : launch_tiles<16>(a, blocks, stream);
}

template <int ROWS>
cudaError_t launch_wgmma(const Call& a, cudaStream_t stream) {
  using TL = WgTile<ROWS>;
  if (a.g % kWgGroup != 0 || a.splits != 1 || reinterpret_cast<uintptr_t>(a.out) % 8 != 0)
    return cudaErrorInvalidValue;
  static_assert(kWgChannels == 128 && kWgGroup == 128, "encode_maps boxes the bytes 128 x 128");
  CUtensorMap x_map, w_map;
  cudaError_t err = encode_maps(a, ROWS, &x_map, &w_map);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(int4_wgmma_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::kSmem);
  if (err != cudaSuccess) return err;
  // row tiles vary fastest: the blocks of one channel tile run together and
  // share its bytes in L2, and all of them share x
  const dim3 grid((a.R + ROWS - 1) / ROWS, (a.E + kWgChannels - 1) / kWgChannels);
  int4_wgmma_kernel<ROWS><<<grid, kWgThreads, TL::kSmem, stream>>>(
      x_map, w_map, a.s4, a.out, a.R, a.D2, a.E, a.n2, a.g, a.out_f32);
  return cudaGetLastError();
}

template <int RC>
cudaError_t launch_fma(const Call& a, cudaStream_t stream) {
  const int aligned = a.E % 4 == 0 && reinterpret_cast<uintptr_t>(a.q4) % 4 == 0;
  const dim3 grid((a.E + kTileE - 1) / kTileE, a.splits, (a.R + kRows - 1) / kRows);
  int4_fma_kernel<RC><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const float*>(a.x), a.q4, a.s4, static_cast<float*>(a.out), a.partial, a.R, a.D2,
      a.E, a.n2, a.g, a.block_k, aligned);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : combine(a, stream);
}

cudaError_t launch_fma_rows(const Call& a, cudaStream_t stream) {
  switch (a.R < kRows ? a.R : kRows) {
    case 1: return launch_fma<1>(a, stream);
    case 2: return launch_fma<2>(a, stream);
    case 3: return launch_fma<3>(a, stream);
    default: return launch_fma<4>(a, stream);
  }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; out_f32: the output is float32 (else
// x's dtype).  x [R, 2 * D2], q4 [D2, E] int8, s4 [N, E] float32, out [R, E].
// route: 0 = fp32 FMAs (float32 x); 1 = the mma.sync tile (bfloat16 x, any
// shape); 2 = the warpgroup kernel (bfloat16 x, more than 16 rows) with
// row_tile = 120 or 152 x rows a block; 3 = the whole-tile kernel (bfloat16 x, up
// to 16 rows).  Routes 2 and 3 want E a multiple of 16, the group a multiple of
// 128 and q4 and s4 on 16-byte boundaries.  The caller picks the route, and one
// the shape cannot take is refused.  On route 0 a block takes block_k packed
// rows (a multiple of 16, at most 1024), so splits = ceil(D2 / block_k), and
// with splits > 1 the blocks' fp32 sums go through partial [splits, R, E]
// float32.  On route 3 splits is the number of persistent blocks, at most the
// number of 64-channel tiles.  The group size D2 / (N / 2) must be a multiple
// of 16.  Returns a cudaError_t.
extern "C" int dd_int4_matmul(int x_dtype, int out_f32, const void* x, const void* q4,
                              const void* s4, void* out, void* partial, int R, int D2, int E,
                              int N, int block_k, int splits, int route, int row_tile,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || E < 1 || D2 < 1 || N < 2 || N % 2 != 0 || D2 % (N / 2) != 0)
    return (int)cudaErrorInvalidValue;
  const int n2 = N / 2, g = D2 / n2;
  if (g % kStep != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const Call call{x, static_cast<const int8_t*>(q4), static_cast<const float*>(s4), out,
                  splits > 1 && route == 0 ? static_cast<float*>(partial) : nullptr, R, D2, E,
                  n2, g, block_k, splits, x_dtype == 0 ? 1 : out_f32};
  if (route == 0) {
    if (x_dtype != 0 || block_k < kStep || block_k % kStep != 0 || block_k > kMaxBlockK ||
        splits != (D2 + block_k - 1) / block_k || (splits > 1 && partial == nullptr))
      return (int)cudaErrorInvalidValue;
    return (int)launch_fma_rows(call, st);
  }
  if (x_dtype != 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (route == 3)
    return R <= kSmallRows && s4 != nullptr ? (int)launch_tiles_rows(call, splits, st)
                                            : (int)cudaErrorInvalidValue;
  if (splits != 1) return (int)cudaErrorInvalidValue;
  if (route == 1) return (int)launch_mma<2, 2, 4>(call, st);
  if (route != 2 || R <= kSmallRows) return (int)cudaErrorInvalidValue;
  if (row_tile == 120) return (int)launch_wgmma<120>(call, st);
  if (row_tile == 152) return (int)launch_wgmma<152>(call, st);
  return (int)cudaErrorInvalidValue;
}

// A walk's memory pattern alone, for measurement (profile_decode.py).  mode -1:
// the whole-tile kernel itself, its consumers neither decoding nor multiplying,
// over x [R, 2 * D2] bfloat16 and q4 [D2, E] with `blocks` blocks.  mode 0:
// int4_stream_kernel's walk of equal spans of the (256-channel tile, chunk)
// list; mode 1: its walk of whole tiles of `width` channels, 64 or 128; both
// with `stages` stages of 32 KB.  Block b writes one float to words [blocks].
extern "C" int dd_int4_stream_probe(const void* x, const void* q4, void* words, int R, int D2,
                                    int E, int width, int stages, int mode, int blocks,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > kSmallRows || E < 1 || D2 < 4 * kProbeRows || D2 % kProbeRows != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Call call{x, static_cast<const int8_t*>(q4), nullptr, words, nullptr, R, D2, E,
                  D2 / kProbeRows, kProbeRows, D2, blocks, 1};
  if (mode == -1) return (int)launch_tiles_rows(call, blocks, st);
  if ((mode == 0 && width != 256) || (mode == 1 && width != 64 && width != 128) || mode < 0 ||
      mode > 1 || stages < 1 || stages > kProbeMaxStages)
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  cudaError_t err = encode_maps(call, 8, &x_map, &w_map, mode == 0 ? 128 : width);
  if (err != cudaSuccess) return (int)err;
  const int smem = stages * kProbeStage + 1024;
  err = cudaFuncSetAttribute(int4_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int4_stream_kernel<<<blocks, kProbeConsumers + 32, smem, st>>>(
      w_map, static_cast<float*>(words), D2, E, width, stages, mode == 0);
  return (int)cudaGetLastError();
}
