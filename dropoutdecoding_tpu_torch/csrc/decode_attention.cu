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
// always-present self score.
//
// What bounds it on this card: the cache bytes.  One decode step at the
// LLaVA-1.5 slice shape reads a layer's K and V panels, 2 x S x KH x D x 2 B
// = 18.9 MB at S = 1152 in bf16, about 5.6 us at 3.35 TB/s; the M x G query
// rows add M x G x D x 4 FLOPs per slot, far under the compute roof.  So the
// design reads each group's [S, D] panel once for all M x G query rows (no
// repeat_kv copy), splits S across blocks so that B x KH x splits blocks
// fill the 132 SMs, and skips every tile no member attends (the slots past
// the current length), so the bytes read follow the cache's fill, not its
// capacity.
//
// Pass 1 (partial_kernel): one block per (b, g, S-tile).  The tile's K and
// V panels are staged in shared memory with 16-byte loads all in flight;
// scores by one warp per slot; the tile's max and exp-sum per row; the
// unnormalised PV.  Writes (max, sum, acc[D]) per row.
// Pass 2 (combine_kernel): one block per (b, g).  Merges the tiles' partial
// softmaxes with the self score (fp32 online-softmax rescaling) and writes
// the output in the input type.
//
// K3 is the same two passes with the cache panels in int8 (one 16-byte load
// is 16 values; a D = 128 head row is 128 B) and the scales of the tile's 64
// slots, contiguous in the head-major [B, KH, S] layout, staged beside them.
// The key scale multiplies the score after the dot, and the value scale the
// unnormalised probability before PV, as the reference does; the softmax
// denominator takes the unscaled probabilities.  At the int8 slice's fill
// (620 slots x 32 heads x 128 x 2 panels) a layer reads 5.1 MB, about 1.5 us
// at 3.35 TB/s; K1 runs at ~13x its byte floor, so latency (the launch, the
// dependent load-reduce chain of each tile, the combine), not bytes, is what
// bounds this simple version.
//
// Templated on bf16 and fp32 activations and on the cache element type; every
// sum is fp32.  Simple and correct first: wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;  // D <= 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

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

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// Shared-memory layout of partial_kernel, in bytes; elem is the size of a
// cache element.
struct Smem {
  size_t q, p, ks, vs, k, v, total;
  __host__ __device__ Smem(int R, int D, int chunk, size_t elem) {
    q = 0;                                                  // [R, D] fp32, pre-scaled
    p = align16(q + (size_t)R * D * sizeof(float));         // [R, chunk] fp32
    ks = align16(p + (size_t)R * chunk * sizeof(float));    // [chunk] fp32 key scales
    vs = align16(ks + (size_t)chunk * sizeof(float));       // [chunk] fp32 value scales
    k = align16(vs + (size_t)chunk * sizeof(float));        // [chunk, D] C
    v = align16(k + (size_t)chunk * D * elem);              // [chunk, D] C
    total = align16(v + (size_t)chunk * D * elem);
  }
};

// T: activation type; C: cache element type (T for K1, int8_t for K3, whose
// ks / vs are then non-null).
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads) partial_kernel(
    const T* __restrict__ q,           // [B, M, H, D]
    const C* __restrict__ kc,          // [B, S, KH, D]
    const C* __restrict__ vc,          // [B, S, KH, D]
    const float* __restrict__ ks,      // [B, KH, S] key scales, or null
    const float* __restrict__ vs,      // [B, KH, S] value scales, or null
    const uint8_t* __restrict__ mask,  // [B, M, S]
    float* __restrict__ part_m,        // [B*KH, nsplit, R]
    float* __restrict__ part_l,        // [B*KH, nsplit, R]
    float* __restrict__ part_acc,      // [B*KH, nsplit, R, D]
    int M, int H, int KH, int S, int D, int chunk, float scale) {
  const int bg = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bg / KH, g = bg % KH;
  const int G = H / KH;
  const int R = M * G;
  const int s0 = split * chunk;
  const int n = min(chunk, S - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t pbase = ((size_t)bg * gridDim.y + split) * R;

  // Skip the tile when no member attends any of its slots.
  int seen = 0;
  for (int i = tid; i < M * n; i += kThreads) {
    const int m = i / n, s = i - m * n;
    seen |= mask[((size_t)b * M + m) * S + s0 + s];
  }
  if (!__syncthreads_or(seen)) {
    for (int r = tid; r < R; r += kThreads) {
      part_m[pbase + r] = -INFINITY;
      part_l[pbase + r] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem lay(R, D, chunk, sizeof(C));
  float* q_s = reinterpret_cast<float*>(smem_raw + lay.q);
  float* p_s = reinterpret_cast<float*>(smem_raw + lay.p);
  float* ks_s = reinterpret_cast<float*>(smem_raw + lay.ks);
  float* vs_s = reinterpret_cast<float*>(smem_raw + lay.vs);
  C* k_s = reinterpret_cast<C*>(smem_raw + lay.k);
  C* v_s = reinterpret_cast<C*>(smem_raw + lay.v);
  const bool scaled = ks != nullptr;

  // The group's K and V panels for this tile, every load in flight at once,
  // and for an int8 cache the tile's scale rows.
  const size_t row0 = (((size_t)b * S + s0) * KH + g) * D;
  load_rows(k_s, kc + row0, (size_t)KH * D, n, D);
  load_rows(v_s, vc + row0, (size_t)KH * D, n, D);
  if (scaled) {
    const size_t srow = ((size_t)b * KH + g) * S + s0;
    for (int s = tid; s < n; s += kThreads) {
      ks_s[s] = ks[srow + s];
      vs_s[s] = vs[srow + s];
    }
  }
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int m = r / G, j = r - m * G;
    q_s[i] = to_f(q[(((size_t)b * M + m) * H + g * G + j) * D + d]) * scale;
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
        p_s[r * chunk + s] = on ? (scaled ? acc * ks_s[s] : acc) : -INFINITY;
      }
    }
  }
  __syncthreads();

  // The tile's softmax statistics per row: one warp per row.  The sum takes
  // the unscaled exponentials; PV reads them times the value scale.
  for (int r = warp; r < R; r += kWarps) {
    float* pr = p_s + r * chunk;
    float mx = -INFINITY;
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
      part_m[pbase + r] = mx;
      part_l[pbase + r] = sum;
    }
  }
  __syncthreads();

  // Unnormalised PV over the tile.
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float* pr = p_s + r * chunk;
    float acc = 0.f;
    for (int s = 0; s < n; ++s) acc += pr[s] * to_f(v_s[s * D + d]);
    part_acc[(pbase + r) * D + d] = acc;
  }
}

// One block per (b, g): each row's self score and the rescaling weights of
// the tiles' partial softmaxes go to shared memory (one warp per row, lanes
// over the tiles), then one thread per (row, d) output element sums the
// tiles' partial PVs.
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const T* __restrict__ q,         // [B, M, H, D]
    const T* __restrict__ kn,        // [B, M, KH, D]
    const T* __restrict__ vn,        // [B, M, KH, D]
    const float* __restrict__ part_m,
    const float* __restrict__ part_l,
    const float* __restrict__ part_acc,
    T* __restrict__ out,             // [B, M, H, D]
    int M, int H, int KH, int D, int nsplit, float scale) {
  const int bg = blockIdx.x;
  const int b = bg / KH, g = bg % KH;
  const int G = H / KH;
  const int R = M * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ float cs[];
  float* w_s = cs;                  // [R, nsplit] weight of each tile, 0 if empty
  float* e_self = cs + R * nsplit;  // [R] weight of the self token
  const size_t base = (size_t)bg * nsplit * R;

  for (int r = warp; r < R; r += kWarps) {
    const int m = r / G, h = g * G + (r - m * G);
    const T* qrow = q + (((size_t)b * M + m) * H + h) * D;
    const T* knrow = kn + (((size_t)b * M + m) * KH + g) * D;
    float self = 0.f;
    for (int d = lane; d < D; d += 32) self += to_f(qrow[d]) * to_f(knrow[d]);
    self = warp_sum(self) * scale;
    float mx = self;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const size_t i = base + (size_t)sp * R + r;
      if (part_l[i] > 0.f) mx = fmaxf(mx, part_m[i]);
    }
    mx = warp_max(mx);
    float denom = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const size_t i = base + (size_t)sp * R + r;
      const float l = part_l[i];
      const float w = l > 0.f ? expf(part_m[i] - mx) : 0.f;
      w_s[r * nsplit + sp] = w;
      denom += l * w;
    }
    denom = warp_sum(denom) + expf(self - mx);
    if (lane == 0) e_self[r] = expf(self - mx) / denom;
    // fold 1/denom into the tiles' weights
    for (int sp = lane; sp < nsplit; sp += 32) w_s[r * nsplit + sp] /= denom;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int m = r / G, h = g * G + (r - m * G);
    float acc = e_self[r] * to_f(vn[(((size_t)b * M + m) * KH + g) * D + d]);
    const float* wr = w_s + r * nsplit;
#pragma unroll 4
    for (int sp = 0; sp < nsplit; ++sp) {
      const float w = wr[sp];
      if (w != 0.f) acc += w * part_acc[(base + (size_t)sp * R + r) * D + d];
    }
    store_f(out + (((size_t)b * M + m) * H + h) * D + d, acc);
  }
}

template <typename T, typename C>
cudaError_t launch(const void* q, const void* kc, const void* ks, const void* vc,
                   const void* vs, const void* kn, const void* vn, const void* mask,
                   void* out, void* part_m, void* part_l, void* part_acc, int B, int M,
                   int H, int KH, int S, int D, int chunk, float scale,
                   cudaStream_t stream) {
  const int R = M * (H / KH);
  const int nsplit = (S + chunk - 1) / chunk;
  const size_t smem = Smem(R, D, chunk, sizeof(C)).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(partial_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  partial_kernel<T, C><<<dim3(B * KH, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(kc), static_cast<const C*>(vc),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(mask), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), M, H, KH, S, D, chunk,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t csmem = (size_t)R * (nsplit + 1) * sizeof(float);
  if (csmem > 48 * 1024) {
    e = cudaFuncSetAttribute(combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)csmem);
    if (e != cudaSuccess) return e;
  }
  combine_kernel<T><<<B * KH, kThreads, csmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), M, H, KH, D, nsplit, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int dd_ensemble_decode_attention(
    int dtype, const void* q, const void* k_cache, const void* v_cache, const void* k_new,
    const void* v_new, const void* key_mask, void* out, void* part_m, void* part_l,
    void* part_acc, int B, int M, int H, int KH, int S, int D, int chunk, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, float>(q, k_cache, nullptr, v_cache, nullptr, k_new, v_new,
                                     key_mask, out, part_m, part_l, part_acc, B, M, H, KH, S,
                                     D, chunk, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_cache, nullptr, v_cache, nullptr, k_new, v_new, key_mask, out, part_m, part_l,
        part_acc, B, M, H, KH, S, D, chunk, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K3: the int8 cache q leaves [B, S, KH, D] and their scales [B, KH, S];
// q and the new K/V in the activation dtype.
extern "C" int dd_ensemble_decode_attention_int8kv(
    int dtype, const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* k_new, const void* v_new, const void* key_mask, void* out, void* part_m,
    void* part_l, void* part_acc, int B, int M, int H, int KH, int S, int D, int chunk,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float, int8_t>(q, kq, ks, vq, vs, k_new, v_new, key_mask, out, part_m,
                                      part_l, part_acc, B, M, H, KH, S, D, chunk, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, int8_t>(q, kq, ks, vq, vs, k_new, v_new, key_mask, out,
                                              part_m, part_l, part_acc, B, M, H, KH, S, D,
                                              chunk, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
