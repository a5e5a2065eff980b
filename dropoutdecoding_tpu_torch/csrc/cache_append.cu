// K4: the int8 KV-cache append for Hopper (sm_90a).
//
// Replaces the TPU kernel cache_append_rows_int8
// (dropoutdecoding_tpu/ops/pallas_decode_attention.py:605, body
// _row_update_kernel :594), and with it the XLA quantize_kv and the scale
// select around it (dropoutdecoding_tpu/models/llama.py:209-239): the TPU
// kernel moved the int8 q leaf only, one call per leaf.
//
// One launch per decode step does the whole append in place.  For each
// (leaf in {K, V}, layer l, row b, kv head g), one warp takes the winner's
// unquantized [D] row x = new[l, b, g, :] and writes
//   s = amax|x| / 127 (1 where amax is 0),  q = clip(rint(x / s), -127, 127)
// into q_cache[l, b, cur_len[b], g * D : (g + 1) * D] and
// s_cache[l, b, g, cur_len[b]].  Bit-equal to utils/quantize.quantize_kv:
// the amax is exact in any order, x / s is an IEEE division (the build
// has no --use_fast_math) and rintf rounds half to even, as torch.round and
// jnp.round do.  A row whose cur_len is outside [0, S) is not written, as an
// XLA scatter drops an out-of-bounds update.
//
// What bounds it on this card: launch latency.  At LLaVA-1.5-7B it moves
// 2 x 32 layers x 32 heads x 128 values, about 260 KB per step, well under
// a microsecond of bandwidth, but a launch is a few microseconds old before
// its first bytes land and every dependent trip to global memory adds one or
// two more.  So: one launch for both leaves and every layer, and inside it
// one trip.  At D = 128 (append_row128_kernel) a lane asks for cur_len[b] and
// for its four values (one 8-byte load in bf16, one 16-byte load in fp32) in
// the same breath, takes the amax by shuffles, quantizes from registers and
// stores one packed 4-byte word.  Other head dims take append_kernel, a
// scalar loop with the same arithmetic.  floor_kernel has the D = 128
// kernel's grid, reads cur_len and writes one word a warp: the time below
// which no kernel of this shape can go, measured beside the byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // append_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = 256;   // append_row128_kernel and floor_kernel
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowD = 128;         // the head dim of the one-trip kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(q.x << 16), x[1] = __uint_as_float(q.x & 0xffff0000u);
  x[2] = __uint_as_float(q.y << 16), x[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float quantize(float x, float s) {
  return fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// D = 128: a warp a (leaf, layer, row, head), four values a lane, one trip.
template <typename T>
__global__ void __launch_bounds__(kRowThreads) append_row128_kernel(
    const T* __restrict__ k_new, const T* __restrict__ v_new, int8_t* __restrict__ kq,
    float* __restrict__ ks, int8_t* __restrict__ vq, float* __restrict__ vs,
    const int64_t* __restrict__ cur_len, int L, int B, int KH, int S) {
  const int rows = L * B * KH;  // per leaf
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= 2 * rows) return;
  const bool is_v = row >= rows;
  const int r = is_v ? row - rows : row;  // (l * B + b) * KH + g
  const int g = r % KH;
  const int lb = r / KH;
  const int b = lb % B;
  float x[4];
  load4((is_v ? v_new : k_new) + (size_t)r * kRowD + 4 * lane, x);  // both loads fly together
  const int64_t pos = cur_len[b];
  float amax = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (pos < 0 || pos >= S) return;
  const float s = amax > 0.f ? amax / 127.f : 1.f;
  uint32_t word = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    word |= ((uint32_t)(int)quantize(x[u], s) & 0xffu) << (8 * u);
  int8_t* q = (is_v ? vq : kq) + (((size_t)lb * S + pos) * KH + g) * kRowD;
  reinterpret_cast<uint32_t*>(q)[lane] = word;
  if (lane == 0) (is_v ? vs : ks)[((size_t)lb * KH + g) * S + pos] = s;
}

// The launch floor: append_row128_kernel's grid, cur_len read, one word a warp.
__global__ void __launch_bounds__(kRowThreads) floor_kernel(
    const int64_t* __restrict__ cur_len, uint32_t* __restrict__ out, int L, int B, int KH) {
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= 2 * L * B * KH) return;
  const int b = (row % (L * B * KH)) / KH % B;
  const int64_t pos = cur_len[b];
  if ((threadIdx.x & 31) == 0) out[row] = (uint32_t)pos;
}

// Any head dim: a warp a row, a scalar loop.
template <typename T>
__global__ void __launch_bounds__(kThreads) append_kernel(
    const T* __restrict__ k_new,       // [L, B, KH, D]
    const T* __restrict__ v_new,       // [L, B, KH, D]
    int8_t* __restrict__ kq,           // [L, B, S, KH * D]
    float* __restrict__ ks,            // [L, B, KH, S]
    int8_t* __restrict__ vq,           // [L, B, S, KH * D]
    float* __restrict__ vs,            // [L, B, KH, S]
    const int64_t* __restrict__ cur_len,  // [B]
    int L, int B, int KH, int S, int D) {
  const int rows = L * B * KH;  // per leaf
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= 2 * rows) return;
  const bool is_v = row >= rows;
  const int r = is_v ? row - rows : row;  // (l * B + b) * KH + g
  const int g = r % KH;
  const int lb = r / KH;
  const int b = lb % B;
  const int64_t pos = cur_len[b];
  if (pos < 0 || pos >= S) return;

  const T* x = (is_v ? v_new : k_new) + (size_t)r * D;
  float amax = 0.f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f(x[d])));
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = amax > 0.f ? amax / 127.f : 1.f;

  int8_t* q = (is_v ? vq : kq) + (((size_t)lb * S + pos) * KH + g) * D;
  for (int d = lane; d < D; d += 32) q[d] = static_cast<int8_t>(quantize(to_f(x[d]), s));
  if (lane == 0) (is_v ? vs : ks)[((size_t)lb * KH + g) * S + pos] = s;
}

template <typename T>
cudaError_t launch(const void* k_new, const void* v_new, void* kq, void* ks, void* vq,
                   void* vs, const void* cur_len, int L, int B, int KH, int S, int D, int route,
                   cudaStream_t stream) {
  const int rows = 2 * L * B * KH;
  const T* kn = static_cast<const T*>(k_new);
  const T* vn = static_cast<const T*>(v_new);
  int8_t* kq8 = static_cast<int8_t*>(kq);
  int8_t* vq8 = static_cast<int8_t*>(vq);
  float* ksf = static_cast<float*>(ks);
  float* vsf = static_cast<float*>(vs);
  const int64_t* cl = static_cast<const int64_t*>(cur_len);
  if (route == 0 && D != kRowD) return cudaErrorInvalidValue;
  if (route == 0)
    append_row128_kernel<T><<<(rows + kRowWarps - 1) / kRowWarps, kRowThreads, 0, stream>>>(
        kn, vn, kq8, ksf, vq8, vsf, cl, L, B, KH, S);
  else
    append_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        kn, vn, kq8, ksf, vq8, vsf, cl, L, B, KH, S, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of k_new / v_new).  route 0: the one-trip
// kernel (D = 128, k_new / v_new on 16-byte and kq / vq on 4-byte boundaries);
// route 1: the scalar kernel.  Returns a cudaError_t (0 = success).
extern "C" int dd_cache_append_int8(int dtype, const void* k_new, const void* v_new, void* kq,
                                    void* ks, void* vq, void* vs, const void* cur_len, int L,
                                    int B, int KH, int S, int D, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(k_new, v_new, kq, ks, vq, vs, cur_len, L, B, KH, S, D, route, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(k_new, v_new, kq, ks, vq, vs, cur_len, L, B, KH, S, D,
                                      route, st);
  return (int)cudaErrorInvalidValue;
}

// The launch floor of the D = 128 append: out holds 2 * L * B * KH words.
extern "C" int dd_cache_append_floor(const void* cur_len, void* out, int L, int B, int KH,
                                     void* stream) {
  const int rows = 2 * L * B * KH;
  floor_kernel<<<(rows + kRowWarps - 1) / kRowWarps, kRowThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const int64_t*>(cur_len),
                                                     static_cast<uint32_t*>(out), L, B, KH);
  return (int)cudaGetLastError();
}
