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
// a microsecond of bandwidth; one launch for both leaves and every layer is
// the whole of the design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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
  for (int d = lane; d < D; d += 32) {
    const float v = fminf(fmaxf(rintf(to_f(x[d]) / s), -127.f), 127.f);
    q[d] = static_cast<int8_t>(v);
  }
  if (lane == 0) (is_v ? vs : ks)[((size_t)lb * KH + g) * S + pos] = s;
}

template <typename T>
cudaError_t launch(const void* k_new, const void* v_new, void* kq, void* ks, void* vq,
                   void* vs, const void* cur_len, int L, int B, int KH, int S, int D,
                   cudaStream_t stream) {
  const int rows = 2 * L * B * KH;
  append_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), static_cast<int8_t*>(kq),
      static_cast<float*>(ks), static_cast<int8_t*>(vq), static_cast<float*>(vs),
      static_cast<const int64_t*>(cur_len), L, B, KH, S, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of k_new / v_new).  Returns a
// cudaError_t (0 = success).
extern "C" int dd_cache_append_int8(int dtype, const void* k_new, const void* v_new, void* kq,
                                    void* ks, void* vq, void* vs, const void* cur_len, int L,
                                    int B, int KH, int S, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(k_new, v_new, kq, ks, vq, vs, cur_len, L, B, KH, S, D, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(k_new, v_new, kq, ks, vq, vs, cur_len, L, B, KH, S, D,
                                      st);
  return (int)cudaErrorInvalidValue;
}
