// K2: visual-token uncertainty statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_uncertainty_fused
// (dropoutdecoding_tpu/ops/pallas_uncertainty.py:101; bodies _pass_a_kernel
// :44, _pass_b_kernel :69, _pass_c_kernel :85).  For logits x [B, L, V] fp32
// and row weights w [B, L] (1/n_valid on rows in the mean, else 0):
//
//   pass A, per row i:  m_i = max_v x_iv,  Z_i = sum_v e^(x_iv - m_i),
//                       A_i = sum_v e^(x_iv - m_i) x_iv,
//                       B_i = sum_v e^(2 (x_iv - m_i))
//   pass B, per column: pavg_v = sum_i w_i e^(x_iv - m_i) / Z_i
//   pass C, per row i:  C_i = sum_v p_iv log(pavg_v + 1e-10)
//
// The Python wrapper turns these into alea, var, epis and the image means.
//
// What bounds it on this card: the logits bytes.  At LLaVA-1.5's 576 x
// 32064 fp32 the tensor is 73.9 MB and each of the three passes reads it
// once: 22 us a pass at 3.35 TB/s, 66 us in all; the exp/log work per
// element is small next to that.  No [L, V] probability tensor is ever written, which is what the
// plain version pays for.  Pass B runs one thread per vocabulary column
// over a block of rows, then a second pass sums the blocks in a fixed
// order, so p_avg needs no atomics and is deterministic; it stores
// log(p_avg + 1e-10) once for pass C.  The ragged vocabulary edge is
// masked by the loop bounds; no padding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // loads in flight per thread in pass A
constexpr int kRowsPerBlock = 32;  // rows per block in pass B
constexpr float kEps = 1e-10f;

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
  Stats s = {-INFINITY, 0.f, 0.f, 0.f};
  for (int v0 = threadIdx.x; v0 < V; v0 += kThreads * kUnroll) {
    float xs[kUnroll];
    float tm = -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      xs[u] = v < V ? xr[v] : -INFINITY;
      tm = fmaxf(tm, xs[u]);
    }
    if (tm > s.m) {  // rescale the running sums to the new max
      const float f = expf(s.m - tm);  // 0 on the first group
      s = {tm, s.z * f, s.a * f, s.b * f * f};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v0 + u * kThreads < V) {
        const float e = expf(xs[u] - s.m);
        s.z += e;
        s.a += e * xs[u];
        s.b += e * e;
      }
    }
  }
  s = warp_merge(s);
  __shared__ Stats red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats t = red[0];
    for (int w = 1; w < kWarps; ++w) t = merge(t, red[w]);
    m_out[row] = t.m;
    z_out[row] = t.z;
    a_out[row] = t.a;
    b_out[row] = t.b;
  }
}

// Pass B, part 1: one thread per vocabulary column and block of kRowsPerBlock
// rows; writes that block's weighted column sums.
__global__ void __launch_bounds__(kThreads) pavg_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ m, const float* __restrict__ z,
    const float* __restrict__ w, float* __restrict__ part, int L, int V) {
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
    acc += w[r] * (expf(xb[(size_t)i * V + v] - m[r]) / z[r]);
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

}  // namespace

// x [B, L, V] fp32; w [B, L] fp32; m, z, a, b, c [B, L] fp32; scratch
// [B, ceil(L / 32) + 1, V] fp32.  Returns a cudaError_t (0 = success).
extern "C" int dd_vision_uncertainty(const void* x, const void* w, void* m, void* z,
                                     void* a, void* b, void* scratch, void* c, int B,
                                     int L, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* mf = static_cast<float*>(m);
  float* zf = static_cast<float*>(z);
  const int nblocks = (L + kRowsPerBlock - 1) / kRowsPerBlock;
  const int vblocks = (V + kThreads - 1) / kThreads;
  float* part = static_cast<float*>(scratch);               // [B, nblocks, V]
  float* log_pavg = part + (size_t)B * nblocks * V;         // [B, V]
  stats_kernel<<<B * L, kThreads, 0, st>>>(xf, mf, zf, static_cast<float*>(a),
                                          static_cast<float*>(b), V);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pavg_partial_kernel<<<dim3(vblocks, nblocks, B), kThreads, 0, st>>>(
      xf, mf, zf, static_cast<const float*>(w), part, L, V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pavg_reduce_kernel<<<dim3(vblocks, B), kThreads, 0, st>>>(part, log_pavg, nblocks, V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cross_kernel<<<B * L, kThreads, 0, st>>>(xf, mf, zf, log_pavg, static_cast<float*>(c), L,
                                          V);
  return (int)cudaGetLastError();
}
