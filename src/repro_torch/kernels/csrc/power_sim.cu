// Fused fleet power / energy / TFLOP/s map: one pass over the utilization
// field, hand-written for Hopper (sm_90a).  Replaces
// src/repro/kernels/power_sim.py:power_sim_pallas.  Bound: bytes (u read
// once); the accurate logf + expf make it bound by instruction issue on an
// H100 at large T (PERF.md).
//
// Grid ceil(T / bins) blocks of 8 warps.  A block owns `bins` consecutive
// bins with `split` warps per bin (bins * split = 8), as the DES readout
// does (des_readout.cu): a warp per bin, or a bin's hosts split across
// the warps of a block when T is too small to fill the card.  The wrapper
// chooses the split (repro_torch/kernels/_launch.py, warp_split).
//
// Order of summation, fixed: thread (warp part p, lane l) of a bin sums
// the hosts p*32 + l, p*32 + l + 32*split, ... in increasing order, with
// kUnroll loads of u in flight, of two terms of u clipped to [0, 1]: the
// power shape 2u - exp(r * log max(u, 1e-30)) and u itself; each warp
// reduces them with an xor-shuffle butterfly, the bin's warp totals are
// added in warp order, and the block's bins x 3 results are written as
// `bins` consecutive floats of each row of out[3, T]:
//   power  = base + span * sum_shape      (base = H*p_idle, span = p_max - p_idle)
//   energy = power * e_factor             (W -> kWh per bin)
//   tflops = sum_u / H * peak
// No float atomics: results are bitwise repeatable.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) power_sim_kernel(
    const float* __restrict__ u, float* __restrict__ out, int T, int H,
    int split, float r, float base, float span, float e_factor, float peak) {
  __shared__ float s_part[2][kWarps];
  __shared__ float s_out[3][kWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bins = kWarps / split;
  const int t0 = blockIdx.x * bins;
  const int t = t0 + warp / split;
  const int first = (warp % split) * 32 + lane;
  const int step = split * 32;

  float shape = 0.0f, us = 0.0f;
  auto add = [&](float x) {
    const float xc = fminf(fmaxf(x, 0.0f), 1.0f);
    shape += 2.0f * xc - expf(r * logf(fmaxf(xc, 1e-30f)));
    us += xc;
  };
  if (t < T) {
    const float* u_row = u + static_cast<long long>(t) * H;
    int i = first;
    for (; i + (kUnroll - 1) * step < H; i += kUnroll * step) {   // full rounds
      float x[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) x[j] = u_row[i + j * step];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) add(x[j]);
    }
    for (; i < H; i += step) add(u_row[i]);                       // the rest, in order
  }
  shape = warp_sum(shape);
  us = warp_sum(us);
  if (lane == 0) {
    s_part[0][warp] = shape;
    s_part[1][warp] = us;
  }
  __syncthreads();

  if (threadIdx.x < bins && t0 + static_cast<int>(threadIdx.x) < T) {
    const int b = threadIdx.x;
    float sum_shape = s_part[0][b * split], sum_u = s_part[1][b * split];
#pragma unroll
    for (int p = 1; p < kWarps; ++p) {
      if (p < split) {
        sum_shape += s_part[0][b * split + p];
        sum_u += s_part[1][b * split + p];
      }
    }
    const float power = base + span * sum_shape;
    s_out[0][b] = power;
    s_out[1][b] = power * e_factor;
    s_out[2][b] = sum_u / static_cast<float>(H) * peak;
  }
  __syncthreads();

  if (threadIdx.x < 3 * bins) {
    const int k = threadIdx.x / bins, b = threadIdx.x % bins;
    if (t0 + b < T) out[static_cast<long long>(k) * T + t0 + b] = s_out[k][b];
  }
}

}  // namespace

extern "C" int power_sim_launch(const float* u, float* out, int T, int H,
                                int split, float r, float base, float span,
                                float e_factor, float peak, void* stream) {
  if (T <= 0 || H <= 0 || !(split == 1 || split == 2 || split == 4 || split == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bins = kWarps / split;
  power_sim_kernel<<<(T + bins - 1) / bins, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      u, out, T, H, split, r, base, span, e_factor, peak);
  return static_cast<int>(cudaGetLastError());
}
