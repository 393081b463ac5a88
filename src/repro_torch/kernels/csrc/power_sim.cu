// Fused fleet power / energy / TFLOP/s map: one pass over the utilization
// field, hand-written for Hopper (sm_90a).
//
// One block per bin row.  Threads stride over the hosts and accumulate two
// sums of u clipped to [0, 1]: the power shape 2u - exp(r * log max(u,
// 1e-30)) and u itself.  A shared-memory tree reduction in fixed order
// combines them (no float atomics: bitwise repeatable), and one thread
// writes the bin's three outputs into out[3, T]:
//   power  = base + span * sum_shape      (base = H*p_idle, span = p_max - p_idle)
//   energy = power * e_factor             (W -> kWh per bin)
//   tflops = sum_u / H * peak

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void power_sim_kernel(const float* __restrict__ u,
                                 float* __restrict__ out, int T, int H,
                                 float r, float base, float span,
                                 float e_factor, float peak) {
  __shared__ float s_shape[kThreads];
  __shared__ float s_u[kThreads];

  const int t = blockIdx.x;
  const float* u_row = u + static_cast<long long>(t) * H;
  float shape = 0.0f, us = 0.0f;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    const float x = fminf(fmaxf(u_row[h], 0.0f), 1.0f);
    shape += 2.0f * x - expf(r * logf(fmaxf(x, 1e-30f)));
    us += x;
  }
  s_shape[threadIdx.x] = shape;
  s_u[threadIdx.x] = us;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_shape[threadIdx.x] += s_shape[threadIdx.x + stride];
      s_u[threadIdx.x] += s_u[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float power = base + span * s_shape[0];
  out[t] = power;
  out[static_cast<long long>(T) + t] = power * e_factor;
  out[2LL * T + t] = s_u[0] / static_cast<float>(H) * peak;
}

}  // namespace

extern "C" int power_sim_launch(const float* u, float* out, int T, int H,
                                float r, float base, float span,
                                float e_factor, float peak, void* stream) {
  if (T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  power_sim_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, out, T, H, r, base, span, e_factor, peak);
  return static_cast<int>(cudaGetLastError());
}
