// Grid-search MAPE of every power-model candidate (the Self-Calibrator's
// hot spot), hand-written for Hopper (sm_90a).
//
// For batch row b and candidate c the kernel accumulates
//     sum_t [|real_t| > 1e-9] * |real_t - sim_t(c)| / (|real_t| + 1e-9)
// with sim_t(c) = H*p_idle_c + (p_max_c - p_idle_c) * (S2_t - Sr_t(c)),
// S2_t = sum_h 2u and Sr_t(c) = sum_h expf(r_c * logf(max(u, 1e-30))) over
// u clipped to [0, 1].  The wrapper applies the 100/n_nonzero scaling and
// the all-zero -> NaN rule.
//
// Layout: grid (ceil(C / kThreads), B), one thread per candidate.  The
// block walks the bins in order; for each bin it stages log(u) and 2u of
// the row's hosts in shared memory (kChunk hosts at a time) and every
// thread sums over the staged hosts in the same fixed order, keeping its
// relative-error sum in a register.  No float atomics: the result is the
// same bit pattern on every run, so the argmin downstream cannot flip.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;

__global__ void calib_mape_grid_kernel(const float* __restrict__ u,
                                       const float* __restrict__ real,
                                       const float* __restrict__ p_idle,
                                       const float* __restrict__ p_max,
                                       const float* __restrict__ r,
                                       float* __restrict__ out,
                                       int T, int H, int C) {
  __shared__ float s_logu[kChunk];
  __shared__ float s_two_u[kChunk];

  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool active = c < C;
  const float pi = active ? p_idle[c] : 0.0f;
  const float pm = active ? p_max[c] : 1.0f;
  const float rc = active ? r[c] : 1.0f;
  const float span = pm - pi;
  const float base = static_cast<float>(H) * pi;

  const float* u_b = u + static_cast<long long>(b) * T * H;
  const float* real_b = real + static_cast<long long>(b) * T;

  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float* u_row = u_b + static_cast<long long>(t) * H;
    float s2 = 0.0f;
    float sr = 0.0f;
    for (int h0 = 0; h0 < H; h0 += kChunk) {
      const int n = min(kChunk, H - h0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float x = fminf(fmaxf(u_row[h0 + i], 0.0f), 1.0f);
        s_logu[i] = logf(fmaxf(x, 1e-30f));
        s_two_u[i] = 2.0f * x;
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        s2 += s_two_u[i];
        sr += expf(rc * s_logu[i]);
      }
    }
    const float re = real_b[t];
    if (fabsf(re) > 1e-9f) {
      const float sim = base + span * (s2 - sr);
      acc += fabsf((re - sim) / (fabsf(re) + 1e-9f));
    }
  }
  if (active) out[static_cast<long long>(b) * C + c] = acc;
}

}  // namespace

extern "C" int calib_mape_grid_launch(const float* u, const float* real,
                                      const float* p_idle, const float* p_max,
                                      const float* r, float* out, int B, int T,
                                      int H, int C, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((C + kThreads - 1) / kThreads, B);
  calib_mape_grid_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      u, real, p_idle, p_max, r, out, T, H, C);
  return static_cast<int>(cudaGetLastError());
}
