// Fused DES readout: the whole per-bin metric pipeline in one pass,
// hand-written for Hopper (sm_90a).
//
// One block per bin row.  Threads stride over the hosts and accumulate
// four sums (IT demand, idle floor, sum u*on, sum on) from the
// failure-aware online mask and the power-model shape; a shared-memory
// tree reduction in fixed order combines them, and one thread evaluates
// the per-bin tail (dynamic PUE, cap clip + linear throttle, energy,
// tflops/efficiency, gCO2, cost) and writes the 9 outputs
// (READOUT_FIELDS order) into out[9, T].
//
// Sentinels as in the JAX kernel: +inf cap (uncapped), identity PUE
// (base 1, coefficients 0), int32.max failure start (never fails), zero
// carbon/price columns when absent.  The power model and the precision
// policy are kernel parameters; bf16 touches only tflops and efficiency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 9;

enum Model { kOpendc = 0, kLinear = 1, kSqrt = 2, kCubic = 3 };

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float shape_term(float uc, float r, int model) {
  switch (model) {
    case kOpendc:
      return 2.0f * uc - expf(r * logf(fmaxf(uc, 1e-30f)));
    case kLinear:
      return uc;
    case kSqrt:
      return sqrtf(uc);
    default:
      return uc * uc * uc;
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void des_readout_kernel(
    const float* __restrict__ u, const float* __restrict__ p_idle,
    const float* __restrict__ p_max, const float* __restrict__ r,
    const float* __restrict__ mask, const int* __restrict__ fail_start,
    const int* __restrict__ fail_end, const float* __restrict__ fail_kill,
    const float* __restrict__ cap, const float* __restrict__ intensity,
    const float* __restrict__ ambient, const float* __restrict__ price,
    float* __restrict__ out, int T, int H, int model, int bf16, float peak,
    float pue_base, float pue_load, float pue_amb, float pue_ref,
    float dt_factor) {
  __shared__ float s_it[kThreads];
  __shared__ float s_idle[kThreads];
  __shared__ float s_u[kThreads];
  __shared__ float s_on[kThreads];

  const int t = blockIdx.x;
  const float* u_row = u + static_cast<long long>(t) * H;
  float it = 0.0f, idle = 0.0f, us = 0.0f, ons = 0.0f;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    const bool off = fail_kill[h] > 0.0f && t >= fail_start[h] && t < fail_end[h];
    const float on = (off ? 0.0f : 1.0f) * mask[h];
    const float x = u_row[h];
    const float pi = p_idle[h];
    const float host_p = pi + (p_max[h] - pi) * shape_term(clip01(x), r[h], model);
    it += host_p * on;
    idle += pi * on;
    us += x * on;
    ons += on;
  }
  s_it[threadIdx.x] = it;
  s_idle[threadIdx.x] = idle;
  s_u[threadIdx.x] = us;
  s_on[threadIdx.x] = ons;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_it[threadIdx.x] += s_it[threadIdx.x + stride];
      s_idle[threadIdx.x] += s_idle[threadIdx.x + stride];
      s_u[threadIdx.x] += s_u[threadIdx.x + stride];
      s_on[threadIdx.x] += s_on[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;

  const float util_raw = s_u[0] / fmaxf(s_on[0], 1.0f);
  const float load = clip01(util_raw);
  float pue = pue_base + pue_load * (1.0f - load);
  pue = pue + pue_amb * fmaxf(ambient[t] - pue_ref, 0.0f);
  const float demand = s_it[0] * pue;
  const float floor_w = s_idle[0] * pue;
  const float cap_t = cap[t];
  const bool exceeded = demand > cap_t;
  const float power = fminf(demand, cap_t);
  const float throttle = clip01((cap_t - floor_w) / fmaxf(demand - floor_w, 1e-9f));
  const float e = power * dt_factor / 1000.0f;
  const float util = exceeded ? util_raw * throttle : util_raw;
  float tflops, eff;
  if (bf16) {
    tflops = bf16_round(bf16_round(util) * bf16_round(peak));
    eff = bf16_round(tflops / bf16_round(fmaxf(e, 1e-9f)));
  } else {
    tflops = util * peak;
    eff = tflops / fmaxf(e, 1e-9f);
  }
  const float vals[kFields] = {power, e, tflops, util, eff,
                               e * intensity[t], demand, pue, e * price[t]};
  for (int k = 0; k < kFields; ++k) out[static_cast<long long>(k) * T + t] = vals[k];
}

}  // namespace

extern "C" int des_readout_launch(
    const float* u, const float* p_idle, const float* p_max, const float* r,
    const float* mask, const int* fail_start, const int* fail_end,
    const float* fail_kill, const float* cap, const float* intensity,
    const float* ambient, const float* price, float* out, int T, int H,
    int model, int bf16, float peak, float pue_base, float pue_load,
    float pue_amb, float pue_ref, float dt_factor, void* stream) {
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  des_readout_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, p_idle, p_max, r, mask, fail_start, fail_end, fail_kill, cap,
      intensity, ambient, price, out, T, H, model, bf16, peak, pue_base,
      pue_load, pue_amb, pue_ref, dt_factor);
  return static_cast<int>(cudaGetLastError());
}
