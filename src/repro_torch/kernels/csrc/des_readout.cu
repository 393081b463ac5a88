// Fused DES readout: the whole per-bin metric pipeline in one pass, for
// lanes x bins x hosts, hand-written for Hopper (sm_90a).
//
// Grid (ceil(T / bins), S), blocks of 8 warps.  A block owns `bins`
// consecutive bins of one lane (scenario), with `split` warps per bin
// (bins * split = 8): split 1 gives each bin a warp, split 8 gives each
// bin the whole block, for grids too small to fill the card.  The wrapper
// chooses the split (repro_torch/kernels/_launch.py, warp_split).
//
// Four sums a bin (IT demand, idle floor, sum u*on, sum on) in float64,
// each term exact there (a float32 value times 0 or the mask), rounded
// once to float32.  With a 0/1 mask and a fleet's values the float64 sums
// are exact, and otherwise within far less than the final rounding, so
// the results do not depend on the order of summation.  They must not: the
// linear throttle (cap - floor) / (demand - floor) cancels where a cap
// sits just above the idle floor, where two float32 orders of the floor
// sum give throttles further apart than the tolerance, and a bf16 leaf
// flips by one bf16 ulp where a float32 order moves the energy by one
// float32 ulp.  The plain version takes the same float64 sums.
//
// Replaces src/repro/kernels/des_readout.py:des_readout_pallas and its
// jax.vmap over scenarios.  Bound: bytes for large fields (each u read
// once); on an H100 the opendc model's accurate logf + expf, the float64
// sums and the staged rows make it bound by instruction issue there
// (PERF.md).
//
// Order of summation, fixed and independent of the timing:
//   - the lane's 7 host rows are staged in shared memory once per block,
//     in chunks of kHostChunk hosts, as (p_idle, p_max - p_idle, r, outage
//     window [start, end), or an empty one when the host is not killed,
//     and p_idle and the mask in float64); where every row is one number
//     (the twin's window path) nothing is staged (kUniform);
//   - thread (warp part p, lane l) of a bin sums the hosts p*32 + l,
//     p*32 + l + 32*split, ... in increasing order, across the chunks
//     (kHostChunk is a multiple of 32*split, so chunking moves no host
//     from one thread to another): full rounds of kUnroll hosts with all
//     their loads of u in flight, then the rest one at a time;
//   - each warp reduces its 32 partials with an xor-shuffle butterfly
//     (offsets 16, 8, 4, 2, 1: float addition commutes, so every lane
//     ends with the same bits);
//   - the bin's `split` warp totals are added in warp order from shared
//     memory, and one thread evaluates the bin's tail (dynamic PUE, cap
//     clip + linear throttle, energy, tflops/efficiency, gCO2, cost);
//   - the block's bins x 9 results are staged in shared memory and each
//     field is written as `bins` consecutive floats of out[9, S, T].
// No float atomics: results are bitwise repeatable.
//
// Operands: u [S, T, H] f32 contiguous; every other operand is an Operand
// descriptor: a pointer with a lane stride and a host (or bin) stride,
// stride 0 for a row shared by the lanes or hosts, or no pointer and a
// uniform value passed in the launch (no device tensor at all).  Host rows
// are [S, H], bin columns (cap, intensity, ambient, price) [S, T], lane
// scalars (peak, PUE) [S].
//
// Sentinels as in the JAX kernel: +inf cap (uncapped), identity PUE
// (base 1, coefficients 0), int32.max failure start (never fails), zero
// carbon/price columns when absent.  The power model is a template
// parameter, the precision policy a kernel parameter; bf16 touches only
// tflops and efficiency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// The launch's operands, by value (kernel parameter space).  Outside the
// anonymous namespace: the C entry point takes them.
struct Operand {
  const void* ptr;          // nullptr: every element is value / ivalue
  long long lane_stride;    // elements between lanes
  long long stride;         // elements between hosts (rows) or bins (columns)
  float value;
  int ivalue;
};

struct ReadoutArgs {
  const float* u;
  float* out;
  Operand p_idle, p_max, r, mask, fail_start, fail_end, fail_kill;  // [S, H]
  Operand cap, intensity, ambient, price;                           // [S, T]
  Operand peak, pue_base, pue_load, pue_amb, pue_ref;               // [S]
  int S, T, H, model, bf16, split;
  float dt_factor;
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFields = 9;
constexpr int kHostChunk = 1024;
constexpr int kUnroll = 8;
constexpr int kMaxLanes = 65535;

enum Model { kOpendc = 0, kLinear = 1, kSqrt = 2, kCubic = 3 };

__device__ __forceinline__ float f32_at(const Operand& o, long long s, long long i) {
  return o.ptr ? static_cast<const float*>(o.ptr)[s * o.lane_stride + i * o.stride]
               : o.value;
}

__device__ __forceinline__ int i32_at(const Operand& o, long long s, long long i) {
  return o.ptr ? static_cast<const int*>(o.ptr)[s * o.lane_stride + i * o.stride]
               : o.ivalue;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

template <int kModel>
__device__ __forceinline__ float shape_term(float uc, float r) {
  if (kModel == kOpendc) return 2.0f * uc - expf(r * logf(fmaxf(uc, 1e-30f)));
  if (kModel == kLinear) return uc;
  if (kModel == kSqrt) return sqrtf(uc);
  return uc * uc * uc;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One host's terms, added to the bin's four float64 sums (it, idle, u*on,
// on); `off` is the host's outage at this bin.
template <int kModel>
__device__ __forceinline__ void add_host(double (&acc)[4], float x, float pi,
                                         float span, float r, double pi_d,
                                         double mask_d, bool off) {
  const double on = (off ? 0.0 : 1.0) * mask_d;
  const float host_p = pi + span * shape_term<kModel>(clip01(x), r);
  acc[0] += static_cast<double>(host_p) * on;
  acc[1] += pi_d * on;
  acc[2] += static_cast<double>(x) * on;
  acc[3] += on;
}

// kUniform: every host row is one number (the twin's window path), so no
// row is staged and the loop reads them from registers.
template <int kModel, bool kUniform>
__global__ void __launch_bounds__(kThreads) des_readout_kernel(const ReadoutArgs a) {
  __shared__ float4 s_row[kUniform ? 1 : kHostChunk];   // p_idle, span, r, outage start
  __shared__ int s_end[kUniform ? 1 : kHostChunk];      // outage end
  __shared__ double2 s_d[kUniform ? 1 : kHostChunk];    // p_idle, mask in float64
  __shared__ double s_part[4][kWarps];
  __shared__ float s_out[kFields][kWarps];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = a.split, bins = kWarps / split;
  const long long s = blockIdx.y;
  const int t0 = blockIdx.x * bins;
  const int t = t0 + warp / split;
  const bool live = t < a.T;
  const float* u_row = a.u + (s * a.T + (live ? t : 0)) * static_cast<long long>(a.H);
  const int first = (warp % split) * 32 + lane;   // this thread's first host
  const int step = split * 32;                    // hosts between its next ones

  // the tail's operands, loaded now so that their latency hides behind the sums
  const int tb = t0 + static_cast<int>(threadIdx.x);
  const bool tail = threadIdx.x < bins && tb < a.T;
  float cap_t = 0.0f, ci = 0.0f, amb = 0.0f, prc = 0.0f;
  if (tail) {
    cap_t = f32_at(a.cap, s, tb);
    ci = f32_at(a.intensity, s, tb);
    amb = f32_at(a.ambient, s, tb);
    prc = f32_at(a.price, s, tb);
  }

  // the host rows where each is one number (kUniform)
  const float u_pi = a.p_idle.value, u_span = a.p_max.value - u_pi, u_r = a.r.value;
  const bool u_kill = a.fail_kill.value > 0.0f;
  const bool u_off = u_kill && t >= a.fail_start.ivalue && t < a.fail_end.ivalue;

  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int h0 = 0; h0 < a.H; h0 += kHostChunk) {
    const int n = min(kHostChunk, a.H - h0);
    if (!kUniform) {
      __syncthreads();                            // the last chunk is consumed
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const long long h = h0 + i;
        const float pi = f32_at(a.p_idle, s, h);
        const bool kill = f32_at(a.fail_kill, s, h) > 0.0f;
        s_row[i] = make_float4(pi, f32_at(a.p_max, s, h) - pi, f32_at(a.r, s, h),
                               __int_as_float(kill ? i32_at(a.fail_start, s, h) : 0));
        s_end[i] = kill ? i32_at(a.fail_end, s, h) : 0;
        s_d[i] = make_double2(pi, f32_at(a.mask, s, h));
      }
      __syncthreads();
    }
    if (!live) continue;
    const float* row = u_row + h0;
    auto add = [&](int k, float x) {
      if (kUniform) {
        add_host<kModel>(acc, x, u_pi, u_span, u_r, u_pi, a.mask.value, u_off);
      } else {
        const float4 hr = s_row[k];
        const double2 hd = s_d[k];
        const bool off = t >= __float_as_int(hr.w) && t < s_end[k];
        add_host<kModel>(acc, x, hr.x, hr.y, hr.z, hd.x, hd.y, off);
      }
    };
    int i = first;
    for (; i + (kUnroll - 1) * step < n; i += kUnroll * step) {   // full rounds
      float x[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) x[j] = row[i + j * step];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) add(i + j * step, x[j]);
    }
    for (; i < n; i += step) add(i, row[i]);                      // the rest, in order
  }

#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = warp_sum(acc[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s_part[q][warp] = acc[q];
  }
  __syncthreads();

  if (tail) {
    const int b = threadIdx.x;
    float sum[4];                    // each rounded once to float32
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      double v = s_part[q][b * split];
#pragma unroll
      for (int p = 1; p < kWarps; ++p)
        if (p < split) v += s_part[q][b * split + p];
      sum[q] = static_cast<float>(v);
    }
    const float peak = f32_at(a.peak, s, 0);
    const float util_raw = sum[2] / fmaxf(sum[3], 1.0f);
    const float load = clip01(util_raw);
    float pue = f32_at(a.pue_base, s, 0) + f32_at(a.pue_load, s, 0) * (1.0f - load);
    pue = pue + f32_at(a.pue_amb, s, 0) * fmaxf(amb - f32_at(a.pue_ref, s, 0), 0.0f);
    const float demand = sum[0] * pue;
    const float floor_w = sum[1] * pue;
    const bool exceeded = demand > cap_t;
    const float power = fminf(demand, cap_t);
    const float throttle = clip01((cap_t - floor_w) / fmaxf(demand - floor_w, 1e-9f));
    const float e = power * a.dt_factor / 1000.0f;
    const float util = exceeded ? util_raw * throttle : util_raw;
    float tflops, eff;
    if (a.bf16) {
      tflops = bf16_round(bf16_round(util) * bf16_round(peak));
      eff = bf16_round(tflops / bf16_round(fmaxf(e, 1e-9f)));
    } else {
      tflops = util * peak;
      eff = tflops / fmaxf(e, 1e-9f);
    }
    const float vals[kFields] = {power, e, tflops, util, eff, e * ci, demand, pue, e * prc};
#pragma unroll
    for (int k = 0; k < kFields; ++k) s_out[k][b] = vals[k];
  }
  __syncthreads();

  if (threadIdx.x < kFields * bins) {
    const int k = threadIdx.x / bins, b = threadIdx.x % bins;
    if (t0 + b < a.T) a.out[(k * static_cast<long long>(a.S) + s) * a.T + t0 + b] = s_out[k][b];
  }
}

template <int kModel>
void launch_model(const ReadoutArgs& a, dim3 grid, cudaStream_t st) {
  const bool uniform = !a.p_idle.ptr && !a.p_max.ptr && !a.r.ptr && !a.mask.ptr &&
                       !a.fail_start.ptr && !a.fail_end.ptr && !a.fail_kill.ptr;
  if (uniform)
    des_readout_kernel<kModel, true><<<grid, kThreads, 0, st>>>(a);
  else
    des_readout_kernel<kModel, false><<<grid, kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" int des_readout_launch(const ReadoutArgs* args, void* stream) {
  const ReadoutArgs& a = *args;
  const int split = a.split;
  if (a.S <= 0 || a.S > kMaxLanes || a.T < 0 || a.H < 0 || a.model < 0 ||
      a.model > kCubic || !(split == 1 || split == 2 || split == 4 || split == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.T == 0) return static_cast<int>(cudaGetLastError());
  const int bins = kWarps / split;
  const dim3 grid((a.T + bins - 1) / bins, a.S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.model) {
    case kOpendc: launch_model<kOpendc>(a, grid, st); break;
    case kLinear: launch_model<kLinear>(a, grid, st); break;
    case kSqrt: launch_model<kSqrt>(a, grid, st); break;
    default: launch_model<kCubic>(a, grid, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
