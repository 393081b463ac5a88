// Mamba2 / SSD intra-chunk term and chunk-end states, hand-written for
// Hopper (sm_90a).  Replaces src/repro/kernels/ssd_chunk.py:65
// (ssd_chunk_pallas, body _kernel).
//
// Layout (all float32, contiguous): x [BC, Q, H, P], dt [BC, Q, H]
// (post-softplus), a_log [H], b/c [BC, Q, G, N], d [H]; out y [BC, Q, H, P],
// st [BC, H, P, N].  Head h reads group g = h / (H / G).  Per (chunk, head):
//   csum     = cumsum(dt * -exp(a_log))                        [Q]
//   att[i,j] = (C_i . B_j) * exp(csum_i - csum_j) * dt_j        (j <= i)
//   y        = att @ x + D * x
//   st[p,n]  = sum_j exp(csum_{Q-1} - csum_j) * dt_j * x[j,p] * B[j,n]
//
// One block of 256 threads (16 x 16) per (chunk, head), as the TPU grid.
// Every product is a tiled matrix product on the CUDA cores in f32: the
// operands are staged in shared memory in chunks of 32 along the
// contracted axis, and each thread owns a 4 x 4 patch of a 64 x 64 output
// tile (rows ty + 16 r, columns tx + 16 c).  The chunk is walked in 64-row
// tiles, so any Q fits that leaves room for the three [Q] rows csum, dt
// and the end weights, which live in shared memory for the whole chunk
// (ssd_chunk_max_q gives the limit):
//   - for each row tile i and each key tile j <= i (the causal triangle
//     only): S = C_i B_j^T over N, then att = S * exp(csum_i - csum_j) *
//     dt_j where j <= i and 0 elsewhere (the exponential is evaluated only
//     where j <= i, so the masked exp(csum_i - csum_j) > 1 is never formed),
//     staged transposed in shared memory, then y_i += att @ x_j;
//   - y = acc + x * D, written once;
//   - st = (x * w)^T B over all rows, in 64-wide tiles of N, w the end
//     weights.
// The cumulative sum runs on one thread in row order, and every sum runs
// in a fixed order with no atomics: results are bitwise repeatable.  The
// products are explicit fmaf (the library builds with -fmad=false).
//
// Bound on an H100 at Mamba2-370M's prefill shape (BC=64, Q=128, H=32,
// P=64, G=1, N=128): operations.  The least work, with C B^T counted once
// per (chunk, group) and only the causal triangle, is 6.6 GFLOP (0.098 ms at
// 67 TFLOP/s f32) against 211 MB of operands (0.063 ms at 3.35 TB/s).  This
// kernel recomputes C B^T per head, as the TPU kernel does, and computes
// the diagonal tiles whole: 14 GFLOP.  Tensor cores are left out (TF32
// would break the 1e-4 parity with the plain version); sharing C B^T
// across a group's heads and tensor-core products are the next steps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16
constexpr int kTile = 64;            // rows of a row / key tile, width of an output tile
constexpr int kK = 32;               // depth of a staged operand chunk
constexpr int kLd = kTile + 1;       // padded shared-memory row
constexpr int kMaxP = kTile;         // head dims the y tile covers

// Fixed shared memory: two staged chunks [kK][kLd] and att^T [kTile][kLd].
constexpr int kFixedFloats = 2 * kK * kLd + kTile * kLd;

__device__ __forceinline__ void tile_fma(const float* __restrict__ a_s,
                                         const float* __restrict__ b_s,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 4
  for (int k = 0; k < kK; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a_s[k * kLd + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b_s[k * kLd + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ d_skip,
                 float* __restrict__ y, float* __restrict__ st, int H, int Q,
                 int P, int G, int N) {
  extern __shared__ float smem[];
  float* a_s = smem;                    // [kK][kLd]: staged A^T chunk
  float* b_s = a_s + kK * kLd;          // [kK][kLd]: staged B chunk
  float* att = b_s + kK * kLd;          // [kTile][kLd]: att^T tile (j, i)
  float* csum = att + kTile * kLd;      // [Q]
  float* dtv = csum + Q;                // [Q]
  float* wend = dtv + Q;                // [Q]

  const int bc = blockIdx.x / H;
  const int h = blockIdx.x - bc * H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const long long xrow = static_cast<long long>(H) * P;   // row stride of x, y
  const long long brow = static_cast<long long>(G) * N;   // row stride of b, c
  const long long x_off = static_cast<long long>(bc) * Q * xrow +
                          static_cast<long long>(h) * P;
  const float* xb = x + x_off;
  float* yb = y + x_off;
  const long long b_off = static_cast<long long>(bc) * Q * brow +
                          static_cast<long long>(g) * N;
  const float* bb = b + b_off;
  const float* cb = c + b_off;
  const float* dtb = dt + static_cast<long long>(bc) * Q * H + h;
  float* stb = st + (static_cast<long long>(bc) * H + h) * P * N;

  const float a = -expf(a_log[h]);
  const float dsk = d_skip[h];

  // dt, da and the cumulative sum (one thread, row order), end weights
  for (int q = tid; q < Q; q += kThreads) {
    const float dq = dtb[static_cast<long long>(q) * H];
    dtv[q] = dq;
    csum[q] = dq * a;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int q = 0; q < Q; ++q) {
      s = s + csum[q];
      csum[q] = s;
    }
  }
  __syncthreads();
  const float last = csum[Q - 1];
  for (int q = tid; q < Q; q += kThreads) wend[q] = expf(last - csum[q]) * dtv[q];
  __syncthreads();

  // y: causal tiles of the chunk
  const int n_tiles = (Q + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    float acc[4][4] = {};
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      float s[4][4] = {};
      for (int n0 = 0; n0 < N; n0 += kK) {
        for (int e = tid; e < kTile * kK; e += kThreads) {
          const int m = e / kK;
          const int k = e - m * kK;
          const int n = n0 + k;
          const int ri = i0 + m;
          const int rj = j0 + m;
          a_s[k * kLd + m] = (ri < Q && n < N) ? cb[ri * brow + n] : 0.0f;
          b_s[k * kLd + m] = (rj < Q && n < N) ? bb[rj * brow + n] : 0.0f;
        }
        __syncthreads();
        tile_fma(a_s, b_s, ty, tx, s);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = i0 + ty + 16 * r;
          const int j = j0 + tx + 16 * cc;
          float v = 0.0f;
          if (j <= i && i < Q) v = s[r][cc] * expf(csum[i] - csum[j]) * dtv[j];
          att[(tx + 16 * cc) * kLd + ty + 16 * r] = v;
        }
      }
      __syncthreads();
      for (int k0 = 0; k0 < kTile; k0 += kK) {
        for (int e = tid; e < kK * kMaxP; e += kThreads) {
          const int k = e / kMaxP;
          const int p = e - k * kMaxP;
          const int j = j0 + k0 + k;
          b_s[k * kLd + p] = (j < Q && p < P) ? xb[j * xrow + p] : 0.0f;
        }
        __syncthreads();
        tile_fma(att + k0 * kLd, b_s, ty, tx, acc);
        __syncthreads();
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= Q) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        if (p < P) {
          const float xv = xb[i * xrow + p];
          yb[i * xrow + p] = acc[r][cc] + xv * dsk;
        }
      }
    }
  }

  // chunk-end state: st = (x * w)^T B, one 64-wide tile of N at a time
  for (int n0 = 0; n0 < N; n0 += kTile) {
    float acc[4][4] = {};
    for (int j0 = 0; j0 < Q; j0 += kK) {
      for (int e = tid; e < kK * kTile; e += kThreads) {
        const int k = e / kTile;
        const int m = e - k * kTile;
        const int j = j0 + k;
        a_s[k * kLd + m] = (j < Q && m < P) ? xb[j * xrow + m] * wend[j] : 0.0f;
        b_s[k * kLd + m] = (j < Q && n0 + m < N) ? bb[j * brow + n0 + m] : 0.0f;
      }
      __syncthreads();
      tile_fma(a_s, b_s, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
      if (p >= P) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = n0 + tx + 16 * cc;
        if (n < N) stb[static_cast<long long>(p) * N + n] = acc[r][cc];
      }
    }
  }
}

}  // namespace

// The largest head dim and chunk length the kernel takes on `device`: the
// three [Q] rows beside the fixed part must fit the block's opt-in shared
// memory.  A negative value is a CUDA error code, negated.
extern "C" int ssd_chunk_max_p() { return kMaxP; }

extern "C" int ssd_chunk_max_q(int device) {
  int smem_bytes = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &smem_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return (smem_bytes / static_cast<int>(sizeof(float)) - kFixedFloats) / 3;
}

extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* a_log, const float* b,
                                const float* c, const float* d_skip, float* y,
                                float* st, int BC, int Q, int H, int P, int G,
                                int N, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || P > kMaxP || G <= 0 ||
      H % G != 0 || N <= 0 ||
      static_cast<long long>(BC) * H > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      (static_cast<size_t>(kFixedFloats) + 3 * static_cast<size_t>(Q)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_chunk_kernel<<<BC * H, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, dt, a_log, b, c, d_skip, y, st, H, Q, P, G, N);
  return static_cast<int>(cudaGetLastError());
}
