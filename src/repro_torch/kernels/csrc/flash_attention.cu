// Causal GQA flash-attention forward (online softmax, f32 m/l/acc),
// hand-written for Hopper (sm_90a).
//
// Layout: q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D], out [B, Hq, Sq, D] in
// q's dtype (float32 or bfloat16), all contiguous.  Query head hq reads KV
// head hq / (Hq / Hkv) in place.
//
// One block of 128 threads per (64-row query tile, query head, batch row);
// two threads per query row, each owning every other float4 chunk of the
// row's scaled q and f32 accumulator (registers).  The block stages each
// 64-row K/V tile in shared memory as f32 and walks the tiles up to the
// causal diagonal: tiles strictly above it are skipped, as the TPU kernel
// skips them.  Inside a tile the row's running max m and sum l are updated
// every 16 keys; the two threads of a row add their half dot products with
// one shuffle (a + b on both: the same bits), so the result is bitwise
// repeatable.  As in the TPU kernel: q is scaled in f32 after the cast, a
// key is masked with -1e30 when it lies past the diagonal (offset
// Skv - Sq) or past Skv (the ragged tile), and the output is
// acc / max(l, 1e-30).  Rows that see no key at all are left as the TPU
// kernel leaves them: undefined.  The products are explicit fmaf: the
// library builds with -fmad=false, which still keeps those fused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQTile = 64;
constexpr int kKTile = 64;
constexpr int kSub = 16;                 // keys per online-softmax update
constexpr int kThreads = 2 * kQTile;     // two threads per query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Skv, int causal, float scale) {
  constexpr int kChunks = D / 8;         // float4 chunks of a thread's half
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [kKTile][D]
  float* vs = ks + kKTile * D;                   // [kKTile][D]

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest causal rows first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int q0 = qt * kQTile;
  const int qi = q0 + (tid >> 1);
  const int diag = Skv - Sq;

  const long long q_base = (static_cast<long long>(b) * Hq + hq) * Sq * D;
  const long long kv_base = (static_cast<long long>(b) * Hkv + hkv) * Skv * D;

  float qr[D / 2];
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (2 * c + half) * 4 + e;
      qr[4 * c + e] =
          qi < Sq ? to_f32(q[q_base + static_cast<long long>(qi) * D + d]) * scale
                  : 0.0f;
      acc[4 * c + e] = 0.0f;
    }
  }
  float m = kNegInf;
  float l = 0.0f;

  int kv_tiles = (Skv + kKTile - 1) / kKTile;
  if (causal) {
    const int last = q0 + kQTile - 1 + diag;     // the tile's last row, on the kv axis
    kv_tiles = min(kv_tiles, last < 0 ? 0 : last / kKTile + 1);
  }

  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int k0 = kt * kKTile;
    __syncthreads();                             // the previous tile is consumed
    for (int idx = tid; idx < kKTile * D; idx += kThreads) {
      const bool ok = k0 + idx / D < Skv;
      const long long g = kv_base + static_cast<long long>(k0) * D + idx;
      ks[idx] = ok ? to_f32(k[g]) : 0.0f;
      vs[idx] = ok ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kKTile; j0 += kSub) {
      float s[kSub];
      float m_cur = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + jj) * D);
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 kv = kr[2 * c + half];
          part = fmaf(qr[4 * c], kv.x, part);
          part = fmaf(qr[4 * c + 1], kv.y, part);
          part = fmaf(qr[4 * c + 2], kv.z, part);
          part = fmaf(qr[4 * c + 3], kv.w, part);
        }
        const float dot = part + __shfl_xor_sync(0xffffffffu, part, 1);
        const int kj = k0 + j0 + jj;
        const bool live = kj < Skv && (!causal || qi + diag >= kj);
        s[jj] = live ? dot : kNegInf;
        m_cur = fmaxf(m_cur, s[jj]);
      }
      const float m_new = fmaxf(m, m_cur);
      const float alpha = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = fmaf(l, alpha, psum);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + jj) * D);
        const float p = s[jj];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 vv = vr[2 * c + half];
          acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
        }
      }
      m = m_new;
    }
  }

  if (qi >= Sq) return;
  const float lc = fmaxf(l, 1e-30f);
  T* orow = o + q_base + static_cast<long long>(qi) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      orow[(2 * c + half) * 4 + e] = from_f32<T>(acc[4 * c + e] / lc);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Sq, int Skv, int causal, float scale,
           cudaStream_t stream) {
  const int smem = 2 * kKTile * D * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<D, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kQTile - 1) / kQTile, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16, T>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 32:
      return launch<32, T>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 64:
      return launch<64, T>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's CUDA error code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      int dtype, int causal, float scale,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                   scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
