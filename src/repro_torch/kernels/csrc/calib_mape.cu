// Grid-search MAPE of every power-model candidate (the Self-Calibrator's
// hot spot), hand-written for Hopper (sm_90a).
//
// Replaces repro/kernels/calib_mape.py:calib_mape_grid_pallas (_kernel),
// and its jax.vmap over a fleet's lanes, whose candidate rows differ per
// lane.  The candidates are [B / group, C] rows: batch row b is scored
// over row b / group (group = B: one [C] set shared by every row; group =
// 1: a row per batch row; group = H: the per-host refit of a fleet, H rows
// per lane).  For batch row b and candidate c:
//     MAPE = 100/n * sum_t [|real_t| > 1e-9] |real_t - sim_t(c)| / (|real_t| + 1e-9)
// with sim_t(c) = H*p_idle_c + (p_max_c - p_idle_c) * (S2_t - Sr_t(r_c)),
// S2_t = sum_h 2u and Sr_t(r) = sum_h expf(r * logf(max(u, 1e-30))) over u
// clipped to [0, 1], n the count of nonzero bins of real (NaN when n = 0).
//
// Bound on an H100: the special-function units.  Each (b, t, h) needs one
// logf and each (b, t, h, distinct r) one expf, at 16 results a clock per
// SM: 2.6 M for the E2 window (T=144, H=277) and its 64 values of r, about
// 0.6 us; the window itself is 160 KB.  The joint grid's 9216 candidates
// hold only 64 distinct r, so Sr is shared, not recomputed.
//
// Pass 1, grid (candidate tiles of 256, bin tiles, B), one thread per
// candidate:
//   1. dedup: a candidate whose r has the bits of an earlier candidate of
//      its tile takes that leader's sums (a shared sum is the very value
//      the candidate would compute itself).  The first candidate of each
//      r is found through a hash table in shared memory (atomicCAS on the
//      bits, atomicMin on the index: integers, so the outcome does not
//      depend on timing); leaders are compacted into slots in candidate
//      order with __ballot_sync / __popc;
//   2. log u and 2u of the block's bins are staged in shared memory, in
//      chunks of kHostChunk hosts;
//   3. every (bin, slot) sum and each bin's S2 is formed in a fixed order:
//      with H >= 32 one warp per sum, lane l over hosts l, l+32, ... of the
//      chunk, then an xor-shuffle tree; with H < 32 (the per-host refit has
//      H = 1) one thread per sum, hosts in order.  Chunk totals add in
//      chunk order;
//   4. each candidate adds the relative errors of its tile's bins in bin
//      order (zero-real bins skipped) into partial[b, tile, c].
// Pass 2, grid (candidate tiles, B): the partials in tile order, the count
// of nonzero bins (__syncthreads_count, an integer), then acc * (100/n) or
// NaN.  No float atomics: the result is the same bit pattern on every run,
// so the argmin downstream cannot flip.  The wrapper picks the bin tile so
// that pass 1 launches at least two blocks an SM where the window allows,
// from the rows of one candidate row (group), not from B: a block's work
// depends only on its own row, so a fleet's lane is summed in the order of
// that lane's call alone and gives the same bits, whatever the fleet's size.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;     // one thread per candidate of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 32;      // bins of one block
constexpr int kHostChunk = 512;   // hosts staged per round, a multiple of 32
constexpr int kStage = 2048;      // staged (bin, host) values of log u and of 2u
constexpr int kSums = 4096;       // (bin, slot or S2) sums of one block
constexpr int kWarpHosts = 32;    // from this many hosts one warp forms a sum
constexpr int kHashBits = 9;      // dedup table of 512 slots for 256 candidates
constexpr int kHash = 1 << kHashBits;
static_assert(kHash <= kStage, "the dedup table shares the staging buffers");
constexpr unsigned kEmpty = 0xffffffffu;  // a free slot (a NaN's bits)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
calib_mape_partial_kernel(const float* __restrict__ u,
                          const float* __restrict__ real,
                          const float* __restrict__ p_idle,
                          const float* __restrict__ p_max,
                          const float* __restrict__ r,
                          float* __restrict__ partial,
                          int T, int H, int C, int bin_tile, int group) {
  __shared__ float s_logu[kStage];
  __shared__ float s_two_u[kStage];
  __shared__ float s_sum[kSums];
  // the dedup table lives in the staging buffers, which are not yet in use
  unsigned* s_key = reinterpret_cast<unsigned*>(s_logu);
  int* s_first = reinterpret_cast<int*>(s_two_u);
  __shared__ float s_lead_r[kThreads];
  __shared__ int s_slot[kThreads];
  __shared__ int s_warp_leads[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.x * kThreads + tid;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = tile * bin_tile;
  const int nt = min(bin_tile, T - t0);
  const bool active = c < C;
  // this batch row's candidate row: [B / group, C], group rows share one
  const long long cand = static_cast<long long>(b / group) * C + c;
  const float rc = active ? r[cand] : 0.0f;
  const unsigned bits = __float_as_uint(rc);

  // 1. dedup r within the tile: the leader is the first candidate with
  // these bits, found through a hash table of the tile's r (integer
  // atomics: which slot a value lands in may vary, its first candidate does
  // not); leaders get slots 0 .. n_lead-1 in candidate order
  for (int i = tid; i < kHash; i += kThreads) {
    s_key[i] = kEmpty;
    s_first[i] = kThreads;
  }
  __syncthreads();
  int leader = tid;
  unsigned entry = 0;
  const bool hashed = active && bits != kEmpty;  // kEmpty's bits lead themselves
  if (hashed) {
    entry = (bits * 2654435761u) >> (32 - kHashBits);
    for (;;) {
      const unsigned prev = atomicCAS(&s_key[entry], kEmpty, bits);
      if (prev == kEmpty || prev == bits) break;
      entry = (entry + 1) & (kHash - 1);
    }
    atomicMin(&s_first[entry], tid);
  }
  __syncthreads();
  if (hashed) leader = s_first[entry];
  const bool is_leader = active && leader == tid;
  const unsigned ballot = __ballot_sync(0xffffffffu, is_leader);
  if (lane == 0) s_warp_leads[warp] = __popc(ballot);
  __syncthreads();
  int first = 0;
  int n_lead = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int n = s_warp_leads[w];
    first += w < warp ? n : 0;
    n_lead += n;
  }
  if (is_leader) {
    const int slot = first + __popc(ballot & ((1u << lane) - 1u));
    s_slot[tid] = slot;
    s_lead_r[slot] = rc;
  }
  __syncthreads();
  const int slot = active ? s_slot[leader] : 0;

  // 2-3. the (bin, slot) sums; slot n_lead of a bin holds S2
  const int width = n_lead + 1;
  const int n_pairs = nt * width;
  const float* u_tile = u + (static_cast<long long>(b) * T + t0) * H;
  int h0 = 0;
  do {
    const int n = min(kHostChunk, H - h0);
    for (int i = tid; i < nt * n; i += kThreads) {
      const int t = i / n;
      const int h = i - t * n;
      const float x = fminf(fmaxf(u_tile[static_cast<long long>(t) * H + h0 + h], 0.0f), 1.0f);
      s_logu[i] = logf(fmaxf(x, 1e-30f));
      s_two_u[i] = 2.0f * x;
    }
    __syncthreads();
    if (H >= kWarpHosts) {
      for (int p = warp; p < n_pairs; p += kWarps) {
        const int t = p / width;
        const int k = p - t * width;
        const float* lu = s_logu + t * n;
        const float* tu = s_two_u + t * n;
        float v = 0.0f;
        if (k < n_lead) {
          const float rk = s_lead_r[k];
#pragma unroll 4
          for (int h = lane; h < n; h += 32) v += expf(rk * lu[h]);
        } else {
          for (int h = lane; h < n; h += 32) v += tu[h];
        }
        v = warp_sum(v);
        if (lane == 0) s_sum[p] = h0 == 0 ? v : s_sum[p] + v;
      }
    } else {
      for (int p = tid; p < n_pairs; p += kThreads) {
        const int t = p / width;
        const int k = p - t * width;
        const float* lu = s_logu + t * n;
        const float* tu = s_two_u + t * n;
        float v = 0.0f;
        if (k < n_lead) {
          const float rk = s_lead_r[k];
          for (int h = 0; h < n; ++h) v += expf(rk * lu[h]);
        } else {
          for (int h = 0; h < n; ++h) v += tu[h];
        }
        s_sum[p] = v;  // H < kWarpHosts: one chunk
      }
    }
    __syncthreads();  // sums complete, the staged chunk fully consumed
    h0 += kHostChunk;
  } while (h0 < H);

  // 4. this tile's relative errors of each candidate, in bin order
  if (!active) return;
  const float pi = p_idle[cand];
  const float span = p_max[cand] - pi;
  const float base = static_cast<float>(H) * pi;
  const float* real_tile = real + static_cast<long long>(b) * T + t0;
  float acc = 0.0f;
  for (int t = 0; t < nt; ++t) {
    const float re = real_tile[t];
    if (fabsf(re) > 1e-9f) {
      const float sim = base + span * (s_sum[t * width + n_lead] - s_sum[t * width + slot]);
      acc += fabsf((re - sim) / (fabsf(re) + 1e-9f));
    }
  }
  partial[(static_cast<long long>(b) * gridDim.y + tile) * C + c] = acc;
}

__global__ void __launch_bounds__(kThreads)
calib_mape_finish_kernel(const float* __restrict__ partial,
                         const float* __restrict__ real,
                         float* __restrict__ out, int T, int C, int n_tiles) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const float* real_b = real + static_cast<long long>(b) * T;
  int n = 0;
  for (int t0 = 0; t0 < T; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    n += __syncthreads_count(t < T && fabsf(real_b[t]) > 1e-9f);
  }
  if (c >= C) return;
  const float* p = partial + static_cast<long long>(b) * n_tiles * C + c;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < n_tiles; ++k) acc += p[static_cast<long long>(k) * C];
  out[static_cast<long long>(b) * C + c] =
      n > 0 ? acc * (100.0f / static_cast<float>(n)) : __int_as_float(0x7fc00000);
}

}  // namespace

// p_idle, p_max and r are [B / group, C] candidate rows, partial is
// [B, ceil(T / bin_tile), C] scratch, out [B, C].  A bin tile beyond the
// block's shared memory (kMaxBins, kStage, kSums), a group that does not
// divide B, or a grid beyond the card's limits is refused with
// cudaErrorInvalidValue.
extern "C" int calib_mape_grid_launch(const float* u, const float* real,
                                      const float* p_idle, const float* p_max,
                                      const float* r, float* partial, float* out,
                                      int B, int T, int H, int C, int bin_tile,
                                      int group, void* stream) {
  if (B < 0 || T < 0 || H < 0 || C < 0 || bin_tile < 1 || bin_tile > kMaxBins ||
      bin_tile * min(H, kHostChunk) > kStage ||
      bin_tile * (min(C, kThreads) + 1) > kSums || B > 65535 || group < 1 ||
      B % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const int n_tiles = (T + bin_tile - 1) / bin_tile;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int c_tiles = (C + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    calib_mape_partial_kernel<<<dim3(c_tiles, n_tiles, B), kThreads, 0, s>>>(
        u, real, p_idle, p_max, r, partial, T, H, C, bin_tile, group);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  calib_mape_finish_kernel<<<dim3(c_tiles, B), kThreads, 0, s>>>(partial, real, out, T, C,
                                                                  n_tiles);
  return static_cast<int>(cudaGetLastError());
}
