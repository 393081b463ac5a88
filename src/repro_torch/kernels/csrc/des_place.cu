// DES placement for every what-if lane in one launch, hand-written for
// Hopper (sm_90a).  Replaces the placement scan of src/repro/core/desim.py
// (simulate_utilization_masked: lax.scan over bins around a while_loop of
// placement attempts, place_one), which the JAX package runs on the device
// and vmaps over scenarios; it has no Pallas kernel.
//
// What it computes, per lane (scenario) s, bin by bin:
//   * free[h] += release[t][h]: cores of jobs that end at bin t come back;
//   * then placement attempts while the FCFS head job is submitted, valid
//     and the bin not blocked, at most max_starts placements a bin.  An
//     attempt scores every host for the head job (and for each backfill
//     candidate d = 1..depth that is submitted, valid and not started):
//     key = (fits ? score : -1) * H + (H - 1 - h), score by the lane's
//     policy (first fit H - h, best fit 2^24 - min(free, 2^24 - 1), worst
//     fit free, random fit a uint32 hash of (h, t, n) with n the jobs
//     placed so far in this bin, the salt); the largest key wins, so ties
//     go to the lowest host.  A head that fits places; else the first startable
//     candidate places (and its bit is set in the skip mask); else the
//     bin is blocked.  A placement writes job_start/job_host and banks its
//     cores at release[min(end, T)][host], end = t + max(dur, 1), or the
//     outage's end when the job lands on an outage host before its window
//     and runs into it (the kill rule).  Hosts in their failure window
//     take no placement, padded hosts (mask 0) none at all.
//   Integer arithmetic only: equal, bit for bit, to des_place_ref
//   (repro_torch/kernels/ref.py), which runs the same rules lane by lane.
//
// Bound on an H100: neither bytes nor FLOPs.  The attempts of a lane form
// one dependent chain (each reads the free cores the one before wrote),
// so a lane takes at least (attempts) x (one barrier round trip); lanes
// run side by side, one block each.
//
// Design: one block per lane, 32 x (max_backfill + 1) threads.  Warp 0
// scores the head job, warp d backfill candidate d; each warp strides over
// the hosts and reduces its int64 keys with __shfl_xor_sync.  free[H] and
// the bin's online flags live in shared memory.  Thread 0 alone decides
// (next_job, skip, placed, blocked), updates free[host] and writes the
// schedule and the release entry: one writer a lane, so no atomics.  Two
// __syncthreads an attempt (scores ready; decision ready), two a bin.  The
// release table [S, T + 1, H] int32 is scratch in global memory, zeroed
// by the wrapper; row T absorbs releases past the horizon.

#include <climits>
#include <cuda_runtime.h>

// hosts a lane may have: free[] (int32) and the online flags (one byte)
// of a lane in static shared memory, 40 KB
constexpr int kMaxHosts = 8192;
// backfill candidates: the skip mask is 32 bits, bit 0 the head
constexpr int kMaxBackfill = 31;

// Field for field as repro_torch/kernels/des_place.py, PlaceArgs.
struct PlaceArgs {
  const int* submit;              // [S, J]
  const int* dur;                 // [S, J]
  const int* cores;               // [S, J]
  const unsigned char* valid;     // [S, J]
  const unsigned char* mask;      // [S, H]
  const int* cores_per_host;      // [S]
  const int* policy;              // [S]
  const int* depth;               // [S]
  const int* fail_start;          // [S, H], or null: no failures
  const int* fail_end;            // [S, H]
  const unsigned char* fail_kill; // [S, H]
  int* release;                   // [S, T + 1, H], zero
  int* job_start;                 // [S, J], -1
  int* job_host;                  // [S, J], -1
  int* attempts;                  // [S]
  int S, J, H, T, max_starts, max_backfill;
};

namespace {

constexpr int kFirstFit = 0, kBestFit = 1, kWorstFit = 2;
constexpr int kBestFitBias = 1 << 24;

__device__ __forceinline__ int hash_score(unsigned h, unsigned t, unsigned salt) {
  unsigned x = h * 0x9E3779B1u ^ t * 0x85EBCA77u ^ salt * 0xC2B2AE3Du;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return static_cast<int>(x & 0x7FFFFFu);
}

// The key's tie-break term: ties go to the lowest host index.  It is its
// own inverse, so it also reads the host back from a key.
__device__ __forceinline__ int tie_break(int h, int H) { return H - 1 - h; }

__device__ __forceinline__ long long warp_max(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(32 * (kMaxBackfill + 1)) des_place_kernel(PlaceArgs a) {
  __shared__ int s_free[kMaxHosts];
  __shared__ unsigned char s_on[kMaxHosts];
  __shared__ long long s_key[kMaxBackfill + 1];
  __shared__ int s_go, s_next, s_salt;
  __shared__ unsigned s_skip;

  const int s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.H, J = a.J, T = a.T;
  const long long jo = static_cast<long long>(s) * J;
  const long long ho = static_cast<long long>(s) * H;
  const int* submit = a.submit + jo;
  const int* dur = a.dur + jo;
  const int* cores = a.cores + jo;
  const unsigned char* valid = a.valid + jo;
  const unsigned char* mask = a.mask + ho;
  const bool fail = a.fail_start != nullptr;
  const int* fs = fail ? a.fail_start + ho : nullptr;
  const int* fe = fail ? a.fail_end + ho : nullptr;
  const unsigned char* fk = fail ? a.fail_kill + ho : nullptr;
  int* release = a.release + static_cast<long long>(s) * (T + 1) * H;
  int* job_start = a.job_start + jo;
  int* job_host = a.job_host + jo;
  const int policy = min(max(a.policy[s], 0), 3);
  const int depth = min(a.depth[s], a.max_backfill);
  const int cph = a.cores_per_host[s];

  for (int h = tid; h < H; h += blockDim.x) s_free[h] = mask[h] ? cph : 0;

  // thread 0's scheduling state; s_salt publishes `placed` to the warps
  int next_job = 0, attempts = 0, placed = 0;
  unsigned skip = 0u;
  auto head_ready = [&](int nj, int t) {
    return nj < J && submit[nj] <= t && valid[nj];
  };

  for (int t = 0; t < T; ++t) {
    const int* rel = release + static_cast<long long>(t) * H;
    for (int h = tid; h < H; h += blockDim.x) {
      s_free[h] += rel[h];
      s_on[h] = mask[h] && !(fail && fs[h] <= t && t < fe[h]);
    }
    __syncthreads();                       // every thread is done with bin t - 1
    if (tid == 0) {
      placed = 0;
      s_go = a.max_starts > 0 && head_ready(next_job, t);
      s_next = next_job;
      s_skip = skip;
      s_salt = 0;
    }
    __syncthreads();
    while (s_go) {
      const int nj = s_next, salt = s_salt;
      const unsigned sk = s_skip;
      // warp 0: the head; warp d: backfill candidate nj + d
      const int job = nj + warp;
      const bool elig = warp == 0 ||
          (warp <= depth && job < J && !((sk >> warp) & 1u) && submit[job] <= t && valid[job]);
      long long best = -1;
      if (elig) {
        const int need = cores[job];
        best = LLONG_MIN;
        for (int h = lane; h < H; h += 32) {
          const int f = s_free[h];
          int score;
          if (policy == kFirstFit) score = H - h;
          else if (policy == kBestFit) score = kBestFitBias - min(f, kBestFitBias - 1);
          else if (policy == kWorstFit) score = f;
          else score = hash_score(h, t, salt);
          const long long key =
              static_cast<long long>(s_on[h] && f >= need ? score : -1) * H + tie_break(h, H);
          best = key > best ? key : best;
        }
        best = warp_max(best);
      }
      if (lane == 0) s_key[warp] = best;
      __syncthreads();                     // every score is in s_key
      if (tid == 0) {
        ++attempts;
        const bool head_fits = s_key[0] >= 0;
        int jid = head_fits ? nj : -1, d_sel = 0;
        long long key = s_key[0];
        for (int d = 1; !head_fits && d <= a.max_backfill; ++d) {
          if (s_key[d] >= 0) {
            jid = nj + d;
            key = s_key[d];
            d_sel = d;
            break;
          }
        }
        if (jid >= 0) {
          const int host = tie_break(static_cast<int>(key % H), H);
          const int need = cores[jid];
          s_free[host] -= need;
          job_start[jid] = t;
          job_host[jid] = host;
          long long end = static_cast<long long>(t) + max(dur[jid], 1);
          if (fail && fk[host] && t < fs[host] && end > fs[host]) end = fe[host];
          if (end > T) end = T;
          release[end * H + host] += need;
          ++placed;
        }
        int nj2 = nj;
        unsigned sk2 = sk;
        bool blocked = false;
        if (head_fits) {                   // past the head and any backfilled successors
          ++nj2;
          sk2 >>= 1;
          while (sk2 & 1u) {
            ++nj2;
            sk2 >>= 1;
          }
        } else if (jid >= 0) {
          sk2 |= 1u << d_sel;
        } else {
          blocked = true;
        }
        next_job = nj2;
        skip = sk2;
        s_go = !blocked && placed < a.max_starts && head_ready(nj2, t);
        s_next = nj2;
        s_skip = sk2;
        s_salt = placed;
      }
      __syncthreads();                     // the decision is in shared memory
    }
  }
  if (tid == 0) a.attempts[s] = attempts;
}

// The barrier round trip of one attempt, alone: thread 0 writes a shared
// word, a barrier, every thread reads it, a barrier; `rounds` times in one
// block of `warps` warps.
__global__ void barrier_kernel(int rounds, int* out) {
  __shared__ int s_x;
  int acc = 0;
  for (int i = 0; i < rounds; ++i) {
    if (threadIdx.x == 0) s_x = i;
    __syncthreads();
    acc += s_x;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace

extern "C" int des_place_launch(const PlaceArgs* args, void* stream) {
  const PlaceArgs& a = *args;
  if (a.S <= 0 || a.J <= 0 || a.H <= 0 || a.H > kMaxHosts || a.T < 0 ||
      a.max_starts < 0 || a.max_backfill < 0 || a.max_backfill > kMaxBackfill)
    return static_cast<int>(cudaErrorInvalidValue);
  des_place_kernel<<<a.S, 32 * (a.max_backfill + 1), 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int des_place_max_hosts() { return kMaxHosts; }

extern "C" int des_place_barrier_launch(int rounds, int warps, int* out, void* stream) {
  if (rounds < 0 || warps < 1 || warps > kMaxBackfill + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  barrier_kernel<<<1, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(rounds, out);
  return static_cast<int>(cudaGetLastError());
}
