// DES placement for every what-if lane in one launch, hand-written for
// Hopper (sm_90a).  Replaces the placement scan of src/repro/core/desim.py
// (simulate_utilization_masked: lax.scan over bins around a while_loop of
// placement attempts, place_one), which the JAX package runs on the device
// and vmaps over scenarios; it has no Pallas kernel.
//
// What it computes, per lane (scenario) s, bin by bin:
//   * free[h] += the cores of jobs that end at bin t;
//   * then placement attempts while the FCFS head job is submitted, valid
//     and the bin not blocked, at most max_starts placements a bin.  An
//     attempt scores every host for the head job (and, when the head fits
//     nowhere, for each backfill candidate d = 1..depth that is submitted,
//     valid and not started): (fits ? score : -1), score by the lane's
//     policy (first fit H - h, best fit 2^24 - min(free, 2^24 - 1), worst
//     fit free, random fit a uint32 hash of (h, t, n) with n the jobs
//     placed so far in this bin, the salt); the largest wins, ties to the
//     lowest host.  A head that fits places; else the first startable
//     candidate places (and its bit is set in the skip mask); else the
//     bin is blocked.  A placement writes job_start/job_host and returns
//     its cores at min(end, T), end = t + max(dur, 1), or the outage's end
//     when the job lands on an outage host before its window and runs
//     into it (the kill rule).  Hosts in their failure window take no
//     placement, padded hosts (mask 0) none at all.
//   Integer arithmetic only: equal, bit for bit, to des_place_ref
//   (repro_torch/kernels/ref.py), which runs the same rules lane by lane.
//
// Bound on an H100: neither bytes nor FLOPs.  The attempts of a lane form
// one dependent chain (each reads the free cores the one before wrote), and
// so do its bins, so a lane takes at least (attempts + bins) x (one
// decision step: a shared store, __syncwarp, a load and two redux.sync,
// timed alone by des_place_step_launch); lanes run side by side.  One warp
// runs the whole chain, so in practice the instructions of a step and
// their latencies bound it, not the memory: the design keeps them few and
// independent.
//
// Design: one block per lane, and one warp of it decides.  Warp 0 holds the
// lane's scheduling state in registers (every lane of the warp the same
// values), so a decision needs no broadcast and no block barrier.  Lane l
// of warp 0 owns the host groups g = l, l + 32, ... (hosts 4g..4g+3): it
// alone writes their rows, so it reads back its own writes and no host
// needs a fence.
//   * Host rows in shared memory: free cores, avail (the free cores of a
//     host that takes placements, INT_MIN where it does not: one int4 load
//     scores four hosts), the failure rows (start and end with the mask
//     folded in, and the kill flags) or the mask.
//   * An attempt scores the lane's groups from avail, kRounds rounds at a
//     time in registers: the batch's largest (fits ? score : -1) and the
//     lowest index holding it as trees, a later batch only if strictly
//     greater; then __reduce_max_sync over the lanes' scores and
//     __reduce_min_sync over the hosts of the lanes that hold the max: the
//     argmax of the int64 key score * H + (H - 1 - h), every lane holding
//     it.  The placement is computed in every lane and stored by the
//     host's owner alone.
//   Nothing on an attempt's chain reads global memory:
//   * Job window: the lane's jobs packed as int4 (ready bin, duration,
//     cores, 0; ready = submit, or kNever where not valid or past J) in a
//     ring of kWindow jobs in shared memory, refilled a chunk of kChunk at
//     a time with cp.async when the head comes within 2 kChunk of the
//     window's end: an attempt reads at most head + 32, so the refill lands
//     long before it is read and overwrites only jobs behind the head.
//   * Release table: [S, T, HP] int32 in global memory (HP = H rounded up
//     to 4), zeroed by the wrapper.  Row t + 1 is prefetched with cp.async
//     into shared memory while bin t places; a placement that ends at
//     t + 1 (a one-bin job, or a kill that ends there) adds its cores to
//     the late row, which the next bin adds with the prefetched one, since
//     the prefetched copy may not see a global write; later rows take a
//     red.global.add.s32 (an integer atomicAdd whose result goes unused,
//     the only atomic here, order-free so the sums are deterministic),
//     ends at T or past it nothing.  No float atomic.
//   * Backfill: the candidates are scored only when the head fits nowhere,
//     the only case in which their result is used.  Up to kHelpers warps
//     score them, warp w the candidates w, w + kHelpers, ... (and none
//     after one that fits): warp 0 posts the attempt in shared memory and
//     meets them at two named barriers (bar.sync 1 and 2), then takes the
//     first pick with __ballot_sync.  Warps past the lane's depth exit at
//     once.
// Shared memory is sized by H (dynamic): 13 KB at 277 hosts, 208 KB at
// 8192 with failures.

#include <climits>
#include <cuda_runtime.h>

// hosts a lane may have: its host rows in shared memory
constexpr int kMaxHosts = 8192;
// backfill candidates: the skip mask is 32 bits, bit 0 the head
constexpr int kMaxBackfill = 31;
// warps that score backfill candidates, candidates d, d + kHelpers, ...
// each: a block of at most 288 threads may give a thread 224 registers,
// so the scoring batches stay in registers
constexpr int kHelpers = 8;
// the job window: a ring of kWindow jobs, refilled kChunk at a time
constexpr int kChunk = 128;
constexpr int kWindow = 4 * kChunk;
// the ready bin of a job that never starts (not valid, or past the trace)
constexpr int kNever = INT_MAX;

// Field for field as repro_torch/kernels/des_place.py, PlaceArgs.
struct PlaceArgs {
  const int4* jobs;               // [S, J] (ready bin, duration, cores, 0)
  const unsigned char* mask;      // [S, H]
  const int* cores_per_host;      // [S]
  const int* policy;              // [S]
  const int* depth;               // [S]
  const int* fail_start;          // [S, H], or null: no failures
  const int* fail_end;            // [S, H]
  const unsigned char* fail_kill; // [S, H]
  int* release;                   // [S, T, HP], zero
  int* job_start;                 // [S, J], -1
  int* job_host;                  // [S, J], -1
  int* attempts;                  // [S]
  int S, J, H, T, max_starts, max_backfill;
};

namespace {

constexpr int kFirstFit = 0, kBestFit = 1, kWorstFit = 2, kRandomFit = 3;
constexpr int kBestFitBias = 1 << 24;
constexpr unsigned kAll = 0xffffffffu;
// a lane scores at most kRounds of its host groups at once, from registers
constexpr int kRounds = 4;

__host__ __device__ constexpr int pad_hosts(int h) { return (h + 3) & ~3; }

// Dynamic shared memory of a lane, in this order: the job window (int4);
// avail, free, rel, late, [fail_start, fail_end] (int); the mask or, with
// failures, the kill flags (byte).
__host__ __device__ constexpr int smem_bytes(int hp, bool fail) {
  return kWindow * 16 + hp * 4 * (fail ? 6 : 4) + hp;
}

__device__ __forceinline__ int hash_score(unsigned h, unsigned t, unsigned salt) {
  unsigned x = h * 0x9E3779B1u ^ t * 0x85EBCA77u ^ salt * 0xC2B2AE3Du;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return static_cast<int>(x & 0x7FFFFFu);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// max, and min, of N values as a tree: log2 N dependent steps, not N
template <int N>
__device__ __forceinline__ int tree_max(int (&a)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) a[i] = max(a[i], a[i + w]);
  return a[0];
}

template <int N>
__device__ __forceinline__ int tree_min(int (&a)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) a[i] = min(a[i], a[i + w]);
  return a[0];
}

struct Pick {
  int score;  // the best (fits ? score : -1); -1: the job fits nowhere
  int host;   // the lowest host that holds it
};

// The warp's pick for a job of `need` cores from avail[] (free cores where
// the host takes placements, INT_MIN where not); every lane of the warp
// calls it and every lane gets the same pick.  A lane scores R rounds of
// its groups at once: the scores in registers, their max and the lowest
// index holding it as trees; a later batch of rounds replaces the lane's
// best only if strictly greater, so ties keep the lowest host.
template <int kPolicy, int R>
__device__ __forceinline__ Pick pick_host(const int4* avail, int groups, int H, int need,
                                          int t, int salt, int lane) {
  int best = INT_MIN, best_host = INT_MAX;
  for (int g0 = lane; g0 < groups; g0 += 32 * R) {
    int v[4 * R], idx[4 * R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int g = g0 + 32 * k;
      const int4 a4 = g < groups ? avail[g] : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
      const int f[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = 4 * g + i;
        int score;
        if (kPolicy == kFirstFit) score = H - h;
        else if (kPolicy == kBestFit)  // unsigned: no overflow where f is INT_MIN
          score = static_cast<int>(static_cast<unsigned>(kBestFitBias) -
                                   static_cast<unsigned>(min(f[i], kBestFitBias - 1)));
        else if (kPolicy == kWorstFit) score = f[i];
        else score = hash_score(h, t, salt);
        v[4 * k + i] = f[i] >= need ? score : -1;
      }
    }
    int m[4 * R];
#pragma unroll
    for (int i = 0; i < 4 * R; ++i) m[i] = v[i];
    const int top = tree_max(m);
#pragma unroll
    for (int i = 0; i < 4 * R; ++i) idx[i] = v[i] == top ? i : 4 * R;
    const int first = tree_min(idx);
    if (top > best) {
      best = top;
      best_host = 4 * (g0 + 32 * (first >> 2)) + (first & 3);
    }
  }
  const int m = __reduce_max_sync(kAll, best);
  const unsigned host =
      __reduce_min_sync(kAll, best == m ? static_cast<unsigned>(best_host) : UINT_MAX);
  return {m, static_cast<int>(host)};
}

template <int R>
__device__ __forceinline__ Pick pick_host(int policy, const int4* avail, int groups, int H,
                                          int need, int t, int salt, int lane) {
  switch (policy) {
    case kFirstFit: return pick_host<kFirstFit, R>(avail, groups, H, need, t, salt, lane);
    case kBestFit: return pick_host<kBestFit, R>(avail, groups, H, need, t, salt, lane);
    case kWorstFit: return pick_host<kWorstFit, R>(avail, groups, H, need, t, salt, lane);
    default: return pick_host<kRandomFit, R>(avail, groups, H, need, t, salt, lane);
  }
}

// R: rounds of 32 groups a lane scores at once, as few as cover the hosts
__device__ __forceinline__ Pick pick_host(int policy, const int4* avail, int groups, int H,
                                          int need, int t, int salt, int lane) {
  switch (min((groups + 31) / 32, kRounds)) {
    case 1: return pick_host<1>(policy, avail, groups, H, need, t, salt, lane);
    case 2: return pick_host<2>(policy, avail, groups, H, need, t, salt, lane);
    case 3: return pick_host<3>(policy, avail, groups, H, need, t, salt, lane);
    default: return pick_host<kRounds>(policy, avail, groups, H, need, t, salt, lane);
  }
}

__global__ void __launch_bounds__(32 * (kHelpers + 1)) des_place_kernel(PlaceArgs a) {
  extern __shared__ int4 smem[];
  __shared__ int s_pick[kMaxBackfill + 1];  // candidate d's host, or -1
  __shared__ int s_task[4];                 // bin, head (-1: done), skip mask, salt

  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = a.H, J = a.J, T = a.T, HP = pad_hosts(H), groups = HP / 4;
  const bool fail = a.fail_start != nullptr;
  const int policy = min(max(a.policy[s], 0), 3);
  const int depth = max(min(a.depth[s], a.max_backfill), 0);
  const int helpers = min(depth, kHelpers);
  const int team = 32 * (helpers + 1);  // threads at the named barriers

  int4* win = smem;                     // the job window
  int4* avail4 = win + kWindow;         // free cores, INT_MIN where no placement
  int4* free4 = avail4 + groups;        // free cores
  int4* rel4 = free4 + groups;          // the release row prefetched for the next bin
  int4* late4 = rel4 + groups;          // releases into that row made after its prefetch
  int4* fs4 = late4 + groups;           // failure window [fs, fe); masked: always
  int4* fe4 = fs4 + (fail ? groups : 0);
  unsigned char* flag = reinterpret_cast<unsigned char*>(fe4 + (fail ? groups : 0));
  int* avail = reinterpret_cast<int*>(avail4);
  int* free = reinterpret_cast<int*>(free4);
  int* late = reinterpret_cast<int*>(late4);
  const int* fs = reinterpret_cast<const int*>(fs4);
  const int* fe = reinterpret_cast<const int*>(fe4);

  if (warp > 0) {  // backfill candidates warp, warp + helpers, ...; or nothing
    if (warp > helpers) return;
    for (;;) {
      bar_sync(1, team);
      const int t = s_task[0], head = s_task[1], salt = s_task[3];
      const unsigned skip = static_cast<unsigned>(s_task[2]);
      if (head < 0) return;
      bool found = false;  // a later candidate of this warp cannot be first
      for (int d = warp; d <= depth; d += helpers) {
        int pick = -1;
        const int4 job = win[(head + d) & (kWindow - 1)];
        if (!found && !((skip >> d) & 1u) && job.x <= t) {
          const Pick p = pick_host(policy, avail4, groups, H, job.z, t, salt, lane);
          if (p.score >= 0) {
            pick = p.host;
            found = true;
          }
        }
        if (lane == 0) s_pick[d] = pick;
      }
      bar_sync(2, team);
    }
  }

  // warp 0: the lane's host rows (a padded host never takes a placement);
  // flag is the mask, or with failures (the mask folded into fs/fe) the
  // kill flag
  const long long ho = static_cast<long long>(s) * H;
  const unsigned char* mask = a.mask + ho;
  const int cph = a.cores_per_host[s];
  for (int h = lane; h < HP; h += 32) {
    const bool m = h < H && mask[h];
    free[h] = m ? cph : 0;
    avail[h] = m ? cph : INT_MIN;
    reinterpret_cast<int*>(rel4)[h] = 0;
    late[h] = 0;
    if (fail) {
      reinterpret_cast<int*>(fs4)[h] = m ? a.fail_start[ho + h] : INT_MIN;
      reinterpret_cast<int*>(fe4)[h] = m ? a.fail_end[ho + h] : INT_MAX;
      flag[h] = m && a.fail_kill[ho + h];
    } else {
      flag[h] = m;
    }
  }

  // the job window: jobs [hi - kWindow, hi) in the ring
  const int4* jobs = a.jobs + static_cast<long long>(s) * J;
  auto fill = [&](int lo) {  // jobs [lo, lo + kChunk) into their slots
    for (int i = lane; i < kChunk; i += 32) {
      const int j = lo + i;
      int4* slot = win + (j & (kWindow - 1));
      if (j < J) cp_async16(slot, jobs + j);
      else *slot = make_int4(kNever, 0, 0, 0);
    }
    cp_async_commit();
  };
  for (int lo = 0; lo < kWindow; lo += kChunk) fill(lo);
  int hi = kWindow;
  cp_async_wait<0>();
  __syncwarp();

  int* release = a.release + static_cast<long long>(s) * T * HP;
  int* job_start = a.job_start + static_cast<long long>(s) * J;
  int* job_host = a.job_host + static_cast<long long>(s) * J;
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(flag);
  int head = 0, attempts = 0;
  unsigned skip = 0u;  // bit d: job head + d started (backfilled)
  bool refilled = false;  // a window chunk was committed after the last row
  bool late_rows = false;  // this lane wrote to its late row in this bin
  for (int t = 0; t < T; ++t) {
    // 1) releases: row t (prefetched during bin t - 1) and the late row;
    //    avail from the online flags; then the prefetch of row t + 1
    if (refilled) cp_async_wait<1>();
    else cp_async_wait<0>();
    refilled = false;
    const int4* next_row = reinterpret_cast<const int4*>(release + static_cast<long long>(t + 1) * HP);
    for (int g = lane; g < groups; g += 32) {
      int4 f = free4[g];
      const int4 r = rel4[g];
      f.x += r.x;
      f.y += r.y;
      f.z += r.z;
      f.w += r.w;
      if (late_rows) {
        const int4 l = late4[g];
        f.x += l.x;
        f.y += l.y;
        f.z += l.z;
        f.w += l.w;
        late4[g] = make_int4(0, 0, 0, 0);
      }
      bool on[4];
      if (fail) {
        const int4 b = fs4[g], e = fe4[g];
        on[0] = !(b.x <= t && t < e.x);
        on[1] = !(b.y <= t && t < e.y);
        on[2] = !(b.z <= t && t < e.z);
        on[3] = !(b.w <= t && t < e.w);
      } else {
        const unsigned m = mask4[g];
#pragma unroll
        for (int i = 0; i < 4; ++i) on[i] = (m >> (8 * i)) & 0xffu;
      }
      free4[g] = f;
      avail4[g] = make_int4(on[0] ? f.x : INT_MIN, on[1] ? f.y : INT_MIN,
                            on[2] ? f.z : INT_MIN, on[3] ? f.w : INT_MIN);
      if (t + 1 < T) cp_async16(rel4 + g, next_row + g);
    }
    cp_async_commit();
    late_rows = false;

    // 2) placement: each attempt places one job or blocks the bin
    int placed = 0;
    int4 job = win[head & (kWindow - 1)];  // the head's fields
    bool go = a.max_starts > 0 && job.x <= t;
    while (go) {
      ++attempts;
      const int salt = placed;  // random fit's salt
      const Pick p = pick_host(policy, avail4, groups, H, job.z, t, salt, lane);
      int jid = -1, d_sel = 0, host = p.host;
      if (p.score >= 0) {
        jid = head;
      } else if (depth > 0) {
        if (lane == 0) {
          s_task[0] = t;
          s_task[1] = head;
          s_task[2] = static_cast<int>(skip);
          s_task[3] = salt;
        }
        bar_sync(1, team);  // the candidates' warps score
        bar_sync(2, team);  // their picks are in s_pick
        const int pick = lane >= 1 && lane <= depth ? s_pick[lane] : -1;
        const unsigned ok = __ballot_sync(kAll, pick >= 0);
        if (ok) {
          d_sel = __ffs(ok) - 1;
          host = __shfl_sync(kAll, pick, d_sel);
          jid = head + d_sel;
          job = win[jid & (kWindow - 1)];
        }
      }
      if (jid < 0) break;  // blocked

      // the placement, in every lane; the host's owner alone writes its
      // rows, the release and the schedule
      const bool owner = lane == ((host >> 2) & 31);
      const int need = job.z, left = free[host] - need;
      long long end = static_cast<long long>(t) + max(job.y, 1);
      if (fail && flag[host] && t < fs[host] && end > fs[host]) end = fe[host];
      const bool soon = end == t + 1 && end < T;  // into the prefetched row
      if (owner) {
        free[host] = left;
        avail[host] = left;
        job_start[jid] = t;
        job_host[jid] = host;
      }
      if (owner && soon) late[host] += need;
      if (owner && end > t + 1 && end < T) atomicAdd(release + end * HP + host, need);
      late_rows |= owner && soon;
      ++placed;
      if (jid == head) {  // past the head and any backfilled successors
        const unsigned rest = skip >> 1;
        const int run = __ffs(~rest) - 1;
        head += 1 + run;
        skip = rest >> run;
        if (head > hi - 2 * kChunk) {
          fill(hi);
          hi += kChunk;
          refilled = true;
          cp_async_wait<1>();  // every chunk but this one is in
          __syncwarp();
        }
      } else {
        skip |= 1u << d_sel;
      }
      job = win[head & (kWindow - 1)];
      go = placed < a.max_starts && job.x <= t;
    }
  }
  if (depth > 0) {
    if (lane == 0) s_task[1] = -1;
    bar_sync(1, team);
  }
  cp_async_wait<0>();
  if (lane == 0) a.attempts[s] = attempts;
}

// The barrier round trip of one attempt of the earlier block design,
// alone: thread 0 writes a shared word, a barrier, every thread reads it,
// a barrier; `rounds` times in one block of `warps` warps.
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

// One decision step alone, as an attempt's chain has it: a shared store,
// __syncwarp, a load and the two redux.sync of pick_host, `rounds` times
// in one warp, each step on the result of the one before.
__global__ void step_kernel(int rounds, int* out) {
  __shared__ int s_x;
  const unsigned lane = threadIdx.x;
  int acc = 0;
  for (int i = 0; i < rounds; ++i) {
    if (lane == 0) s_x = acc + i;
    __syncwarp();
    const int v = s_x + static_cast<int>(lane & 7u);
    const int m = __reduce_max_sync(kAll, v);
    acc = m + static_cast<int>(__reduce_min_sync(kAll, v == m ? lane : 32u));
  }
  if (lane == 0) out[0] = acc;
}

}  // namespace

extern "C" int des_place_launch(const PlaceArgs* args, void* stream) {
  const PlaceArgs& a = *args;
  if (a.S <= 0 || a.J <= 0 || a.H <= 0 || a.H > kMaxHosts || a.T < 0 ||
      a.max_starts < 0 || a.max_backfill < 0 || a.max_backfill > kMaxBackfill)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes(pad_hosts(a.H), a.fail_start != nullptr);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        des_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  des_place_kernel<<<a.S, 32 * (min(a.max_backfill, kHelpers) + 1), bytes,
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

extern "C" int des_place_step_launch(int rounds, int* out, void* stream) {
  if (rounds < 0) return static_cast<int>(cudaErrorInvalidValue);
  step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(rounds, out);
  return static_cast<int>(cudaGetLastError());
}
