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
// Bound on an H100 at Mamba2-370M's prefill shape (BC=64, Q=128, H=32,
// P=64, G=1, N=128): the least work, C B^T once per (chunk, group) over the
// causal triangle, is 6.70 GFLOP with the elementwise terms, against
// 210.8 MB of operands.  On the CUDA cores in f32 (67 TFLOP/s) that is
// 0.0999 ms, bound by operations; on this kernel's route, the TF32 tensor
// cores' 495 TFLOP/s over three passes (165 TFLOP/s), the operations take
// 0.0406 ms and the bytes 0.0629 ms: bound by bytes.
//
// What held the first design back: one block per (chunk, head) recomputed
// C B^T for every head although all heads of a group share it (14.0 GFLOP
// instead of 6.7), every product ran as 32-deep f32 fmaf chunks on the
// CUDA cores between two barriers, and 128 registers a thread left two
// blocks per SM: 18 TFLOP/s, 0.78 ms.
//
// This design:
//   - one block of 8 warps per (chunk, group, slice of up to 8 heads of
//     that group), so the grid fills the card (256 blocks for Mamba2-370M,
//     512 for Zamba2-1.2B) and C B^T is formed once per slice, not per head;
//   - the chunk is walked in 64-row tiles.  For row tile i the block forms
//     C_i B_j^T for every key tile j <= i (the causal tiles only) and keeps
//     them in shared memory; then for each head of the slice it applies the
//     decay exp(csum_i - csum_j) * dt_j where j <= i (the exponential is
//     evaluated only there) into an att tile and accumulates
//     y_i += att_ij @ x_j; y = acc + x * D is written once;
//   - the states, st = (x * w)^T B over all rows (w the end weights), per
//     head in 64-wide tiles of N;
//   - every product runs on the tensor cores as mma.sync.m16n8k8.tf32 with a
//     3xTF32 split: each operand a = a_hi + a_lo, both parts rounded to TF32
//     as cvt.rna.tf32.f32 rounds, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi
//     in f32 accumulation, about 2^-21 relative per product (one TF32 pass
//     misses the 1e-4 parity: tests/test_torch_kernel_precision.py);
//   - each warp owns a 16 x 32 patch of a 64 x 64 output tile; operands are
//     staged by cp.async in shared memory with padded rows (68 floats for
//     row-major A reads, 72 for [k][n] reads), conflict-free fragment loads,
//     and the next round's copies run during this round's products; on a
//     diagonal tile the k-steps past a warp's last row (att = 0) are skipped.
// The cumulative sum runs on one thread per head in row order, and every
// sum runs in a fixed order with no atomics: results are bitwise repeatable.
// The chunk length is capped by shared memory: a chunk longer than 448 rows
// (on an H100) runs with fewer heads per block, down to one, and
// ssd_chunk_max_q (576 on an H100) is the longest that fits then.
// `ssd_chunked` makes chunks of up to 2 ssd_chunk - 1 rows: 255 at the
// configs' 128, 511 at upstream Mamba2's 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kTile = 64;            // rows of a row / key tile, width of an output tile
constexpr int kK = 32;               // depth of a staged C / B chunk (C B^T)
constexpr int kMaxP = kTile;         // head dims the y tile covers
constexpr int kMaxHeads = 8;         // heads of a block's slice
constexpr int kLdRow = kTile + 4;    // [row][k] tiles: A reads conflict-free
constexpr int kLdCol = kTile + 8;    // [k][n] tiles: transposed reads conflict-free
constexpr int kLdK = kK + 4;         // staged C / B chunks, [row][k]
constexpr int kTileFloats = kTile * kLdCol;  // one 64-row tile buffer

// Shared memory: three tile buffers (att, xs, bs) and, per row tile of the
// chunk, one C B^T tile and the three [kTile] rows (dt, csum, end weights)
// of each head of the slice.  Copies run one round ahead of the products:
// x tiles alternate between xs and bs; C / B chunks between bs and xs; in
// the states phase (x, B) alternate between (xs, bs) and (att, cb[0]).
constexpr int kFixedFloats = 3 * kTileFloats;
static_assert(2 * kTile * kLdK <= kTileFloats, "C and B chunks fit one buffer");
static_assert(kTile * kLdRow <= kTileFloats, "row-major tiles fit one buffer");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows [row0, row0 + kTile) x columns [col0, col0 + W) of a row-major
// matrix with `rows` x `cols` entries and row stride `ld` into `dst` (row
// stride `lds`), zero outside the matrix.  `vec`: 16-byte copies (cols and
// ld multiples of 4, src 16-byte aligned).
template <int W>
__device__ __forceinline__ void stage(float* dst, int lds, const float* src,
                                      long long ld, int row0, int rows,
                                      int col0, int cols, bool vec, int tid) {
  if (vec) {
    constexpr int kPer = W / 4;
    for (int e = tid; e < kTile * kPer; e += kThreads) {
      const int r = e / kPer;
      const int c = (e - r * kPer) * 4;
      const bool ok = row0 + r < rows && col0 + c < cols;
      cp_async16(dst + r * lds + c, ok ? src + (row0 + r) * ld + col0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < kTile * W; e += kThreads) {
      const int r = e / W;
      const int c = e - r * W;
      const bool ok = row0 + r < rows && col0 + c < cols;
      cp_async4(dst + r * lds + c, ok ? src + (row0 + r) * ld + col0 + c : src, ok);
    }
  }
}

// `a` rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest on the 13
// low mantissa bits, ties away from zero; the same bits for every finite
// value), as an integer add and mask, which issues faster than the
// conversion instruction: each operand element is rounded once per warp
// that reads it
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 x 32 patch: acc[nb] += A (16 x 8 ksteps) * B (8 ksteps x 32),
// 3xTF32.  a_at(r, k) and b_at(k, n) read the operands, relative to the
// patch; g / tig are the lane's group and thread within the group.
template <typename FA, typename FB>
__device__ __forceinline__ void mma3(float (&acc)[4][4], int ksteps, FA a_at,
                                     FB b_at, int g, int tig) {
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 8 + tig;
    uint32_t ah[4], al[4];
    split_tf32(a_at(g, k), ah[0], al[0]);
    split_tf32(a_at(g + 8, k), ah[1], al[1]);
    split_tf32(a_at(g, k + 4), ah[2], al[2]);
    split_tf32(a_at(g + 8, k + 4), ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b_at(k, nb * 8 + g), bh0, bl0);
      split_tf32(b_at(k + 4, nb * 8 + g), bh1, bl1);
      mma_tf32(acc[nb], al, bh0, bh1);
      mma_tf32(acc[nb], ah, bl0, bl1);
      mma_tf32(acc[nb], ah, bh0, bh1);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ d_skip,
                 float* __restrict__ y, float* __restrict__ st, int H, int Q,
                 int P, int G, int N, int HS, int vec_x, int vec_bc) {
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int qp = n_tiles * kTile;
  extern __shared__ __align__(16) float smem[];
  float* att = smem;                                // [kTile][kLdRow]
  float* xs = att + kTileFloats;                    // [kTile][kLdCol]
  float* bs = xs + kTileFloats;                     // [kTile][kLdCol]
  float* cb = bs + kTileFloats;                     // [n_tiles][kTile][kLdRow]
  float* dtv = cb + n_tiles * kTileFloats;          // [HS][qp]
  float* csum = dtv + HS * qp;                      // [HS][qp]
  float* wend = csum + HS * qp;                     // [HS][qp]

  const int hpg = H / G;
  const int slices = hpg / HS;
  const int bc = blockIdx.x / (G * slices);
  const int rem = blockIdx.x - bc * G * slices;
  const int grp = rem / slices;
  const int h0 = grp * hpg + (rem - grp * slices) * HS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wr = (warp & 3) * 16;                   // the warp's patch: rows
  const int wc = (warp >> 2) * 32;                  // and columns

  const long long xrow = static_cast<long long>(H) * P;   // row stride of x, y
  const long long brow = static_cast<long long>(G) * N;   // row stride of b, c
  const float* xc = x + static_cast<long long>(bc) * Q * xrow;
  float* yc = y + static_cast<long long>(bc) * Q * xrow;
  const float* bb = b + static_cast<long long>(bc) * Q * brow + static_cast<long long>(grp) * N;
  const float* cc = c + static_cast<long long>(bc) * Q * brow + static_cast<long long>(grp) * N;
  const float* dtc = dt + static_cast<long long>(bc) * Q * H;

  // dt, da and the cumulative sum (one thread per head, row order), end weights
  for (int e = tid; e < HS * qp; e += kThreads) {
    const int s = e / qp;
    const int q = e - s * qp;
    const float dq = q < Q ? dtc[static_cast<long long>(q) * H + h0 + s] : 0.0f;
    dtv[e] = dq;
    csum[e] = dq * -expf(a_log[h0 + s]);
  }
  __syncthreads();
  if (tid < HS) {
    float* cs = csum + tid * qp;
    float acc = 0.0f;
    for (int q = 0; q < Q; ++q) {
      acc = acc + cs[q];
      cs[q] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < HS * qp; e += kThreads) {
    const int s = e / qp;
    const int q = e - s * qp;
    wend[e] = q < Q ? expf(csum[s * qp + Q - 1] - csum[e]) * dtv[e] : 0.0f;
  }

  // Each phase below is a sequence of rounds: wait for round r's copies,
  // barrier (round r-1's products are done with the other buffer), start
  // round r+1's copies into it, then round r's products.
  float acc[4][4];
  const int n_chunks = (N + kK - 1) / kK;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;

    // C_i B_j^T for the causal key tiles j <= i, once for the slice
    {
      const auto buf = [&](int r) { return (r & 1) ? xs : bs; };
      const auto load = [&](int r) {
        const int jt = r / n_chunks;
        const int n0 = (r - jt * n_chunks) * kK;
        float* cst = buf(r);
        stage<kK>(cst, kLdK, cc, brow, i0, Q, n0, N, vec_bc, tid);
        stage<kK>(cst + kTile * kLdK, kLdK, bb, brow, jt * kTile, Q, n0, N, vec_bc, tid);
        cp_async_commit();
      };
      const int rounds = (it + 1) * n_chunks;
      __syncthreads();                              // the previous phase is done
      load(0);
      for (int r = 0; r < rounds; ++r) {
        const int jt = r / n_chunks;
        const int nc = r - jt * n_chunks;
        if (nc == 0) zero(acc);
        cp_async_wait_all();
        __syncthreads();
        if (r + 1 < rounds) load(r + 1);
        const float* cst = buf(r);
        const float* bst = cst + kTile * kLdK;
        mma3(acc, kK / 8, [&](int rr, int k) { return cst[(wr + rr) * kLdK + k]; },
             [&](int k, int n) { return bst[(wc + n) * kLdK + k]; }, g, tig);
        if (nc == n_chunks - 1) {
          float* out = cb + jt * kTileFloats;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int col = wc + nb * 8 + 2 * tig;
            out[(wr + g) * kLdRow + col] = acc[nb][0];
            out[(wr + g) * kLdRow + col + 1] = acc[nb][1];
            out[(wr + g + 8) * kLdRow + col] = acc[nb][2];
            out[(wr + g + 8) * kLdRow + col + 1] = acc[nb][3];
          }
        }
      }
    }

    // y_i = sum_j att_ij @ x_j + D * x_i, head by head (j = i last: x_i
    // is the last tile staged)
    {
      const auto buf = [&](int r) { return (r & 1) ? bs : xs; };
      const int per = it + 1;
      const auto load = [&](int r) {
        const int s = r / per;
        stage<kTile>(buf(r), kLdCol, xc + static_cast<long long>(h0 + s) * P,
                     xrow, (r - s * per) * kTile, Q, 0, P, vec_x, tid);
        cp_async_commit();
      };
      const int rounds = HS * per;
      __syncthreads();                              // C B^T phase done with xs, bs
      load(0);
      for (int r = 0; r < rounds; ++r) {
        const int s = r / per;
        const int jt = r - s * per;
        const int j0 = jt * kTile;
        const float* cs = csum + s * qp;
        const float* dv = dtv + s * qp;
        if (jt == 0) zero(acc);
        cp_async_wait_all();
        __syncthreads();                            // att and the other buffer are free
        if (r + 1 < rounds) load(r + 1);
        const float* cbt = cb + jt * kTileFloats;
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int i = e >> 6;
          const int j = e & (kTile - 1);
          const int gi = i0 + i;
          const int gj = j0 + j;
          float v = 0.0f;
          if (gj <= gi && gi < Q) v = cbt[i * kLdRow + j] * expf(cs[gi] - cs[gj]) * dv[gj];
          att[i * kLdRow + j] = v;
        }
        __syncthreads();
        // on the diagonal tile att is 0 past the warp's last row: skip those k-steps
        const float* xt = buf(r);
        mma3(acc, jt == it ? wr / 8 + 2 : kTile / 8,
             [&](int rr, int k) { return att[(wr + rr) * kLdRow + k]; },
             [&](int k, int n) { return xt[k * kLdCol + wc + n]; }, g, tig);
        if (jt == it) {
          const int h = h0 + s;
          const float dsk = d_skip[h];
          float* yrow = yc + static_cast<long long>(h) * P;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; e += 2) {            // (p, p + 1) in one store
              const int rr = wr + g + 8 * (e >> 1);
              const int p = wc + nb * 8 + 2 * tig;
              if (i0 + rr >= Q || p >= P) continue;
              float* out = yrow + (i0 + rr) * xrow + p;
              const float y0 = acc[nb][e] + xt[rr * kLdCol + p] * dsk;
              const float y1 = acc[nb][e + 1] + xt[rr * kLdCol + p + 1] * dsk;
              if (P % 2 == 0) {
                *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
              } else {
                out[0] = y0;
                if (p + 1 < P) out[1] = y1;
              }
            }
          }
        }
      }
    }
  }

  // chunk-end states: st = (x * w)^T B, one 64-wide tile of N at a time
  {
    const auto xbuf = [&](int r) { return (r & 1) ? att : xs; };
    const auto bbuf = [&](int r) { return (r & 1) ? cb : bs; };
    const int nt = (N + kTile - 1) / kTile;
    const int per = nt * n_tiles;
    const auto load = [&](int r) {
      const int s = r / per;
      const int rest = r - s * per;
      const int n0 = rest / n_tiles * kTile;
      const int j0 = (rest % n_tiles) * kTile;
      stage<kTile>(xbuf(r), kLdCol, xc + static_cast<long long>(h0 + s) * P,
                   xrow, j0, Q, 0, P, vec_x, tid);
      stage<kTile>(bbuf(r), kLdCol, bb, brow, j0, Q, n0, N, vec_bc, tid);
      cp_async_commit();
    };
    const int rounds = HS * per;
    __syncthreads();                                // the y phase is done with every buffer
    load(0);
    for (int r = 0; r < rounds; ++r) {
      const int s = r / per;
      const int rest = r - s * per;
      const int n0 = rest / n_tiles * kTile;
      const int jt = rest % n_tiles;
      const int j0 = jt * kTile;
      if (jt == 0) zero(acc);
      cp_async_wait_all();
      __syncthreads();
      if (r + 1 < rounds) load(r + 1);
      const float* xt = xbuf(r);
      const float* bt = bbuf(r);
      const float* w = wend + s * qp + j0;
      mma3(acc, kTile / 8, [&](int rr, int k) { return xt[k * kLdCol + wr + rr] * w[k]; },
           [&](int k, int n) { return bt[k * kLdCol + wc + n]; }, g, tig);
      if (jt == n_tiles - 1) {
        float* sth = st + (static_cast<long long>(bc) * H + h0 + s) * P * N;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {              // (n, n + 1) in one store
            const int p = wr + g + 8 * (e >> 1);
            const int n = n0 + wc + nb * 8 + 2 * tig;
            if (p >= P || n >= N) continue;
            float* out = sth + static_cast<long long>(p) * N + n;
            if (N % 2 == 0) {
              *reinterpret_cast<float2*>(out) = make_float2(acc[nb][e], acc[nb][e + 1]);
            } else {
              out[0] = acc[nb][e];
              if (n + 1 < N) out[1] = acc[nb][e + 1];
            }
          }
        }
      }
    }
  }
}

size_t smem_bytes(int Q, int HS) {
  const size_t tiles = static_cast<size_t>((Q + kTile - 1) / kTile);
  return (kFixedFloats + tiles * kTileFloats + 3 * HS * tiles * kTile) * sizeof(float);
}

// the block's opt-in shared memory on the current device, or a negated
// CUDA error code
int smem_optin() {
  int device = 0;
  int smem = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? smem : -static_cast<int>(e);
}

}  // namespace

// The largest head dim and chunk length the kernel takes on `device`: the
// chunk's C B^T row tiles and the per-head rows of a one-head slice beside
// the fixed part must fit the block's opt-in shared memory.  A negative
// value is a CUDA error code, negated.
extern "C" int ssd_chunk_max_p() { return kMaxP; }

extern "C" int ssd_chunk_max_q(int device) {
  int smem = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return (smem / static_cast<int>(sizeof(float)) - kFixedFloats) /
         (kTileFloats + 3 * kTile) * kTile;
}

extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* a_log, const float* b,
                                const float* c, const float* d_skip, float* y,
                                float* st, int BC, int Q, int H, int P, int G,
                                int N, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || P > kMaxP || G <= 0 ||
      H % G != 0 || N <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int optin = smem_optin();
  if (optin < 0) return -optin;
  // the largest slice that divides a group's heads and fits shared memory
  int HS = kMaxHeads;
  while (HS > 1 && ((H / G) % HS != 0 || smem_bytes(Q, HS) > static_cast<size_t>(optin)))
    --HS;
  if (smem_bytes(Q, HS) > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(BC) * (H / HS);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = P % 4 == 0 && aligned(x);
  const int vec_bc = N % 4 == 0 && aligned(b) && aligned(c);
  const size_t smem = smem_bytes(Q, HS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, dt, a_log, b, c, d_skip, y, st, H, Q, P, G, N, HS, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}
