// Causal GQA flash-attention forward (online softmax, f32 m/l/acc),
// hand-written for Hopper (sm_90a).  Replaces
// src/repro/kernels/flash_attention.py:95 (flash_attention_pallas, body
// _kernel).
//
// Layout: q [B, Hq, Sq, D], k [B, Hkv, Skv, D], v [B, Hkv, Skv, Dv], out
// [B, Hq, Sq, Dv] in q's dtype, all contiguous.  The QK head dim D and the
// V head dim Dv are separate template parameters (MLA: D = qk_nope +
// qk_rope, Dv = v_head_dim); the exact pairs instantiated are (16, 16),
// (32, 32), (64, 64), (128, 128), (80, 80), (96, 64) and (192, 128).  Any
// other pair with 1 <= D, Dv <= 256 runs padded: the instantiation (Dp,
// Dvp) of least Dp + Dvp with Dp >= D and Dvp >= Dv, (256, 256) the last,
// with kRagged set and the true widths as arguments (see "Padded pairs"
// below).  Query head hq
// reads KV head hq / (Hq / Hkv) in place.  As in the TPU kernel: a key is
// masked with -1e30 when it lies past the diagonal (offset Skv - Sq) or
// past Skv (the ragged tile), KV tiles strictly above the diagonal are
// skipped, the output is acc / max(l, 1e-30), and rows that see no key at
// all are left undefined.
// Where the caller passes an lse buffer ([B, Hq, Sq] f32), each row also
// writes its log-sum-exp m + log(max(l, 1e-30)) once, after its last KV
// tile, from the f32 statistics, in natural-log units of the scaled
// logits (the JAX package's _flash_fwd_scan, which the backward reads).
// Both routes sum in a fixed order with no atomics: bitwise repeatable.
//
// Bound on an H100 at SmolLM-360M's prefill shape (B=4, Hq=15, Hkv=5,
// S=2048, D=64, causal): operations, 32.2 GFLOP over the causal half,
// 0.0326 ms at 989 TFLOP/s bf16 against 25 MB of q/k/v/o.
//
// Head dims 80, 96 and 192 (StableLM-3B; the MLA of MiniCPM3-4B and
// DeepSeek-V2-Lite, whose V is 64 and 128 wide) take the same code: K and V
// are staged with rows of their own widths, and the bf16 route keeps Q's
// D/16 k-step fragments and O's Dv/8 accumulator blocks in registers (12
// and 16 at (192, 128)).  Its shared memory, (64 + 2 * 64) (D + 8) +
// 2 * 64 (Dv + 8) bf16, is 109 KB at (192, 128), the f32 route's
// 64 (D + Dv) floats 80 KB: both are opted in above 48 KB (set_smem).
//
// Padded pairs (kRagged): the tiles keep the instantiation's widths Dp and
// Dvp in shared memory and registers, and the kernel takes the true d and
// dv.  Rows are read d (dv) elements apart; Q and K columns d..Dp-1 and V
// columns dv..Dvp-1 are exact zeros in shared memory (a padded column then
// adds 0 to every score: never garbage times zero, which can be NaN), and
// only the first dv output columns are stored.  The lse is the exact
// pair's.  A row of d bf16 values need not start on 16 bytes (d = 20: 40-
// byte rows), so the bf16 route copies in chunks of 8, 4 or 2 elements by
// cp.async, or 1 by a load and a store, the largest that divides d and the
// operand's alignment (vec_for); it stores pairs of outputs where dv is
// even, single ones where it is odd.  The f32 route masks its scalar q
// loads and its staged K/V at d and dv.  A padded pair issues the products
// of (Dp, Dvp), more than flash_attention_flops counts for (d, dv).  At
// (256, 256) the bf16 route's shared memory is 165 KB, the f32 route's
// 128 KB.  The exact pairs' code is the kRagged = false instantiation,
// unchanged.
//
// Two routes, chosen by dtype:
//
// bfloat16 (every prefill): the tensor cores.  The first design staged
// K/V as f32 and let two threads per query row form scalar fmaf dot
// products on the CUDA cores (21 TFLOP/s; even the 67 TFLOP/s f32 peak
// would take 0.48 ms).  Now one block of 4 warps per (64-row query tile,
// query head, batch row), longest causal rows first; each warp owns 16
// query rows.  K and V tiles of 64 keys stay bf16 in shared memory (rows
// padded by 16 bytes against bank conflicts), in a ring of two stages
// filled by cp.async, so tile t+1 loads while tile t is multiplied.
// S = Q K^T is mma.sync.m16n8k16 bf16 with f32 accumulation, K read with
// ldmatrix and Q's fragments held in registers for the whole KV loop.  The
// online softmax runs on the accumulator fragments (row max over the 4
// threads of a quad by shuffles; f32 m, l and O); P is rounded to bf16 in
// registers and is P V's A operand as it lies (the m16n8k16 accumulator
// layout is its A layout), V read with ldmatrix.trans.  Only tiles that
// cross the diagonal or the ragged end at Skv take the mask.  Numerics
// against the TPU kernel (f32 after the cast): P is rounded to bf16 before
// P V; the scale, times log2(e), multiplies S in f32 (not q) and the
// exponentials are exp2; the sums run in another order.
//
// float32 (the card-vs-CPU checks, held at 1e-4): the CUDA cores, as first
// written.  One block of 128 threads per 64-row query tile, two threads per
// query row, each owning every other float4 chunk of the row's scaled q and
// f32 accumulator; 64-key K/V tiles staged in shared memory; m and l
// updated every 16 keys; the two threads of a row add their half dot
// products with one shuffle (a + b on both: the same bits).  The products
// are explicit fmaf: the library builds with -fmad=false, which still
// keeps those fused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- float32

constexpr int kQTile = 64;
constexpr int kKTile = 64;
constexpr int kSub = 16;                 // keys per online-softmax update
constexpr int kThreads = 2 * kQTile;     // two threads per query row

template <int D, int Dv, bool kRagged>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 int causal, float scale, int dq, int dvq) {
  // the operands' row lengths: the template widths, or the true ones
  const int wq = kRagged ? dq : D;
  const int wv = kRagged ? dvq : Dv;
  constexpr int kChunks = D / 8;         // float4 chunks of a thread's half of q
  constexpr int kVChunks = Dv / 8;       // ... and of its accumulator
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [kKTile][D]
  float* vs = ks + kKTile * D;                   // [kKTile][Dv]

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest causal rows first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int q0 = qt * kQTile;
  const int qi = q0 + (tid >> 1);
  const int diag = Skv - Sq;

  const long long q_base = (static_cast<long long>(b) * Hq + hq) * Sq * wq;
  const long long o_base = (static_cast<long long>(b) * Hq + hq) * Sq * wv;
  const long long k_base = (static_cast<long long>(b) * Hkv + hkv) * Skv * wq;
  const long long v_base = (static_cast<long long>(b) * Hkv + hkv) * Skv * wv;

  float qr[D / 2];
  float acc[Dv / 2];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (2 * c + half) * 4 + e;
      qr[4 * c + e] = qi < Sq && (!kRagged || d < wq)
                          ? q[q_base + static_cast<long long>(qi) * wq + d] * scale
                          : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < Dv / 2; ++i) acc[i] = 0.0f;
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
    if constexpr (kRagged) {
      // rows wq (wv) apart; columns past them exact zeros
      for (int idx = tid; idx < kKTile * D; idx += kThreads) {
        const int r = idx / D;
        const int c = idx - r * D;
        const bool ok = k0 + r < Skv && c < wq;
        ks[idx] = ok ? k[k_base + static_cast<long long>(k0 + r) * wq + c] : 0.0f;
      }
      for (int idx = tid; idx < kKTile * Dv; idx += kThreads) {
        const int r = idx / Dv;
        const int c = idx - r * Dv;
        const bool ok = k0 + r < Skv && c < wv;
        vs[idx] = ok ? v[v_base + static_cast<long long>(k0 + r) * wv + c] : 0.0f;
      }
    } else {
      for (int idx = tid; idx < kKTile * D; idx += kThreads) {
        const bool ok = k0 + idx / D < Skv;
        ks[idx] = ok ? k[k_base + static_cast<long long>(k0) * D + idx] : 0.0f;
      }
      for (int idx = tid; idx < kKTile * Dv; idx += kThreads) {
        const bool ok = k0 + idx / Dv < Skv;
        vs[idx] = ok ? v[v_base + static_cast<long long>(k0) * Dv + idx] : 0.0f;
      }
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
      for (int i = 0; i < Dv / 2; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + jj) * Dv);
        const float p = s[jj];
#pragma unroll
        for (int c = 0; c < kVChunks; ++c) {
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
  if (lse != nullptr && half == 0)
    lse[(static_cast<long long>(b) * Hq + hq) * Sq + qi] = m + logf(lc);
  float* orow = o + o_base + static_cast<long long>(qi) * wv;
#pragma unroll
  for (int c = 0; c < kVChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = (2 * c + half) * 4 + e;
      if (!kRagged || col < wv) orow[col] = acc[4 * c + e] / lc;
    }
  }
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;       // query rows of a block
constexpr int kKeys = 64;                // keys of a K/V tile
constexpr int kTcThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 or 8 bytes global -> shared (cp.async.ca: .cg takes only 16),
// zero-filled when !ok
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + R) of a bf16 matrix whose rows lie G elements apart
// (its own width W: G = W) into shared memory with row stride W + 8; rows at
// or past `valid` are zero-filled
template <int W, int G, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int valid, int tid) {
  constexpr int kLd = W + 8;
  constexpr int kPer = W / 8;            // 16-byte chunks of a row
  for (int idx = tid; idx < R * kPer; idx += kTcThreads) {
    const int r = idx / kPer;
    const int c = idx - r * kPer;
    const bool ok = row0 + r < valid;
    const bf16* g = ok ? src + static_cast<long long>(row0 + r) * G + c * 8 : src;
    cp_async16(smem_addr(dst + r * kLd + c * 8), g, ok);
  }
}

// rows [row0, row0 + R) of a bf16 matrix of w <= W columns, rows w elements
// apart, into shared memory with row stride W + 8: columns at or past w
// and rows at or past `valid` are exact zeros.  kVec elements a copy: 8, 4
// or 2 by cp.async, 1 by a load and a store (vec_for: kVec divides w and
// the source's alignment, so a copy lies wholly inside or past a row)
template <int W, int R, int kVec>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0,
                                          int valid, int w, int tid) {
  constexpr int kLd = W + 8;
  constexpr int kPer = W / kVec;         // copies of a row
  for (int idx = tid; idx < R * kPer; idx += kTcThreads) {
    const int r = idx / kPer;
    const int c = (idx - r * kPer) * kVec;
    const bool ok = row0 + r < valid && c < w;
    const bf16* g = ok ? src + static_cast<long long>(row0 + r) * w + c : src;
    if constexpr (kVec == 1) {
      dst[r * kLd + c] = ok ? *g : __float2bfloat16(0.0f);
    } else {
      const uint32_t s = smem_addr(dst + r * kLd + c);
      if constexpr (kVec == 8) {
        cp_async16(s, g, ok);
      } else {
        cp_async_ca<2 * kVec>(s, g, ok);
      }
    }
  }
}

// load_rows at the copy width vec (8, 4, 2 or 1) vec_for gave
template <int W, int R>
__device__ __forceinline__ void load_tile_ragged(bf16* dst, const bf16* src,
                                                 int row0, int valid, int w,
                                                 int vec, int tid) {
  if (vec == 8) {
    load_rows<W, R, 8>(dst, src, row0, valid, w, tid);
  } else if (vec == 4) {
    load_rows<W, R, 4>(dst, src, row0, valid, w, tid);
  } else if (vec == 2) {
    load_rows<W, R, 2>(dst, src, row0, valid, w, tid);
  } else {
    load_rows<W, R, 1>(dst, src, row0, valid, w, tid);
  }
}

// the copy width vec of load_tile_ragged for rows of w bf16 values from p
__host__ int vec_for(const void* p, int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int vec = 8; vec > 1; vec /= 2)
    if (w % vec == 0 && a % (2 * vec) == 0) return vec;
  return 1;
}

// the copy widths of q, k and v, 4 bits each
__host__ int pack_vecs(const void* q, const void* k, const void* v, int d, int dv) {
  return vec_for(q, d) | vec_for(k, d) << 4 | vec_for(v, dv) << 8;
}

template <int D, int Dv, bool kRagged>
__global__ void __launch_bounds__(kTcThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                  int causal, float scale_log2, int dq, int dvq, int vecs) {
  // the operands' row lengths: the template widths, or the true ones
  const int wq = kRagged ? dq : D;
  const int wv = kRagged ? dvq : Dv;
  constexpr int kLd = D + 8;             // padded rows: ldmatrix conflict-free
  constexpr int kLdv = Dv + 8;
  constexpr int kDSteps = D / 16;        // k-steps of Q K^T
  constexpr int kSBlocks = kKeys / 8;    // n-blocks of S
  constexpr int kOBlocks = Dv / 8;       // n-blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kLd]
  bf16* ks = qs + kRows * kLd;                   // [2][kKeys][kLd]
  bf16* vs = ks + 2 * kKeys * kLd;               // [2][kKeys][kLdv]

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest causal rows first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                       // row within an 8-row group
  const int tig = lane & 3;                      // thread within the quad
  const int q0 = qt * kRows;
  const int diag = Skv - Sq;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const bf16* qb = q + (static_cast<long long>(b) * Hq + hq) * Sq * wq;
  const bf16* kb = k + (static_cast<long long>(b) * Hkv + hkv) * Skv * wq;
  const bf16* vb = v + (static_cast<long long>(b) * Hkv + hkv) * Skv * wv;
  // a padded pair's copy widths of q, k and v (pack_vecs)
  [[maybe_unused]] const int vq = vecs & 15, vk = (vecs >> 4) & 15, vv = vecs >> 8;

  int kv_tiles = (Skv + kKeys - 1) / kKeys;
  if (causal) {
    const int last = q0 + kRows - 1 + diag;      // the tile's last row, on the kv axis
    kv_tiles = min(kv_tiles, last < 0 ? 0 : last / kKeys + 1);
  }

  if constexpr (!kRagged) {
    load_tile<D, D, kRows>(qs, qb, q0, Sq, tid);
    if (kv_tiles > 0) {
      load_tile<D, D, kKeys>(ks, kb, 0, Skv, tid);
      load_tile<Dv, Dv, kKeys>(vs, vb, 0, Skv, tid);
    }
  } else {
    load_tile_ragged<D, kRows>(qs, qb, q0, Sq, wq, vq, tid);
    if (kv_tiles > 0) {
      load_tile_ragged<D, kKeys>(ks, kb, 0, Skv, wq, vk, tid);
      load_tile_ragged<Dv, kKeys>(vs, vb, 0, Skv, wv, vv, tid);
    }
  }
  cp_async_commit();

  uint32_t qf[kDSteps][4];
  float oacc[kOBlocks][4];
#pragma unroll
  for (int j = 0; j < kOBlocks; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < kv_tiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();                     // tile kt landed; tile kt-1 consumed
    if (kt == 0) {
#pragma unroll
      for (int ds = 0; ds < kDSteps; ++ds) {
        const int r = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldsm_x4(qf[ds], smem_addr(qs + r * kLd + ds * 16 + 8 * (lane >> 4)));
      }
    }
    if (kt + 1 < kv_tiles) {
      const int nxt = (kt + 1) & 1;
      if constexpr (!kRagged) {
        load_tile<D, D, kKeys>(ks + nxt * kKeys * kLd, kb, (kt + 1) * kKeys, Skv, tid);
        load_tile<Dv, Dv, kKeys>(vs + nxt * kKeys * kLdv, vb, (kt + 1) * kKeys, Skv, tid);
      } else {
        load_tile_ragged<D, kKeys>(ks + nxt * kKeys * kLd, kb, (kt + 1) * kKeys, Skv,
                                   wq, vk, tid);
        load_tile_ragged<Dv, kKeys>(vs + nxt * kKeys * kLdv, vb, (kt + 1) * kKeys, Skv,
                                    wv, vv, tid);
      }
    }
    cp_async_commit();
    const bf16* kst = ks + (kt & 1) * kKeys * kLd;
    const bf16* vst = vs + (kt & 1) * kKeys * kLdv;

    // S = Q K^T on the tensor cores
    float s[kSBlocks][4];
#pragma unroll
    for (int j = 0; j < kSBlocks; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int ds = 0; ds < kDSteps; ++ds) {
#pragma unroll
      for (int j2 = 0; j2 < kSBlocks / 2; ++j2) {
        uint32_t kf[4];
        const int key = j2 * 16 + (lane & 7) + 8 * (lane >> 4);
        ldsm_x4(kf, smem_addr(kst + key * kLd + ds * 16 + 8 * ((lane >> 3) & 1)));
        mma_bf16(s[2 * j2], qf[ds], kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], qf[ds], kf[2], kf[3]);
      }
    }

    // scale, mask (only tiles crossing the diagonal or the ragged end)
    const int k0 = kt * kKeys;
    const bool masked =
        k0 + kKeys > Skv || (causal && k0 + kKeys - 1 > q0 + diag);
#pragma unroll
    for (int j = 0; j < kSBlocks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + j * 8 + 2 * tig + (e & 1);
          const bool live = key < Skv && (!causal || rows[e >> 1] + diag >= key);
          x = live ? x : kNegInf;
        }
        s[j][e] = x;
      }
    }

    // online softmax on the fragments: a row lives in the 4 threads of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSBlocks; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kSBlocks; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
        psum += s[j][2 * r];
        psum += s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int j = 0; j < kOBlocks; ++j) {
        oacc[j][2 * r] *= alpha;
        oacc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P (bf16) from registers as the A operand, V via ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j2 = 0; j2 < kOBlocks / 2; ++j2) {
        uint32_t vf[4];
        const int key = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldsm_x4_t(vf, smem_addr(vst + key * kLdv + j2 * 16 + 8 * (lane >> 4)));
        mma_bf16(oacc[2 * j2], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * j2 + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait_all();                   // no copy outlives the block

  // the row sums over the quad (a + b on both lanes: the same bits), then out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    // m is in log2 units of the scaled logits (scale * log2(e) multiplies S)
    if (lse != nullptr && tig == 0)
      lse[(static_cast<long long>(b) * Hq + hq) * Sq + rows[r]] =
          m[r] * 0.6931471805599453f + logf(lc);
    bf16* orow = o + (static_cast<long long>(b) * Hq + hq) * Sq * wv +
                 static_cast<long long>(rows[r]) * wv;
    if constexpr (!kRagged) {
#pragma unroll
      for (int j = 0; j < kOBlocks; ++j) {
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tig) =
            pack_bf16(oacc[j][2 * r] / lc, oacc[j][2 * r + 1] / lc);
      }
    } else {
      // the first wv columns: pairs where wv is even (4-byte aligned, as
      // o is), else one value at a time
#pragma unroll
      for (int j = 0; j < kOBlocks; ++j) {
        const int c = j * 8 + 2 * tig;
        const float lo = oacc[j][2 * r] / lc;
        const float hi = oacc[j][2 * r + 1] / lc;
        if ((wv & 1) == 0) {
          if (c < wv) *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(lo, hi);
        } else {
          if (c < wv) orow[c] = __float2bfloat16_rn(lo);
          if (c + 1 < wv) orow[c + 1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int D, int Dv, bool kRagged>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, int Hq, int Hkv, int Sq, int Skv, int d, int dv, int causal,
               float scale, cudaStream_t stream) {
  const int smem = kKTile * (D + Dv) * static_cast<int>(sizeof(float));
  auto kernel = flash_f32_kernel<D, Dv, kRagged>;
  if (const int e = set_smem(kernel, smem)) return e;
  const dim3 grid((Sq + kQTile - 1) / kQTile, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hkv, Sq,
      Skv, causal, scale, d, dv);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int Dv, bool kRagged>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                int B, int Hq, int Hkv, int Sq, int Skv, int d, int dv, int causal,
                float scale, cudaStream_t stream) {
  // an exact pair moves 16-byte chunks: every operand must start 16-byte
  // aligned; a padded one picks its copy widths from the inputs' alignment
  // (pack_vecs) and stores output pairs on 4 bytes
  const uintptr_t in = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  const uintptr_t out = reinterpret_cast<uintptr_t>(o);
  if (kRagged ? out % 4 != 0 : (in | out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // Q tile, two K stages, two V stages; 109 KB at (192, 128), 165 KB at
  // (256, 256), opted in
  const int smem = ((kRows + 2 * kKeys) * (D + 8) + 2 * kKeys * (Dv + 8)) *
                   static_cast<int>(sizeof(bf16));
  auto kernel = flash_bf16_kernel<D, Dv, kRagged>;
  if (const int e = set_smem(kernel, smem)) return e;
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Hq, Hkv, Sq,
      Skv, causal, scale_log2, d, dv, kRagged ? pack_vecs(q, k, v, d, dv) : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int Dv, bool kRagged>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int d, int dv,
           int causal, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D, Dv, kRagged>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, d, dv,
                                      causal, scale, stream);
  if (dtype == 1)
    return launch_bf16<D, Dv, kRagged>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, d, dv,
                                       causal, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// D: the QK head dim, Dv: the V head dim, each 1..256.  An exact pair
// (FLASH_PAIR) runs its own instantiation; any other runs padded, on the
// first FLASH_PADDED pair that holds it: they are in order of Dp + Dvp
// (then Dp), so it is the one of least Dp + Dvp (the wrapper's
// instantiation_for states the same order).  dtype: 0 = float32, 1 =
// bfloat16.  lse: a [B, Hq, Sq] f32 buffer for the rows' log-sum-exp, or
// null for none.  Returns the launch's CUDA error code
// (cudaErrorInvalidValue for a head dim outside 1..256).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Hq, int Hkv, int Sq, int Skv,
                                      int D, int Dv, int dtype, int causal,
                                      float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hkv != 0 ||
      D <= 0 || Dv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FLASH_PAIR(DQK, DV)                                                    \
  if (D == DQK && Dv == DV)                                                    \
    return launch<DQK, DV, false>(dtype, q, k, v, o, l, B, Hq, Hkv, Sq, Skv, D, \
                                  Dv, causal, scale, st);
  FLASH_PAIR(16, 16)
  FLASH_PAIR(32, 32)
  FLASH_PAIR(64, 64)
  FLASH_PAIR(128, 128)
  FLASH_PAIR(80, 80)
  FLASH_PAIR(96, 64)
  FLASH_PAIR(192, 128)
#undef FLASH_PAIR
#define FLASH_PADDED(DQK, DV)                                                 \
  if (D <= DQK && Dv <= DV)                                                   \
    return launch<DQK, DV, true>(dtype, q, k, v, o, l, B, Hq, Hkv, Sq, Skv, D, \
                                 Dv, causal, scale, st);
  FLASH_PADDED(16, 16)
  FLASH_PADDED(32, 32)
  FLASH_PADDED(64, 64)
  FLASH_PADDED(80, 80)
  FLASH_PADDED(96, 64)
  FLASH_PADDED(128, 128)
  FLASH_PADDED(192, 128)
  FLASH_PADDED(256, 256)
#undef FLASH_PADDED
  return static_cast<int>(cudaErrorInvalidValue);
}
