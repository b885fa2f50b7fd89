// Flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
//   flash_attention (body _kernel) -> flash_attention
//
// q [B, S, H, hd], k and v [B, T, KV, hd] and out [B, S, H, hd], all bf16
// (the served model) or all f32 (a model run in f32).  Query head h reads
// KV head h / (H / KV) (GQA).  Query row i sits at position i and key j at
// position j; a key counts for row i when (causal) j <= i and (window > 0)
// j > i - window.  Any S and T, any head_dim up to 256.
//
// Common to both bodies.  One block per (64-row query tile, head, batch
// row).  The TPU ran the KV tiles as the innermost, sequential grid axis
// with (m, l, acc) in VMEM scratch; here the block loops over key tiles
// itself.  Tiles that the causal or window mask covers for every row of
// the block are skipped.  A masked key gets the finite logit -1e30, as in
// the reference oracle (repro/kernels/ref.py naive_attention), so a row
// whose every key is masked (only possible with a window, when the row
// sits window or more positions past the last key) averages v over all T
// keys, like the oracle's softmax; the Pallas kernel writes 0 there.  A
// block holding such a row visits every tile.  Keys past T weigh exactly
// 0.  Logits are f32 products, scaled after the product.
//
// What bounds it: at the prefill shapes of the serving path (S = T from
// 128 to 4096, 32 heads, hd 96) 4 hd flops per unmasked (query, key) pair
// against bf16 reads of q, k, v once: from S ~ 512 up the work is the
// tensor cores' (989 TFLOP/s bf16), below it the bytes and, at the served
// 128-token bucket (64 blocks on 132 SMs), the latency of two tiles' cold
// loads.
//
// bf16 body (namespace tc): an FA2 design on the tensor cores, mma.sync
// with cp.async, as on Ampere; wgmma, TMA and warp specialisation are a
// later change.
// - 4 warps a block, 16 query rows each.  Causal query tiles run longest
//   first (blockIdx.x reversed), so the short diagonal tiles fill the tail.
// - Shared memory, all bf16, head_dim padded with zeros to HDP, the next
//   multiple of 16 (96 stays 96, 100 becomes 112, 200 becomes 208), rows
//   (HDP + 8) elements apart: the stride is an odd number of 16-byte
//   chunks, so the 8 row addresses of an ldmatrix hit 8 distinct bank
//   groups (a plain 192-byte stride at hd 96 conflicts 4-way).  Q [64],
//   then a 2-stage ring of K and V tiles of BK keys: BK = 64 for HDP <=
//   128 (66.5 KB a block at hd 96, three blocks an SM), 32 above it.
// - Copies: 16-byte cp.async.cg (zero-filled past S, T and hd) when hd %
//   8 == 0 and every base pointer is 16-byte aligned, else element loads
//   in the same kernel.  Q is one commit group, each K/V tile another;
//   tile j + 1 is in flight (wait_group 1) while tile j is computed.  Two
//   __syncthreads a tile: after the wait (the tile is visible) and after
//   the compute (its stage may be overwritten by the copy of tile j + 2).
// - S = Q K^T: mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.  Q's A
//   fragments are loaded once (ldmatrix.x4) and kept in registers for
//   HDP <= 128; above that they are reloaded from shared memory for each
//   16-column step, to keep acc (HDP / 2 f32 a lane) out of local
//   memory.  K's B fragments: ldmatrix.x4 of K rows (keys x d is B in
//   "col" layout), two 8-key n-tiles per load.
// - Softmax in registers, in the log2 domain (logit * scale * log2 e,
//   exp2f).  Lane l holds rows l/4 and l/4 + 8 of its warp's 16 (the
//   m16n8 C layout: columns 2 (l % 4) and + 1 of every 8-key n-tile); the
//   row max takes __shfl_xor 1 and 2, m stays in registers, and l is kept
//   per lane as a partial sum and reduced once at the end.  The mask is
//   evaluated only on tiles that reach past the warp's diagonal, the
//   window's edge or T.
// - O += P V: the C fragments of two n-tiles (16 keys) are the A fragment
//   of the next mma once packed to bf16 (__floats2bfloat162_rn); V's B
//   fragments come from ldmatrix.x4.trans of V rows.  acc is f32; it is
//   divided by l once at the end, staged through the warp's own rows of
//   the Q tile and stored with 16-byte writes (element writes otherwise),
//   only d < hd and rows < S.
// - Numerics: the unnormalised p is rounded to bf16 before P V, as every
//   tensor-core FA2 does; l sums the unrounded p in f32.  The oracle
//   rounds the normalised p to bf16 instead.  Each side's weight is within
//   one bf16 rounding (2^-8 relative) of the exact one; each rounds its
//   output to bf16 once.
//
// f32 body (namespace cc): 256 threads, each a 4 x 4 block of scores
// and then 4 rows x ceil(hd / 16) columns of acc (DPT, a template cap,
// guarded), as scalar fmaf on the f32 CUDA cores from shared memory (Q,
// K, V in f32 at an odd row stride), scores and m, l through shared
// memory, p kept in f32 as the Pallas kernel keeps it.  f32 inputs are
// the test configuration of an f32 model, held to 2e-5 of the oracle;
// TF32 tensor cores (10-bit mantissa) would miss that, so f32 keeps its
// exact products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxHd = 256;
constexpr float kNeg = -1e30f;      // the reference's mask value

namespace tc {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

template <int KD>                   // KD = HDP / 16 column steps
struct Cfg {
  static constexpr int HDP = 16 * KD;
  static constexpr int LD = HDP + 8;            // shared row stride
  static constexpr int CH = HDP / 8;            // 16-byte chunks a row
  static constexpr int BK = KD <= 8 ? 64 : 32;  // keys a tile
  static constexpr int NT = BK / 8;             // 8-key n-tiles
  static constexpr bool QREG = KD <= 8;         // Q fragments in registers
  static constexpr size_t smem = sizeof(bf16) * (size_t)(kRows + 4 * BK) * LD;
};

// rows [r0, r0 + ROWS) of a [*, row_stride] bf16 matrix (columns [0, hd)
// from `src`, zeros past `limit` rows and past hd) into dst [ROWS][LD]
template <int KD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t row_stride, int r0,
                                          int limit, int hd, bool vec,
                                          int tid) {
  using C = Cfg<KD>;
  constexpr int N = ROWS * C::CH;
  if (vec) {
#pragma unroll
    for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
      const int c = tid + it * kThreads;
      if (N % kThreads != 0 && c >= N) break;
      const int r = c / C::CH, col = (c % C::CH) * 8;
      const bool full = r0 + r < limit && col < hd;
      const bf16* s = full ? src + (size_t)(r0 + r) * row_stride + col : src;
      cp_async16(smem_addr(dst + r * C::LD + col), s, full);
    }
  } else {
    for (int i = tid; i < ROWS * C::HDP; i += kThreads) {
      const int r = i / C::HDP, d = i % C::HDP;
      dst[r * C::LD + d] = r0 + r < limit && d < hd
                               ? src[(size_t)(r0 + r) * row_stride + d]
                               : __float2bfloat16(0.f);
    }
  }
}

template <int KD>
__global__ void __launch_bounds__(kThreads)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int S, int T, int H, int KV, int hd, int causal,
                          int window, float scale_log2, int vec) {
  using C = Cfg<KD>;
  constexpr int LD = C::LD, BK = C::BK, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kRows][LD]
  bf16* Ks = Qs + kRows * LD;                      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                     // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = (size_t)H * hd, k_row = (size_t)KV * hd;
  const bf16* qb = q + (size_t)b * S * q_row + (size_t)h * hd;
  const bf16* kb = k + (size_t)b * T * k_row + (size_t)kvh * hd;
  const bf16* vb = v + (size_t)b * T * k_row + (size_t)kvh * hd;

  // keys any row of the block can see: [klo, khi)
  const int q1 = min(q0 + kRows, S) - 1;
  int klo = window > 0 ? max(0, q0 - window + 1) : 0;
  int khi = causal ? min(T, q1 + 1) : T;
  // a row with no key at all averages every key: visit every tile
  if ((window > 0 && q1 - window + 1 >= T) || klo >= khi) {
    klo = 0;
    khi = T;
  }
  const int j0 = klo / BK, j1 = (khi + BK - 1) / BK;

  load_rows<KD, kRows>(Qs, qb, q_row, q0, S, hd, vec, tid);
  cp_async_commit();
  load_rows<KD, BK>(Ks, kb, k_row, j0 * BK, T, hd, vec, tid);
  load_rows<KD, BK>(Vs, vb, k_row, j0 * BK, T, hd, vec, tid);
  cp_async_commit();

  // ldmatrix.x4 lane addresses.  A (and V^T): lane l names row l % 16,
  // column 8 (l / 16) of a 16 x 16 block.  K: lane l names key
  // 8 (l / 16) + l % 8, column 8 ((l / 8) % 2): matrices (keys 0-7, d
  // 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) = b0, b1 of n-tile 0,
  // b0, b1 of n-tile 1.
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int k_off =
      ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const uint32_t q_base = smem_addr(Qs + warp * 16 * LD + a_off);

  uint32_t qf[C::QREG ? KD : 1][4];
  if (C::QREG) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qf[C::QREG ? kk : 0], q_base + kk * 32);
  }

  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  const int wq0 = q0 + warp * 16;               // the warp's first row
  const int row0 = wq0 + (lane >> 2);           // rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);              // columns col0, col0 + 1

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    if (j + 1 < j1) {
      bf16* kd = Ks + (st ^ 1) * BK * LD;
      bf16* vd = Vs + (st ^ 1) * BK * LD;
      load_rows<KD, BK>(kd, kb, k_row, (j + 1) * BK, T, hd, vec, tid);
      load_rows<KD, BK>(vd, vb, k_row, (j + 1) * BK, T, hd, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // s = Q K^T for the warp's 16 rows and the tile's BK keys
    const uint32_t k_base = smem_addr(Ks + st * BK * LD + k_off);
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if (C::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[C::QREG ? kk : 0][e];
      } else {
        ldsm_x4(a, q_base + kk * 32);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_base + (n * 8 * LD + kk * 16) * 2);
        mma(s[n], a, bk[0], bk[1]);
        mma(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, online softmax (log2 domain)
    const int k0 = j * BK;
    const bool edge = (causal && k0 + BK - 1 > wq0) ||
                      (window > 0 && k0 <= wq0 + 15 - window) ||
                      k0 + BK > T;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kp = k0 + n * 8 + col0 + (e & 1);
          const int qp = row0 + (e >> 1) * 8;
          bool ok = !causal || kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          // keys past T do not exist: weight exactly 0
          x = kp >= T ? -INFINITY : (ok ? x : kNeg);
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);          // m is finite: starts at kNeg
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // acc += P V: n-tiles 2 t and 2 t + 1 of p are the A fragment of
    // keys 16 t .. 16 t + 15
    const uint32_t v_base = smem_addr(Vs + st * BK * LD + a_off);
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      a[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      a[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      a[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_base + (t * 16 * LD + dp * 16) * 2);
        mma(acc[2 * dp], a, bv[0], bv[1]);
        mma(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();            // the copy of tile j + 2 overwrites stage st
  }

  // out = acc / l through the warp's own 16 rows of Qs, then to memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* Ow = Qs + warp * 16 * LD;
  const int g = lane >> 2;
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n) {
    *reinterpret_cast<uint32_t*>(Ow + g * LD + n * 8 + col0) =
        pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * LD + n * 8 + col0) =
        pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  __syncwarp();
  bf16* ob = out + (size_t)b * S * q_row + (size_t)h * hd;
  if (vec) {
    for (int c = lane; c < 16 * C::CH; c += 32) {
      const int r = c / C::CH, col = (c % C::CH) * 8;
      if (wq0 + r < S && col < hd)
        *reinterpret_cast<uint4*>(ob + (size_t)(wq0 + r) * q_row + col) =
            *reinterpret_cast<const uint4*>(Ow + r * LD + col);
    }
  } else {
    for (int i = lane; i < 16 * C::HDP; i += 32) {
      const int r = i / C::HDP, d = i % C::HDP;
      if (wq0 + r < S && d < hd) ob[(size_t)(wq0 + r) * q_row + d] =
          Ow[r * LD + d];
    }
  }
}

template <int KD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T, int H, int KV, int hd, int causal, int window,
           float scale, int vec, cudaStream_t stream) {
  const size_t smem = Cfg<KD>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<KD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_tc_kernel<KD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, T, H, KV, hd,
      causal, window, scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T, int H, int KV, int hd, int causal, int window,
             float scale, cudaStream_t st) {
  const int vec = hd % 8 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                   (uintptr_t)out) % 16 == 0;
#define FA_CASE(KD)                                                        \
  case KD:                                                                 \
    return launch<KD>(q, k, v, out, B, S, T, H, KV, hd, causal, window,   \
                      scale, vec, st);
  switch ((hd + 15) / 16) {
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6)
    FA_CASE(7) FA_CASE(8) FA_CASE(9) FA_CASE(10) FA_CASE(11) FA_CASE(12)
    FA_CASE(13) FA_CASE(14) FA_CASE(15) FA_CASE(16)
  }
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

namespace cc {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;       // 16 x 16: 4 rows x 4 keys each

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * ld +
                          (size_t)kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename E, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, E* __restrict__ out, int S,
                       int T, int H,
                       int KV, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;              // odd row stride: column reads of
                                      // 16 rows hit 16 banks
  float* Qs = smem;                   // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;          // [kBK][ld]
  float* Vs = Ks + kBK * ld;          // [kBK][ld]
  float* Ps = Vs + kBK * ld;          // [kBQ][kBK + 1] scores, then p
  float* m_s = Ps + kBQ * (kBK + 1);  // running row max
  float* l_s = m_s + kBQ;             // running row sum of p
  float* c_s = l_s + kBQ;             // this tile's rescale of acc

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = (size_t)H * hd, k_row = (size_t)KV * hd;
  const E* qb = q + (size_t)b * S * q_row + (size_t)h * hd;
  const E* kb = k + (size_t)b * T * k_row + (size_t)kvh * hd;
  const E* vb = v + (size_t)b * T * k_row + (size_t)kvh * hd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    Qs[r * ld + d] = q0 + r < S ? to_f32(qb[(q0 + r) * q_row + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  // keys any row of the block can see: [klo, khi)
  const int q1 = min(q0 + kBQ, S) - 1;
  int klo = window > 0 ? max(0, q0 - window + 1) : 0;
  int khi = causal ? min(T, q1 + 1) : T;
  // a row with no key at all averages every key: visit every tile
  if ((window > 0 && q1 - window + 1 >= T) || klo >= khi) {
    klo = 0;
    khi = T;
  }

  const int ty = tid >> 4, tx = tid & 15;   // rows ty*4+i, keys tx+16*j
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = (klo / kBK) * kBK; k0 < khi; k0 += kBK) {
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const bool in = k0 + r < T;
      Ks[r * ld + d] = in ? to_f32(kb[(k0 + r) * k_row + d]) : 0.f;
      Vs[r * ld + d] = in ? to_f32(vb[(k0 + r) * k_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = !causal || kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        // keys past T do not exist: weight exactly 0
        const float x = kp >= T ? -INFINITY : (ok ? s[i][j] * scale : kNeg);
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = x;
      }
    }
    __syncthreads();

    {  // online softmax: 4 neighbouring lanes per row, 16 keys each
      const int r = tid >> 2, part = tid & 3;
      float* prow = Ps + r * (kBK + 1) + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);   // finite: m starts at kNeg
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {          // the shuffles ordered the reads of m_s[r]
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) corr[i] = c_s[ty * 4 + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr[i];
    const int kn = min(kBK, T - k0);
    for (int c = 0; c < kn; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = Vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();            // the next tile overwrites Ks, Vs and Ps
  }

  E* ob = out + (size_t)b * S * q_row + (size_t)h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= S) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(ob + (q0 + r) * q_row + d, acc[i][j] / l);
    }
  }
}

template <typename E, int DPT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T, int H, int KV, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<E, DPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<E, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(out), S, T, H, KV, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T, int H, int KV, int hd, int causal, int window,
             float scale, cudaStream_t st) {
  if (hd <= 32)
    return launch<float, 2>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                        scale, st);
  if (hd <= 64)
    return launch<float, 4>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                        scale, st);
  if (hd <= 128)
    return launch<float, 8>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                        scale, st);
  return launch<float, 16>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                       scale, st);
}

}  // namespace cc

}  // namespace

// C entry point: q [B, S, H, hd], k and v [B, T, KV, hd], out [B, S, H, hd],
// contiguous device pointers, all bf16 (f32 = 0) or all f32 (f32 = 1);
// causal 0/1; window 0 = none, else the number of positions a query sees
// back (>= 1); scale multiplies the f32 logits; `stream` is a
// cudaStream_t.  bf16 runs the tensor-core body, f32 the CUDA-core body.
// Returns cudaGetLastError() after the launch: 0 when the launch was
// accepted.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int T, int H, int KV,
                               int hd, int causal, int window, float scale,
                               int f32, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H < KV || H % KV != 0 ||
      hd < 1 || hd > kMaxHd || window < 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return cc::dispatch(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                        scale, st);
  return tc::dispatch(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                      scale, st);
}
