// Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:
//   ssd_scan (body _kernel) -> ssd_scan
//
// x [B, S, H, P] and Bm, Cm [B, S, N] (the single B/C group), all bf16 (the
// served model) or all f32; dt [B, S, H], A [H] and the optional initial
// state h0 [B, H, P, N] in f32.  Out: y [B, S, H, P] and the final state
// hN [B, H, P, N], both f32.  S is a multiple of the chunk length L; P and
// N up to 128, L up to 1024.  Within a chunk, with h the state entering it
// (h0 or 0 for the first):
//
//   a      = A[h] * dt,  cum = cumsum(a) over the chunk
//   M[t,s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s       for s <= t only
//   y_t    = sum_s M[t,s] x_s + exp(cum_t) * (C_t . h)
//   h'     = exp(cum_L) * h + sum_s exp(cum_L - cum_s) * dt_s * x_s (x) B_s
//
// What bounds it: per batch row and chunk C . B^T once over the causal
// pairs (L (L + 1) N flops: one B/C group for all heads), per head M . x
// (L (L + 1) P) and C . h with the state update (4 L P N), against x, B,
// C and dt read once and y and the state written once.  On the tensor
// cores, with every product that has an f32 operand done twice (hi and
// lo, below), the served shape (B 1, S 512, H 64, P 64, N 128, L 256)
// needs 3.2 GFLOP, 3.3 us at 989 TFLOP/s, and moves 15 MB, 4.5 us at
// 3.35 TB/s: the bytes.  What holds it above that: the latency of three
// dependent launches and, within them, of cold tile loads; mma.sync
// issued from at most 12 warps an SM, far from the tensor cores' peak
// (wgmma is a later change); and the scratch below (at B 4, S 2048 the
// state scratch moves about as many bytes as x and y).
//
// Design: the SSD paper's chunked algorithm (arXiv:2405.21060), in three
// launches chained by programmatic dependent launch (a launch's blocks
// start while the previous one runs and wait, griddepcontrol.wait,
// before they read its output).  The TPU walked the chunks as the
// innermost, sequential grid axis with the state in VMEM; here only the
// state passing is sequential, over P x N elements:
//   1. chunk states, a block per (head, chunk, batch row, 64 x 64 slice
//      of the P x N state): cum by a block prefix sum, w_s = exp(cum_L -
//      cum_s) dt_s, the chunk's own state sum_s (w_s x_s) (x) B_s from
//      zero into f32 scratch, and exp(cum_L).  In the same launch, a
//      block per (chunk, batch row, pair of 64-row tiles t >= s) writes
//      that tile of C . B^T in f32 to scratch, once for all heads (B and
//      C are one group): 10 tiles of 16 KB a chunk at L = 256;
//   2. state passing, a thread per state element: h <- exp(cum_L) h + upd
//      chunk by chunk from h0 (or 0); it writes the state entering every
//      chunk that has one, already split into bf16 parts (below), and hN;
//   3. chunk outputs, a block per (head, chunk, batch row, 64-row query
//      tile), the longest tiles first: C . h of the entering state, scaled
//      by exp(cum_t), then for every source tile s <= t the C . B^T tile
//      from scratch, the decay and dt applied with the mask tested before
//      the exp (exp(cum_t - cum_s) for s > t can overflow to inf, and inf
//      * 0 is NaN), and M . x into the same accumulators.
// At the served shape that is 276, 2048 and 512 blocks of 4, 8 and 4
// warps (the first design ran 64 blocks, one per head).  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (scripts/ssd_timing.py): the shared
// C . B^T tiles read as many bytes as the B tiles they replace and save
// each head's block its products, 7 % of the served time and 14 % at
// B 4, S 2048; deeper rings and tile loads issued before the prefix sum
// measured slower.  The state passing
// stays a launch of its own: folding it into the chunk states needs a
// look-back across chunks (a later change).
//
// Products: mma.sync.m16n8k16 bf16 -> f32, ldmatrix fragments and 16-byte
// cp.async tile loads into a 2-stage ring (as flash_attention.cu; helpers
// in sm90.cuh).  bf16 tiles sit in shared memory with columns
// zero-padded to a multiple of 16 and rows (width + 8) elements apart,
// so the 8 row addresses of an ldmatrix hit 8 distinct bank groups; the
// f32 C . B^T tile rows are 72 floats apart (conflict-free 8-byte reads).
//
// Numerics.  A bf16 x bf16 product is exact in f32, so C . B^T of bf16
// inputs is one product.  An f32 operand (M, the scaled w x of the state
// update, the carried state h) never enters as one bf16 rounding, which
// would miss the f32 plain version's bound by an order of magnitude:
// it is split into parts, hi = bf16(v), lo = bf16(v - hi) (v - hi is
// exact in f32), and the products of the parts are summed in f32.  Parts
// i of one operand and j of the other are multiplied when i + j < K, the
// larger part count: bf16 inputs (1 part, exact) against f32 operands in
// K = 2 parts, two products, a relative error near 2^-16 per operand.
// f32 inputs are split into 3 parts by a fourth launch before the others
// (their bf16 planes in scratch) and f32 operands into 3, six products
// of parts, within a few ulp of f32: this is the test configuration of a
// model run in f32, held to the same f32 bound as bf16 inputs.  Every
// sum is f32; cum, the exps, M and the state passing are f32 on the CUDA
// cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 64;              // rows of a query, source or state tile
constexpr int kMaxChunk = 1024;
constexpr int kMaxN = 128;          // d_state
constexpr int kMaxP = 128;          // head_dim
constexpr int kPassThreads = 256;

// parts of an f32 operand: 2 beside bf16 inputs (1 part), 3 beside f32
// inputs (3 parts)
__host__ __device__ constexpr int parts_of(int KP) {
  return KP == 1 ? 2 : 3;
}
__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// rows [0, nrows) x columns [0, width) of PARTS planes of a bf16 matrix
// (rows `stride` elements apart, planes `pstride` apart) into dst, rows
// `ld` apart and planes nrows * ld apart; zero past `rows` rows and past
// `cols` columns.  vec: 16-byte cp.async (cols a multiple of 8, 16-byte
// aligned rows), else element copies.
template <int PARTS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, int width,
                                          int nrows, const bf16* src,
                                          size_t stride, size_t pstride,
                                          int rows, int cols, bool vec) {
#pragma unroll
  for (int part = 0; part < PARTS; ++part) {
    bf16* d = dst + part * nrows * ld;
    const bf16* sp = src + part * pstride;
    if (vec) {
      const int ch = width / 8;
      for (int i = threadIdx.x; i < nrows * ch; i += kThreads) {
        const int r = i / ch, col = (i - r * ch) * 8;
        const bool full = r < rows && col < cols;
        cp_async16(smem_addr(d + r * ld + col),
                   full ? sp + (size_t)r * stride + col : sp, full);
      }
    } else {
      for (int i = threadIdx.x; i < nrows * width; i += kThreads) {
        const int r = i / width, col = i - r * width;
        d[r * ld + col] = r < rows && col < cols
                              ? sp[(size_t)r * stride + col]
                              : __float2bfloat16(0.f);
      }
    }
  }
}

// v[2r], v[2r + 1] (fragment register r) as K bf16 parts: out[k][r]
template <int K>
__device__ __forceinline__ void split_frag(const float* v,
                                           uint32_t (*out)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lo = v[2 * r], hi = v[2 * r + 1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
      out[k][r] = *reinterpret_cast<const uint32_t*>(&p);
      lo -= __low2float(p);
      hi -= __high2float(p);
    }
  }
}

// the f32 sum of the KP parts of a fragment: v[2r + e] from register r
template <int KP>
__device__ __forceinline__ void widen_frag(const uint32_t (*a)[4], float* v) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const __nv_bfloat162 p =
          *reinterpret_cast<const __nv_bfloat162*>(&a[k][r]);
      lo += __low2float(p);
      hi += __high2float(p);
    }
    v[2 * r] = lo;
    v[2 * r + 1] = hi;
  }
}

// c0 (n-tile 2i) and c1 (n-tile 2i + 1) += sum over part pairs i + j < K
// of a[i] b[j], b[j] an ldmatrix.x4 of two n-tiles
template <int KA, int KB>
__device__ __forceinline__ void mma_parts(float* c0, float* c1,
                                          const uint32_t (*a)[4],
                                          const uint32_t (*b)[4]) {
  constexpr int K = KA > KB ? KA : KB;
#pragma unroll
  for (int i = 0; i < KA; ++i)
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (i + j < K) {
        mma(c0, a[i], b[j][0], b[j][1]);
        mma(c1, a[i], b[j][2], b[j][3]);
      }
}

// cum[t] = sum_{t' <= t} a dt[t'] and dts[t] = dt[t] for t < n (dt rows
// `dstride` apart), by the whole block, kThreads steps a round (warp
// shuffles, then the warp totals in warp order): a prefix is computed
// the same whatever n, so every launch gets the same cum
__device__ __forceinline__ void chunk_cumsum(float* cum, float* dts,
                                             const float* dt, size_t dstride,
                                             float a, int n,
                                             float* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < n; base += kThreads) {
    const int t = base + tid;
    const float d = t < n ? dt[(size_t)t * dstride] : 0.f;
    float v = a * d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    float before = carry, total = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_tot[w];
      total += warp_tot[w];
    }
    if (t < n) {
      cum[t] = before + v;
      dts[t] = d;
    }
    carry = total;
    __syncthreads();                // warp_tot is rewritten next round
  }
}

// ---- 0. f32 inputs -> 3 bf16 planes each -----------------------------------
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_split_kernel(const float* __restrict__ x,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm, bf16* __restrict__ xs,
                      bf16* __restrict__ bs, bf16* __restrict__ cs,
                      size_t nx, size_t nb) {
  const float* src = blockIdx.y == 0 ? x : blockIdx.y == 1 ? Bm : Cm;
  bf16* dst = blockIdx.y == 0 ? xs : blockIdx.y == 1 ? bs : cs;
  const size_t n = blockIdx.y == 0 ? nx : nb;
  for (size_t i = (size_t)blockIdx.x * kPassThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kPassThreads) {
    float v = src[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bf16 p = __float2bfloat16_rn(v);
      dst[k * n + i] = p;
      v -= __bfloat162float(p);
    }
  }
}

// ---- 1a. C . B^T, once per chunk for all heads -----------------------------
// The 64 x 64 tile (ti, tj), tj <= ti, of C . B^T in f32 into cb (rows past
// L are zero): 4 warps of 16 rows, A = C [t][n], B operand = B [s][n].
template <int KP>
__device__ __forceinline__ void cb_tile(bf16* smem, const bf16* Cm,
                                        const bf16* Bm, float* cb,
                                        size_t row0, int N, int L, int ti,
                                        int tj, size_t b_pstride, bool vec) {
  const int NP = round16(N), LDN = NP + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* Cs = smem;
  bf16* Bs = smem + KP * kT * LDN;
  load_tile<KP>(Cs, LDN, NP, kT, Cm + (row0 + ti * kT) * N, N, b_pstride,
                min(kT, L - ti * kT), N, vec);
  load_tile<KP>(Bs, LDN, NP, kT, Bm + (row0 + tj * kT) * N, N, b_pstride,
                min(kT, L - tj * kT), N, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // ldmatrix lane offsets: A from [m][k] storage, row l % 16, column 8
  // (l / 16); B from [n][k] storage, row 8 (l / 16) + l % 8, column
  // 8 ((l / 8) % 2)
  const int a_off = (warp * 16 + (lane & 15)) * LDN + 8 * (lane >> 4);
  const int k_off = (8 * (lane >> 4) + (lane & 7)) * LDN +
                    8 * ((lane >> 3) & 1);
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kk = 0; kk < NP / 16; ++kk) {
    uint32_t ac[KP][4];
#pragma unroll
    for (int k = 0; k < KP; ++k)
      ldsm_x4(ac[k], smem_addr(Cs + k * kT * LDN + kk * 16 + a_off));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[KP][4];
#pragma unroll
      for (int k = 0; k < KP; ++k)
        ldsm_x4(bb[k], smem_addr(Bs + k * kT * LDN + np * 16 * LDN +
                                 kk * 16 + k_off));
      mma_parts<KP, KP>(acc[2 * np], acc[2 * np + 1], ac, bb);
    }
  }
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(cb + (16 * warp + g + 8 * r) * kT + 8 * n +
                                 2 * cq) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
}

// ---- 1. chunk states -------------------------------------------------------
// Block (head, chunk + NC * batch row, p slice * n_ns + n slice): upd[p][n]
// = sum_s (w_s x_s[p]) B_s[n] over the chunk, 64 p rows (16 a warp) by 64
// n columns.  A = (w x)^T: ldmatrix.trans of the x tile [s][p], widened,
// scaled by w_s and split in registers; B operand: ldmatrix.trans of the
// B tile [s][n].  Blocks past the heads (blockIdx.x >= H) compute the
// chunk's C . B^T tile pairs instead (cb_tile), with the z slice 0.
template <int KP>
__global__ void __launch_bounds__(kThreads)
ssd_scan_states_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm, float* __restrict__ upd,
                       float* __restrict__ decay, float* __restrict__ cb,
                       int S, int H, int P, int N, int L, int n_ns,
                       size_t x_pstride, size_t b_pstride, int vec) {
  constexpr int KS = parts_of(KP);
  constexpr int LD = kT + 8;
  constexpr int STAGE = 2 * KP * kT * LD;       // x planes, then B planes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_tot[kWarps];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);           // [2][STAGE]
  const int n_tiles = (L + kT - 1) / kT;
  float* cum = reinterpret_cast<float*>(ring + 2 * STAGE);  // [n_tiles kT]
  float* w = cum + n_tiles * kT;                            // [n_tiles kT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, NC = S / L;
  const int c = blockIdx.y % NC, b = blockIdx.y / NC;
  const int p0 = (blockIdx.z / n_ns) * kT, n0 = (blockIdx.z % n_ns) * kT;
  const size_t row0 = (size_t)b * S + (size_t)c * L;  // the chunk's first step

  if (h >= H) {
    // the split planes of f32 inputs come from the launch before
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (blockIdx.z != 0) return;
    const int q = h - H, n_pairs = n_tiles * (n_tiles + 1) / 2;
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= q) ++ti;
    cb_tile<KP>(ring, Cm, Bm,
                cb + ((size_t)blockIdx.y * n_pairs + q) * kT * kT, row0, N,
                L, ti, q - ti * (ti + 1) / 2, b_pstride, vec);
    return;
  }

  chunk_cumsum(cum, w, dt + row0 * H + h, H, A[h], L, warp_tot);
  const float cum_L = cum[L - 1];
  for (int t = tid; t < n_tiles * kT; t += kThreads)
    w[t] = t < L ? expf(cum_L - cum[t]) * w[t] : 0.f;
  if (blockIdx.z == 0 && tid == 0)
    decay[((size_t)b * NC + c) * H + h] = expf(cum_L);
  // the split planes of f32 inputs come from the launch before
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");

  const size_t xrow = (size_t)H * P;
  const bf16* xs = x + row0 * xrow + (size_t)h * P + p0;
  const bf16* bs = Bm + row0 * N + n0;
  auto load = [&](int j, int st) {
    bf16* xd = ring + st * STAGE;
    const int rows = min(kT, L - j * kT);
    load_tile<KP>(xd, LD, kT, kT, xs + (size_t)j * kT * xrow, xrow,
                  x_pstride, rows, P - p0, vec);
    load_tile<KP>(xd + KP * kT * LD, LD, kT, kT, bs + (size_t)j * kT * N, N,
                  b_pstride, rows, N - n0, vec);
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // ldmatrix lane offsets.  A from [k][m] storage (.trans): lane l names
  // row k = l % 8 + 8 (l / 16), column m = 8 ((l / 8) % 2).  B from
  // [k][n] storage (.trans): row k = l % 16, column n = 8 (l / 16).
  const int a_off = ((lane & 7) + 8 * (lane >> 4)) * LD + 16 * warp +
                    8 * ((lane >> 3) & 1);
  const int b_off = (lane & 15) * LD + 8 * (lane >> 4);
  const int cq = lane & 3;
  const bool active = p0 + 16 * warp < P;   // rows past P are zeros

  load(0, 0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) load(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* xt = ring + st * STAGE;
    const bf16* bt = xt + KP * kT * LD;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const int s0 = j * kT + kk * 16;
        if (s0 >= L) break;
        uint32_t ax[KP][4];
#pragma unroll
        for (int k = 0; k < KP; ++k)
          ldsm_x4_trans(ax[k], smem_addr(xt + k * kT * LD + kk * 16 * LD +
                                         a_off));
        // register r holds k indices 2 cq, 2 cq + 1 (r = 0, 1) or
        // 2 cq + 8, 2 cq + 9 (r = 2, 3)
        float v[8];
        widen_frag<KP>(ax, v);
        const float w0 = w[s0 + 2 * cq], w1 = w[s0 + 2 * cq + 1];
        const float w8 = w[s0 + 2 * cq + 8], w9 = w[s0 + 2 * cq + 9];
        v[0] *= w0; v[1] *= w1; v[2] *= w0; v[3] *= w1;
        v[4] *= w8; v[5] *= w9; v[6] *= w8; v[7] *= w9;
        uint32_t aw[KS][4];
        split_frag<KS>(v, aw);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[KP][4];
#pragma unroll
          for (int k = 0; k < KP; ++k)
            ldsm_x4_trans(bb[k], smem_addr(bt + k * kT * LD + kk * 16 * LD +
                                           np * 16 + b_off));
          mma_parts<KS, KP>(acc[2 * np], acc[2 * np + 1], aw, bb);
        }
      }
    }
    __syncthreads();                // the copy of tile j + 2 overwrites st
  }

  float* u = upd + (((size_t)b * NC + c) * H + h) * (size_t)P * N;
  const int g = lane >> 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 16 * warp + g + 8 * (e >> 1);
      const int n = n0 + 8 * nt + 2 * cq + (e & 1);
      if (p < P && n < N) u[(size_t)p * N + n] = acc[nt][e];
    }
}

// ---- 2. state passing ------------------------------------------------------
// A thread per (batch row, head, state element), chunk by chunk: the state
// entering chunk c (when it has one: c > 0, or h0 given) goes to hin as KS
// bf16 parts, then h <- exp(cum_L) h + upd.
template <int KS>
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_pass_kernel(const float* __restrict__ upd,
                     const float* __restrict__ decay,
                     const float* __restrict__ h0, bf16* __restrict__ hin,
                     float* __restrict__ hN, int B, int NC, int H, int PN) {
  asm volatile("griddepcontrol.launch_dependents;");
  const size_t i = (size_t)blockIdx.x * kPassThreads + threadIdx.x;
  if (i >= (size_t)B * H * PN) return;
  const size_t bh = i / PN;
  const int e = (int)(i - bh * PN), h = (int)(bh % H), b = (int)(bh / H);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float s = h0 != nullptr ? h0[i] : 0.f;
  for (int c = 0; c < NC; ++c) {
    const size_t cbh = ((size_t)b * NC + c) * H + h;
    if (c > 0 || h0 != nullptr) {
      float r = s;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const bf16 p = __float2bfloat16_rn(r);
        hin[(cbh * KS + k) * PN + e] = p;
        r -= __bfloat162float(p);
      }
    }
    s = decay[cbh] * s + upd[cbh * PN + e];
  }
  hN[i] = s;
}

// ---- 3. chunk outputs ------------------------------------------------------
// Block (head, chunk + NC * batch row, query tile, longest first): y of 64
// rows, 16 a warp, over PT16 16-column steps of P at most.
template <int KP, int PT16>
__global__ void __launch_bounds__(kThreads)
ssd_scan_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ cb,
                    const bf16* __restrict__ Cm, const bf16* __restrict__ hin,
                    float* __restrict__ y, int S, int H, int P, int N, int L,
                    int has_h0, size_t x_pstride, size_t b_pstride,
                    int vec) {
  constexpr int KS = parts_of(KP);
  constexpr int STAGES = KP == 1 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_tot[kWarps];
  const int NP = round16(N), PP = round16(P);
  const int LDN = NP + 8, LDP = PP + 8;
  constexpr int LDC = kT + 8;        // f32 row stride of a C . B^T tile
  const int stage = 2 * kT * LDC + KP * kT * LDP;  // C.B^T, then x planes
  const int region = max(STAGES * stage, KS * PP * LDN);
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);        // [KP][kT][LDN]
  bf16* ring = Cs + KP * kT * LDN;   // the ring, or the entering state's
                                     // KS planes [PP][LDN] before it
  float* cum = reinterpret_cast<float*>(ring + region);  // [t0 + kT]
  float* dts = cum + L;                                   // [t0 + kT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, NC = S / L;
  const int c = blockIdx.y % NC, b = blockIdx.y / NC;
  const int tq = gridDim.z - 1 - blockIdx.z;
  const int t0 = tq * kT, rows_t = min(kT, L - t0);
  const size_t row0 = (size_t)b * S + (size_t)c * L;
  const size_t xrow = (size_t)H * P;

  chunk_cumsum(cum, dts, dt + row0 * H + h, H, A[h], t0 + rows_t, warp_tot);
  asm volatile("griddepcontrol.wait;" ::: "memory");

  const bool has_state = c > 0 || has_h0;
  if (has_state) {
    load_tile<KP>(Cs, LDN, NP, kT, Cm + (row0 + t0) * N, N, b_pstride,
                  rows_t, N, vec);
    load_tile<KS>(ring, LDN, NP, PP,
                  hin + (((size_t)b * NC + c) * H + h) * KS * P * N, N,
                  (size_t)P * N, P, N, vec);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float yacc[2 * PT16][4];
#pragma unroll
  for (int n = 0; n < 2 * PT16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
  // ldmatrix lane offsets.  A from [m][k] storage: row l % 16, column 8
  // (l / 16).  B from [n][k] storage: row 8 (l / 16) + l % 8, column
  // 8 ((l / 8) % 2).  B from [k][n] storage (.trans): row l % 16, column
  // 8 (l / 16).
  const int a_off = (lane & 15) * LDN + 8 * (lane >> 4);
  const int k_off = (8 * (lane >> 4) + (lane & 7)) * LDN +
                    8 * ((lane >> 3) & 1);
  const int v_off = (lane & 15) * LDP + 8 * (lane >> 4);
  const int nk = NP / 16, np16 = PP / 16;
  const int g = lane >> 2, cq = lane & 3;
  const int tr = t0 + 16 * warp + g;          // rows tr and tr + 8
  const bf16* Cw = Cs + warp * 16 * LDN;

  // inter-chunk: y = exp(cum_t) C_t . h
  if (has_state) {
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t ac[KP][4];
#pragma unroll
      for (int k = 0; k < KP; ++k)
        ldsm_x4(ac[k], smem_addr(Cw + k * kT * LDN + kk * 16 + a_off));
#pragma unroll
      for (int pp = 0; pp < PT16; ++pp) {
        if (pp >= np16) break;
        uint32_t bh[KS][4];
#pragma unroll
        for (int k = 0; k < KS; ++k)
          ldsm_x4(bh[k], smem_addr(ring + k * PP * LDN + pp * 16 * LDN +
                                   kk * 16 + k_off));
        mma_parts<KP, KS>(yacc[2 * pp], yacc[2 * pp + 1], ac, bh);
      }
    }
    const float e0 = tr < L ? expf(cum[tr]) : 0.f;
    const float e1 = tr + 8 < L ? expf(cum[tr + 8]) : 0.f;
#pragma unroll
    for (int n = 0; n < 2 * PT16; ++n) {
      yacc[n][0] *= e0;
      yacc[n][1] *= e0;
      yacc[n][2] *= e1;
      yacc[n][3] *= e1;
    }
    __syncthreads();                // the ring overwrites the state
  }

  // intra-chunk: source tiles j <= tq
  const bf16* xs = x + row0 * xrow + (size_t)h * P;
  // the C . B^T tiles (tq, j) of this chunk
  const int n_pairs = gridDim.z * (gridDim.z + 1) / 2;
  const float* cbq =
      cb + ((size_t)blockIdx.y * n_pairs + tq * (tq + 1) / 2) * kT * kT;
  auto load = [&](int j, int st) {
    float* cd = reinterpret_cast<float*>(ring + st * stage);
    const float* src = cbq + (size_t)j * kT * kT;
    for (int i = tid; i < kT * kT / 4; i += kThreads) {
      const int r = i / (kT / 4), col = (i % (kT / 4)) * 4;
      cp_async16(smem_addr(cd + r * LDC + col), src + r * kT + col, true);
    }
    load_tile<KP>(reinterpret_cast<bf16*>(cd + kT * LDC), LDP, PP, kT,
                  xs + (size_t)j * kT * xrow, xrow, x_pstride,
                  min(kT, L - j * kT), P, vec);
  };
  if (STAGES == 2) {
    load(0, 0);
    cp_async_commit();
  }
  for (int j = 0; j <= tq; ++j) {
    int st = 0;
    if (STAGES == 2) {
      st = j & 1;
      if (j < tq) load(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load(j, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cbt = reinterpret_cast<const float*>(ring + st * stage);
    const bf16* xt = reinterpret_cast<const bf16*>(cbt + kT * LDC);
    const int s0 = j * kT;
    // on the diagonal tile, sources past the warp's last row never count
    const int ncols = j == tq ? 16 * (warp + 1) : kT;

    // C.B^T in the m16n8 accumulator layout: rows g, g + 8 of the warp,
    // columns 2 cq, 2 cq + 1 of each 8-column n-tile
    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = 8 * n < ncols
            ? *reinterpret_cast<const float2*>(
                  cbt + (16 * warp + g + 8 * r) * LDC + 8 * n + 2 * cq)
            : make_float2(0.f, 0.f);
        sacc[n][2 * r] = v.x;
        sacc[n][2 * r + 1] = v.y;
      }
    // M = (C.B) exp(cum_t - cum_s) dt_s, masked before the exp
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tr + 8 * (e >> 1);
        const int s = s0 + 8 * n + 2 * cq + (e & 1);
        sacc[n][e] = s <= t && t < L
                         ? sacc[n][e] * expf(cum[t] - cum[s]) * dts[s]
                         : 0.f;
      }
    // y += M x: n-tiles 2 kk and 2 kk + 1 of M are the A fragment of
    // sources 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (16 * kk >= ncols) break;
      const float v[8] = {sacc[2 * kk][0], sacc[2 * kk][1],
                          sacc[2 * kk][2], sacc[2 * kk][3],
                          sacc[2 * kk + 1][0], sacc[2 * kk + 1][1],
                          sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]};
      uint32_t am[KS][4];
      split_frag<KS>(v, am);
#pragma unroll
      for (int pp = 0; pp < PT16; ++pp) {
        if (pp >= np16) break;
        uint32_t bx[KP][4];
#pragma unroll
        for (int k = 0; k < KP; ++k)
          ldsm_x4_trans(bx[k], smem_addr(xt + k * kT * LDP + kk * 16 * LDP +
                                         pp * 16 + v_off));
        mma_parts<KS, KP>(yacc[2 * pp], yacc[2 * pp + 1], am, bx);
      }
    }
    __syncthreads();                // the next copy overwrites stage st
  }

  float* yb = y + row0 * xrow + (size_t)h * P;
#pragma unroll
  for (int n = 0; n < 2 * PT16; ++n) {
    const int p = 8 * n + 2 * cq;
    if (p >= P) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = tr + 8 * r;
      if (t >= L) continue;
      float* o = yb + (size_t)t * xrow + p;
      if (p + 1 < P && (P & 1) == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(yacc[n][2 * r],
                                                    yacc[n][2 * r + 1]);
      } else {
        o[0] = yacc[n][2 * r];
        if (p + 1 < P) o[1] = yacc[n][2 * r + 1];
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int KP, int PT16>
int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm,
           const bf16* Cm, const float* h0, float* y, float* hN, float* upd,
           float* decay, float* cb, bf16* hin, int B, int S, int H, int P,
           int N, int L,
           size_t x_pstride, size_t b_pstride, bool vec, bool first_pdl,
           cudaStream_t stream) {
  constexpr int KS = parts_of(KP);
  const int NC = S / L, n_tiles = (L + kT - 1) / kT;
  const int n_ps = (P + kT - 1) / kT, n_ns = (N + kT - 1) / kT;

  // 1. chunk states
  // (a C . B^T block takes 2 KP kT (round16(N) + 8) <= 2 KP kT 2 (kT + 8))
  const size_t smem1 = sizeof(bf16) * 2 * 2 * KP * kT * (kT + 8) +
                       sizeof(float) * 2 * n_tiles * kT;
  cudaError_t err = allow_smem(ssd_scan_states_kernel<KP>, smem1);
  if (err != cudaSuccess) return (int)err;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  PdlConfig c1(dim3(H + n_pairs, NC * B, n_ps * n_ns), kThreads, smem1,
               stream);
  c1.cfg.numAttrs = first_pdl ? 1 : 0;
  err = cudaLaunchKernelEx(&c1.cfg, ssd_scan_states_kernel<KP>, x, dt, A, Bm,
                           Cm, upd, decay, cb, S, H, P, N, L, n_ns, x_pstride,
                           b_pstride, (int)vec);
  if (err != cudaSuccess) return (int)err;

  // 2. state passing
  const int PN = P * N;
  const size_t n2 = (size_t)B * H * PN;
  PdlConfig c2(dim3((unsigned)((n2 + kPassThreads - 1) / kPassThreads)),
               kPassThreads, 0, stream);
  err = cudaLaunchKernelEx(&c2.cfg, ssd_scan_pass_kernel<KS>,
                           (const float*)upd, (const float*)decay, h0, hin,
                           hN, B, NC, H, PN);
  if (err != cudaSuccess) return (int)err;

  // 3. chunk outputs
  const int NP = round16(N), PP = round16(P);
  const int stage = 2 * kT * (kT + 8) + KP * kT * (PP + 8);
  const int stages = KP == 1 ? 2 : 1;
  const int region = stages * stage > KS * PP * (NP + 8)
                         ? stages * stage : KS * PP * (NP + 8);
  const size_t smem3 = sizeof(bf16) * (KP * kT * (NP + 8) + region) +
                       sizeof(float) * 2 * L;
  err = allow_smem(ssd_scan_out_kernel<KP, PT16>, smem3);
  if (err != cudaSuccess) return (int)err;
  PdlConfig c3(dim3(H, NC * B, n_tiles), kThreads, smem3, stream);
  err = cudaLaunchKernelEx(&c3.cfg, ssd_scan_out_kernel<KP, PT16>, x, dt, A,
                           (const float*)cb, Cm, (const bf16*)hin, y, S, H, P,
                           N, L,
                           (int)(h0 != nullptr), x_pstride, b_pstride,
                           (int)vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C entry point: x [B, S, H, P], Bm and Cm [B, S, N], all bf16 (f32 = 0) or
// all f32 (f32 = 1); dt [B, S, H], A [H], h0 [B, H, P, N] (or NULL: a zero
// state) in f32; y [B, S, H, P] and hN [B, H, P, N] f32 outputs; scratch:
// upd [B, S / L, H, P, N] f32, decay [B, S / L, H] f32, cb [B, S / L,
// T (T + 1) / 2, 64, 64] f32 (T = ceil(L / 64)), hin [B, S / L, H, K, P,
// N] bf16 (K = 2 for bf16 inputs, 3 for f32), and for f32 inputs
// planes, 3 (B S H P + 2 B S N) bf16 (NULL for bf16); contiguous device
// pointers; S a multiple of the chunk length L (<= 1024); P, N <= 128;
// `stream` is a cudaStream_t.  Three launches for bf16 inputs, four for
// f32.  Returns the first launch error, else cudaGetLastError(): 0 when
// every launch was accepted.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0,
                        void* y, void* hN, void* upd, void* decay, void* cb,
                        void* hin, void* planes, int B, int S, int H, int P,
                        int N, int L, int f32, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || L < 1 || L > kMaxChunk || S % L != 0 ||
      (size_t)(S / L) * B > 65535 ||
      (f32 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hNf = static_cast<float*>(hN);
  float* updf = static_cast<float*>(upd);
  float* decf = static_cast<float*>(decay);
  float* cbf = static_cast<float*>(cb);
  bf16* hinb = static_cast<bf16*>(hin);
  const bool wide = P > 64;
  const bf16 *xb, *bb, *cmb;
  size_t x_pstride = 0, b_pstride = 0;
  if (f32) {
    const size_t nx = (size_t)B * S * H * P, nb = (size_t)B * S * N;
    bf16* xs = static_cast<bf16*>(planes);
    bf16* bs = xs + 3 * nx;
    bf16* cs = bs + 3 * nb;
    const size_t most = nx > nb ? nx : nb;
    size_t blocks = (most + kPassThreads - 1) / kPassThreads;
    if (blocks > 1024) blocks = 1024;
    ssd_scan_split_kernel<<<dim3((unsigned)blocks, 3), kPassThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), xs, bs, cs, nx, nb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xb = xs;
    bb = bs;
    cmb = cs;
    x_pstride = nx;
    b_pstride = nb;
  } else {
    xb = static_cast<const bf16*>(x);
    bb = static_cast<const bf16*>(Bm);
    cmb = static_cast<const bf16*>(Cm);
  }
  const bool vec = P % 8 == 0 && N % 8 == 0 && aligned16(xb) &&
                   aligned16(bb) && aligned16(cmb) && aligned16(hin);
#define SSD_LAUNCH(KP, PT16)                                                  \
  return launch<KP, PT16>(xb, dtf, Af, bb, cmb, h0f, yf, hNf, updf, decf,     \
                          cbf, hinb, B, S, H, P, N, L, x_pstride, b_pstride,  \
                          vec, f32 != 0, st)
  if (f32) {
    if (wide) SSD_LAUNCH(3, 8);
    SSD_LAUNCH(3, 4);
  }
  if (wide) SSD_LAUNCH(1, 8);
  SSD_LAUNCH(1, 4);
#undef SSD_LAUNCH
}
