// Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:
//   ssd_scan (body _kernel) -> ssd_scan
//
// x [B, S, H, P] and Bm, Cm [B, S, N] (the single B/C group), all bf16 (the
// served model) or all f32; dt [B, S, H], A [H] and the optional initial
// state h0 [B, H, P, N] in f32.  Out: y [B, S, H, P] and the final state
// hN [B, H, P, N], both f32.  S is a multiple of the chunk length L.  The
// state h (P x N) starts at h0 (or 0) and, chunk by chunk, in order:
//
//   a      = A[h] * dt,  cum = cumsum(a) over the chunk
//   M[t,s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s       for s <= t only
//   y_t    = sum_s M[t,s] x_s + exp(cum_t) * (C_t . h)
//   h      = exp(cum_L) * h + sum_s exp(cum_L - cum_s) * dt_s * x_s (x) B_s
//
// Inputs of either dtype are widened to f32 before any product, as the
// Pallas kernel widens them; every sum is f32.
//
// Design.  The TPU ran the chunks as the innermost, sequential grid axis
// with the state in VMEM scratch.  Here one block per (head, batch row)
// loops over the chunks itself and keeps the state in shared memory (P x N
// f32: 32 KB at P = 64, N = 128).  A chunk's B, C and x do not fit beside
// it (at L = 256, N = 128 B and C alone are 128 KB each in f32), so the
// chunk is cut into 64-row tiles: for each query tile of C, first the
// inter-chunk term C . h, then every source tile s <= t of B and x (tiles
// wholly above the diagonal skipped): the 64 x 64 tile of C . B^T, the
// decay and dt applied with the mask tested before the exp (exp(cum_t -
// cum_s) for s > t can overflow to inf, and inf * 0 is NaN), then M . x
// into the y accumulators.  After the last query tile the state is
// updated from every source tile once more.  cum comes from a block
// prefix sum (warp shuffles, then the warp totals).  B and C are shared
// by all heads; each block re-reads them (from L2), as the Pallas kernel
// does.
//
// What bounds it: the function needs, over the causal pairs t >= s, per
// (batch row, chunk) C . B^T once (L (L + 1) N flops: one B/C group for
// all heads) and per head L (L + 1) P (M . x) + 4 L P N (C . h and the
// state update), against x, B, C and dt read once and y and the state
// written once: at the served shape (L = 256, P = 64, N = 128) about 110
// flops per byte, compute.  This first version multiplies on the f32 CUDA
// cores from shared memory (each thread a 4 x 4 block of C . B^T, 4 rows x
// P/16 columns of y, P/16 x N/16 of the state update), not on the tensor
// cores, and each head's block computes C . B^T again: mma / wgmma, and
// C . B^T shared across heads, are later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

constexpr int kThreads = 256;       // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;              // rows of a query tile and a source tile
constexpr int kMaxChunk = 1024;
constexpr int kMaxN = 128;          // d_state: 16 * kNJ columns
constexpr int kNJ = kMaxN / 16;
constexpr int kMaxP = 64;           // head_dim: 16 * kPJ columns
constexpr int kPJ = kMaxP / 16;

size_t smem_bytes(int P, int N, int L) {
  const size_t ldn = N + 1;
  return sizeof(float) * ((size_t)P * ldn + 2 * kT * ldn + (size_t)kT * P +
                          kT * (kT + 1) + 2 * (size_t)L);
}

// rows [0, rows) of a kT-row tile from global rows of `stride` elements,
// `cols` wide, widened to f32; the rows past `rows` are zero
template <typename E>
__device__ __forceinline__ void load_tile(float* dst, int ld, const E* src,
                                          size_t stride, int rows,
                                          int cols) {
  for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = r < rows ? to_f32(src[(size_t)r * stride + c]) : 0.f;
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const E* __restrict__ Bm,
                const E* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hN, int S, int H,
                int P, int N, int L) {
  extern __shared__ float smem[];
  __shared__ float warp_tot[kWarps];
  const int ldn = N + 1;              // odd row stride: 16 rows read down a
                                      // column hit 16 banks
  float* Hs = smem;                   // [P][ldn] the state
  float* Cs = Hs + P * ldn;           // [kT][ldn] query tile of C
  float* Bs = Cs + kT * ldn;          // [kT][ldn] source tile of B
  float* Xs = Bs + kT * ldn;          // [kT][P]   source tile of x
  float* Ms = Xs + kT * P;            // [kT][kT + 1] decayed C . B^T
  float* cum = Ms + kT * (kT + 1);    // [L] cumsum(A * dt) of the chunk
  float* wts = cum + L;               // [L] dt, then exp(cum_L - cum) * dt

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int hi = blockIdx.x, bi = blockIdx.y;
  const float a_h = A[hi];
  const size_t xrow = (size_t)H * P;  // one step of x and y
  const E* xb = x + (size_t)bi * S * xrow + (size_t)hi * P;
  float* yb = y + (size_t)bi * S * xrow + (size_t)hi * P;
  const float* dtb = dt + (size_t)bi * S * H + hi;
  const E* Bb = Bm + (size_t)bi * S * N;
  const E* Cb = Cm + (size_t)bi * S * N;
  const size_t hoff = ((size_t)bi * H + hi) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    Hs[p * ldn + n] = h0 != nullptr ? h0[hoff + i] : 0.f;
  }
  const int n_tiles = (L + kT - 1) / kT;

  for (int c0 = 0; c0 < S; c0 += L) {
    // ---- cum = cumsum(A * dt): one element a thread, kThreads at a time
    float carry = 0.f;
    for (int base = 0; base < L; base += kThreads) {
      const int t = base + tid;
      const float d = t < L ? dtb[(size_t)(c0 + t) * H] : 0.f;
      float v = a_h * d;
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
      if (t < L) {
        cum[t] = before + v;
        wts[t] = d;
      }
      carry = total;
      __syncthreads();                // warp_tot is rewritten next round
    }
    const float cum_last = cum[L - 1];

    // ---- y, one query tile of 64 rows at a time
    for (int tq = 0; tq < n_tiles; ++tq) {
      const int t0 = tq * kT;
      load_tile(Cs, ldn, Cb + (size_t)(c0 + t0) * N, N, min(kT, L - t0), N);
      __syncthreads();

      // inter-chunk: exp(cum_t) * C_t . h, h from the previous chunk
      float acc[4][kPJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kPJ; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[kPJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * ldn + n];
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          const int p = tx + 16 * j;
          hv[j] = p < P ? Hs[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kPJ; ++j) acc[i][j] = fmaf(cv[i], hv[j],
                                                        acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        const float e = t < L ? expf(cum[t]) : 0.f;
#pragma unroll
        for (int j = 0; j < kPJ; ++j) acc[i][j] *= e;
      }

      // intra-chunk: source tiles at or below the diagonal
      for (int ts = 0; ts <= tq; ++ts) {
        const int s0 = ts * kT;
        const int rows = min(kT, L - s0);
        load_tile(Bs, ldn, Bb + (size_t)(c0 + s0) * N, N, rows, N);
        load_tile(Xs, P, xb + (size_t)(c0 + s0) * xrow, xrow, rows, P);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j],
                                                        sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            // masked before the exp: s > t never reaches expf
            Ms[(ty * 4 + i) * (kT + 1) + tx + 16 * j] =
                (s <= t && t < L)
                    ? sc[i][j] * expf(cum[t] - cum[s]) * wts[s]
                    : 0.f;
          }
        }
        __syncthreads();
        for (int s = 0; s < rows; ++s) {
          float mv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = Ms[(ty * 4 + i) * (kT + 1) + s];
#pragma unroll
          for (int j = 0; j < kPJ; ++j) {
            const int p = tx + 16 * j;
            const float xv = p < P ? Xs[s * P + p] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(mv[i], xv,
                                                         acc[i][j]);
          }
        }
        __syncthreads();              // the next tile overwrites Bs, Xs, Ms
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        if (t >= L) continue;
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yb[(size_t)(c0 + t) * xrow + p] = acc[i][j];
        }
      }
    }

    // ---- state: h = exp(cum_L) h + sum_s (exp(cum_L - cum_s) dt_s) x_s B_s
    for (int t = tid; t < L; t += kThreads)
      wts[t] = expf(cum_last - cum[t]) * wts[t];
    __syncthreads();
    float up[kPJ][kNJ];
#pragma unroll
    for (int i = 0; i < kPJ; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) up[i][j] = 0.f;
    for (int ts = 0; ts < n_tiles; ++ts) {
      const int s0 = ts * kT;
      const int rows = min(kT, L - s0);
      load_tile(Bs, ldn, Bb + (size_t)(c0 + s0) * N, N, rows, N);
      load_tile(Xs, P, xb + (size_t)(c0 + s0) * xrow, xrow, rows, P);
      __syncthreads();
      for (int s = 0; s < rows; ++s) {
        const float w = wts[s0 + s];
        float xv[kPJ], bv[kNJ];
#pragma unroll
        for (int i = 0; i < kPJ; ++i) {
          const int p = ty + 16 * i;
          xv[i] = p < P ? Xs[s * P + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int n = tx + 16 * j;
          bv[j] = n < N ? Bs[s * ldn + n] * w : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kPJ; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) up[i][j] = fmaf(xv[i], bv[j],
                                                        up[i][j]);
      }
      __syncthreads();
    }
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < kPJ; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int n = tx + 16 * j;
        if (p < P && n < N)
          Hs[p * ldn + n] = decay * Hs[p * ldn + n] + up[i][j];
      }
    }
    __syncthreads();                  // the next chunk reads the new state
  }

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    hN[hoff + i] = Hs[p * ldn + n];
  }
}

template <typename E>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* h0, void* y, void* hN, int Bsz, int S,
           int H, int P, int N, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, L);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, Bsz);
  ssd_scan_kernel<E><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const E*>(Bm),
      static_cast<const E*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hN), S, H, P, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: x [B, S, H, P], Bm and Cm [B, S, N], all bf16 (f32 = 0) or
// all f32 (f32 = 1); dt [B, S, H], A [H], h0 [B, H, P, N] (or NULL: a zero
// state) in f32; y [B, S, H, P] and hN [B, H, P, N] f32 outputs; contiguous
// device pointers; S a multiple of the chunk length L (<= 1024); P <= 64,
// N <= 128; `stream` is a cudaStream_t.  Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0,
                        void* y, void* hN, int B, int S, int H, int P, int N,
                        int L, int f32, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || L < 1 || L > kMaxChunk || S % L != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return launch<float>(x, dt, A, Bm, Cm, h0, y, hN, B, S, H, P, N, L, st);
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hN, B, S, H, P, N, L,
                               st);
}
