// Flash attention for prefill, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
//   flash_attention (body _kernel) -> flash_attention
//
// q [B, S, H, hd], k and v [B, T, KV, hd] and out [B, S, H, hd], all bf16
// (the served model) or all f32 (a model run in f32).  Query head h reads
// KV head h / (H / KV) (GQA).  Query row i sits
// at position i and key j at position j; a key counts for row i when
// (causal) j <= i and (window > 0) j > i - window.
//
// One block per (64-row query tile, head, batch row).  The TPU ran the KV
// tiles as the innermost, sequential grid axis with (m, l, acc) in VMEM
// scratch; here the block loops over 64-key tiles itself and keeps m and
// l in shared memory and acc in registers, all in f32.  Tiles that the
// causal or window mask covers for every row of the block are skipped.
// Any S and T are taken (ragged tiles are masked), and any head_dim up to
// 256: each thread holds 4 rows x ceil(hd / 16) columns of acc, with the
// column count a template cap (16 * DPT >= hd) and a guard for the rest,
// so hd = 96 runs on the cap of 128.
//
// Numerics.  Logits are f32 dot products, scaled after the product, as
// the reference oracle does (repro/kernels/ref.py naive_attention).  A
// masked key gets the finite logit -1e30, as in the oracle, so a row
// whose every key is masked (only possible with a window, when the row
// sits window or more positions past the last key) averages v over all T
// keys, like the oracle's softmax; the Pallas kernel writes 0 there.  A
// block holding such a row visits every tile.  Like the Pallas kernel,
// and unlike the oracle, which casts the normalised probabilities to v's
// dtype before P.V, this kernel keeps the unnormalised p in f32 and
// divides acc by l at the end.  In f32 the two agree up to the order of
// f32 sums; in bf16 they differ by the rounding of p to bf16 (at most
// 2^-9 relative per weight) plus one rounding of the output each.
//
// What bounds it: at the prefill shapes of the serving path (S = T up to
// 4096, 32 heads, hd 96) the work is compute: 4 * hd flops per unmasked
// (query, key) pair against bf16 reads of q, k, v once.  This first
// version multiplies on the f32 CUDA cores from shared memory (each
// thread a 4 x 4 block of scores, then a 4 x DPT block of acc), not on
// the tensor cores: mma / wgmma with TMA-fed tiles is a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;       // 16 x 16: 4 rows x 4 keys each
constexpr int kMaxHd = 256;
constexpr float kNeg = -1e30f;      // the reference's mask value

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

template <typename E>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T, int H, int KV, int hd, int causal, int window,
             float scale, cudaStream_t st) {
  if (hd <= 32)
    return launch<E, 2>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                        scale, st);
  if (hd <= 64)
    return launch<E, 4>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                        scale, st);
  if (hd <= 128)
    return launch<E, 8>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                        scale, st);
  return launch<E, 16>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                       scale, st);
}

}  // namespace

// C entry point: q [B, S, H, hd], k and v [B, T, KV, hd], out [B, S, H, hd],
// contiguous device pointers, all bf16 (f32 = 0) or all f32 (f32 = 1);
// causal 0/1; window 0 = none, else the number of positions a query sees
// back (>= 1); scale multiplies the f32 logits; `stream` is a
// cudaStream_t.  Returns cudaGetLastError() after the launch: 0 when the
// launch was accepted.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int T, int H, int KV,
                               int hd, int causal, int window, float scale,
                               int f32, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H < KV || H % KV != 0 ||
      hd < 1 || hd > kMaxHd || window < 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return dispatch<float>(q, k, v, out, B, S, T, H, KV, hd, causal, window,
                           scale, st);
  return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, hd, causal,
                                 window, scale, st);
}
