// Flash-decode attention of one query token per row, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:
//   decode_attention (body _kernel) -> decode_attention
//
// q [B, H, hd] (bf16 for the served model, f32 for a model run in f32),
// k and v [B, T, KV, hd] bf16 (the decode cache, bf16 whatever the
// model's dtype), out [B, H, hd] bf16 (v's dtype, as the oracle's P.V);
// lengths [B], key_positions [B, T] (the absolute position each cache
// slot holds, -1 = empty; a ring for sliding-window layers) and q_pos [B],
// all int32.  Key j counts for row b when 0 <= key_positions[b, j] <
// lengths[b] and, with window > 0, key_positions[b, j] > q_pos[b] - window.
//
// One block per (KV head, batch row): the G = H / KV query heads that
// read that KV head go together, so each key and value is read once for
// all G of them (the TPU kernel put G on the MXU's M dimension).  The
// TPU's sequential grid axis over T becomes the block's loops over T:
//   1. each warp takes keys in turn, its lanes split head_dim and reduce
//      the G dot products by shuffles; the scaled logits go to a scratch
//      row per query head ([B, H, T] f32, from the wrapper) and each
//      row's max m is kept;
//   2. one warp per query head sums l = sum_j exp(s_j - m);
//   3. tile by tile, the threads turn logits into probabilities
//      p_j = exp(s_j - m) / l, rounded to bf16, in shared memory; each
//      thread owns up to two head_dim columns of the G f32 accumulators
//      and streams v rows with coalesced loads.
// Split-K across T (several blocks per row and a combine pass) is a later
// change.
//
// Numerics: those of the reference oracle (repro/kernels/ref.py
// decode_attention), operation for operation: f32 logits scaled after the
// product, masked keys at the finite -1e30 (a row with no valid key
// averages v over all T slots; the Pallas kernel writes 0 there), the
// softmax normalised in f32, the probabilities rounded to v's dtype
// before P.V, f32 accumulation, one rounding of the output.  Kernel and
// plain version differ only where their f32 sums, taken in other orders,
// round a probability or an output to the other side of a bf16 step.
// (The Pallas kernel, and the prefill kernel flash_attention.cu, keep p in
// f32 instead; matching the oracle here keeps the card's decode within
// f32 noise of the CPU's in a model run in f32.)
//
// What bounds it: bytes.  Every key and value of the cache is read once
// (2 * B * T * KV * hd * 2 bytes; the scratch adds 4 bytes per (query
// head, key) written and read back) for 4 * hd flops per (query head,
// key): G flops per byte, far below the card's ~295 bf16 flops per byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 128;            // keys per tile of pass 3
constexpr int kMaxHd = 2 * kThreads;
constexpr float kNeg = -1e30f;      // the reference's mask value

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename TQ, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lengths,
                        const int* __restrict__ kpos,
                        const int* __restrict__ qpos,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ logits, int T, int H, int KV,
                        int hd, int window, float scale) {
  __shared__ float qs[MAXG][kMaxHd];
  __shared__ float ps[MAXG][kBT];   // this tile's probabilities
  __shared__ float wmax[kWarps][MAXG];
  __shared__ float m_s[MAXG], l_s[MAXG];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const size_t k_row = (size_t)KV * hd;
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  const TQ* qb = q + head0 * hd;
  const __nv_bfloat16* kb = k + (size_t)b * T * k_row + (size_t)kvh * hd;
  const __nv_bfloat16* vb = v + (size_t)b * T * k_row + (size_t)kvh * hd;
  float* sb = logits + head0 * T;   // [G][T]: this block's rows
  const int* kp_b = kpos + (size_t)b * T;
  const int len = lengths[b];
  const int qp = qpos[b];

  for (int i = tid; i < G * hd; i += kThreads)
    qs[i / hd][i % hd] = to_f32(qb[i]);
  __syncthreads();

  // 1. logits and row maxima
  float mx[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) mx[g] = -INFINITY;
  for (int t = warp; t < T; t += kWarps) {
    const __nv_bfloat16* kr = kb + (size_t)t * k_row;
    float part[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float kv = __bfloat162float(kr[d]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) part[g] = fmaf(qs[g][d], kv, part[g]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
    }
    const int p = kp_b[t];
    bool ok = p >= 0 && p < len;
    if (window > 0) ok = ok && p > qp - window;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      const float s = ok ? part[g] * scale : kNeg;
      mx[g] = fmaxf(mx[g], s);
      if (lane == 0) sb[(size_t)g * T + t] = s;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) wmax[warp][g] = mx[g];
  }
  __syncthreads();                  // also publishes the logits
  if (tid < G) {
    float m = wmax[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w][tid]);
    m_s[tid] = m;                   // finite: every logit is >= kNeg
  }
  __syncthreads();

  // 2. row sums of exp(s - m)
  for (int g = warp; g < G; g += kWarps) {
    const float m = m_s[g];
    float sum = 0.f;
    for (int c = lane; c < T; c += 32) sum += expf(sb[(size_t)g * T + c] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) l_s[g] = sum;    // >= 1: the max term is exp(0)
  }
  __syncthreads();

  // 3. probabilities rounded to bf16, then P.V
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.f;
  for (int t0 = 0; t0 < T; t0 += kBT) {
    const int tn = min(kBT, T - t0);
    for (int i = tid; i < G * tn; i += kThreads) {
      const int g = i / tn, c = i - g * tn;
      const float p = expf(sb[(size_t)g * T + t0 + c] - m_s[g]) / l_s[g];
      ps[g][c] = __bfloat162float(__float2bfloat16(p));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = tid + kThreads * j;
      if (d >= hd) continue;
      for (int tt = 0; tt < tn; ++tt) {
        const float vv = __bfloat162float(vb[(size_t)(t0 + tt) * k_row + d]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g][j] = fmaf(ps[g][tt], vv, acc[g][j]);
      }
    }
    __syncthreads();                // the next tile overwrites ps
  }

  __nv_bfloat16* ob = out + head0 * hd;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = tid + kThreads * j;
    if (d >= hd) continue;
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) ob[(size_t)g * hd + d] = __float2bfloat16(acc[g][j]);
  }
}

template <typename TQ, int MAXG>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* kpos, const void* qpos, void* out, void* logits,
           int B, int T, int H, int KV, int hd, int window, float scale,
           cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_attention_kernel<TQ, MAXG><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(logits), T, H, KV, hd, window, scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             const void* kpos, const void* qpos, void* out, void* logits,
             int B, int T, int H, int KV, int hd, int window, float scale,
             cudaStream_t st) {
  const int G = H / KV;
  if (G == 1)
    return launch<TQ, 1>(q, k, v, lengths, kpos, qpos, out, logits, B, T, H,
                         KV, hd, window, scale, st);
  if (G <= 2)
    return launch<TQ, 2>(q, k, v, lengths, kpos, qpos, out, logits, B, T, H,
                         KV, hd, window, scale, st);
  if (G <= 4)
    return launch<TQ, 4>(q, k, v, lengths, kpos, qpos, out, logits, B, T, H,
                         KV, hd, window, scale, st);
  if (G <= 8)
    return launch<TQ, 8>(q, k, v, lengths, kpos, qpos, out, logits, B, T, H,
                         KV, hd, window, scale, st);
  return launch<TQ, 16>(q, k, v, lengths, kpos, qpos, out, logits, B, T, H,
                        KV, hd, window, scale, st);
}

}  // namespace

// C entry point: q [B, H, hd] (bf16 when q_f32 = 0, f32 when 1), k and v
// [B, T, KV, hd] bf16, out [B, H, hd] bf16, logits [B, H, T] f32 scratch;
// lengths [B], key_positions [B, T], q_pos [B], int32; all contiguous
// device pointers.  window 0 = none; scale multiplies the f32 logits;
// `stream` is a cudaStream_t.  Needs H / KV <= 16 and hd <= 256.  Returns
// cudaGetLastError() after the launch: 0 when the launch was accepted.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, const void* kpos,
                                const void* qpos, void* out, void* logits,
                                int B, int T, int H, int KV, int hd,
                                int window, float scale, int q_f32,
                                void* stream) {
  if (B < 1 || T < 1 || KV < 1 || H < KV || H % KV != 0 || H / KV > 16 ||
      hd < 1 || hd > kMaxHd || window < 0 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_f32)
    return dispatch<float>(q, k, v, lengths, kpos, qpos, out, logits, B, T,
                           H, KV, hd, window, scale, st);
  return dispatch<__nv_bfloat16>(q, k, v, lengths, kpos, qpos, out, logits,
                                 B, T, H, KV, hd, window, scale, st);
}
