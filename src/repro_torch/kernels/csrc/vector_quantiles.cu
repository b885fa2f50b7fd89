// Fused p50/p95/p99 head of the vector runtime, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/vector_quantiles.py:
//   fused_quantiles (body _quantile_kernel) -> fused_quantiles
//
// One thread block per row of the [C, K] latency matrix (+inf padded
// past each row's count).  Non-negative f32 values bitcast to u32 keep
// their order, so an exact radix select finds each order statistic: for
// each of the 6 target ranks (floor/ceil of the three quantiles), 32
// MSB-first rounds count the row's values below prefix|bit and keep the
// bit while that count is <= the rank.  All 6 ranks share one pass over
// the row per round.  The selected values are true elements, so the
// result is bit-equal to a full sort followed by the same rank and lerp
// arithmetic (repro_torch/kernels/ref.py fused_quantiles).
//
// What bounds it: the row is read once per round (32 times) from L2
// after the first read from device memory, against a bytes bound of one
// read.  Keeping the row in shared memory would take 128 KB at K = 32768
// (dynamic shared memory with the opt-in) and is left for a later
// change: simple and right first.
//
// Built with --fmad=false: the lerp a + (b - a) * t rounds the product
// before the sum, exactly as the separate PyTorch ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 3;                 // p50, p95, p99
constexpr int kR = 2 * kQ;            // floor and ceil rank of each
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fused_quantiles_kernel(const float* __restrict__ lat,
                       const int* __restrict__ counts,
                       float* __restrict__ out, int K) {
  __shared__ int red[kR][kWarps];
  const int row = blockIdx.x;
  const uint32_t* u = reinterpret_cast<const uint32_t*>(lat) +
                      (size_t)row * K;
  const int n = counts[row];
  // np.percentile's ranks: pos = f32(q / 100) * (n - 1), floor and ceil
  const float qc[kQ] = {(float)(50.0 / 100.0), (float)(95.0 / 100.0),
                        (float)(99.0 / 100.0)};
  const float nf1 = (float)n - 1.f;
  float pos[kQ];
  int rank[kR];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    pos[j] = qc[j] * nf1;
    rank[j] = (int)floorf(pos[j]);
    rank[kQ + j] = (int)ceilf(pos[j]);
  }
  uint32_t prefix[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) prefix[j] = 0u;

  for (int b = 31; b >= 0; --b) {
    const uint32_t bit = 1u << b;
    int cnt[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) cnt[j] = 0;
    for (int i = threadIdx.x; i < K; i += kThreads) {
      const uint32_t v = __ldg(u + i);
#pragma unroll
      for (int j = 0; j < kR; ++j) cnt[j] += v < (prefix[j] | bit);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        cnt[j] += __shfl_xor_sync(0xffffffffu, cnt[j], o);
    }
    __syncthreads();                    // earlier readers of red are done
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int j = 0; j < kR; ++j) red[j][threadIdx.x >> 5] = cnt[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      int below = 0;
      for (int w = 0; w < kWarps; ++w) below += red[j][w];
      // fewer than rank+1 values below the candidate: the rank-th order
      // statistic is >= the candidate, so the bit survives
      if (below <= rank[j]) prefix[j] |= bit;
    }
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const float a = __uint_as_float(prefix[j]);
      const float b = __uint_as_float(prefix[kQ + j]);
      const float t = pos[j] - (float)rank[j];
      const float v = t >= 0.5f ? b - (b - a) * (1.f - t) : a + (b - a) * t;
      out[(size_t)row * kQ + j] = n > 0 ? v : __int_as_float(0x7fc00000);
    }
  }
}

}  // namespace

// C entry point: lat [C, K] f32, counts [C] int32, out [C, 3] f32, all
// device pointers; `stream` is a cudaStream_t.  Returns cudaGetLastError()
// after the launch: 0 when the launch was accepted.
extern "C" int fused_quantiles(const void* lat, const void* counts,
                               void* out, int C, int K, void* stream) {
  if (C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  fused_quantiles_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(lat), static_cast<const int*>(counts),
      static_cast<float*>(out), K);
  return (int)cudaGetLastError();
}
