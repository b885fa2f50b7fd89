// Fused p50/p95/p99 head of the vector runtime, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/vector_quantiles.py:
//   fused_quantiles (:57, body _quantile_kernel) -> fused_quantiles
//
// Each row of the [C, K] latency matrix holds counts[row] samples, then
// +inf.  Non-negative f32 values bitcast to u32 keep their order, so an
// exact radix select finds each of the 6 order statistics (floor and
// ceil rank of the three quantiles).  The selected values are true
// elements, so the result is bit-equal to a full sort followed by the
// same rank and lerp arithmetic (repro_torch/kernels/ref.py
// fused_quantiles).  Only the first min(counts[row], K) values are read:
// past them the row holds +inf, which no rank below the count selects.
//
// What bounds it: one read of the row's samples from device memory is
// the bytes bound; the selection is integer work on data already on
// chip, one shared-memory increment a value a round.  The design:
// - A row is split over a thread-block cluster of 1, 2, 4 or 8 blocks
//   (the wrapper's launch_plan).  Each block copies its slice into
//   shared memory once, by bulk copies of the copy engine that complete
//   on an mbarrier (a scalar head and tail where the slice does not
//   start or end on a 16-byte boundary), and every round reads it there.
// - 8-bit digits, most significant first: 4 rounds instead of 32.  Each
//   round builds a 256-bin histogram of the digit over the values whose
//   higher digits match a rank's prefix; ranks whose prefixes agree
//   share one histogram (at most 6 distinct prefixes a round).  The
//   compares are unrolled for the round's number of prefixes.
// - The first digit (sign and 7 exponent bits) of latencies falls into a
//   handful of bins, and ties fall into one bin every round, so the lanes
//   of a warp often increment one word together.  The increment is one
//   predicated shared-memory add of 1 (no branch), which the hardware
//   performs once per distinct address of the warp (ATOMS.POPC.INC):
//   one copy of each histogram measured as fast on the H100 as 16
//   copies spread over the lanes, on all-tie rows too (PERF.md).
// - The cluster's histograms are summed in the leader block (rank 0)
//   through distributed shared memory: each block adds its nonzero bins
//   to the leader's total (red.shared::cluster), and after one cluster
//   barrier every block reads the total and selects the same digits, with
//   no broadcast.  The totals rotate over three buffers, so the leader
//   zeroes the next round's while this round's is read.
// - A digit is chosen by the rule of the bit loop it replaces: the
//   largest digit d whose values below it number <= the rank.
// - Rows too long for the cluster's shared memory (K past ~400k) take
//   the same kernel with the slice streamed from device memory in every
//   round instead of held (kResident = false).
//
// Built with --fmad=false: the lerp a + (b - a) * t rounds the product
// before the sum, exactly as the separate PyTorch ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kQ = 3;                 // p50, p95, p99
constexpr int kR = 2 * kQ;            // floor and ceil rank of each
constexpr int kThreads = 512;
constexpr int kBins = 256;            // 8-bit digits
constexpr int kRounds = 4;
constexpr int kMaxCluster = 8;
constexpr int kBatch = 4;             // 16-byte groups in flight a thread
constexpr int kCopyBytes = 4096;      // bytes of one bulk copy
// dynamic shared memory past the resident slice (must match the
// wrapper's HIST_BYTES): the block's histograms, one a group, and the
// cluster's (used in the leader block; three buffers, one a round)
constexpr int kHistWords = kR * kBins;
constexpr int kTotals = 3;
constexpr int kHistBytes = 4 * (kHistWords + kTotals * kHistWords);

// The distinct prefixes of the 6 ranks, gp[0..ng), and the group of
// each rank.
struct Groups {
  uint32_t gp[kR];
  int grp[kR];
  int ng;
};

__device__ __forceinline__ Groups make_groups(const uint32_t* prefix) {
  Groups G;
  G.ng = 0;
#pragma unroll
  for (int i = 0; i < kR; ++i) G.gp[i] = 0u;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const uint32_t p = prefix[j];
    int g = G.ng;
#pragma unroll
    for (int i = kR - 1; i >= 0; --i)
      if (i < G.ng && G.gp[i] == p) g = i;
#pragma unroll
    for (int i = 0; i < kR; ++i)
      if (g == G.ng && i == g) G.gp[i] = p;
    G.grp[j] = g;
    G.ng += g == G.ng;
  }
  return G;
}

// The block's rank in its cluster, and the cluster's size.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// A cluster barrier (release, acquire); a block barrier when the
// cluster is one block.
__device__ __forceinline__ void sync_cluster(int cs) {
  if (cs == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}
// The shared::cluster address of this block's `p` in block `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void cluster_add(uint32_t addr, uint32_t v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;\n"
               :: "r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 cluster_load4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr) : "memory");
  return v;
}
// One more in the shared-memory word at `addr` where `on`: a predicated
// add, no branch around it.
__device__ __forceinline__ void count_if(uint32_t addr, bool on) {
  asm volatile("{\n"
               ".reg .pred p;\n"
               "setp.ne.u32 p, %1, 0;\n"
               "@p red.shared.add.u32 [%0], 1;\n"
               "}\n" :: "r"(addr), "r"((uint32_t)on));
}

// The mbarrier that the slice's bulk copies complete on (one arrival, by
// the thread that initialises it, with the bytes to expect).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// `bytes` (a multiple of 16) global -> shared by the copy engine; both
// addresses 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <bool kResident>
__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  if constexpr (kResident) return *reinterpret_cast<const uint4*>(p);
  else return __ldg(reinterpret_cast<const uint4*>(p));
}
template <bool kResident>
__device__ __forceinline__ uint32_t load1(const uint32_t* p) {
  if constexpr (kResident) return *p;
  else return __ldg(p);
}

// Positions [p0, p1) of src (src 16-byte aligned): whole 16-byte groups
// [q0, q1) as vectors, the rest (a head and a tail of at most 3 each)
// one by one.
struct Span {
  int p0, p1, q0, q1, h1, t0;
  __device__ __forceinline__ Span(int a, int b) : p0(a), p1(b) {
    q0 = (a + 3) >> 2;
    q1 = b >> 2;
    h1 = min(4 * q0, b);
    t0 = max(4 * q1, h1);
  }
};

// Adds round kRound's digit of every value of the span whose higher
// digits match one of the kNg groups' prefixes to that group's
// histogram.
template <int kRound, bool kResident, int kNg>
__device__ __forceinline__ void accumulate(const uint32_t* src,
                                           const Span& sp, const Groups& G,
                                           uint32_t* hist) {
  const uint32_t at = smem_addr(hist);
  constexpr int kShift = 24 - 8 * kRound;
  auto visit = [&](uint32_t u) {
    uint32_t a = at;
    bool on = true;
    if constexpr (kRound > 0) {
      const uint32_t hi = u >> (32 - 8 * kRound);
      on = hi == G.gp[0];
#pragma unroll
      for (int i = 1; i < kNg; ++i) {
        a = hi == G.gp[i] ? at + 4 * i * kBins : a;
        on |= hi == G.gp[i];
      }
    }
    count_if(a + 4 * ((u >> kShift) & 0xffu), on);
  };
  // kBatch groups are loaded before any is counted: the adds would
  // otherwise hold each later load of the slice behind them
  for (int q0 = sp.q0 + threadIdx.x; q0 < sp.q1; q0 += kBatch * kThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * kThreads;
      if (q < sp.q1) v[b] = load4<kResident>(src + 4 * q);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (q0 + b * kThreads < sp.q1) {
        visit(v[b].x);
        visit(v[b].y);
        visit(v[b].z);
        visit(v[b].w);
      }
    }
  }
  if (sp.p0 + (int)threadIdx.x < sp.h1)
    visit(load1<kResident>(src + sp.p0 + threadIdx.x));
  if (sp.t0 + (int)threadIdx.x < sp.p1)
    visit(load1<kResident>(src + sp.t0 + threadIdx.x));
}

// One round's histogram pass, its compares unrolled for the round's
// number of groups (a uniform branch).
template <int kRound, bool kResident>
__device__ __forceinline__ void histogram(const uint32_t* src, const Span& sp,
                                          const Groups& G, uint32_t* hist) {
  if constexpr (kRound == 0) {
    accumulate<0, kResident, 1>(src, sp, G, hist);  // one prefix, empty
  } else {
    switch (G.ng) {
      case 1: accumulate<kRound, kResident, 1>(src, sp, G, hist); break;
      case 2: accumulate<kRound, kResident, 2>(src, sp, G, hist); break;
      case 3: accumulate<kRound, kResident, 3>(src, sp, G, hist); break;
      case 4: accumulate<kRound, kResident, 4>(src, sp, G, hist); break;
      case 5: accumulate<kRound, kResident, 5>(src, sp, G, hist); break;
      default: accumulate<kRound, kResident, 6>(src, sp, G, hist); break;
    }
  }
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
fused_quantiles_kernel(const float* __restrict__ lat,
                       const int* __restrict__ counts,
                       float* __restrict__ out, int K, int width) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t s_prefix[kR];   // digits chosen so far, MSB first
  __shared__ uint32_t s_rank[kR];     // rank among the prefix's values
  __shared__ uint64_t s_bar;          // the slice's bulk copies
  const int cs = cluster_size();
  const int crank = cluster_rank();
  const int row = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int n = counts[row];
  if (n <= 0) {                       // the whole cluster leaves here
    if (crank == 0 && tid < kQ)
      out[(size_t)row * kQ + tid] = __int_as_float(0x7fc00000);
    return;
  }
  const int m = min(n, K);            // values read; ranks clamp below m
  uint32_t* data = smem;              // the resident slice, 16-byte aligned
  uint32_t* hist = smem + (kResident ? width + 4 : 0);
  uint32_t* total = hist + kHistWords;

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
  if (tid < kR) {
    s_prefix[tid] = 0u;
    // the sort's gather clamps its index into the row
    s_rank[tid] = (uint32_t)min(rank[tid], m - 1);
  }

  // this block's slice of the m values, split evenly over the cluster
  const int w = ((m + cs - 1) / cs + 3) & ~3;
  const int j0 = min(crank * w, m), j1 = min(j0 + w, m);
  const uint32_t* rowp = reinterpret_cast<const uint32_t*>(lat) +
                         (size_t)row * K;
  const int mis = (int)((reinterpret_cast<uintptr_t>(rowp + j0) >> 2) & 3);
  // position p of src is value j0 - mis + p; src is 16-byte aligned
  const uint32_t* gsrc = rowp + j0 - mis;
  const Span sp(mis, mis + (j1 - j0));
  for (int i = tid; i < kHistWords; i += kThreads) hist[i] = 0u;
  if (crank == 0)
    for (int i = tid; i < kHistWords; i += kThreads) total[i] = 0u;
  if constexpr (kResident) {
    // the whole 16-byte groups by the copy engine, head and tail by hand
    const int bytes = 16 * max(sp.q1 - sp.q0, 0);
    if (tid < 32 && bytes > 0) {      // warp 0: lane i issues copies i + 32k
      if (tid == 0) {
        mbar_init(&s_bar, 1);
        mbar_expect_tx(&s_bar, bytes);
      }
      __syncwarp();
      for (int off = tid * kCopyBytes; off < bytes; off += 32 * kCopyBytes)
        bulk_copy(data + 4 * sp.q0 + off / 4, gsrc + 4 * sp.q0 + off / 4,
                  min(kCopyBytes, bytes - off), &s_bar);
    }
    if (sp.p0 + tid < sp.h1) data[sp.p0 + tid] = __ldg(gsrc + sp.p0 + tid);
    if (sp.t0 + tid < sp.p1) data[sp.t0 + tid] = __ldg(gsrc + sp.t0 + tid);
    __syncthreads();                  // the mbarrier is initialised
    if (bytes > 0) mbar_wait(&s_bar, 0);
  }
  // the slice, the zeroed histograms and the leader's first total are
  // ready, and every block of the cluster has started (before any remote
  // access)
  sync_cluster(cs);
  const uint32_t* src = kResident ? data : gsrc;

  for (int r = 0; r < kRounds; ++r) {
    const Groups G = make_groups(s_prefix);
    switch (r) {
      case 0: histogram<0, kResident>(src, sp, G, hist); break;
      case 1: histogram<1, kResident>(src, sp, G, hist); break;
      case 2: histogram<2, kResident>(src, sp, G, hist); break;
      default: histogram<3, kResident>(src, sp, G, hist); break;
    }
    __syncthreads();
    // add the block's nonzero bins to the leader's total of this round,
    // zeroing them; the leader zeroes the total of the next round (last
    // read two cluster barriers ago)
    const uint32_t lead = map_rank(total + (r % kTotals) * kHistWords, 0);
    for (int e = tid; e < G.ng * kBins; e += kThreads) {
      const uint32_t v = hist[e];
      hist[e] = 0u;
      if (v) cluster_add(lead + 4 * e, v);
    }
    if (crank == 0) {
      uint32_t* next = total + ((r + 1) % kTotals) * kHistWords;
      for (int e = tid; e < kHistWords; e += kThreads) next[e] = 0u;
    }
    sync_cluster(cs);                 // the round's total is complete
    // warp j picks rank j's digit: the largest d with the group's values
    // below d (exclusive prefix over the bins) <= the rank
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < kR) {
      const uint32_t prefix = s_prefix[warp], kk = s_rank[warp];
      __syncwarp();
      int g = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j) g = j == warp ? G.grp[j] : g;
      const uint32_t h = lead + 4 * (g * kBins + lane * 8);
      const uint4 a = cluster_load4(h);
      const uint4 b = cluster_load4(h + 16);
      const uint32_t c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += c[i];
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      uint32_t below = incl - sum;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (below <= kk && kk < below + c[i]) {
          s_prefix[warp] = (prefix << 8) | (uint32_t)(lane * 8 + i);
          s_rank[warp] = kk - below;
        }
        below += c[i];
      }
    }
    __syncthreads();
  }

  if (crank == 0 && tid == 0) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const float a = __uint_as_float(s_prefix[j]);
      const float b = __uint_as_float(s_prefix[kQ + j]);
      const float t = pos[j] - (float)rank[j];
      const float v = t >= 0.5f ? b - (b - a) * (1.f - t) : a + (b - a) * t;
      out[(size_t)row * kQ + j] = v;
    }
  }
  sync_cluster(cs);                   // the leader stays while read
}

template <bool kResident>
cudaError_t launch(const float* lat, const int* counts, float* out, int C,
                   int K, int cs, int width, cudaStream_t stream) {
  const size_t smem = kHistBytes + (kResident ? 4 * ((size_t)width + 4) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      fused_quantiles_kernel<kResident>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C * (unsigned)cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fused_quantiles_kernel<kResident>, lat,
                            counts, out, K, width);
}

}  // namespace

// C entry point: lat [C, K] f32, counts [C] int32, out [C, 3] f32, all
// device pointers; `stream` is a cudaStream_t.  The launch plan comes
// from the wrapper (vector_quantiles.launch_plan): `cluster` blocks a
// row (1, 2, 4 or 8), `width` the words of shared memory a block holds
// of its slice (a multiple of 4, >= ceil(K / cluster)) when `resident`,
// else the slice is streamed from device memory every round.  Returns
// cudaGetLastError()'s code for the launch: 0 when it was accepted.
extern "C" int fused_quantiles(const void* lat, const void* counts,
                               void* out, int C, int K, int cluster,
                               int width, int resident, void* stream) {
  if (C < 1 || K < 1 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 ||
      (resident && (width % 4 != 0 || (long long)width * cluster < K)))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lat);
  const int* c = static_cast<const int*>(counts);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = resident
      ? launch<true>(l, c, o, C, K, cluster, width, st)
      : launch<false>(l, c, o, C, K, cluster, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
