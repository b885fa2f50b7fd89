// Split-K flash-decode attention of one query token per row, for Hopper
// (sm_90a).
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
// Grid (KV, B, n_split): a block takes block_t consecutive cache slots
// (a split; the last one may be shorter) for the G = H / KV query heads
// that read one KV head, so each key and value is read once for all G
// (the TPU kernel put G on the MXU's M dimension).  The TPU's sequential
// grid axis over T becomes n_split blocks side by side, in three
// launches chained by programmatic dependent launch (a launch's blocks
// start while the previous one runs and wait, griddepcontrol.wait,
// before they read its output):
//   A. logits: each key row goes to a group of lanes, each lane loading
//      8-element (16-byte) chunks of it, two keys per lane in flight; the
//      group's partial dot products are reduced by shuffles within the
//      group.  A masked slot (empty, past the row's length, outside the
//      window) gets the logit -1e30 without its key being read.  The
//      scaled f32 logits go to a [B, H, T] scratch (and shared memory),
//      the split's m_i = max s and l_i = sum exp(s - m_i) to [B, H,
//      n_split];
//   B. P.V: every block of a row folds all (m_i, l_i) in split order,
//      m = max m_i and l = sum_i l_i exp(m_i - m) (a warp's lanes load
//      32 splits at once; the terms are added in order through
//      shuffles), so every block gets the same m and l; it forms the
//      globally normalised p_j = exp(s_j - m) / l rounded to bf16 (where
//      the oracle rounds it), and threads that own 8-element head_dim
//      chunks, in groups that take every KG-th slot, accumulate p.V in
//      f32, summed through shared memory in group order into the split's
//      f32 partial [B, H, n_split, hd].  A masked slot's value row is
//      skipped when the row has a valid key (its p is then exactly 0); a
//      row with no valid key averages v over all T slots, as the oracle
//      does, and so reads every value.  With one split, B writes the
//      output itself;
//   C. combine: a thread per output element sums its partials in split
//      order and rounds once to bf16.  p is already normalised, so this
//      is a plain sum: no rescale, the same result on every run.
// Two modes serve a decode whose cache is sharded along its slots across
// ranks (a flash-decode across ranks, in two rounds around one exchange):
//   lse_mode 1 (the LSE output): A, then B folds (m_i, l_i) and its
//      first split's block writes each head's log-sum-exp m + log l of
//      this rank's slots (f32 [B, H]); no P.V, no output, no C;
//   lse_mode 2 (the LSE input): the ranks' log-sum-exps combined into the
//      row's L are given; B normalises with it, p = exp(s - L) (m = L,
//      l = 1, no fold), so every rank rounds the same globally normalised
//      p to bf16 as one device would, and the output is this rank's f32
//      partial P.V (B or C write f32, not rounded): the ranks sum their
//      partials and round once.  L > -1e30 exactly when the row has a
//      valid key on some rank, so a rank without one adds zeros.
// Where hd % 8 != 0 or a pointer is not 16-byte aligned, the same kernels
// run with 2-byte element loads (W = 1).
//
// Numerics: those of the reference oracle (repro/kernels/ref.py
// decode_attention): f32 logits scaled after the product, masked keys at
// the finite -1e30 (a row with no valid key averages v over all T slots;
// the Pallas kernel writes 0 there), the softmax normalised in f32, the
// probabilities rounded to v's dtype before P.V, f32 accumulation, one
// rounding of the output.  Kernel and plain version differ only where
// their f32 sums, taken in other orders (l over splits, P.V over key
// groups and splits), round a probability or an output to the other side
// of a bf16 step.  (Per-split online softmax, rescaled in the combine,
// would round an unnormalised p instead; p in f32 moved f32 logits by
// 1.6e-3 in a model run in f32, enough to split greedy tokens.)
//
// What bounds it: bytes.  Every valid key and value is read once
// (4 * hd bytes per (row, valid slot, KV head)), plus 4 bytes per (query
// head, slot) of logits written and read back, for 4 * hd flops per
// (query head, key): G / 2 flops per byte, far below the card's ~295 bf16
// flops per byte.  At the served shapes those bytes take 0.7-10 us at
// 3.35 TB/s, and the chains of dependent memory round trips set the
// time: launch A's positions, keys and logits; launch B's (m, l) fold,
// logits, value rows and partials; launch C's partials.  The split grid
// gives every SM two or more blocks and keeps all of a block's keys in
// flight at once; the dependent launches hide B's and C's start behind
// the launch before.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 128;            // keys per probability tile of launch B
constexpr int kSplitLogits = 2048;  // launch A keeps G * block_t <= this
constexpr int kMaxHd = 256;
constexpr int kMaxG = 16;
constexpr float kNeg = -1e30f;      // the reference's mask value

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

// W consecutive bf16 values of a row, in registers: one 16-byte load for
// W = 8, one 2-byte load for W = 1.
template <int W>
struct Raw;

template <>
struct Raw<8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void clear() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float at(int e) const {   // e: unrolled
    const __nv_bfloat162 h =
        reinterpret_cast<const __nv_bfloat162*>(&r)[e >> 1];
    return (e & 1) ? __high2float(h) : __low2float(h);
  }
};

template <>
struct Raw<1> {
  __nv_bfloat16 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(p);
  }
  __device__ __forceinline__ void clear() { r = __float2bfloat16(0.f); }
  __device__ __forceinline__ float at(int) const {
    return __bfloat162float(r);
  }
};

// acc + q[0:W] . r, q in shared memory (16-byte aligned for W = 8)
template <int W>
__device__ __forceinline__ float dot_chunk(const float* qrow,
                                           const Raw<W>& r, float acc);

template <>
__device__ __forceinline__ float dot_chunk<8>(const float* qrow,
                                              const Raw<8>& r, float acc) {
  const float4 a = reinterpret_cast<const float4*>(qrow)[0];
  const float4 b = reinterpret_cast<const float4*>(qrow)[1];
  acc = fmaf(a.x, r.at(0), acc);
  acc = fmaf(a.y, r.at(1), acc);
  acc = fmaf(a.z, r.at(2), acc);
  acc = fmaf(a.w, r.at(3), acc);
  acc = fmaf(b.x, r.at(4), acc);
  acc = fmaf(b.y, r.at(5), acc);
  acc = fmaf(b.z, r.at(6), acc);
  return fmaf(b.w, r.at(7), acc);
}

template <>
__device__ __forceinline__ float dot_chunk<1>(const float* qrow,
                                              const Raw<1>& r, float acc) {
  return fmaf(qrow[0], r.at(0), acc);
}

__device__ __forceinline__ bool key_ok(int p, int len, int qp, int window) {
  return p >= 0 && p < len && (window == 0 || p > qp - window);
}

// Launch A: logits of one split and its (m_i, l_i).
template <typename TQ, int MAXG, int W>
__global__ void __launch_bounds__(kThreads)
decode_logits_kernel(const TQ* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const int* __restrict__ lengths,
                     const int* __restrict__ kpos,
                     const int* __restrict__ qpos, float* logits,
                     float2* __restrict__ ml, int T, int H, int KV, int hd,
                     int window, float scale, int block_t, int n_split) {
  constexpr int kMaxC = W == 8 ? 4 : 8;   // chunks of a key row per lane
  constexpr int U = 2;                    // keys per lane in flight
  __shared__ __align__(16) float qs[MAXG * kMaxHd];
  __shared__ float ss[kSplitLogits];  // the split's logits, when they fit
  __shared__ float wmax[kWarps][MAXG];
  __shared__ float m_s[MAXG];

  // launch B's blocks may start now: they wait for this grid before
  // reading what it writes
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = H / KV;
  const int t0 = split * block_t, t1 = min(T, t0 + block_t);
  const size_t row = (size_t)KV * hd;
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  const __nv_bfloat16* kb = k + (size_t)b * T * row + (size_t)kvh * hd;
  float* sb = logits + head0 * T;   // [G][T]: this block's rows
  const int* kp = kpos + (size_t)b * T;

  // lanes per key: a power of two, so each lane holds <= kMaxC chunks
  const int C = hd / W;
  int lpk = 1;
  while (lpk * kMaxC < C) lpk <<= 1;
  const int kpw = 32 / lpk;               // keys per warp and step
  const int gl = lane & (lpk - 1), grp = lane / lpk;
  const int step = kWarps * kpw;
  const int base0 = t0 + warp * kpw;
  const int nt = t1 - t0;
  const bool in_smem = G * nt <= kSplitLogits;

  // the first step's slot positions load beside q, lengths and q_pos
  int pk[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = base0 + u * step + grp;
    pk[u] = t < t1 ? kp[t] : -1;
  }
  const int len = lengths[b], qp = qpos[b];
  const TQ* qb = q + head0 * hd;
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f32(qb[i]);
  __syncthreads();

  float mx[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) mx[g] = -INFINITY;
  for (int base = base0; base < t1; base += U * step) {
    Raw<W> kr[U][kMaxC];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * step + grp;
      ok[u] = t < t1 && key_ok(pk[u], len, qp, window);
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int ch = gl + c * lpk;
        if (ok[u] && ch < C)
          kr[u][c].load(kb + (size_t)t * row + ch * W);
        else
          kr[u][c].clear();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {         // the next step's positions
      const int t = base + (U + u) * step + grp;
      pk[u] = t < t1 ? kp[t] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int ch = gl + c * lpk;
        if (ch >= C) continue;
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) part[g] = dot_chunk<W>(qs + g * hd + ch * W, kr[u][c],
                                            part[g]);
      }
      for (int o = lpk >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
      const int t = base + u * step + grp;
      if (t < t1) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) continue;
          const float s = ok[u] ? part[g] * scale : kNeg;
          mx[g] = fmaxf(mx[g], s);
          if ((g & (lpk - 1)) == gl) {
            sb[(size_t)g * T + t] = s;
            if (in_smem) ss[g * nt + t - t0] = s;
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) wmax[warp][g] = mx[g];
  }
  __syncthreads();                  // also publishes the block's logits
  if (tid < G) {
    float m = wmax[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w][tid]);
    m_s[tid] = m;                   // >= -1e30: the split has a slot
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    const float m = m_s[g];
    float sum = 0.f;
    for (int t = t0 + lane; t < t1; t += 32)
      sum += expf((in_smem ? ss[g * nt + t - t0]
                           : __ldcg(sb + (size_t)g * T + t)) - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) ml[(head0 + g) * n_split + split] = make_float2(m, sum);
  }
}

// acc[g] += p[g][j] * v_j over the G heads, for one value row's chunks
template <int MAXG, int CPT, int W>
__device__ __forceinline__ void add_pv(float (&acc)[MAXG][CPT][W],
                                       const float (*ps)[kBT], int j, int G,
                                       const Raw<W> (&vr)[CPT]) {
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) continue;
    const float pg = ps[g][j];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < W; ++e)
        acc[g][c][e] = fmaf(pg, vr[c].at(e), acc[g][c][e]);
  }
}

// Launch B: p.V of one split: its partial, or the output if it is the only one.
template <int MAXG, int W>
__global__ void __launch_bounds__(kThreads)
decode_pv_kernel(const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ lengths,
                 const int* __restrict__ kpos,
                 const int* __restrict__ qpos, const float* logits,
                 const float2* ml, float* part,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ out32,
                 float* lse, int lse_mode, int T, int H, int KV, int hd,
                 int window, int block_t, int n_split) {
  constexpr int kCPT = W == 8 ? 1 : 2;    // head_dim chunks per thread
  constexpr int UB = 4;                   // value rows per thread in flight
  extern __shared__ __align__(16) float red[];   // [KG][G * hd]
  __shared__ float ps[MAXG][kBT];         // this tile's logits, then p
  __shared__ bool vok[kBT];               // this tile's valid slots
  __shared__ float m_s[MAXG], l_s[MAXG];

  asm volatile("griddepcontrol.launch_dependents;");   // launch C
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = H / KV;
  const int t0 = split * block_t, t1 = min(T, t0 + block_t);
  const size_t row = (size_t)KV * hd;
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  const __nv_bfloat16* vb = v + (size_t)b * T * row + (size_t)kvh * hd;
  const float* sb = logits + head0 * T;
  const int* kp = kpos + (size_t)b * T;
  const int len = lengths[b], qp = qpos[b];

  // thread (kg, c0) owns chunks c0 + j * kThreads of head_dim and takes
  // every KG-th slot of a tile
  const int C = hd / W;
  const int Ct = min(C, kThreads);
  const int KG = kThreads / Ct;
  const int kg = tid / Ct, c0 = tid - kg * Ct;
  const bool active = kg < KG;

  float acc[MAXG][kCPT][W];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < kCPT; ++j)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][j][e] = 0.f;

  // launch A's logits and (m_i, l_i) are complete and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (lse_mode == 1 && split != 0) return;   // one block a head group
  if (lse_mode == 2 && tid < G) {            // the rows' L is given
    m_s[tid] = lse[head0 + tid];
    l_s[tid] = 1.f;
  }
  // m = max_i m_i and l = sum_i l_i exp(m_i - m) in split order, the
  // same in every block: a warp per head, its lanes load 32 splits at
  // once, and the terms are added in order through shuffles
  for (int g = warp; g < (lse_mode == 2 ? 0 : G); g += kWarps) {
    const float2* r = ml + (head0 + g) * n_split;
    const float2 e0 = lane < n_split ? __ldcg(r + lane)
                                     : make_float2(-INFINITY, 0.f);
    float m = e0.x;
    for (int i = lane + 32; i < n_split; i += 32)
      m = fmaxf(m, __ldcg(r + i).x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int c = 0; c < n_split; c += 32) {
      const int i = c + lane;
      const float2 e = c == 0 ? e0
          : (i < n_split ? __ldcg(r + i) : make_float2(-INFINITY, 0.f));
      const float term = i < n_split ? e.y * expf(e.x - m) : 0.f;
      const int n = min(32, n_split - c);
      for (int src = 0; src < n; ++src)
        l += __shfl_sync(0xffffffffu, term, src);
    }
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;                   // >= 1: the max term is exp(0)
    }
  }
  if (lse_mode == 1) {
    __syncthreads();
    if (tid < G) lse[head0 + tid] = m_s[tid] + logf(l_s[tid]);
    return;
  }
  bool any_valid = true;
  for (int tile = t0; tile < t1; tile += kBT) {
    const int tn = min(kBT, t1 - tile);
    for (int i = tid; i < tn; i += kThreads)
      vok[i] = key_ok(kp[tile + i], len, qp, window);
    for (int i = tid; i < G * tn; i += kThreads) {
      const int g = i / tn, j = i - g * tn;
      ps[g][j] = __ldcg(sb + (size_t)g * T + tile + j);
    }
    __syncthreads();
    any_valid = m_s[0] > kNeg;      // else every p is 1 / T
    for (int i = tid; i < G * tn; i += kThreads) {
      const int g = i / tn, j = i - g * tn;
      const float p = expf(ps[g][j] - m_s[g]) / l_s[g];
      ps[g][j] = __bfloat162float(__float2bfloat16(p));
    }
    __syncthreads();
    if (active) {
      for (int j0 = kg; j0 < tn; j0 += KG * UB) {
        Raw<W> vr[UB][kCPT];
        bool use[UB];
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const int j = j0 + u * KG;
          use[u] = j < tn && (vok[j] || !any_valid);
#pragma unroll
          for (int c = 0; c < kCPT; ++c) {
            const int ch = c0 + c * kThreads;
            if (use[u] && ch < C)
              vr[u][c].load(vb + (size_t)(tile + j) * row + ch * W);
            else
              vr[u][c].clear();
          }
        }
#pragma unroll
        for (int u = 0; u < UB; ++u)
          if (use[u]) add_pv<MAXG>(acc, ps, j0 + u * KG, G, vr[u]);
      }
    }
    __syncthreads();                // the next tile overwrites ps, vok
  }

  // sum the key groups in order
  const int GH = G * hd;
  if (active) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int c = 0; c < kCPT; ++c) {
        const int ch = c0 + c * kThreads;
        if (ch >= C) continue;
        float* dst = red + (size_t)kg * GH + g * hd + ch * W;
        if constexpr (W == 8) {
          reinterpret_cast<float4*>(dst)[0] = make_float4(
              acc[g][c][0], acc[g][c][1], acc[g][c][2], acc[g][c][3]);
          reinterpret_cast<float4*>(dst)[1] = make_float4(
              acc[g][c][4], acc[g][c][5], acc[g][c][6], acc[g][c][7]);
        } else {
          dst[0] = acc[g][c][0];
        }
      }
    }
  }
  __syncthreads();
  // the output with one split, else the partial [B, H, n_split, hd]
  for (int i = tid; i < GH; i += kThreads) {
    float s = 0.f;
    for (int r = 0; r < KG; ++r) s += red[(size_t)r * GH + i];
    const int g = i / hd, d = i - g * hd;
    if (n_split == 1 && out32 != nullptr)
      out32[head0 * hd + i] = s;
    else if (n_split == 1)
      out[head0 * hd + i] = __float2bfloat16(s);
    else
      part[((head0 + g) * n_split + split) * hd + d] = s;
  }
}

// Launch C: out = the sum of the partials in split order, rounded once;
// a thread per output element, 8 partials in flight.
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* part, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ out32, int n_out, int hd,
                      int n_split) {
  asm volatile("griddepcontrol.wait;" ::: "memory");   // launch B's partials
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int bh = i / hd, d = i - bh * hd;
  const float* pr = part + (size_t)bh * n_split * hd + d;
  float s = 0.f;
  for (int sp = 0; sp < n_split; sp += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = sp + u < n_split ? __ldcg(pr + (size_t)(sp + u) * hd) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (sp + u < n_split) s += x[u];
  }
  if (out32 != nullptr)
    out32[i] = s;
  else
    out[i] = __float2bfloat16(s);
}

template <typename TQ, int MAXG, int W>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* kpos, const void* qpos, void* out, void* logits,
           void* ml, void* part, void* lse, int lse_mode, int B, int T,
           int H, int KV, int hd, int window, float scale, int block_t,
           int n_split, cudaStream_t stream) {
  // lse_mode 2 writes an f32 output
  __nv_bfloat16* out16 =
      lse_mode == 2 ? nullptr : static_cast<__nv_bfloat16*>(out);
  float* out32 = lse_mode == 2 ? static_cast<float*>(out) : nullptr;
  const dim3 grid(KV, B, n_split);
  const int* len = static_cast<const int*>(lengths);
  const int* kp = static_cast<const int*>(kpos);
  const int* qp = static_cast<const int*>(qpos);
  decode_logits_kernel<TQ, MAXG, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k), len,
      kp, qp, static_cast<float*>(logits), static_cast<float2*>(ml), T, H,
      KV, hd, window, scale, block_t, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int C = hd / W;
  const int KG = kThreads / (C < kThreads ? C : kThreads);
  const size_t smem = (size_t)KG * (H / KV) * hd * sizeof(float);
  if (smem > 48 * 1024) {           // up to 64 KB, at G > 12
    err = cudaFuncSetAttribute(decode_pv_kernel<MAXG, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  PdlConfig b_cfg(grid, kThreads, smem, stream);
  err = cudaLaunchKernelEx(
      &b_cfg.cfg, decode_pv_kernel<MAXG, W>,
      static_cast<const __nv_bfloat16*>(v), len, kp, qp,
      static_cast<const float*>(logits), static_cast<const float2*>(ml),
      static_cast<float*>(part), out16, out32, static_cast<float*>(lse),
      lse_mode, T, H, KV, hd, window, block_t, n_split);
  if (err != cudaSuccess || n_split == 1 || lse_mode == 1) return (int)err;
  const int n_out = B * H * hd;
  PdlConfig c_cfg(dim3((n_out + kThreads - 1) / kThreads), kThreads, 0,
                  stream);
  err = cudaLaunchKernelEx(&c_cfg.cfg, decode_combine_kernel,
                           static_cast<const float*>(part), out16, out32,
                           n_out, hd, n_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, int W>
int dispatch(int G, const void* q, const void* k, const void* v,
             const void* lengths, const void* kpos, const void* qpos,
             void* out, void* logits, void* ml, void* part, void* lse,
             int lse_mode, int B, int T, int H, int KV, int hd, int window,
             float scale, int block_t, int n_split, cudaStream_t st) {
#define DECODE_LAUNCH(MG)                                                     \
  return launch<TQ, MG, W>(q, k, v, lengths, kpos, qpos, out, logits, ml,     \
                           part, lse, lse_mode, B, T, H, KV, hd, window,      \
                           scale, block_t, n_split, st)
  if (G == 1) DECODE_LAUNCH(1);
  if (G <= 2) DECODE_LAUNCH(2);
  if (G <= 4) DECODE_LAUNCH(4);
  if (G <= 8) DECODE_LAUNCH(8);
  DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}

}  // namespace

// C entry point: q [B, H, hd] (bf16 when q_f32 = 0, f32 when 1), k and v
// [B, T, KV, hd] bf16, out [B, H, hd] bf16; lengths [B], key_positions
// [B, T], q_pos [B], int32; scratch: logits [B, H, T] f32, ml [B, H,
// n_split] float2 (m_i, l_i), part [B, H, n_split, hd] f32 (unused when
// n_split = 1); all contiguous device pointers, ml 8-byte aligned.
// n_split = ceil(T / block_t).  window 0 = none; scale multiplies the
// f32 logits; `stream` is a cudaStream_t.  lse_mode 0: lse unused;
// 1: lse [B, H] f32 receives each head's log-sum-exp of the scaled,
// masked logits and out is unused; 2: lse [B, H] f32 holds the rows' L,
// and out [B, H, hd] is f32, the unrounded sum of bf16(exp(s - L)) v.
// Needs H / KV <= 16, hd <= 256, n_split <= 65535 and B * H * hd < 2^31.
// Returns the first CUDA error of the launches, else 0: every launch was
// accepted.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, const void* kpos,
                                const void* qpos, void* out, void* logits,
                                void* ml, void* part, int B, int T, int H,
                                int KV, int hd, int window, float scale,
                                int q_f32, int block_t, void* lse,
                                int lse_mode, void* stream) {
  if (B < 1 || T < 1 || KV < 1 || H < KV || H % KV != 0 ||
      H / KV > kMaxG || hd < 1 || hd > kMaxHd || window < 0 ||
      B > 65535 || block_t < 1 || (long long)B * H * hd >= (1LL << 31) ||
      lse_mode < 0 || lse_mode > 2 || (lse_mode != 0 && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_split = (T + block_t - 1) / block_t;
  if (n_split > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  const bool vec = hd % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) &
       15) == 0;
#define DECODE_ARGS                                                           \
  G, q, k, v, lengths, kpos, qpos, out, logits, ml, part, lse, lse_mode, B, \
      T, H, KV, hd, window, scale, block_t, n_split, st
  if (q_f32)
    return vec ? dispatch<float, 8>(DECODE_ARGS)
               : dispatch<float, 1>(DECODE_ARGS);
  return vec ? dispatch<__nv_bfloat16, 8>(DECODE_ARGS)
             : dispatch<__nv_bfloat16, 1>(DECODE_ARGS);
#undef DECODE_ARGS
}
