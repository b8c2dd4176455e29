// K1 and K4 for Hopper: the fused Sinkhorn solve, one tile per (query,
// document).
//
// Replaces: src/repro/kernels/sddmm_spmm.py, sinkhorn_fused_all_batched
// (K1; pallas_call body _fused_batched_kernel -> _solve_block), reached
// from repro.core.index.WmdEngine._solve_group through
// repro.kernels.ops.sinkhorn_fused_all_batched; and sinkhorn_fused_all
// (K4; body _fused_kernel -> the same _solve_block), reached from
// repro.core.wmd.one_to_many(impl="kernel") through
// repro.kernels.ops.sinkhorn_wmd_kernel. K4 is K1 for one query: its
// wrapper launches the same kernels on an (N, 1) grid. Fixed n_iter or the
// adaptive exit (tol, check_every, resmask); fp32 or bf16 operands; linear
// or log domain.
//
// Per (query q, doc n), with G = g[q, :, n, :] (v_r x L):
//   x0[k] = 1/(live rows) on rows with any G != 0, else 0
//   repeat n_iter:  u = 1/x (0 where x <= 0)
//                   t[l] = sum_k G[k,l] u[k]                (SDDMM)
//                   w[l] = val[l] * (1/t[l]) on live slots
//                   x[k] = sum_l (G[k,l]/r[k]) w[l]          (SpMM)
//   wmd = sum_k u[k] sum_l GM[k,l] w[l],  GM = -G log G / lam (G > 0)
// Under log_domain g holds log K (pad rows -inf): the tile is shifted by
// its per-column max and exponentiated on chip, and the distance gets the
// exact correction -sum_l shift[l] val[l] / lam.
//
// Adaptive mode (check_every > 0) exits PER DOC. After one seeded
// iteration and then every check_every iterations the block reduces
// max_l |w - w_prev| and max_l |w| over the doc's slots in scope (the live
// slots, val > 0, of a doc whose resmask entry is > 0; every doc without
// resmask) and stops once diff / max(scale, 1e-30) is not above tol (a NaN
// stops it, as the reference's res > tol does) or the count reaches
// n_iter; counts land on 1 + k*check_every. An empty scope gives 0, so
// such a doc stops at the first check. The reference exits per grid block
// of 128 docs, which CUDA blocks cannot agree on without a grid-wide sync:
// here each doc folds its count into its block's iters entry with
// atomicMax, so the entry is the block's largest, the reference's count
// wherever the residuals fall monotonically once below tol. The
// reductions propagate NaN as torch.max does, so each stop decision is the
// plain version's (kernels/ref.py) up to the order of the sums.
//
// bf16 (template BF16): G and G/r are rounded to bf16 once (round to
// nearest even, __float2bfloat16_rn, as torch's and JAX's casts), after
// the log-domain shift; u is rounded as the SDDMM operand and w as the
// SpMM operand; products and sums stay fp32, and the residual and the
// distance line read the unrounded w, u and G. The warp variant rounds
// each operand once, where it is made (its comment below); the shared-
// and device-memory variants round as they read.
//
// Docs are independent. The reference starts x from 1/(live rows of a
// block of block_n docs); here the count is the doc's own. The two differ
// by a constant factor per doc, which scales x, u and w and cancels in the
// distance line and the residual ratio, so the result does not depend on
// block_n. In the linear domain w = val/t is not guarded: a K column that
// underflowed to all zero turns the distance NaN, which the engine raises
// as LamUnderflowError (the reference's einsum path does the same; its
// kernel path hides the fault, see ROADMAP queue 3).
//
// What bounds it on the H100: reading G once. At the paper's widest chunk
// shape (Q = 4, v_r = 48, N = 8192, L = 48) G is 302 MB, ~90 us at 3.35
// TB/s, while 2 * 2 * v_r * L per doc per iteration over 16 passes is
// ~4.8 GFLOP, ~72 us at 67 TFLOP/s fp32: bound by bytes.
//
// What the design does about it: G is read from device memory exactly
// once per (query, doc) tile, and every iteration and the distance line
// run on chip; u, x, t, w never leave the SM, and GM is rebuilt from the
// tile (no second array). The final sum is in a fixed order, so the
// result is deterministic. Four variants; "auto" routes by the shapes it
// is given, (v_r, L):
// - sinkhorn_fused_warp_kernel ("warp", what "auto" runs up to 64 x 64,
//   every shape of the paper's workload): a warp per tile, no block
//   barrier, asynchronous tile loads, inert docs skipped (its comment
//   below);
// - sinkhorn_fused_live_kernel (what "auto" runs past 64 x 64): each
//   pair solved over its live tile only (rows to its last live row, slots
//   to its last val != 0), read once into shared memory, pairs of varied
//   size packed into persistent blocks in two launches by size, and
//   sinkhorn_fused_stream_kernel for the pairs over its arena (their
//   comments below). Past 64 x 64 a group pads its documents to its
//   widest and a chunk its queries to its widest, so most of a padded
//   tile is dead (news20's 500-slot group averages ~146 live slots): the
//   two variants below run every padded slot, and this one only the live
//   ones. On small tiles with little padding (~96 rows, at most 64
//   slots) the shared variant is faster (PERF.md, section 7);
// - the kernel just below ("shared"): the padded tile in dynamic shared
//   memory (row stride padded to an odd count so the SpMM's row-per-thread
//   reads hit distinct banks), 64 threads a block;
// - sinkhorn_fused_global_kernel ("global"): G read from device memory at
//   every pass, any size.
// "shared" and "global" were "auto"'s route past 64 x 64 before the live
// kernel; they stay for the tests and timings that hold it against them.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phases k1, k1_tiles,
// k1_crossover; PERF.md) the warp variant was 2.2-3.3x faster than the
// block-per-tile design it replaced at the paper's chunks, and faster in
// every class up to 64 x 64. All are latency-bound, not bound by bytes:
// 16 dependent passes per doc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "async_copy.cuh"
#include "device_attr.cuh"

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float safe_inv(float x) {
  return x > 0.f ? 1.f / x : 0.f;
}

// x rounded to bf16 and back under BF16 (the operand policy), else x
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// max that propagates NaN, as torch.max does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The residual check: the block-wide max of every thread's diff and scale
// (0 on a thread without a slot in scope), reduced in one order on every
// thread, and whether the doc stops: its ratio is not above tol. red holds
// 2 * NT / 32 floats. Every thread of the block calls it (it holds a
// barrier); the caller writes red again only after later barriers.
template <int NT>
__device__ __forceinline__ bool converged(float diff, float scale,
                                          float tol, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    diff = nanmax(diff, __shfl_xor_sync(0xffffffffu, diff, off));
    scale = nanmax(scale, __shfl_xor_sync(0xffffffffu, scale, off));
  }
  constexpr int NW = NT / 32;
  const int wid = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[wid] = diff;
    red[NW + wid] = scale;
  }
  __syncthreads();
  diff = red[0];
  scale = red[NW];
  for (int i = 1; i < NW; ++i) {
    diff = nanmax(diff, red[i]);
    scale = nanmax(scale, red[NW + i]);
  }
  return !(diff / fmaxf(scale, 1e-30f) > tol);
}

// Both variants run this schedule. A pass is the SDDMM (w from u), then,
// unless `done` iterations are all the doc takes (done >= end), the SpMM
// (u from w); the last pass leaves u and w for the distance line. Fixed
// mode: end = n_iter. Adaptive mode: after each SpMM whose count `done + 1`
// is a decision point (`next`: the seed's 1, then every check_every), the
// doc stops (end = done + 1) or sets the next one.
//   int end = check_every > 0 ? INT_MAX : n_iter, next = 1;
//   for (done = 0;; ++done) { SDDMM; if (done >= end) break; SpMM;
//                             if (adaptive && done + 1 == next) decide; }

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
sinkhorn_fused_batched_kernel(const float* __restrict__ g,
                              const float* __restrict__ val,
                              const float* __restrict__ r,
                              const float* __restrict__ resmask,
                              float* __restrict__ wmd,
                              int* __restrict__ iters, int VR, int N, int L,
                              int n_iter, float lam, int log_domain,
                              int block_n, float tol, int check_every) {
  extern __shared__ float smem[];
  const int Ls = L | 1;                    // odd row stride: no bank conflicts
  float* G = smem;                         // (VR, Ls)
  float* xs = G + (size_t)VR * Ls;         // (VR,)
  float* us = xs + VR;                     // (VR,)
  float* rinv = us + VR;                   // (VR,)
  float* ws = rinv + VR;                   // (L,)
  float* wprev = ws + L;                   // (L,) w at the last decision
  float* vals = wprev + L;                 // (L,)
  float* shift = vals + L;                 // (L,)
  float* red = shift + L;                  // (2 * kThreads / 32,)

  const int n = blockIdx.x;
  const int q = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t nl = (size_t)N * L;
  const float* gq = g + (size_t)q * VR * nl + (size_t)n * L;
  const bool doc_in_scope =
      resmask == nullptr || resmask[(size_t)q * N + n] > 0.f;

  for (int i = tid; i < VR * L; i += kThreads) {
    int k = i / L, l = i % L;
    G[k * Ls + l] = gq[(size_t)k * nl + l];
  }
  for (int l = tid; l < L; l += kThreads) {
    vals[l] = val[(size_t)n * L + l];
    shift[l] = 0.f;
  }
  for (int k = tid; k < VR; k += kThreads)
    rinv[k] = safe_inv(r[(size_t)q * VR + k]);
  __syncthreads();

  if (log_domain) {
    for (int l = tid; l < L; l += kThreads) {
      float m = -INFINITY;
      for (int k = 0; k < VR; ++k) m = fmaxf(m, G[k * Ls + l]);
      shift[l] = isfinite(m) ? m : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < VR * L; i += kThreads) {
      int k = i / L, l = i % L;
      float v = G[k * Ls + l];
      G[k * Ls + l] = isfinite(v) ? expf(v - shift[l]) : 0.f;
    }
    __syncthreads();
  }

  // live rows of this doc: any G != 0 (pad rows are all zero)
  for (int k = tid; k < VR; k += kThreads) {
    float live = 0.f;
    for (int l = 0; l < L; ++l)
      if (G[k * Ls + l] != 0.f) live = 1.f;
    us[k] = live;
  }
  __syncthreads();
  float cnt = 0.f;
  for (int k = 0; k < VR; ++k) cnt += us[k];
  for (int k = tid; k < VR; k += kThreads)
    xs[k] = us[k] > 0.f ? 1.f / cnt : 0.f;
  __syncthreads();

  int end = check_every > 0 ? INT_MAX : n_iter, next = 1;
  for (int done = 0;; ++done) {
    for (int k = tid; k < VR; k += kThreads) us[k] = safe_inv(xs[k]);
    __syncthreads();
    for (int l = tid; l < L; l += kThreads) {              // SDDMM
      float t = 0.f;
      for (int k = 0; k < VR; ++k)
        t = fmaf(rnd<BF16>(G[k * Ls + l]), rnd<BF16>(us[k]), t);
      const float v = vals[l];
      float inv = log_domain ? safe_inv(t) : 1.f / t;
      ws[l] = v > 0.f ? v * inv : 0.f;
    }
    __syncthreads();
    if (done >= end) break;         // last pass: u and w for the distance
    for (int k = tid; k < VR; k += kThreads) {             // SpMM
      const float ri = rinv[k];
      float x = 0.f;
      for (int l = 0; l < L; ++l)
        x = fmaf(rnd<BF16>(G[k * Ls + l] * ri), rnd<BF16>(ws[l]), x);
      xs[k] = x;
    }
    __syncthreads();
    if (check_every > 0 && done + 1 == next) {              // decide
      float diff = 0.f, scale = 0.f;
      for (int l = tid; l < L; l += kThreads) {
        if (doc_in_scope && vals[l] > 0.f) {
          diff = nanmax(diff, fabsf(ws[l] - wprev[l]));
          scale = nanmax(scale, fabsf(ws[l]));
        }
        wprev[l] = ws[l];           // each thread reads only its own slots
      }
      const bool conv = done > 0 && converged<kThreads>(diff, scale, tol,
                                                         red);
      if (conv || done + 1 >= n_iter) {
        end = done + 1;
      } else {
        next = done + 1 + check_every;
      }
    }
  }

  // distance line: sum_k u[k] sum_l GM[k,l] w[l], GM rebuilt from the tile
  float part = 0.f;
  for (int k = tid; k < VR; k += kThreads) {
    float s = 0.f;
    for (int l = 0; l < L; ++l) {
      const float gv = G[k * Ls + l];
      const float gm = gv > 0.f ? (-gv * logf(gv)) / lam : 0.f;
      s = fmaf(gm, ws[l], s);
    }
    part = fmaf(us[k], s, part);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) total += red[i];
    if (log_domain) {
      float corr = 0.f;
      for (int l = 0; l < L; ++l) corr = fmaf(shift[l], vals[l], corr);
      total -= corr / lam;
    }
    wmd[(size_t)q * N + n] = total;
    if (iters != nullptr)
      atomicMax(iters + (size_t)q * ((N + block_n - 1) / block_n) +
                    n / block_n,
                end);
  }
}

// Variant for a (v_r, L) tile over the per-block shared-memory limit (for
// example 256 query rows against 256 doc slots, 263 KB): G stays in device
// memory and every pass reads it there, so only u, x, 1/r, w, val, the
// shift and the reductions live in shared memory. The same arithmetic as
// the kernels above. Under log_domain each read shifts and exponentiates
// the raw log K on the fly (expf(v - shift[l]), the value the shared
// variant stores); under BF16 each read rounds, as the shared variant's
// do. The SDDMM runs a thread per slot (a warp reads 32 neighbouring
// slots of one row), the SpMM and the distance line a warp per row (lanes
// over the slots, then a shuffle sum), so every read of G is coalesced.
// A doc's tile is read twice per iteration; at 256 x 256 one block's tile
// is 256 KB, and the tiles of the blocks in flight fit the 50 MB L2.
//
// stream_solve is that solve for one pair, by every thread of a block of
// kGThreads, over the tile's rows [0, K) and slots [0, Lt): the
// device-memory kernel passes the whole tile; the stream kernel below
// passes a pair whose live tile is over the live-tile kernel's shared
// memory, trimmed to its last live row and slot. Its reductions take
// 2 * kGThreads / 32 floats (red), which global_smem_bytes reserves from
// the same constant: a block of more threads would write red past what
// is reserved. Rows past K are zero (or -inf) on the slots kept and
// slots past Lt have val 0, so they change nothing but the live-row
// count (a constant factor that cancels) and the NaN a dead row's 0 * inf
// gives the full loop where some w is not finite, which the end
// restores.
constexpr int kGThreads = 256;

template <bool BF16>
__device__ void stream_solve(float* smem, const float* __restrict__ g,
                             const float* __restrict__ val,
                             const float* __restrict__ r,
                             const float* __restrict__ resmask,
                             float* __restrict__ wmd, int* __restrict__ iters,
                             int q, int n, int VR, int N, int L, int K,
                             int Lt, int n_iter, float lam, int log_domain,
                             int block_n, float tol, int check_every) {
  constexpr int NT = kGThreads, NW = NT / 32;
  float* xs = smem;                        // (K,)
  float* us = xs + K;                      // (K,)
  float* rinv = us + K;                    // (K,)
  float* ws = rinv + K;                    // (Lt,)
  float* wprev = ws + Lt;                  // (Lt,) w at the last decision
  float* vals = wprev + Lt;                // (Lt,)
  float* shift = vals + Lt;                // (Lt,)
  float* red = shift + Lt;                 // (2 * NW,)

  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const size_t nl = (size_t)N * L;
  const float* gq = g + (size_t)q * VR * nl + (size_t)n * L;
  const bool doc_in_scope =
      resmask == nullptr || resmask[(size_t)q * N + n] > 0.f;

  // G[k, l] as the shared variant holds it: shifted and exponentiated
  // under log_domain (shift[l] must be set)
  auto gat = [&](int k, int l) -> float {
    const float v = gq[(size_t)k * nl + l];
    if (!log_domain) return v;
    return isfinite(v) ? expf(v - shift[l]) : 0.f;
  };

  for (int l = tid; l < Lt; l += NT) {
    vals[l] = val[(size_t)n * L + l];
    float m = -INFINITY;
    if (log_domain)
      for (int k = 0; k < K; ++k) m = fmaxf(m, gq[(size_t)k * nl + l]);
    shift[l] = log_domain && isfinite(m) ? m : 0.f;
  }
  for (int k = tid; k < K; k += NT)
    rinv[k] = safe_inv(r[(size_t)q * VR + k]);
  __syncthreads();

  // live rows of this doc: any G != 0 (pad rows are all zero)
  for (int k = wid; k < K; k += NW) {
    bool live = false;
    for (int l = lane; l < Lt; l += 32) live = live || gat(k, l) != 0.f;
    live = __any_sync(0xffffffffu, live);
    if (lane == 0) us[k] = live ? 1.f : 0.f;
  }
  __syncthreads();
  float cnt = 0.f;
  for (int k = 0; k < K; ++k) cnt += us[k];
  for (int k = tid; k < K; k += NT)
    xs[k] = us[k] > 0.f ? 1.f / cnt : 0.f;
  __syncthreads();

  int end = check_every > 0 ? INT_MAX : n_iter, next = 1;
  for (int done = 0;; ++done) {
    for (int k = tid; k < K; k += NT) us[k] = safe_inv(xs[k]);
    __syncthreads();
    for (int l = tid; l < Lt; l += NT) {                   // SDDMM
      float t = 0.f;
      for (int k = 0; k < K; ++k)
        t = fmaf(rnd<BF16>(gat(k, l)), rnd<BF16>(us[k]), t);
      const float v = vals[l];
      float inv = log_domain ? safe_inv(t) : 1.f / t;
      ws[l] = v > 0.f ? v * inv : 0.f;
    }
    __syncthreads();
    if (done >= end) break;         // last pass: u and w for the distance
    for (int k = wid; k < K; k += NW) {                    // SpMM
      const float ri = rinv[k];
      float x = 0.f;
      for (int l = lane; l < Lt; l += 32)
        x = fmaf(rnd<BF16>(gat(k, l) * ri), rnd<BF16>(ws[l]), x);
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) xs[k] = x;
    }
    __syncthreads();
    if (check_every > 0 && done + 1 == next) {              // decide
      float diff = 0.f, scale = 0.f;
      for (int l = tid; l < Lt; l += NT) {
        if (doc_in_scope && vals[l] > 0.f) {
          diff = nanmax(diff, fabsf(ws[l] - wprev[l]));
          scale = nanmax(scale, fabsf(ws[l]));
        }
        wprev[l] = ws[l];           // each thread reads only its own slots
      }
      const bool conv = done > 0 && converged<NT>(diff, scale, tol, red);
      if (conv || done + 1 >= n_iter) {
        end = done + 1;
      } else {
        next = done + 1 + check_every;
      }
    }
  }

  // distance line: sum_k u[k] sum_l GM[k,l] w[l], a warp per row
  float part = 0.f;
  for (int k = wid; k < K; k += NW) {
    float s = 0.f;
    for (int l = lane; l < Lt; l += 32) {
      const float gv = gat(k, l);
      const float gm = gv > 0.f ? (-gv * logf(gv)) / lam : 0.f;
      s = fmaf(gm, ws[l], s);
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) part = fmaf(us[k], s, part);
  }
  bool bad = false;                 // a w that is not finite
  for (int l = tid; l < Lt; l += NT) bad = bad || !isfinite(ws[l]);
  bad = __syncthreads_or(bad);      // red was last read by the decisions
  if (lane == 0) red[wid] = part;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < NW; ++i) total += red[i];
    if (log_domain) {
      float corr = 0.f;
      for (int l = 0; l < Lt; ++l) corr = fmaf(shift[l], vals[l], corr);
      total -= corr / lam;
    }
    // a dead row's 0 * inf (a row of the tile that no slot kept reaches)
    if (bad && cnt < (float)VR) total = NAN;
    wmd[(size_t)q * N + n] = total;
    if (iters != nullptr)
      atomicMax(iters + (size_t)q * ((N + block_n - 1) / block_n) +
                    n / block_n,
                end);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kGThreads)
sinkhorn_fused_global_kernel(const float* __restrict__ g,
                             const float* __restrict__ val,
                             const float* __restrict__ r,
                             const float* __restrict__ resmask,
                             float* __restrict__ wmd,
                             int* __restrict__ iters, int VR, int N, int L,
                             int n_iter, float lam, int log_domain,
                             int block_n, float tol, int check_every) {
  extern __shared__ float smem[];
  stream_solve<BF16>(smem, g, val, r, resmask, wmd, iters, blockIdx.y,
                     blockIdx.x, VR, N, L, VR, L, n_iter, lam, log_domain,
                     block_n, tol, check_every);
}

// Warp-per-tile variant (tile="warp"), the redesign for tiles up to 64 x
// 64. One warp solves one (query, doc) tile; a block holds kWarpsPerBlock
// independent warps, and a grid sized to the card's resident warps strides
// them over the Q * N pairs, so no block barrier runs in the loop (two
// __syncwarp per iteration). Each warp has its own slice of shared memory:
// NSLOT tile slots (row stride LM + 4: 16-byte rows, conflict-free float4
// row reads and column reads) and u, w (and their bf16-rounded copies),
// read as float4 broadcasts.
//
// - Loads: while a warp solves one pair, cp.async brings the next pair's
//   tile into its other slot (16-byte copies when L is a multiple of 4,
//   else 4-byte ones). A tile row is L floats at a stride of N * L.
// - Inert docs: a doc whose val row is all zero loads no G; its warp
//   writes what the full loop gives such a doc (distance 0, the count of
//   ref.inert_doc_iters). A val row with a negative or NaN entry is
//   solved in full, so the result is the full loop's either way.
// - Registers: lane l keeps column l (LC columns of KM rows, the SDDMM's
//   operand) and lane k row k (KC rows of LM slots, the SpMM's and the
//   distance line's), 64 * KC * LC floats in all; the (2, 2) class (both
//   sides over 32) keeps its columns and reads its rows from the slot
//   (ROWS_SMEM, one slot).
// - Loops run over float4 steps up to the tile's last live row and last
//   live slot, not to KM and LM.
// - The log domain shifts and exponentiates each element once, in the
//   slot, where the rows are then read; the distance line takes log G
//   from the exponentiated G as the other variants do.
// - fp32 SpMM: x[k] = (1/r[k]) * sum_l G[k,l] w[l] (the other variants
//   multiply G by 1/r per element; a rounding apart). bf16: the registers
//   hold round(G) (columns) and round(G/r) (rows), u and w are kept both
//   unrounded and rounded, and the distance line reads the unrounded G
//   from the slot.
// - The decision reductions are warp shuffles that propagate NaN; the
//   final sum is a fixed-order shuffle tree.
constexpr int kWarpsPerBlock = 4;

template <int KC, int LC, bool ROWS_SMEM>
struct WarpTile {
  static constexpr int KM = 32 * KC, LM = 32 * LC;
  static constexpr int LS = LM + 4;
  static constexpr int NSLOT = ROWS_SMEM ? 1 : 2;
  static constexpr int SLOT = KM * LS;
  // slots, then u, u rounded, w, w rounded
  static constexpr int FLOATS = NSLOT * SLOT + 2 * (KM + LM);
};

__device__ __forceinline__ float gm_of(float gv, float lam) {
  return gv > 0.f ? (-gv * logf(gv)) / lam : 0.f;
}

// the realized count of an inert doc (ref.inert_doc_iters)
__device__ __forceinline__ int inert_count(int n_iter, float tol,
                                           int check_every) {
  if (check_every <= 0) return n_iter;
  int count = 1;
  while (count < n_iter) {
    count += check_every;
    if (!(0.f > tol)) break;
  }
  return count;
}

// One warp's solve of pair (q, n) on its loaded slot.
template <int KC, int LC, bool BF16, bool ROWS_SMEM>
__device__ __forceinline__ void warp_solve(
    float* __restrict__ slot, float* __restrict__ us, float* __restrict__ ub,
    float* __restrict__ ws, float* __restrict__ wb,
    const float* __restrict__ val, const float* __restrict__ r,
    const float* __restrict__ resmask, float* __restrict__ wmd,
    int* __restrict__ iters, int q, int n, int VR, int N, int L, int n_iter,
    float lam, int log_domain, int block_n, float tol, int check_every) {
  using T = WarpTile<KC, LC, ROWS_SMEM>;
  constexpr int KM = T::KM, LM = T::LM, LS = T::LS;
  const int lane = threadIdx.x & 31;
  const float4* slot4 = reinterpret_cast<const float4*>(slot);

  float vl[LC], sh[LC];
#pragma unroll
  for (int c = 0; c < LC; ++c) {
    const int l = lane + 32 * c;
    vl[c] = l < L ? val[(size_t)n * L + l] : 0.f;
    sh[c] = 0.f;
  }
  float ri[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int k = lane + 32 * c;
    ri[c] = k < VR ? safe_inv(r[(size_t)q * VR + k]) : 0.f;
  }

  if (log_domain) {            // shift per column, exponentiate once
#pragma unroll
    for (int c = 0; c < LC; ++c) {
      const int l = lane + 32 * c;
      float m = -INFINITY;
      for (int k = 0; k < VR; ++k) m = fmaxf(m, slot[k * LS + l]);
      sh[c] = (l < L && isfinite(m)) ? m : 0.f;
      for (int k = 0; k < VR; ++k) {
        const float v = slot[k * LS + l];
        slot[k * LS + l] = (l < L && isfinite(v)) ? expf(v - sh[c]) : 0.f;
      }
    }
    __syncwarp();
  }

  float col[LC][KM];
#pragma unroll
  for (int c = 0; c < LC; ++c)
#pragma unroll
    for (int k = 0; k < KM; ++k) col[c][k] = slot[k * LS + lane + 32 * c];
  constexpr int RK = ROWS_SMEM ? 1 : KC, RL = ROWS_SMEM ? 4 : LM;
  float row[RK][RL];
  bool rlive[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int k = lane + 32 * c;
    bool any = false;
#pragma unroll
    for (int j = 0; j < LM / 4; ++j) {
      const float4 v = slot4[(k * LS) / 4 + j];
      any = any || v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      if constexpr (!ROWS_SMEM) {
        row[c][4 * j + 0] = v.x;
        row[c][4 * j + 1] = v.y;
        row[c][4 * j + 2] = v.z;
        row[c][4 * j + 3] = v.w;
      }
    }
    rlive[c] = any;
  }
  const unsigned rb0 = __ballot_sync(0xffffffffu, rlive[0]);
  const unsigned rb1 = KC > 1 ? __ballot_sync(0xffffffffu, rlive[KC - 1])
                              : 0u;
  const unsigned sb0 = __ballot_sync(0xffffffffu, vl[0] > 0.f);
  const unsigned sb1 = LC > 1 ? __ballot_sync(0xffffffffu, vl[LC - 1] > 0.f)
                              : 0u;
  const int cnt = __popc(rb0) + __popc(rb1);
  const int kq = ((rb1 ? 64 - __clz(rb1) : 32 - __clz(rb0)) + 3) >> 2;
  const int lq = ((sb1 ? 64 - __clz(sb1) : 32 - __clz(sb0)) + 3) >> 2;

  float uk[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int k = lane + 32 * c;
    uk[c] = rlive[c] ? safe_inv(1.f / (float)cnt) : 0.f;
    us[k] = uk[c];
    if constexpr (BF16) ub[k] = rnd<BF16>(uk[c]);
  }
  if constexpr (BF16) {       // the operands: round(G), round(G/r)
#pragma unroll
    for (int c = 0; c < LC; ++c)
#pragma unroll
      for (int k = 0; k < KM; ++k) col[c][k] = rnd<BF16>(col[c][k]);
    if constexpr (!ROWS_SMEM) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int l = 0; l < LM; ++l) row[c][l] = rnd<BF16>(row[c][l] * ri[c]);
    }
  }
  const bool doc_in_scope =
      resmask == nullptr || resmask[(size_t)q * N + n] > 0.f;
  bool in_scope[LC];
#pragma unroll
  for (int c = 0; c < LC; ++c) in_scope[c] = doc_in_scope && vl[c] > 0.f;
  __syncwarp();

  float wcur[LC], wprev[LC];
#pragma unroll
  for (int c = 0; c < LC; ++c) wprev[c] = 0.f;
  int end = check_every > 0 ? INT_MAX : n_iter, next = 1;
  for (int done = 0;; ++done) {
    {                                                       // SDDMM
      const float4* u4 = reinterpret_cast<const float4*>(BF16 ? ub : us);
      float t[LC][2];
#pragma unroll
      for (int c = 0; c < LC; ++c) t[c][0] = t[c][1] = 0.f;
#pragma unroll
      for (int i = 0; i < KM / 4; ++i) {
        if (i < kq) {
          const float4 u = u4[i];
#pragma unroll
          for (int c = 0; c < LC; ++c) {
            float& a = t[c][i & 1];
            a = fmaf(col[c][4 * i + 0], u.x, a);
            a = fmaf(col[c][4 * i + 1], u.y, a);
            a = fmaf(col[c][4 * i + 2], u.z, a);
            a = fmaf(col[c][4 * i + 3], u.w, a);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < LC; ++c) {
        const float tt = t[c][0] + t[c][1];
        const float inv = log_domain ? safe_inv(tt) : 1.f / tt;
        wcur[c] = vl[c] > 0.f ? vl[c] * inv : 0.f;
        ws[lane + 32 * c] = wcur[c];
        if constexpr (BF16) wb[lane + 32 * c] = rnd<BF16>(wcur[c]);
      }
    }
    __syncwarp();
    if (done >= end) break;         // last pass: u and w for the distance
    {                                                       // SpMM
      const float4* w4 = reinterpret_cast<const float4*>(BF16 ? wb : ws);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int k = lane + 32 * c;
        float x[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < LM / 4; ++j) {
          if (j < lq) {
            const float4 w = w4[j];
            float4 gv;
            if constexpr (ROWS_SMEM) {
              gv = slot4[(k * LS) / 4 + j];
              if constexpr (BF16) {
                gv.x = rnd<BF16>(gv.x * ri[c]);
                gv.y = rnd<BF16>(gv.y * ri[c]);
                gv.z = rnd<BF16>(gv.z * ri[c]);
                gv.w = rnd<BF16>(gv.w * ri[c]);
              }
            } else {
              gv = make_float4(row[c][4 * j], row[c][4 * j + 1],
                               row[c][4 * j + 2], row[c][4 * j + 3]);
            }
            float& a = x[j & 1];
            a = fmaf(gv.x, w.x, a);
            a = fmaf(gv.y, w.y, a);
            a = fmaf(gv.z, w.z, a);
            a = fmaf(gv.w, w.w, a);
          }
        }
        float xx = x[0] + x[1];
        if constexpr (!BF16) xx *= ri[c];
        uk[c] = k < VR ? safe_inv(xx) : 0.f;
        us[k] = uk[c];
        if constexpr (BF16) ub[k] = rnd<BF16>(uk[c]);
      }
    }
    __syncwarp();
    if (check_every > 0 && done + 1 == next) {              // decide
      float diff = 0.f, scale = 0.f;
#pragma unroll
      for (int c = 0; c < LC; ++c) {
        if (in_scope[c]) {
          diff = nanmax(diff, fabsf(wcur[c] - wprev[c]));
          scale = nanmax(scale, fabsf(wcur[c]));
        }
        wprev[c] = wcur[c];
      }
      bool conv = false;
      if (done > 0) {
        for (int off = 16; off > 0; off >>= 1) {
          diff = nanmax(diff, __shfl_xor_sync(0xffffffffu, diff, off));
          scale = nanmax(scale, __shfl_xor_sync(0xffffffffu, scale, off));
        }
        conv = !(diff / fmaxf(scale, 1e-30f) > tol);
      }
      if (conv || done + 1 >= n_iter) {
        end = done + 1;
      } else {
        next = done + 1 + check_every;
      }
    }
  }

  // distance line on the rows: u[k] sum_l GM[k,l] w[l]
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  float part = 0.f;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int k = lane + 32 * c;
    if (k < VR) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < LM / 4; ++j) {
        if (j < lq) {
          const float4 w = w4[j];
          float4 gv;
          if constexpr (BF16 || ROWS_SMEM) {
            gv = slot4[(k * LS) / 4 + j];
          } else {
            gv = make_float4(row[c][4 * j], row[c][4 * j + 1],
                             row[c][4 * j + 2], row[c][4 * j + 3]);
          }
          s = fmaf(gm_of(gv.x, lam), w.x, s);
          s = fmaf(gm_of(gv.y, lam), w.y, s);
          s = fmaf(gm_of(gv.z, lam), w.z, s);
          s = fmaf(gm_of(gv.w, lam), w.w, s);
        }
      }
      part = fmaf(uk[c], s, part);
    }
  }
  float corr = 0.f;
#pragma unroll
  for (int c = 0; c < LC; ++c) corr = fmaf(sh[c], vl[c], corr);
  for (int off = 16; off > 0; off >>= 1) {
    part += __shfl_down_sync(0xffffffffu, part, off);
    corr += __shfl_down_sync(0xffffffffu, corr, off);
  }
  if (lane == 0) {
    wmd[(size_t)q * N + n] = log_domain ? part - corr / lam : part;
    if (iters != nullptr)
      atomicMax(iters + (size_t)q * ((N + block_n - 1) / block_n) +
                    n / block_n,
                end);
  }
}

template <int KC, int LC, bool BF16, bool ROWS_SMEM>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sinkhorn_fused_warp_kernel(const float* __restrict__ g,
                           const float* __restrict__ val,
                           const float* __restrict__ r,
                           const float* __restrict__ resmask,
                           float* __restrict__ wmd, int* __restrict__ iters,
                           int Q, int VR, int N, int L, int n_iter, float lam,
                           int log_domain, int block_n, float tol,
                           int check_every, int vec4) {
  using T = WarpTile<KC, LC, ROWS_SMEM>;
  constexpr int NSLOT = T::NSLOT, LS = T::LS;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  float* base = smem + (threadIdx.x >> 5) * T::FLOATS;
  float* us = base + NSLOT * T::SLOT;
  float* ub = us + T::KM;
  float* ws = ub + T::KM;
  float* wb = ws + T::LM;
  for (int i = lane; i < NSLOT * T::SLOT; i += 32) base[i] = 0.f;
  __syncwarp();                  // pad rows and slots stay zero from here

  const int total = Q * N;
  const int warps = gridDim.x * kWarpsPerBlock;
  const size_t nl = (size_t)N * L;
  // the tile's copies: cpr per row (16-byte, or 4-byte), row k = c / cpr
  const int cpr = vec4 ? L / 4 : L;
  const int n_copies = VR * cpr;
  const unsigned long long magic = ((1ull << 32) + cpr - 1) / cpr;
  const int idle = inert_count(n_iter, tol, check_every);

  auto doc_live = [&](int p) -> bool {
    const int n = p % N;
    bool any = false;
#pragma unroll
    for (int c = 0; c < LC; ++c) {
      const int l = lane + 32 * c;
      any = any || (l < L && val[(size_t)n * L + l] != 0.f);
    }
    return __any_sync(0xffffffffu, any);
  };
  auto load = [&](int p, float* slot) {
    const int q = p / N, n = p - q * N;
    const float* gq = g + (size_t)q * VR * nl + (size_t)n * L;
    for (int c = lane; c < n_copies; c += 32) {
      const int k = (int)(((unsigned long long)c * magic) >> 32);
      const int j = c - k * cpr;
      if (vec4) {
        async_copy::copy16(slot + k * LS + 4 * j, gq + k * nl + 4 * j);
      } else {
        async_copy::copy4(slot + k * LS + j, gq + k * nl + j);
      }
    }
  };

  int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int s = 0;
  bool live = p < total && doc_live(p);
  if (live) load(p, base);
  async_copy::commit();
  for (; p < total; p += warps) {
    const int pn = p + warps;
    bool live_n = false;
    if constexpr (NSLOT == 2) {     // the next pair's tile, other slot
      live_n = pn < total && doc_live(pn);
      if (live_n) load(pn, base + (s ^ 1) * T::SLOT);
      async_copy::commit();
      async_copy::wait<1>();
    } else {
      async_copy::wait<0>();
    }
    __syncwarp();
    const int q = p / N, n = p - q * N;
    if (live) {
      warp_solve<KC, LC, BF16, ROWS_SMEM>(
          base + s * T::SLOT, us, ub, ws, wb, val, r, resmask, wmd, iters, q,
          n, VR, N, L, n_iter, lam, log_domain, block_n, tol, check_every);
    } else if (lane == 0) {
      wmd[(size_t)q * N + n] = 0.f;
      if (iters != nullptr)
        atomicMax(iters + (size_t)q * ((N + block_n - 1) / block_n) +
                      n / block_n,
                  idle);
    }
    __syncwarp();                   // the slot is free for the next copy
    if constexpr (NSLOT == 1) {
      live_n = pn < total && doc_live(pn);
      if (live_n) load(pn, base);
      async_copy::commit();
    } else {
      s ^= 1;
    }
    live = live_n;
  }
  async_copy::wait<0>();
}

// Live-tile variant, what "auto" runs past 64 x 64. Each
// (query, doc) pair is solved over its live tile only: the query's rows up
// to its last live row (any G != 0 on the slots kept; under log_domain any
// finite log K) and the doc's slots up to its last val != 0. The live tile
// is read from device memory once, exponentiated once as it lands (log
// domain), and every pass of the solve reads it from shared memory.
//
// Persistent blocks take pairs from a counter in device memory (`work`,
// zero at launch) kLPairs at a time (fewer in a launch of fewer than
// kLPairs pairs a block, which would leave blocks idle), measure each (a
// warp per pair: val's last nonzero, then rows from the last down, eight
// at a time, until one is live; the first launch measures every pair and
// keeps its extents in `ext`, where the second reads them), and pack them
// in order into their arena (the whole of the block's dynamic shared
// memory) while they fit. A launch's shared memory is one size for every
// block, and live tiles vary ~10x, so the launches are split by live
// size: a first launch at two blocks an SM, each with half the arena,
// takes the pairs whose region fits half of it (most pairs and cells at
// news20's shapes), a second at one block an SM the rest (lo_floats <
// live_floats <= hi_floats picks a launch's pairs; each has its own
// counter). Packing keeps each block's threads busy where tiles are far
// below its arena; the classes put twice the warps on an SM for the
// common small tiles (tools/time_kernel_variants.py k1 times both against
// one launch, and one pair a round; PERF.md). The round's
// pairs are solved together: every phase is a flat list of items over all
// of them (a thread per item, then one barrier), so a round of small
// tiles keeps as many threads busy as one large tile:
// - SDDMM: an item is a slot l and a run of kLSeg rows, summed in order
//   into a partial; then an item per slot adds its partials in order and
//   makes w. SpMM and the distance line: an item is a row k and a run of
//   kLSeg slots; then an item per row. The row stride is odd, so a warp's
//   row items read distinct banks; its slot items read neighbouring words.
// - Each pair's sums run in an order fixed by its own (K, Lt) alone, so a
//   distance does not depend on the pairs it was packed with.
// - Adaptive mode: each pair keeps its own count and exit; the residual's
//   maxima are shared atomicMax on the bits (non-negative floats and NaN
//   order as unsigned), and the round runs until its last pair stops.
// - A doc whose val row is all zero loads nothing (distance 0 and the
//   count of ref.inert_doc_iters, as the warp variant). A filler query has
//   no live row: its tile is empty and its loop costs one slot pass.
// - A pair whose live tile is over the whole arena is listed by the
//   second launch (`over`) for a third, sinkhorn_fused_stream_kernel
//   (below), which streams it from device memory. `stats`, unless null,
//   gathers the live cells (K * Lt) solved on chip (stats[0]) and
//   streamed (stats[1]).
// 512 threads: a block of 1024 (one an SM) ran ~10% faster in an earlier
// form of this kernel, which streamed the pairs over its arena itself,
// but its adaptive exit was wrong on streamed pairs: it ran stream_solve
// at 1024 threads in space reserved for 256 threads' reductions (the
// scale maxima of warps 16-31 fell in the packing arena). 1024 threads
// have not been timed since.
// fp32: x[k] = (1/r[k]) * sum_l G[k,l] w[l] (a rounding apart from the
// shared variant's per-element G/r); bf16 rounds as the shared variant.
constexpr int kLThreads = 512;
constexpr int kLWarps = kLThreads / 32;
constexpr int kLPairs = 16;               // pairs measured and packed a round
constexpr int kLSeg = 64;                 // terms one thread sums in order

__host__ __device__ constexpr long long r4(long long x) {
  return (x + 3) & ~3LL;
}

// floats of one pair's region: the tile (row stride Lt | 1), the partial
// sums, u and 1/r (K each), w, w at the last decision, val and the shift
// (Lt each), every part 16-byte aligned. kernels/ops.py's live_tile_bytes
// is the same rule.
__host__ __device__ inline long long live_floats(int K, int Lt) {
  const long long ck = (K + kLSeg - 1) / kLSeg, cl = (Lt + kLSeg - 1) / kLSeg;
  const long long part = ck * Lt > cl * K ? ck * Lt : cl * K;
  return r4((long long)K * (Lt | 1)) + r4(part) + 2 * r4(K) + 4 * r4(Lt);
}

// A pair's live extents, by one warp: Lt, its doc's last slot with
// val != 0, plus one (0: an inert doc); K, its last row with a live entry
// on those slots (G != 0, or finite log K), plus one, found from the last
// row down, eight rows a step.
__device__ __forceinline__ void measure_pair(const float* __restrict__ g,
                                             const float* __restrict__ val,
                                             int q, int n, int VR, int N,
                                             int L, int log_domain, int* K,
                                             int* Lt) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t nl = (size_t)N * L;
  int last = -1;
  for (int l = lane; l < L; l += 32)
    if (val[(size_t)n * L + l] != 0.f) last = l;
  const int lt = __reduce_max_sync(full, last) + 1;
  int kext = 0;
  if (lt > 0) {
    const float* gq = g + (size_t)q * VR * nl + (size_t)n * L;
    for (int k0 = VR; k0 > 0 && kext == 0; k0 -= 8) {
      unsigned bits = 0;
      for (int l = lane; l < lt; l += 32) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 - 1 - j;
          if (k >= 0) {
            const float v = gq[(size_t)k * nl + l];
            if (log_domain ? isfinite(v) : v != 0.f) bits |= 1u << j;
          }
        }
      }
      bits = __reduce_or_sync(full, bits);
      if (bits) kext = k0 - (__ffs(bits) - 1);
    }
  }
  *K = kext;
  *Lt = lt;
}

struct LiveRound {
  // the round's pairs: coordinates, extents and offsets into the arena
  int q[kLPairs], n[kLPairs], K[kLPairs], Lt[kLPairs];
  int tile[kLPairs], part[kLPairs], u[kLPairs], rinv[kLPairs], w[kLPairs];
  int wprev[kLPairs], val[kLPairs], shift[kLPairs];
  int end[kLPairs], next[kLPairs], scope[kLPairs];
  unsigned diff[kLPairs], scale[kLPairs];
  float cnt[kLPairs];
  // item counts before each pair: rows, slots, SDDMM and SpMM partials
  int pre_k[kLPairs + 1], pre_l[kLPairs + 1];
  int pre_sd[kLPairs + 1], pre_sp[kLPairs + 1];
  int np, maxend;
  // pairs measured and not yet packed, in the order taken
  int cq[kLPairs], cn[kLPairs], cK[kLPairs], cL[kLPairs];
  int ncand, fetch, nfetch, exhausted;
  int eK[kLPairs], eL[kLPairs];
};

// the pair that item i falls in, given the last one (a thread's items rise)
__device__ __forceinline__ int pair_of(const int* pre, int i, int p) {
  while (i >= pre[p + 1]) ++p;
  return p;
}

template <bool BF16>
__global__ void __launch_bounds__(kLThreads, 2)
sinkhorn_fused_live_kernel(const float* __restrict__ g,
                           const float* __restrict__ val,
                           const float* __restrict__ r,
                           const float* __restrict__ resmask,
                           float* __restrict__ wmd, int* __restrict__ iters,
                           int* __restrict__ work,
                           int* __restrict__ ext, int measure,
                           int* __restrict__ over, int* __restrict__ n_over,
                           unsigned long long* __restrict__ stats, int Q,
                           int VR, int N, int L, int n_iter, float lam,
                           int log_domain, int block_n, float tol,
                           int check_every, int arena_floats,
                           int lo_floats, int hi_floats) {
  extern __shared__ __align__(16) float arena[];
  __shared__ LiveRound s;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned full = 0xffffffffu;
  const int total = Q * N;
  // pairs a block takes at a time: kLPairs, or its share of a launch of
  // few pairs, so that they spread over every block
  const int share = min(kLPairs, max(1, (total + (int)gridDim.x - 1) /
                                            (int)gridDim.x));
  const size_t nl = (size_t)N * L;
  const int nb = (N + block_n - 1) / block_n;
  const bool adaptive = check_every > 0;
  if (tid == 0) {
    s.ncand = 0;
    s.exhausted = 0;
  }

  for (;;) {
    __syncthreads();                // the last round's state is read
    if (tid == 0) {                 // take the next pairs
      const int need = s.exhausted ? 0 : min(share, kLPairs - s.ncand);
      const int base = need > 0 ? atomicAdd(work, need) : total;
      const int got = base < total ? min(need, total - base) : 0;
      if (got < need) s.exhausted = 1;
      s.fetch = base;
      s.nfetch = got;
    }
    __syncthreads();
    if (wid < s.nfetch) {           // measure one (a warp), or read it
      const int p = s.fetch + wid, q = p / N, n = p - q * N;
      int kext, lt;
      if (measure) {
        measure_pair(g, val, q, n, VR, N, L, log_domain, &kext, &lt);
        if (lane == 0) {
          ext[p] = (int)((unsigned)kext << 16 | (unsigned)lt);
          if (lt == 0) {            // inert doc: what the full loop gives
            wmd[(size_t)q * N + n] = 0.f;
            if (iters != nullptr)
              atomicMax(iters + (size_t)q * nb + n / block_n,
                        inert_count(n_iter, tol, check_every));
          }
        }
      } else {
        kext = (int)((unsigned)ext[p] >> 16);
        lt = ext[p] & 0xffff;
      }
      if (lane == 0) {
        s.eK[wid] = kext;
        s.eL[wid] = lt;
      }
    }
    __syncthreads();
    if (tid == 0) {                 // queue, then pack in order
      for (int i = 0; i < s.nfetch; ++i) {
        const int p = s.fetch + i;
        const long long f = s.eL[i] ? live_floats(s.eK[i], s.eL[i]) : 0;
        if (over != nullptr && f > hi_floats)  // for the stream kernel
          over[atomicAdd(n_over, 1)] = p;
        if (s.eL[i] == 0 || f <= lo_floats || f > hi_floats) continue;
        const int c = s.ncand++;
        s.cq[c] = p / N;
        s.cn[c] = p % N;
        s.cK[c] = s.eK[i];
        s.cL[c] = s.eL[i];
      }
      int taken = 0;
      s.pre_k[0] = s.pre_l[0] = s.pre_sd[0] = s.pre_sp[0] = 0;
      {
        long long off = 0;
        for (; taken < s.ncand; ++taken) {
          const int K = s.cK[taken], Lt = s.cL[taken], i = taken;
          const long long f = live_floats(K, Lt);
          if (off + f > arena_floats) break;
          const int ck = (K + kLSeg - 1) / kLSeg, cl = (Lt + kLSeg - 1) / kLSeg;
          s.q[i] = s.cq[taken];
          s.n[i] = s.cn[taken];
          s.K[i] = K;
          s.Lt[i] = Lt;
          s.tile[i] = (int)off;
          s.part[i] = s.tile[i] + (int)r4((long long)K * (Lt | 1));
          s.u[i] = s.part[i] + (int)r4(ck * Lt > cl * K ? ck * Lt : cl * K);
          s.rinv[i] = s.u[i] + (int)r4(K);
          s.w[i] = s.rinv[i] + (int)r4(K);
          s.wprev[i] = s.w[i] + (int)r4(Lt);
          s.val[i] = s.wprev[i] + (int)r4(Lt);
          s.shift[i] = s.val[i] + (int)r4(Lt);
          s.end[i] = adaptive ? INT_MAX : n_iter;
          s.next[i] = 1;
          s.scope[i] = resmask == nullptr ||
                       resmask[(size_t)s.q[i] * N + s.n[i]] > 0.f;
          s.diff[i] = s.scale[i] = 0u;
          s.pre_k[i + 1] = s.pre_k[i] + K;
          s.pre_l[i + 1] = s.pre_l[i] + Lt;
          s.pre_sd[i + 1] = s.pre_sd[i] + ck * Lt;
          s.pre_sp[i + 1] = s.pre_sp[i] + cl * K;
          if (stats != nullptr)
            atomicAdd(stats, (unsigned long long)K * Lt);
          off += f;
        }
        s.np = taken;
        s.maxend = adaptive ? INT_MAX : n_iter;
      }
      for (int i = taken; i < s.ncand; ++i) {
        s.cq[i - taken] = s.cq[i];
        s.cn[i - taken] = s.cn[i];
        s.cK[i - taken] = s.cK[i];
        s.cL[i - taken] = s.cL[i];
      }
      s.ncand -= taken;
    }
    __syncthreads();
    const int np = s.np;
    if (np == 0) {
      if (s.ncand == 0 && s.exhausted) break;
      continue;
    }

    // load: a warp per row of a pair's live tile, lanes over its slots
    for (int row = wid, p = 0; row < s.pre_k[np]; row += kLWarps) {
      p = pair_of(s.pre_k, row, p);
      const int k = row - s.pre_k[p], Lt = s.Lt[p];
      const float* src =
          g + ((size_t)s.q[p] * VR + k) * nl + (size_t)s.n[p] * L;
      float* dst = arena + s.tile[p] + k * (Lt | 1);
      for (int l = lane; l < Lt; l += 32) async_copy::copy4(dst + l, src + l);
    }
    async_copy::commit();
    for (int i = tid, p = 0; i < s.pre_k[np]; i += kLThreads) {
      p = pair_of(s.pre_k, i, p);
      const int k = i - s.pre_k[p];
      arena[s.rinv[p] + k] = safe_inv(r[(size_t)s.q[p] * VR + k]);
    }
    for (int i = tid, p = 0; i < s.pre_l[np]; i += kLThreads) {
      p = pair_of(s.pre_l, i, p);
      const int l = i - s.pre_l[p];
      arena[s.val[p] + l] = val[(size_t)s.n[p] * L + l];
      arena[s.shift[p] + l] = 0.f;
    }
    async_copy::wait<0>();
    __syncthreads();

    if (log_domain) {               // shift per column (max in any order)
      for (int i = tid, p = 0; i < s.pre_l[np]; i += kLThreads) {
        p = pair_of(s.pre_l, i, p);
        const int l = i - s.pre_l[p], Ls = s.Lt[p] | 1, K = s.K[p];
        const float* t = arena + s.tile[p] + l;
        float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        int k = 0;
        for (; k + 4 <= K; k += 4)
#pragma unroll
          for (int j = 0; j < 4; ++j) m[j] = fmaxf(m[j], t[(k + j) * Ls]);
        for (; k < K; ++k) m[0] = fmaxf(m[0], t[k * Ls]);
        const float mm = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
        arena[s.shift[p] + l] = isfinite(mm) ? mm : 0.f;
      }
      __syncthreads();
    }
    // exponentiate once (log domain); live rows (any G != 0)
    for (int row = wid, p = 0; row < s.pre_k[np]; row += kLWarps) {
      p = pair_of(s.pre_k, row, p);
      const int k = row - s.pre_k[p], Lt = s.Lt[p];
      float* t = arena + s.tile[p] + k * (Lt | 1);
      const float* sh = arena + s.shift[p];
      bool any = false;
      for (int l = lane; l < Lt; l += 32) {
        float v = t[l];
        if (log_domain) t[l] = v = isfinite(v) ? expf(v - sh[l]) : 0.f;
        any = any || v != 0.f;
      }
      any = __any_sync(full, any);
      if (lane == 0) arena[s.u[p] + k] = any ? 1.f : 0.f;
    }
    __syncthreads();
    for (int p = wid; p < np; p += kLWarps) {
      float c = 0.f;
      for (int k = lane; k < s.K[p]; k += 32) c += arena[s.u[p] + k];
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_xor_sync(full, c, off);
      if (lane == 0) s.cnt[p] = c;
    }
    __syncthreads();
    for (int i = tid, p = 0; i < s.pre_k[np]; i += kLThreads) {
      p = pair_of(s.pre_k, i, p);
      float* u = arena + s.u[p] + (i - s.pre_k[p]);
      *u = *u > 0.f ? safe_inv(1.f / s.cnt[p]) : 0.f;
    }
    __syncthreads();

    for (int done = 0;; ++done) {
      // SDDMM partials: slot l, rows [c * kLSeg, +kLSeg)
      for (int i = tid, p = 0; i < s.pre_sd[np]; i += kLThreads) {
        p = pair_of(s.pre_sd, i, p);
        if (done > s.end[p]) continue;
        const int j = i - s.pre_sd[p], Lt = s.Lt[p], Ls = Lt | 1;
        const int c = j / Lt, l = j - c * Lt;
        const int k1 = min(c * kLSeg + kLSeg, s.K[p]);
        const float* t = arena + s.tile[p] + l;
        const float* u = arena + s.u[p];
        float a = 0.f;
        int k = c * kLSeg;
        for (; k + 4 <= k1; k += 4) {
          const float4 uu = *reinterpret_cast<const float4*>(u + k);
          a = fmaf(rnd<BF16>(t[k * Ls]), rnd<BF16>(uu.x), a);
          a = fmaf(rnd<BF16>(t[(k + 1) * Ls]), rnd<BF16>(uu.y), a);
          a = fmaf(rnd<BF16>(t[(k + 2) * Ls]), rnd<BF16>(uu.z), a);
          a = fmaf(rnd<BF16>(t[(k + 3) * Ls]), rnd<BF16>(uu.w), a);
        }
        for (; k < k1; ++k) a = fmaf(rnd<BF16>(t[k * Ls]), rnd<BF16>(u[k]), a);
        arena[s.part[p] + j] = a;
      }
      __syncthreads();
      // w from the partials; the residual's maxima at a decision point
      for (int i = tid, p = 0; i < s.pre_l[np]; i += kLThreads) {
        p = pair_of(s.pre_l, i, p);
        if (done > s.end[p]) continue;
        const int l = i - s.pre_l[p], Lt = s.Lt[p];
        const int ck = (s.K[p] + kLSeg - 1) / kLSeg;
        float t = 0.f;
        for (int c = 0; c < ck; ++c) t += arena[s.part[p] + c * Lt + l];
        const float v = arena[s.val[p] + l];
        const float inv = log_domain ? safe_inv(t) : 1.f / t;
        const float w = v > 0.f ? v * inv : 0.f;
        arena[s.w[p] + l] = w;
        if (adaptive && done < s.end[p] && done + 1 == s.next[p]) {
          float* wp = arena + s.wprev[p] + l;
          if (s.scope[p] && v > 0.f) {
            atomicMax(&s.diff[p], __float_as_uint(fabsf(w - *wp)));
            atomicMax(&s.scale[p], __float_as_uint(fabsf(w)));
          }
          *wp = w;
        }
      }
      __syncthreads();
      if (done >= s.maxend) break;  // last pass: u and w for the distance
      // SpMM partials: row k, slots [c * kLSeg, +kLSeg)
      for (int i = tid, p = 0; i < s.pre_sp[np]; i += kLThreads) {
        p = pair_of(s.pre_sp, i, p);
        if (done >= s.end[p]) continue;
        const int j = i - s.pre_sp[p], K = s.K[p], Lt = s.Lt[p];
        const int c = j / K, k = j - c * K;
        const int l1 = min(c * kLSeg + kLSeg, Lt);
        const float* t = arena + s.tile[p] + k * (Lt | 1);
        const float* w = arena + s.w[p];
        const float ri = arena[s.rinv[p] + k];
        float a = 0.f;
        int l = c * kLSeg;
        for (; l + 4 <= l1; l += 4) {
          const float4 ww = *reinterpret_cast<const float4*>(w + l);
          if constexpr (BF16) {
            a = fmaf(rnd<BF16>(t[l] * ri), rnd<BF16>(ww.x), a);
            a = fmaf(rnd<BF16>(t[l + 1] * ri), rnd<BF16>(ww.y), a);
            a = fmaf(rnd<BF16>(t[l + 2] * ri), rnd<BF16>(ww.z), a);
            a = fmaf(rnd<BF16>(t[l + 3] * ri), rnd<BF16>(ww.w), a);
          } else {
            a = fmaf(t[l], ww.x, a);
            a = fmaf(t[l + 1], ww.y, a);
            a = fmaf(t[l + 2], ww.z, a);
            a = fmaf(t[l + 3], ww.w, a);
          }
        }
        for (; l < l1; ++l)
          a = BF16 ? fmaf(rnd<BF16>(t[l] * ri), rnd<BF16>(w[l]), a)
                   : fmaf(t[l], w[l], a);
        arena[s.part[p] + j] = a;
      }
      __syncthreads();
      // u = 1/x from the partials
      for (int i = tid, p = 0; i < s.pre_k[np]; i += kLThreads) {
        p = pair_of(s.pre_k, i, p);
        if (done >= s.end[p]) continue;
        const int k = i - s.pre_k[p], K = s.K[p];
        const int cl = (s.Lt[p] + kLSeg - 1) / kLSeg;
        float x = 0.f;
        for (int c = 0; c < cl; ++c) x += arena[s.part[p] + c * K + k];
        if constexpr (!BF16) x *= arena[s.rinv[p] + k];
        arena[s.u[p] + k] = safe_inv(x);
      }
      __syncthreads();
      if (adaptive) {                                       // decide
        if (tid < np && done < s.end[tid] && done + 1 == s.next[tid]) {
          const float diff = __uint_as_float(s.diff[tid]);
          const float scale = __uint_as_float(s.scale[tid]);
          s.diff[tid] = s.scale[tid] = 0u;
          const bool conv = done > 0 && !(diff / fmaxf(scale, 1e-30f) > tol);
          if (conv || done + 1 >= n_iter) {
            s.end[tid] = done + 1;
          } else {
            s.next[tid] = done + 1 + check_every;
          }
        }
        __syncthreads();
        if (tid == 0) {
          int m = 0;
          for (int p = 0; p < np; ++p) m = max(m, s.end[p]);
          s.maxend = m;
        }
      }
    }

    // distance line: partials of sum_l (-G log G)[k,l] w[l], then u[k]
    // times each row's sum over lam, then a warp per pair sums its rows
    // in a fixed order
    for (int i = tid, p = 0; i < s.pre_sp[np]; i += kLThreads) {
      p = pair_of(s.pre_sp, i, p);
      const int j = i - s.pre_sp[p], K = s.K[p], Lt = s.Lt[p];
      const int c = j / K, k = j - c * K;
      const int l1 = min(c * kLSeg + kLSeg, Lt);
      const float* t = arena + s.tile[p] + k * (Lt | 1);
      const float* w = arena + s.w[p];
      float a = 0.f;
      for (int l = c * kLSeg; l < l1; ++l) {
        const float gv = t[l];
        a = fmaf(gv > 0.f ? -gv * logf(gv) : 0.f, w[l], a);
      }
      arena[s.part[p] + j] = a;
    }
    __syncthreads();
    for (int i = tid, p = 0; i < s.pre_k[np]; i += kLThreads) {
      p = pair_of(s.pre_k, i, p);
      const int k = i - s.pre_k[p], K = s.K[p];
      const int cl = (s.Lt[p] + kLSeg - 1) / kLSeg;
      float x = 0.f;
      for (int c = 0; c < cl; ++c) x += arena[s.part[p] + c * K + k];
      arena[s.rinv[p] + k] = arena[s.u[p] + k] * (x / lam);
    }
    __syncthreads();
    for (int p = wid; p < np; p += kLWarps) {
      const int K = s.K[p], Lt = s.Lt[p];
      float part = 0.f, corr = 0.f;
      bool bad = false;             // a w that is not finite
      for (int k = lane; k < K; k += 32) part += arena[s.rinv[p] + k];
      for (int l = lane; l < Lt; l += 32) {
        const float w = arena[s.w[p] + l];
        bad = bad || !isfinite(w);
        if (log_domain)
          corr = fmaf(arena[s.shift[p] + l], arena[s.val[p] + l], corr);
      }
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_down_sync(full, part, off);
        corr += __shfl_down_sync(full, corr, off);
      }
      bad = __any_sync(full, bad);
      if (lane == 0) {
        float total = log_domain ? part - corr / lam : part;
        // a dead row's 0 * inf in the full loop (stream_solve's note)
        if (bad && s.cnt[p] < (float)VR) total = NAN;
        wmd[(size_t)s.q[p] * N + s.n[p]] = total;
        if (iters != nullptr)
          atomicMax(iters + (size_t)s.q[p] * nb + s.n[p] / block_n,
                    s.end[p]);
      }
    }
  }
}

// The pairs whose live tile is over the live-tile kernel's arena, which
// its second launch lists in `over` (n_over of them, in any order), each
// solved by stream_solve over its live rows and slots (its extents in
// `ext`, as the first launch measured them) by one block, as the
// device-memory kernel solves a pair. Persistent blocks take the list in
// strides; many share an SM (their shared memory is the vectors alone),
// so the streamed pairs' reads of G overlap as the device-memory
// kernel's do. A pair's result does not depend on the block that solves
// it.
template <bool BF16>
__global__ void __launch_bounds__(kGThreads)
sinkhorn_fused_stream_kernel(const float* __restrict__ g,
                             const float* __restrict__ val,
                             const float* __restrict__ r,
                             const float* __restrict__ resmask,
                             float* __restrict__ wmd, int* __restrict__ iters,
                             const int* __restrict__ ext,
                             const int* __restrict__ over,
                             const int* __restrict__ n_over,
                             unsigned long long* __restrict__ stats, int VR,
                             int N, int L, int n_iter, float lam,
                             int log_domain, int block_n, float tol,
                             int check_every) {
  extern __shared__ float smem[];
  const int count = *n_over;
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int p = over[i], q = p / N, n = p - q * N;
    const int K = (int)((unsigned)ext[p] >> 16), Lt = ext[p] & 0xffff;
    if (stats != nullptr && threadIdx.x == 0)
      atomicAdd(stats + 1, (unsigned long long)K * Lt);
    stream_solve<BF16>(smem, g, val, r, resmask, wmd, iters, q, n, VR, N, L,
                       K, Lt, n_iter, lam, log_domain, block_n, tol,
                       check_every);
    __syncthreads();                // the next pair rewrites the vectors
  }
}

struct Args {
  const float *g, *val, *r, *resmask;
  float* wmd;
  int* iters;
  int* work;
  int* ext;
  unsigned long long* stats;
  int Q, VR, N, L, n_iter;
  float lam;
  int log_domain, block_n;
  float tol;
  int check_every;
  int arena_bytes;
};

bool fits_warp(int VR, int L) { return VR <= 64 && L <= 64; }

template <int KC, int LC, bool ROWS_SMEM>
constexpr long long warp_smem_bytes() {
  return (long long)sizeof(float) * kWarpsPerBlock *
         WarpTile<KC, LC, ROWS_SMEM>::FLOATS;
}

long long warp_smem_bytes(int VR, int L) {
  const bool k2 = VR > 32, l2 = L > 32;
  if (k2 && l2) return warp_smem_bytes<2, 2, true>();
  if (k2) return warp_smem_bytes<2, 1, false>();
  if (l2) return warp_smem_bytes<1, 2, false>();
  return warp_smem_bytes<1, 1, false>();
}

template <int KC, int LC, bool BF16, bool ROWS_SMEM>
cudaError_t launch_warp(const Args& a, cudaStream_t stream) {
  auto kernel = sinkhorn_fused_warp_kernel<KC, LC, BF16, ROWS_SMEM>;
  constexpr int smem = (int)warp_smem_bytes<KC, LC, ROWS_SMEM>();
  constexpr int threads = 32 * kWarpsPerBlock;
  // resident blocks on the card, asked once per device
  cudaError_t err = device_attr::allow_smem(kernel, smem);
  long long room = 0;
  if (err == cudaSuccess) err = device_attr::room(kernel, threads, smem, &room);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)a.Q * a.N;
  const long long need = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = (int)(need < room ? need : room);
  const int vec4 = a.L % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(a.g) % 16 == 0;
  kernel<<<blocks, threads, smem, stream>>>(
      a.g, a.val, a.r, a.resmask, a.wmd, a.iters, a.Q, a.VR, a.N, a.L,
      a.n_iter, a.lam, a.log_domain, a.block_n, a.tol, a.check_every, vec4);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_warp_class(const Args& a, cudaStream_t s) {
  const bool k2 = a.VR > 32, l2 = a.L > 32;
  if (k2 && l2) return launch_warp<2, 2, BF16, true>(a, s);
  if (k2) return launch_warp<2, 1, BF16, false>(a, s);
  if (l2) return launch_warp<1, 2, BF16, false>(a, s);
  return launch_warp<1, 1, BF16, false>(a, s);
}

long long smem_bytes(int VR, int L) {
  return (long long)sizeof(float) *
         ((long long)VR * (L | 1) + 3LL * VR + 4LL * L + 2 * kThreads / 32);
}

long long global_smem_bytes(int VR, int L) {
  return (long long)sizeof(float) *
         (3LL * VR + 4LL * L + 2 * kGThreads / 32);
}

constexpr long long kMaxBlockSmem = 232448;   // the H100's 227 KB
// the live-tile kernel's static shared memory (its LiveRound), with room
// for the compiler's alignment
constexpr long long kLiveStatic = 2048;
static_assert(sizeof(LiveRound) + 64 <= kLiveStatic, "LiveRound grew");


// Variant: 0 ("auto") picks the warp-per-tile kernel when the tile fits
// 64 x 64, else the live-tile route; 1 asks for the warp-per-tile kernel
// (the tile must fit 64 x 64), 2 for the shared-memory one, 3 for the
// device-memory one. The shared- and
// device-memory kernels run every padded slot of the tile (the first
// reads it into shared memory with 64 threads a block, so at most two
// blocks an SM; the second reads it from device memory at every pass);
// "auto" ran them past 64 x 64 until the live-tile kernel replaced them
// there, and they stay for tests and timings to hold against it.
bool use_warp(int VR, int L, int variant) {
  return variant == 1 || (variant == 0 && fits_warp(VR, L));
}

template <typename K>
cudaError_t launch_dyn(K kernel, int threads, size_t smem, const Args& a,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.N, a.Q);
  kernel<<<grid, threads, smem, s>>>(
      a.g, a.val, a.r, a.resmask, a.wmd, a.iters, a.VR, a.N, a.L, a.n_iter,
      a.lam, a.log_domain, a.block_n, a.tol, a.check_every);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_live(const Args& a, cudaStream_t stream) {
  auto kernel = sinkhorn_fused_live_kernel<BF16>;
  const size_t smem = (size_t)a.arena_bytes;
  // the most a block may take beside its LiveRound, set once per device
  cudaError_t err =
      device_attr::allow_smem(kernel, (size_t)(kMaxBlockSmem - kLiveStatic));
  long long room = 0;
  if (err == cudaSuccess)
    err = device_attr::room(kernel, kLThreads, smem, &room);
  if (err != cudaSuccess) return err;
  // the small class at two blocks an SM, each with half the arena
  const int half = a.arena_bytes / 8 - 512;
  long long room2 = 0;
  err = device_attr::room(kernel, kLThreads, (size_t)half * 4, &room2);
  if (err != cudaSuccess) return err;
  // the stream kernel's vectors (at most the wrapper's limit), and its
  // resident blocks at this shape
  auto streamed = sinkhorn_fused_stream_kernel<BF16>;
  const size_t gsmem = (size_t)global_smem_bytes(a.VR, a.L);
  long long room_s = 0;
  err = device_attr::allow_smem(streamed, (size_t)kMaxBlockSmem);
  if (err == cudaSuccess)
    err = device_attr::room(streamed, kGThreads, gsmem, &room_s);
  if (err != cudaSuccess) return err;
  // the first launch measures every pair it takes (all of them) and keeps
  // its extents in ext; the second reads them there and lists the pairs
  // over its arena for the stream kernel
  const long long pairs = (long long)a.Q * a.N;
  int* over = a.ext + pairs;
  int blocks = (int)(pairs < room2 ? pairs : room2);
  kernel<<<blocks, kLThreads, (size_t)half * 4, stream>>>(
      a.g, a.val, a.r, a.resmask, a.wmd, a.iters, a.work, a.ext, 1, nullptr,
      nullptr, a.stats, a.Q, a.VR, a.N, a.L, a.n_iter, a.lam, a.log_domain,
      a.block_n, a.tol, a.check_every, half, 0, half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blocks = (int)(pairs < room ? pairs : room);
  const int arena = (int)(smem / sizeof(float));
  kernel<<<blocks, kLThreads, smem, stream>>>(
      a.g, a.val, a.r, a.resmask, a.wmd, a.iters, a.work + 1, a.ext, 0, over,
      a.work + 2, a.stats, a.Q, a.VR, a.N, a.L, a.n_iter, a.lam,
      a.log_domain, a.block_n, a.tol, a.check_every, arena, half, arena);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blocks = (int)(pairs < room_s ? pairs : room_s);
  streamed<<<blocks, kGThreads, gsmem, stream>>>(
      a.g, a.val, a.r, a.resmask, a.wmd, a.iters, a.ext, over, a.work + 2,
      a.stats, a.VR, a.N, a.L, a.n_iter, a.lam, a.log_domain, a.block_n,
      a.tol, a.check_every);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch(const Args& a, int variant, cudaStream_t s) {
  if (use_warp(a.VR, a.L, variant)) return launch_warp_class<BF16>(a, s);
  if (variant == 3)
    return launch_dyn(sinkhorn_fused_global_kernel<BF16>, kGThreads,
                      (size_t)global_smem_bytes(a.VR, a.L), a, s);
  if (variant == 2)
    return launch_dyn(sinkhorn_fused_batched_kernel<BF16>, kThreads,
                      (size_t)smem_bytes(a.VR, a.L), a, s);
  return launch_live<BF16>(a, s);
}

}  // namespace

// Shared-memory bytes one block of the chosen variant needs (the
// live-tile route: its arena and static LiveRound, or the stream
// kernel's vectors where more). The wrapper refuses shapes above the
// card's per-block limit before launching.
extern "C" long long sinkhorn_fused_smem_bytes(int VR, int L, int variant,
                                               int arena_bytes) {
  if (use_warp(VR, L, variant)) return warp_smem_bytes(VR, L);
  if (variant == 3) return global_smem_bytes(VR, L);
  if (variant == 2) return smem_bytes(VR, L);
  // the live-tile kernel's block, or the stream kernel's where more
  const long long live = arena_bytes + kLiveStatic;
  const long long streamed = global_smem_bytes(VR, L);
  return live > streamed ? live : streamed;
}

// Floats of a pair's region in the live-tile kernel's arena at K live rows
// and Lt live slots (kernels/ops.py holds its own copy of the rule to it).
extern "C" long long sinkhorn_fused_live_floats(int K, int Lt) {
  return live_floats(K, Lt);
}

// K1 (and K4, Q = 1): g (Q, VR, N, L), val (N, L), r (Q, VR), resmask
// (Q, N) or null -> wmd (Q, N), and iters (Q, ceil(N / block_n)) unless
// null, which must hold zeros (each doc folds its count in with
// atomicMax); fp32 / int32, contiguous, on the device. check_every = 0
// runs n_iter iterations (tol and resmask unused); check_every > 0 the
// adaptive exit. bf16 != 0 rounds the reductions' operands to bf16. The
// live-tile route (variant 0 past 64 x 64) is three launches: the
// live-tile kernel's two size classes, each taking its pairs from its own
// int of `work` (three, 0 at launch) and packing them into arena_bytes of
// shared memory (half of it in the first), then the stream kernel for the
// pairs over arena_bytes. `ext` holds 2 * Q * N ints, which no caller
// reads: the first launch writes each pair's live extents (K << 16 | Lt;
// VR and L are below 2**16, as the stream kernel's shared memory bounds
// them) to the first Q * N, the second lists the pairs over the arena in
// the rest and counts them in work[2]. The launches add the on-chip and
// streamed live cells to stats[0] and stats[1] unless stats is null.
// Returns the cudaError_t of the launches.
extern "C" int sinkhorn_fused_batched_launch(
    const float* g, const float* val, const float* r, const float* resmask,
    float* wmd, int* iters, int* work, int* ext,
    unsigned long long* stats, int Q,
    int VR, int N, int L, int n_iter, float lam, int log_domain, int block_n,
    float tol, int check_every, int bf16, int variant, int arena_bytes,
    void* stream) {
  if (Q == 0 || N == 0) return 0;
  if (variant < 0 || variant > 3 || (variant == 1 && !fits_warp(VR, L)) ||
      (long long)Q * N >= (1 << 30) ||
      (!use_warp(VR, L, variant) && variant == 0 &&
       (work == nullptr || ext == nullptr || arena_bytes < 4096 ||
        VR >= (1 << 16) || L >= (1 << 16))))
    return (int)cudaErrorInvalidValue;
  const Args a{g,       val,     r,     resmask, wmd,        iters,
               work,    ext,     stats, Q,    VR,      N,
               L,       n_iter,  lam,   log_domain,      block_n,
               tol,     check_every,    arena_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<true>(a, variant, s)
                    : launch<false>(a, variant, s));
}
