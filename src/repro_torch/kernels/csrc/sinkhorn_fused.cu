// K1 and K4 for Hopper: the fused Sinkhorn solve, one tile per (query,
// document).
//
// Replaces: src/repro/kernels/sddmm_spmm.py, sinkhorn_fused_all_batched
// (K1; pallas_call body _fused_batched_kernel -> _solve_block), reached
// from repro.core.index.WmdEngine._solve_group through
// repro.kernels.ops.sinkhorn_fused_all_batched; and sinkhorn_fused_all
// (K4; body _fused_kernel -> the same _solve_block), reached from
// repro.core.wmd.one_to_many(impl="kernel") through
// repro.kernels.ops.sinkhorn_wmd_kernel. K4 is K1 for one query: its entry
// point, sinkhorn_fused_launch, launches the same kernels on an (N, 1)
// grid. Fixed n_iter, fp32, linear or log domain; the adaptive exit
// (tol/resmask) and bf16 operands are not ported yet.
//
// Per (query q, doc n), with G = g[q, :, n, :] (v_r x L):
//   x0[k] = 1/(live rows) on rows with any G != 0, else 0
//   repeat n_iter:  u = 1/x (0 where x <= 0)
//                   t[l] = sum_k G[k,l] u[k]                (SDDMM)
//                   w[l] = val[l] * (1/t[l]) on live slots
//                   x[k] = sum_l (G[k,l]/r[k]) w[l]          (SpMM)
//   wmd = sum_k u[k] sum_l GM[k,l] w[l],  GM = -G log G / lam (G > 0)
// Under log_domain g holds log K (pad rows -inf): the tile is shifted by
// its per-column max and exponentiated in shared memory, and the distance
// gets the exact correction -sum_l shift[l] val[l] / lam.
//
// Docs are independent in fixed-iteration mode. The reference starts x
// from 1/(live rows of a block of block_n docs); here the count is the
// doc's own. The two differ by a constant factor per doc, which scales x,
// u and w and cancels in the distance line, so the result does not depend
// on block_n. In the linear domain w = val/t is not guarded: a K column
// that underflowed to all zero turns the distance NaN, which the engine
// raises as LamUnderflowError (the reference's einsum path does the same;
// its kernel path hides the fault, see ROADMAP queue 3).
//
// What bounds it on the H100: reading G once. At the paper's widest chunk
// shape (Q = 4, v_r = 48, N = 8192, L = 48) G is 302 MB, ~90 us at 3.35
// TB/s, while 2 * 2 * v_r * L per doc per iteration over 16 passes is
// ~4.8 GFLOP, ~72 us at 67 TFLOP/s fp32: bound by bytes.
//
// What the design does about it: G is read from device memory exactly
// once, per (query, doc) block, and every iteration and the distance line
// run on chip; u, x, t, w never leave the SM, and GM is rebuilt from the
// tile (no second array). The final sum is a fixed-order block reduction,
// so the result is deterministic. Two variants, chosen by the tile's size:
// sinkhorn_fused_reg_kernel (below) keeps the tile in registers for tiles
// up to 64 x 64, every shape of the paper's workload; the kernel here
// keeps it in dynamic shared memory (row stride padded to an odd count so
// the SpMM's row-per-thread reads hit distinct banks) for wider tiles, up
// to the 227 KB per-block limit. At the main path's widest chunk, on an
// H100 80GB HBM3 at 700 W, the register variant is 1.28x (log) and 1.61x
// (linear) faster (chip_smoke.py phase k1_tiles). Both are latency-bound, not bound by
// bytes: 16 dependent passes per doc, each with block barriers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float safe_inv(float x) {
  return x > 0.f ? 1.f / x : 0.f;
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_fused_batched_kernel(const float* __restrict__ g,
                              const float* __restrict__ val,
                              const float* __restrict__ r,
                              float* __restrict__ wmd,
                              int* __restrict__ iters, int VR, int N, int L,
                              int n_iter, float lam, int log_domain,
                              int block_n) {
  extern __shared__ float smem[];
  const int Ls = L | 1;                    // odd row stride: no bank conflicts
  float* G = smem;                         // (VR, Ls)
  float* xs = G + (size_t)VR * Ls;         // (VR,)
  float* us = xs + VR;                     // (VR,)
  float* rinv = us + VR;                   // (VR,)
  float* ws = rinv + VR;                   // (L,)
  float* vals = ws + L;                    // (L,)
  float* shift = vals + L;                 // (L,)
  float* red = shift + L;                  // (kThreads / 32,)

  const int n = blockIdx.x;
  const int q = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t nl = (size_t)N * L;
  const float* gq = g + (size_t)q * VR * nl + (size_t)n * L;

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

  for (int it = 0; it <= n_iter; ++it) {
    for (int k = tid; k < VR; k += kThreads) us[k] = safe_inv(xs[k]);
    __syncthreads();
    for (int l = tid; l < L; l += kThreads) {              // SDDMM
      float t = 0.f;
      for (int k = 0; k < VR; ++k) t = fmaf(G[k * Ls + l], us[k], t);
      const float v = vals[l];
      float inv = log_domain ? safe_inv(t) : 1.f / t;
      ws[l] = v > 0.f ? v * inv : 0.f;
    }
    __syncthreads();
    if (it == n_iter) break;        // last pass: u and w for the distance
    for (int k = tid; k < VR; k += kThreads) {             // SpMM
      const float ri = rinv[k];
      float x = 0.f;
      for (int l = 0; l < L; ++l) x = fmaf(G[k * Ls + l] * ri, ws[l], x);
      xs[k] = x;
    }
    __syncthreads();
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
    if (n % block_n == 0) {
      const int nb = (N + block_n - 1) / block_n;
      iters[(size_t)q * nb + n / block_n] = n_iter;
    }
  }
}

// Register-resident variant for tiles up to 64 x 64 (every shape of the
// paper's workload). The same arithmetic as the kernel above, but each
// of LM "column" threads keeps its column G[:, l] in registers for the
// SDDMM and each of KM "row" threads its row G[k, :] for the SpMM and the
// distance line, so the loop reads only u and w from shared memory, as
// float4 broadcasts: about one shared load per four FMAs instead of two
// per FMA. Rows k >= VR and slots l >= L are zero in the registers and
// add exact zeros. Two block barriers per iteration instead of three.
template <int KM, int LM>
__global__ void __launch_bounds__(KM + LM)
sinkhorn_fused_reg_kernel(const float* __restrict__ g,
                          const float* __restrict__ val,
                          const float* __restrict__ r,
                          float* __restrict__ wmd, int* __restrict__ iters,
                          int VR, int N, int L, int n_iter, float lam,
                          int log_domain, int block_n) {
  constexpr int RM = KM > LM ? KM : LM;
  constexpr int NT = KM + LM;
  __shared__ float Gs[KM * (LM + 1)];
  __shared__ __align__(16) float us[KM];
  __shared__ __align__(16) float ws[LM];
  __shared__ float vals[LM], shift[LM], rinv[KM], red[NT / 32];

  const int n = blockIdx.x;
  const int q = blockIdx.y;
  const int tid = threadIdx.x;
  const bool is_col = tid < LM;             // column thread l = tid
  const int k = tid - LM;                   // row thread k (if !is_col)
  const size_t nl = (size_t)N * L;
  const float* gq = g + (size_t)q * VR * nl + (size_t)n * L;

  for (int i = tid; i < VR * L; i += NT) {
    int kk = i / L, l = i % L;
    Gs[kk * (LM + 1) + l] = gq[(size_t)kk * nl + l];
  }
  if (is_col) {
    vals[tid] = tid < L ? val[(size_t)n * L + tid] : 0.f;
  } else {
    rinv[k] = k < VR ? safe_inv(r[(size_t)q * VR + k]) : 0.f;
  }
  __syncthreads();

  float reg[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float v = 0.f;
    if (is_col) {
      if (i < KM && i < VR && tid < L) v = Gs[i * (LM + 1) + tid];
    } else {
      if (i < LM && i < L && k < VR) v = Gs[k * (LM + 1) + i];
    }
    reg[i] = v;
  }

  float sh = 0.f;
  if (is_col) {
    if (log_domain && tid < L) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < KM; ++i)
        if (i < VR) m = fmaxf(m, reg[i]);
      sh = isfinite(m) ? m : 0.f;
    }
    shift[tid] = sh;
  }
  __syncthreads();
  if (log_domain) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool in = is_col ? (i < KM && i < VR && tid < L)
                       : (i < LM && i < L && k < VR);
      float s = is_col ? sh : shift[i < LM ? i : 0];
      reg[i] = (in && isfinite(reg[i])) ? expf(reg[i] - s) : 0.f;
    }
  }

  // live rows of this doc: any G != 0 (pad rows are all zero)
  bool live = false;
  if (!is_col && k < VR) {
#pragma unroll
    for (int i = 0; i < LM; ++i) live = live || reg[i] != 0.f;
  }
  const int cnt = __syncthreads_count(live);
  if (!is_col) us[k] = live ? safe_inv(1.f / (float)cnt) : 0.f;
  __syncthreads();

  for (int it = 0; it <= n_iter; ++it) {
    if (is_col) {                                           // SDDMM
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < KM / 4; ++i) {
        const float4 u = u4[i];
        t = fmaf(reg[4 * i + 0], u.x, t);
        t = fmaf(reg[4 * i + 1], u.y, t);
        t = fmaf(reg[4 * i + 2], u.z, t);
        t = fmaf(reg[4 * i + 3], u.w, t);
      }
      const float v = vals[tid];
      const float inv = log_domain ? safe_inv(t) : 1.f / t;
      ws[tid] = v > 0.f ? v * inv : 0.f;
    }
    __syncthreads();
    if (it == n_iter) break;        // last pass: u and w for the distance
    if (!is_col) {                                          // SpMM
      const float4* w4 = reinterpret_cast<const float4*>(ws);
      const float ri = rinv[k];
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < LM / 4; ++i) {
        const float4 w = w4[i];
        x = fmaf(reg[4 * i + 0] * ri, w.x, x);
        x = fmaf(reg[4 * i + 1] * ri, w.y, x);
        x = fmaf(reg[4 * i + 2] * ri, w.z, x);
        x = fmaf(reg[4 * i + 3] * ri, w.w, x);
      }
      us[k] = k < VR ? safe_inv(x) : 0.f;
    }
    __syncthreads();
  }

  // distance line on the row threads: u[k] sum_l GM[k,l] w[l]
  float part = 0.f;
  if (!is_col && k < VR) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < LM; ++i) {
      const float gv = reg[i];
      const float gm = gv > 0.f ? (-gv * logf(gv)) / lam : 0.f;
      s = fmaf(gm, ws[i], s);
    }
    part = us[k] * s;
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < NT / 32; ++i) total += red[i];
    if (log_domain) {
      float corr = 0.f;
      for (int l = 0; l < L; ++l) corr = fmaf(shift[l], vals[l], corr);
      total -= corr / lam;
    }
    wmd[(size_t)q * N + n] = total;
    if (n % block_n == 0) {
      const int nb = (N + block_n - 1) / block_n;
      iters[(size_t)q * nb + n / block_n] = n_iter;
    }
  }
}

template <int KM, int LM>
cudaError_t launch_reg(const float* g, const float* val, const float* r,
                       float* wmd, int* iters, int Q, int VR, int N, int L,
                       int n_iter, float lam, int log_domain, int block_n,
                       cudaStream_t stream) {
  dim3 grid(N, Q);
  sinkhorn_fused_reg_kernel<KM, LM><<<grid, KM + LM, 0, stream>>>(
      g, val, r, wmd, iters, VR, N, L, n_iter, lam, log_domain, block_n);
  return cudaGetLastError();
}

bool fits_registers(int VR, int L) { return VR <= 64 && L <= 64; }

// Variant: 0 picks the register-resident kernel when the tile fits it,
// else the shared-memory one; 1 asks for the register-resident kernel (the
// tile must fit 64 x 64); 2 for the shared-memory one.
bool use_registers(int VR, int L, int variant) {
  return variant == 1 || (variant == 0 && fits_registers(VR, L));
}

}  // namespace

// Dynamic shared-memory bytes one block needs (0 for the register-resident
// variant, whose shared memory is static). The wrapper refuses shapes above
// the card's per-block limit before launching.
extern "C" long long sinkhorn_fused_smem_bytes(int VR, int L, int variant) {
  if (use_registers(VR, L, variant)) return 0;
  return (long long)sizeof(float) *
         ((long long)VR * (L | 1) + 3LL * VR + 3LL * L + kThreads / 32);
}

// g (Q, VR, N, L), val (N, L), r (Q, VR) -> wmd (Q, N),
// iters (Q, ceil(N / block_n)); fp32 / int32, contiguous, on the device.
// Returns the cudaError_t of the launch.
extern "C" int sinkhorn_fused_batched_launch(const float* g, const float* val,
                                             const float* r, float* wmd,
                                             int* iters, int Q, int VR, int N,
                                             int L, int n_iter, float lam,
                                             int log_domain, int block_n,
                                             int variant, void* stream) {
  if (Q == 0 || N == 0) return 0;
  if (variant == 1 && !fits_registers(VR, L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_registers(VR, L, variant)) {
    const bool k32 = VR <= 32, l32 = L <= 32;
    if (k32 && l32)
      return launch_reg<32, 32>(g, val, r, wmd, iters, Q, VR, N, L, n_iter,
                                lam, log_domain, block_n, s);
    if (k32)
      return launch_reg<32, 64>(g, val, r, wmd, iters, Q, VR, N, L, n_iter,
                                lam, log_domain, block_n, s);
    if (l32)
      return launch_reg<64, 32>(g, val, r, wmd, iters, Q, VR, N, L, n_iter,
                                lam, log_domain, block_n, s);
    return launch_reg<64, 64>(g, val, r, wmd, iters, Q, VR, N, L, n_iter,
                              lam, log_domain, block_n, s);
  }
  size_t smem = (size_t)sinkhorn_fused_smem_bytes(VR, L, variant);
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_fused_batched_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N, Q);
  sinkhorn_fused_batched_kernel<<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      g, val, r, wmd, iters, VR, N, L, n_iter, lam, log_domain, block_n);
  return (int)cudaGetLastError();
}

// K4: g (VR, N, L), val (N, L), r (VR,) -> wmd (N,), iters
// (ceil(N / block_n),): K1 with Q = 1, through the same kernels.
extern "C" int sinkhorn_fused_launch(const float* g, const float* val,
                                     const float* r, float* wmd, int* iters,
                                     int VR, int N, int L, int n_iter,
                                     float lam, int log_domain, int block_n,
                                     int variant, void* stream) {
  return sinkhorn_fused_batched_launch(g, val, r, wmd, iters, 1, VR, N, L,
                                       n_iter, lam, log_domain, block_n,
                                       variant, stream);
}
