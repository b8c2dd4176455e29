// K5 for Hopper: one fused SDDMM_SpMM Sinkhorn iteration, the paper's
// Fig. 4 kernel in ELL form.
//
// Replaces: src/repro/kernels/sddmm_spmm.py, sddmm_spmm_step (pallas_call
// body _step_kernel), the public entry point repro.kernels.ops.
// sddmm_spmm_step (the fusion ablation).
//
// Per document n, with G = g[:, n, :] and GR = g_over_r[:, n, :] (VR x L):
//   u[k] = safe_inv(x[k, n])
//   t[l] = sum_k G[k, l] u[k]                     (SDDMM)
//   w[l] = val[n, l] * safe_inv(t[l])              (sparse selection)
//   x'[k, n] = sum_l GR[k, l] w[l]                 (SpMM)
// safe_inv(z) = 1/z for z >= FLT_MIN, else 0: both inverses are guarded,
// as in the reference's _step_kernel (K1 keeps a raw val/t instead), and a
// subnormal argument counts as not positive, as the reference's fp32 flushes
// it to zero (1/z of a subnormal z overflows to inf, and a dead slot's
// 0 * inf would turn its doc's x' NaN).
//
// What bounds it on the H100: bytes. At the paper's widest query (VR = 23,
// N = 5000, L = 28) G and G/r are 12.9 MB each, ~8 us at 3.35 TB/s; the
// 4*VR*L flops per doc are ~0.2 us at 67 TFLOP/s. Both are read at every
// slot: G/r is needed only where val != 0 (~16 of 28 slots there), but
// reading it only up to each doc's last live slot was no faster (PERF.md,
// section 6), and every slot keeps x' equal to the plain version's for any
// G/r (an inf times w = 0 is NaN in both).
//
// What the design does about it: each warp asks for a doc's bytes with a
// whole tile's loads in flight at once, and leaves the SM's shared memory
// to L1. (A cp.async ring of the same tiles in shared memory ran slower the
// more of it it held; PERF.md, section 6.)
// - Persistent warps: the grid holds as many 4-warp blocks as are
//   resident on the card (or fewer), and each warp strides over the docs,
//   one doc at a time; no block barrier.
// - SDDMM: lane l owns slot l (lanes loop over slot classes above 32). It
//   loads its column of G a chunk of rows at a time, all of the chunk's
//   loads before the first FMA (one coalesced L-wide read a row), and sums
//   it against u, which lane k computes from x[k, n] and hands out by
//   shuffle. w goes to the warp's L floats of shared memory.
// - SpMM: lane l loads its column of G/r the same way, times w[l]; a
//   transposing butterfly (31 shuffles) then leaves row k's sum in lane k
//   (summed over slot classes), which stores x'[k, n].
// - Any shape: rows in chunks of 32 and slots in classes of 32, except
//   where VR <= 24 and L <= 32 (the paper's queries and docs): one chunk of
//   24 rows with each loop run once, known to the compiler (the loops, or
//   a chunk of 32 rows, took 11.1 and 10.1 against 8.8 us for the paper's
//   23-row queries). Shared memory holds only w (L floats a warp), with
//   fewer warps a block for L over 14 528.

#include <cfloat>

#include <cuda_runtime.h>

#include "device_attr.cuh"

namespace {

constexpr int kWarps = 4;          // warps per block, at most
// resident blocks an SM should fit: 10 (48 registers a thread) where VR
// and L fit one tile, so 40 warps an SM run the paper's 5000 docs in one
// pass on 132 SMs; 8 (64 registers) for the loops over wider tiles, which
// spill at 48
constexpr int kMinBlocks = 10, kMinBlocksWide = 8;
constexpr int kMaxSmem = 232448;   // the H100's per-block limit (227 KB)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float safe_inv(float z) {
  return z >= FLT_MIN ? 1.f / z : 0.f;
}

// One step of the transposing butterfly: lanes on either side of bit O
// swap halves of p[0 .. 2*O) and add, so p[0 .. O) carries twice as many
// lanes' terms.
template <int O>
__device__ __forceinline__ void transpose_step(float (&p)[32], int lane) {
  const bool hi = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = hi ? p[i] : p[i + O];
    const float keep = hi ? p[i + O] : p[i];
    p[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// p[k] on every lane -> the warp's sum of p[k] on lane k
__device__ __forceinline__ float transpose_sum(float (&p)[32], int lane) {
  transpose_step<16>(p, lane);
  transpose_step<8>(p, lane);
  transpose_step<4>(p, lane);
  transpose_step<2>(p, lane);
  transpose_step<1>(p, lane);
  return p[0];
}

// KM: rows a chunk (32, or 24 where VR fits them: the rows past KM are
// known zeros and take no registers). ONE: VR <= KM and L <= 32 (the
// paper's queries and docs), where each loop over row chunks and slot
// classes runs once, known to the compiler.
template <int KM, bool ONE>
__global__ void __launch_bounds__(32 * kWarps,
                                  ONE ? kMinBlocks : kMinBlocksWide)
sddmm_spmm_step_kernel(const float* __restrict__ g,
                       const float* __restrict__ gor,
                       const float* __restrict__ val,
                       const float* __restrict__ x, float* __restrict__ xout,
                       int VR, int N, int L) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  float* ws = smem + (threadIdx.x >> 5) * L;               // w, L floats
  const size_t nl = (size_t)N * L;
  for (int n = blockIdx.x * wpb + (threadIdx.x >> 5); n < N;
       n += gridDim.x * wpb) {
    const float* gn = g + (size_t)n * L;
    const float* grn = gor + (size_t)n * L;
    for (int l0 = 0; l0 < (ONE ? 1 : L); l0 += 32) {       // SDDMM
      const int l = l0 + lane;
      const bool on = l < L;
      const float v = on ? val[(size_t)n * L + l] : 0.f;
      float t0 = 0.f, t1 = 0.f;
      for (int k0 = 0; k0 < (ONE ? 1 : VR); k0 += KM) {
        const float xk = lane < KM && k0 + lane < VR
                             ? x[(size_t)(k0 + lane) * N + n] : 0.f;
        float col[KM];
#pragma unroll
        for (int k = 0; k < KM; ++k)
          col[k] = on && k0 + k < VR ? gn[(k0 + k) * nl + l] : 0.f;
        const float uk = safe_inv(xk);   // after the loads: 1/x branches
#pragma unroll
        for (int k = 0; k < KM; k += 2) {
          t0 = fmaf(col[k], __shfl_sync(kFull, uk, k), t0);
          t1 = fmaf(col[k + 1], __shfl_sync(kFull, uk, k + 1), t1);
        }
      }
      if (on) ws[l] = v * safe_inv(t0 + t1);
    }
    // lim = L. Where the loops run once, it comes from a warp reduction,
    // which the compiler cannot see through: the SpMM's load predicates are
    // then made here, not during the SDDMM and held across it in general
    // registers, which took 11.1 against 8.8 us at the paper shape
    // (PERF.md, section 6)
    const int lim = ONE ? __reduce_max_sync(kFull, L) : L;
    __syncwarp();
    for (int k0 = 0; k0 < (ONE ? 1 : VR); k0 += KM) {      // SpMM
      float s = 0.f;
      for (int l0 = 0; l0 < (ONE ? 1 : lim); l0 += 32) {
        const int l = l0 + lane;
        const bool on = l < lim;
        const float w = on ? ws[l] : 0.f;
        float p[32];
#pragma unroll
        for (int k = 0; k < 32; ++k)
          p[k] = k < KM && on && k0 + k < VR ? grn[(k0 + k) * nl + l] : 0.f;
#pragma unroll
        for (int k = 0; k < KM; ++k) p[k] *= w;
        s += transpose_sum(p, lane);
      }
      if (lane < KM && k0 + lane < VR)
        xout[(size_t)(k0 + lane) * N + n] = s;
    }
    __syncwarp();                        // ws is the next doc's
  }
}

// Warps a block: 4, fewer where 4 warps' w (L floats each) exceed the
// per-block shared memory; 0 where even one warp's does.
int block_warps(int L) {
  for (int wpb = kWarps; wpb >= 1; wpb /= 2)
    if ((long long)sizeof(float) * wpb * L <= kMaxSmem) return wpb;
  return 0;
}

template <int KM, bool ONE>
cudaError_t launch(const float* g, const float* gor, const float* val,
                   const float* x, float* xout, int VR, int N, int L,
                   cudaStream_t stream) {
  auto kernel = sddmm_spmm_step_kernel<KM, ONE>;
  const int wpb = block_warps(L);
  if (wpb == 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * wpb * (size_t)L;
  // the largest block's shared memory, and the resident blocks on the
  // card for this block shape, once per device
  cudaError_t err = device_attr::allow_smem(kernel, kMaxSmem);
  long long room = 0;
  if (err == cudaSuccess)
    err = device_attr::room(kernel, 32 * wpb, smem, &room);
  if (err != cudaSuccess) return err;
  const long long need = (N + wpb - 1) / wpb;
  kernel<<<(int)(need < room ? need : room), 32 * wpb, smem, stream>>>(
      g, gor, val, x, xout, VR, N, L);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared-memory bytes one block takes (w of each warp), or -1
// where not even one warp's L floats fit; the wrapper refuses that before
// launching.
extern "C" long long sddmm_spmm_step_smem_bytes(int L) {
  const int wpb = block_warps(L);
  return wpb > 0 ? (long long)sizeof(float) * wpb * L : -1;
}

// g, g_over_r (VR, N, L), val (N, L), x (VR, N) -> xout (VR, N); fp32,
// contiguous, on the device. Returns the cudaError_t of the launch.
extern "C" int sddmm_spmm_step_launch(const float* g, const float* gor,
                                      const float* val, const float* x,
                                      float* xout, int VR, int N, int L,
                                      void* stream) {
  if (VR == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      L > 32 || VR > 24 ? launch<32, false>(g, gor, val, x, xout, VR, N, L, s)
                        : launch<24, true>(g, gor, val, x, xout, VR, N, L, s);
  return (int)err;
}
