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
// safe_inv(z) = 1/z for z > 0, else 0: both inverses are guarded, as in
// the reference's _step_kernel (K1 keeps a raw val/t instead).
//
// What bounds it on the H100: reading G and G/r once each. At the
// paper's one-query shape (VR = 24, N = 5000, L = 28) that is 27 MB,
// ~8 us at 3.35 TB/s; the 4*VR*L flops per doc are ~4 us at 67 TFLOP/s.
// So it is bound by bytes.
//
// What the design does about it: one warp per document, four documents
// per block. The SDDMM puts the lanes on the doc's slots, so each query
// word's row of G is one coalesced read; t and w never leave the SM (w
// sits in the warp's slice of shared memory). The SpMM reads each row of
// G/r the same way and sums it across the warp with shuffles, so only x'
// reaches device memory. G and G/r are each read once.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;      // documents per block

__device__ __forceinline__ float safe_inv(float z) {
  return z > 0.f ? 1.f / z : 0.f;
}

__global__ void __launch_bounds__(32 * kWarps)
sddmm_spmm_step_kernel(const float* __restrict__ g,
                       const float* __restrict__ gor,
                       const float* __restrict__ val,
                       const float* __restrict__ x, float* __restrict__ xout,
                       int VR, int N, int L) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;                   // warp-level only: no block barrier
  float* us = smem + (size_t)warp * (VR + L);   // (VR,)
  float* ws = us + VR;                          // (L,)
  const size_t nl = (size_t)N * L;
  const float* gn = g + (size_t)n * L;
  const float* grn = gor + (size_t)n * L;

  for (int k = lane; k < VR; k += 32) us[k] = safe_inv(x[(size_t)k * N + n]);
  __syncwarp();
  for (int l = lane; l < L; l += 32) {                     // SDDMM
    float t = 0.f;
    for (int k = 0; k < VR; ++k) t = fmaf(gn[(size_t)k * nl + l], us[k], t);
    ws[l] = val[(size_t)n * L + l] * safe_inv(t);
  }
  __syncwarp();
  for (int k = 0; k < VR; ++k) {                           // SpMM
    float p = 0.f;
    for (int l = lane; l < L; l += 32)
      p = fmaf(grn[(size_t)k * nl + l], ws[l], p);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (lane == 0) xout[(size_t)k * N + n] = p;
  }
}

}  // namespace

// Dynamic shared-memory bytes one block needs; the wrapper refuses shapes
// above the card's per-block limit before launching.
extern "C" long long sddmm_spmm_step_smem_bytes(int VR, int L) {
  return (long long)sizeof(float) * kWarps * ((long long)VR + L);
}

// g, g_over_r (VR, N, L), val (N, L), x (VR, N) -> xout (VR, N); fp32,
// contiguous, on the device. Returns the cudaError_t of the launch.
extern "C" int sddmm_spmm_step_launch(const float* g, const float* gor,
                                      const float* val, const float* x,
                                      float* xout, int VR, int N, int L,
                                      void* stream) {
  if (VR == 0 || N == 0) return 0;
  const size_t smem = (size_t)sddmm_spmm_step_smem_bytes(VR, L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sddmm_spmm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sddmm_spmm_step_kernel<<<(N + kWarps - 1) / kWarps, 32 * kWarps, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      g, gor, val, x, xout, VR, N, L);
  return (int)cudaGetLastError();
}
