// K3 for Hopper: the fused GEMM-shaped distance with its exp and 1/r
// epilogue, the first stage of the single-query kernel path.
//
// Replaces: src/repro/kernels/cdist_exp.py, cdist_exp (pallas_call body
// _kernel), reached from repro.core.wmd.one_to_many(impl="kernel")
// through repro.kernels.ops.sinkhorn_wmd_kernel -> ops.cdist_exp.
//
//   M[k, v]  = sqrt(max(|a_k|^2 + |b_v|^2 - 2 a_k.b_v, 0))
//   K[k, v]  = exp(-lam M[k, v])      (-lam M[k, v] under log_k)
//   KR[k, v] = K[k, v] / r[k]
// for query words a (VR, W), vocabulary b (V, W) and weights r (VR,);
// under k_only only K is written. fp32 throughout, no TF32; with bf16 the
// operands of a_k.b_v are rounded to bf16 (the reference's gemm="bf16"),
// its products and sums and the norms stay fp32.
//
// What bounds it on the H100: reading b. At the paper's shape (VR ~ 24,
// W = 300, V = 100 000) b is 120 MB, ~36 us at 3.35 TB/s; k_only writes
// 9.6 MB more; the product is 2*VR*W*V ~ 1.4 GFLOP, ~21 us at the 67
// TFLOP/s fp32 rate outside the tensor cores. So it is bound by bytes.
//
// What the design does about it: the product is K2's register tile
// (cdist_tile.cuh) with an elementwise epilogue in place of K2's min. A
// block covers up to 64 query rows (a row tile) against 128 vocabulary
// rows; a query wider than 64 words runs as several row tiles, so any VR
// runs. The blocks that share a vocabulary tile are adjacent in launch
// order, so b is read from device memory once per call (the extra row
// tiles of a wide query find it in L2), and a, which is small, streams
// from L2 in 32-wide chunks of w beside it. Only the requested outputs are
// written, 16 bytes at a time where the row allows.

#include <cuda_runtime.h>
#include <math.h>

#include "cdist_tile.cuh"

namespace {

using cdist_tile::kTileV;

constexpr int kMaxRows = 64;   // query rows per block

// out[0..n) = v[0..n); 16-byte stores when all 8 are in range and aligned
__device__ __forceinline__ void store8(float* out, const float (&v)[8],
                                       int n, bool vec) {
  if (vec && n == 8) {
    reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (c < n) out[c] = v[c];
}

template <int BMAX, bool BF16>
__global__ void __launch_bounds__(2 * BMAX)
cdist_exp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ r, float* __restrict__ m_out,
                 float* __restrict__ k_out, float* __restrict__ kr_out,
                 int VR, int W, int V, int n_row_tiles, float lam,
                 int log_k) {
  __shared__ __align__(16) cdist_tile::Staging<BMAX> st;
  __shared__ float a2s[BMAX], rs[BMAX];

  // row tile fastest: the blocks of one vocabulary tile run together
  const int k0 = (blockIdx.x % n_row_tiles) * BMAX;
  const int v0 = (blockIdx.x / n_row_tiles) * kTileV;
  const int B = min(BMAX, VR - k0);
  const int tid = threadIdx.x;
  const int vg = tid % 16, kg = tid / 16;

  float acc[8][8], b2[8], a2;
  cdist_tile::product<BMAX, false, BF16>(a + (size_t)k0 * W, B, b, v0, W,
                                         V, st, acc, b2, a2);
  if (tid < BMAX) {
    a2s[tid] = a2;
    rs[tid] = tid < B ? r[k0 + tid] : 1.f;
  }
  __syncthreads();

  const int vc = v0 + vg * 8;
  const int n = min(8, V - vc);
  const bool vec = (V & 3) == 0;        // rows start 16-byte aligned
  if (n <= 0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = kg * 8 + i;
    if (k >= B) break;
    float mv[8], kv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float d2 = a2s[k] + b2[c] - 2.f * acc[i][c];
      mv[c] = sqrtf(fmaxf(d2, 0.f));
      kv[c] = log_k ? -lam * mv[c] : expf(-lam * mv[c]);
    }
    const size_t o = (size_t)(k0 + k) * V + vc;
    store8(k_out + o, kv, n, vec);
    if (m_out != nullptr) {
      store8(m_out + o, mv, n, vec);
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = kv[c] / rs[k];
      store8(kr_out + o, kv, n, vec);
    }
  }
}

template <int BMAX, bool BF16>
cudaError_t launch(const float* a, const float* b, const float* r, float* m,
                   float* k, float* kr, int VR, int W, int V, float lam,
                   int log_k, cudaStream_t stream) {
  const int row_tiles = (VR + BMAX - 1) / BMAX;
  const long long blocks =
      (long long)row_tiles * ((V + kTileV - 1) / kTileV);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cdist_exp_kernel<BMAX, BF16><<<(unsigned)blocks, 2 * BMAX, 0, stream>>>(
      a, b, r, m, k, kr, VR, W, V, row_tiles, lam, log_k);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_rows(const float* a, const float* b, const float* r,
                        float* m, float* k, float* kr, int VR, int W, int V,
                        float lam, int log_k, cudaStream_t s) {
  switch (VR >= kMaxRows ? kMaxRows : ((VR + 7) / 8) * 8) {
    case 8:
      return launch<8, BF16>(a, b, r, m, k, kr, VR, W, V, lam, log_k, s);
    case 16:
      return launch<16, BF16>(a, b, r, m, k, kr, VR, W, V, lam, log_k, s);
    case 24:
      return launch<24, BF16>(a, b, r, m, k, kr, VR, W, V, lam, log_k, s);
    case 32:
      return launch<32, BF16>(a, b, r, m, k, kr, VR, W, V, lam, log_k, s);
    case 40:
      return launch<40, BF16>(a, b, r, m, k, kr, VR, W, V, lam, log_k, s);
    case 48:
      return launch<48, BF16>(a, b, r, m, k, kr, VR, W, V, lam, log_k, s);
    case 56:
      return launch<56, BF16>(a, b, r, m, k, kr, VR, W, V, lam, log_k, s);
    case 64:
      return launch<64, BF16>(a, b, r, m, k, kr, VR, W, V, lam, log_k, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// a (VR, W), b (V, W), r (VR,) -> k (VR, V), and m, kr (VR, V) unless
// m is null (k_only); fp32, contiguous, on the device; bf16 != 0 rounds
// the product's operands to bf16. Returns the cudaError_t of the launch.
extern "C" int cdist_exp_launch(const float* a, const float* b,
                                const float* r, float* m, float* k,
                                float* kr, int VR, int W, int V, float lam,
                                int log_k, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (VR == 0 || V == 0) return 0;
  return (int)(bf16 ? launch_rows<true>(a, b, r, m, k, kr, VR, W, V, lam,
                                        log_k, s)
                    : launch_rows<false>(a, b, r, m, k, kr, VR, W, V, lam,
                                         log_k, s));
}
