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
// 9.2 MB more; the product is 2*VR*W*V ~ 1.4 GFLOP, ~21 us at the 67
// TFLOP/s fp32 rate outside the tensor cores. So it is bound by bytes.
//
// What the design does about it: b streams through a cp.async ring
// (cdist_ring.cuh), so the copies of the next chunk of w are in flight
// while the FFMAs of the current one run, and no thread waits on a load
// of its own. A block covers up to 64 query rows (a row tile, a warp per 8
// rows) against TV vocabulary rows (TV / 32 per lane): 64 for row tiles
// of up to 32 rows (the paper's queries; at VR = 24 a block has 3 warps
// and 25 KB of ring), 128 above, where the wider tile halves the re-reads
// of a per vocabulary row; each was the faster one on its side on an H100
// (PERF.md). A query wider than 64 words runs as several row tiles: the
// blocks that share a vocabulary tile are adjacent in launch order, so b
// is read from device memory once per call and the other row tiles find
// it in L2. Only the requested outputs are written; a warp stores 32
// consecutive floats of a row per instruction, so every store fills whole
// 128-byte lines.

#include <cuda_runtime.h>
#include <math.h>

#include "cdist_ring.cuh"
#include "device_attr.cuh"

namespace {

using cdist_ring::kChunk;
using cdist_ring::kStride;

constexpr int kMaxRows = 64;          // query rows per block
constexpr int kStages = 2;

// vocabulary rows per block for a row tile of BMAX query rows
__host__ __device__ constexpr int tile_v(int BMAX) {
  return BMAX <= 32 ? 64 : 128;
}

template <int BMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * kStages * (BMAX + tile_v(BMAX)) * kStride;
}

template <int BMAX, bool BF16>
__global__ void __launch_bounds__(4 * BMAX)
cdist_exp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ r, float* __restrict__ m_out,
                 float* __restrict__ k_out, float* __restrict__ kr_out,
                 int VR, int W, int V, int n_row_tiles, float lam,
                 int log_k, int vec4) {
  constexpr int NT = 4 * BMAX;          // a warp per 8 query rows
  constexpr int kTileV = tile_v(BMAX);
  constexpr int kCols = kTileV / 32;    // vocabulary rows per lane
  constexpr int ROWS = BMAX + kTileV;   // staged rows: a's, then b's
  extern __shared__ __align__(16) float smem[];

  // row tile fastest: the blocks of one vocabulary tile run together
  const int k0 = (blockIdx.x % n_row_tiles) * BMAX;
  const int v0 = (blockIdx.x / n_row_tiles) * kTileV;
  const int B = min(BMAX, VR - k0);
  const int nv = min(kTileV, V - v0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = warp * 8 < B;       // the warp has a query row
  const int n_chunks = (W + kChunk - 1) / kChunk;
  auto row = [&](int i) -> const float* {
    if (i < BMAX) return i < B ? a + (size_t)(k0 + i) * W : nullptr;
    return i - BMAX < nv ? b + (size_t)(v0 + i - BMAX) * W : nullptr;
  };
  for (int s = 0; s < kStages - 1 && s < n_chunks; ++s) {
    cdist_ring::stage<NT>(smem + s * ROWS * kStride, ROWS, row, b,
                          s * kChunk, W, vec4);
    async_copy::commit();
  }

  float acc[8][kCols], b2[kCols], a2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) b2[c] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int next = ch + kStages - 1;
    if (next < n_chunks)
      cdist_ring::stage<NT>(smem + (next % kStages) * ROWS * kStride, ROWS,
                            row, b, next * kChunk, W, vec4);
    async_copy::commit();
    async_copy::wait<kStages - 1>();
    __syncthreads();                    // chunk ch is in for every thread
    float* st = smem + (ch % kStages) * ROWS * kStride;
    if (live) {
      cdist_ring::prep_rows<BF16>(st + warp * 8 * kStride, a2);
      const int nj4 = (min(kChunk, W - ch * kChunk) + 3) / 4;
      cdist_ring::fma_chunk<kCols, BF16>(st + warp * 8 * kStride,
                                         st + (BMAX + lane) * kStride, nj4,
                                         acc, b2);
    }
    __syncthreads();                    // the stage is read before it refills
  }
  if (!live) return;

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = warp * 8 + i;
    if (k >= B) break;                  // the same on every lane
    const float a2k = __shfl_sync(0xffffffffu, a2, i);
    const size_t o = (size_t)(k0 + k) * V + v0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int v = lane + 32 * c;
      if (v >= nv) break;
      const float d2 = a2k + b2[c] - 2.f * acc[i][c];
      const float mv = sqrtf(fmaxf(d2, 0.f));
      const float kv = log_k ? -lam * mv : expf(-lam * mv);
      k_out[o + v] = kv;
      if (m_out != nullptr) {
        m_out[o + v] = mv;
        kr_out[o + v] = kv / r[k0 + k];
      }
    }
  }
}

template <int BMAX, bool BF16>
cudaError_t launch(const float* a, const float* b, const float* r, float* m,
                   float* k, float* kr, int VR, int W, int V, float lam,
                   int log_k, cudaStream_t stream) {
  auto kernel = cdist_exp_kernel<BMAX, BF16>;
  const cudaError_t err = device_attr::allow_smem(kernel, smem_bytes<BMAX>());
  if (err != cudaSuccess) return err;
  const int row_tiles = (VR + BMAX - 1) / BMAX;
  const long long blocks =
      (long long)row_tiles * ((V + tile_v(BMAX) - 1) / tile_v(BMAX));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec4 = W % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(b) % 16 == 0;
  kernel<<<(unsigned)blocks, 4 * BMAX, smem_bytes<BMAX>(), stream>>>(
      a, b, r, m, k, kr, VR, W, V, row_tiles, lam, log_k, vec4);
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
