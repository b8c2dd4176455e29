// The register-tiled fp32 FFMA product behind K2 (rwmd_min_cdist.cu) and
// K3 (cdist_exp.cu): a.b^T between up to BMAX rows of a and a tile of
// kTileV vocabulary rows of b, with the squared norms both epilogues need.
//
// A block has 2*BMAX threads; thread tid owns the 8 (a rows) x 8
// (vocabulary rows) sub-tile at rows kg*8.. and vocabulary rows
// v0 + vg*8.., with vg = tid % 16, kg = tid / 16. a and b stream through
// shared memory in 32-wide chunks of w, both transposed, so that four
// 16-byte shared loads feed 64 FFMAs per coordinate. Rows of a at or
// beyond B and vocabulary rows at or beyond V load as zeros; w is not
// padded. Full fp32, no TF32: the products feed the prune bound and the
// distances.
//
// With GATHER (K2s, the cascade's candidate-vocabulary subset), tile row v
// is b's row rows[v] instead of row v: the gather happens in the load, so
// no (V, w) copy of the selected rows is ever written. The ids are int64
// (torch's index type); an id outside [0, Vb) loads as a zero row, so a
// bad id gives a wrong column, never an out-of-bounds read. GATHER is a
// template parameter so that K2's and K3's loads carry no test for it.
//
// With BF16 (K3's gemm="bf16") each product's operands are rounded to bf16
// (round to nearest even) as they leave shared memory, and the FFMAs
// accumulate in fp32; the squared norms a2 and b2 stay the unrounded fp32
// sums, as the reference keeps them. A template parameter, so that K2's
// and K2s's instantiations compile to the code they compiled to before.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cdist_tile {

constexpr int kTileV = 128;            // vocabulary rows per block
constexpr int kChunkW = 32;            // embedding coordinates per chunk
constexpr int kStrideB = kTileV + 4;   // keeps float4 rows 16-byte aligned

// Shared staging of one chunk: aT (kChunkW x BMAX) and bT (kChunkW x
// kStrideB), both [coordinate][row], 16-byte aligned.
template <int BMAX>
struct Staging {
  float aT[kChunkW * BMAX];
  float bT[kChunkW * kStrideB];
};

// acc[r][c] = a[kg*8+r] . b[v0+vg*8+c], b2[c] = |b[v0+vg*8+c]|^2 and, on
// threads tid < BMAX, a2 = |a[tid]|^2 (0 on the others). a holds B rows
// of W floats; V is the number of tile rows (b's rows, or with GATHER the
// length of `rows`, which then indexes b's Vb rows). Ends with every
// thread past its last read of `st`; the caller synchronises before
// reusing it.
template <int BMAX, bool GATHER = false, bool BF16 = false>
__device__ __forceinline__ void product(const float* __restrict__ a, int B,
                                        const float* __restrict__ b, int v0,
                                        int W, int V, Staging<BMAX>& st,
                                        float (&acc)[8][8], float (&b2)[8],
                                        float& a2,
                                        const long long* __restrict__ rows =
                                            nullptr,
                                        int Vb = 0) {
  constexpr int NT = 2 * BMAX;
  const int tid = threadIdx.x;
  const int vg = tid % 16, kg = tid / 16;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) b2[c] = 0.f;
  a2 = 0.f;

  for (int j0 = 0; j0 < W; j0 += kChunkW) {
    const int wc = min(kChunkW, W - j0);
    __syncthreads();                    // previous chunk consumed
    for (int i = tid; i < BMAX * kChunkW; i += NT) {
      int k = i / kChunkW, j = i % kChunkW;
      st.aT[j * BMAX + k] =
          (k < B && j < wc) ? a[(size_t)k * W + j0 + j] : 0.f;
    }
    for (int i = tid; i < kTileV * kChunkW; i += NT) {
      int v = i / kChunkW, j = i % kChunkW;
      float x = 0.f;
      if (v0 + v < V && j < wc) {
        if constexpr (GATHER) {
          const long long row = rows[v0 + v];
          if (row >= 0 && row < Vb) x = b[(size_t)row * W + j0 + j];
        } else {
          x = b[(size_t)(v0 + v) * W + j0 + j];
        }
      }
      st.bT[j * kStrideB + v] = x;
    }
    __syncthreads();
    if (tid < BMAX)
      for (int j = 0; j < wc; ++j) {
        const float x = st.aT[j * BMAX + tid];
        a2 = fmaf(x, x, a2);
      }
    for (int jj = 0; jj < wc; ++jj) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          st.aT + jj * BMAX + kg * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(
          st.aT + jj * BMAX + kg * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(
          st.bT + jj * kStrideB + vg * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(
          st.bT + jj * kStrideB + vg * 8 + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) b2[c] = fmaf(bv[c], bv[c], b2[c]);
      if constexpr (BF16) {
        float ar[8], br[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          ar[c] = __bfloat162float(__float2bfloat16_rn(av[c]));
          br[c] = __bfloat162float(__float2bfloat16_rn(bv[c]));
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
  }
}

}  // namespace cdist_tile
