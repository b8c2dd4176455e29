// The product behind K2s (rwmd_min_cdist.cu) and K3 (cdist_exp.cu):
// a.b^T between a block's rows of a and its tile of vocabulary rows, with
// the squared norms both epilogues need, full fp32 FFMA, no TF32.
//
// Both kernels stream w through shared memory in chunks of kChunk
// coordinates: a ring of stages, each holding the chunk of every staged
// row (the block's rows of a, then its vocabulary rows), filled by
// cp.async copies issued kStages - 1 chunks ahead of the FFMAs, so the
// copies of the next chunks are in flight while the current one is
// multiplied. Rows are row-major at a stride of kStride floats: 16-byte
// rows for 16-byte copies, and float4 reads along the coordinates that
// are free of bank conflicts for the 32 lanes' 32 consecutive rows.
//
// A warp owns 8 rows of a and each lane C vocabulary rows (lane, lane + 32,
// ...): the warp reads each a row as one broadcast float4 and each lane
// its own b rows, so C + 8 shared loads feed 32 C FFMAs per 4 coordinates.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace cdist_ring {

constexpr int kChunk = 32;             // coordinates of w per stage
constexpr int kStride = kChunk + 4;    // floats per staged row
constexpr int kStride4 = kStride / 4;  // float4 per staged row

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Issues the copies of coordinates [j0, j0 + kChunk) of n_rows rows into
// dst (row i at dst + i * kStride); the caller commits them. row(i) is row
// i's first element in device memory, or nullptr for a row of zeros;
// coordinates at or past W are zeros, so every staged float is written.
// vec4 (W % 4 == 0 and every row 16-byte aligned) takes 16-byte copies,
// else 4-byte ones. `any` is a valid device address for the copies that
// read nothing.
template <int NT, typename Row>
__device__ __forceinline__ void stage(float* dst, int n_rows, Row row,
                                      const float* any, int j0, int W,
                                      bool vec4) {
  const int wc = min(kChunk, W - j0);
  if (vec4) {
    for (int i = threadIdx.x; i < n_rows * (kChunk / 4); i += NT) {
      const int rr = i / (kChunk / 4), jc = i % (kChunk / 4);
      const float* p = row(rr);
      const int bytes =
          p != nullptr ? max(0, min(16, 4 * (wc - 4 * jc))) : 0;
      async_copy::copy16(dst + rr * kStride + 4 * jc,
                         bytes > 0 ? p + j0 + 4 * jc : any, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * kChunk; i += NT) {
      const int rr = i / kChunk, j = i % kChunk;
      const float* p = row(rr);
      const bool ok = p != nullptr && j < wc;
      async_copy::copy4(dst + rr * kStride + j, ok ? p + j0 + j : any,
                        ok ? 4 : 0);
    }
  }
}

// |a|^2 of a warp's 8 staged rows `as` over one chunk: lane r < 8 adds row
// r's coordinates to a2 in order, as fma_chunk adds each b row's to b2 and
// each product to acc, so a query word that is a vocabulary row meets
// itself at distance 0 exactly (fp32). Under BF16 the lane then rounds the
// row in place, so the FFMAs read rounded a while the norm stays the
// unrounded sum; the warp's own lanes are the only readers of its rows, so
// a __syncwarp orders it. Row i's norm is lane i's a2.
template <bool BF16>
__device__ __forceinline__ void prep_rows(float* as, float& a2) {
  const int lane = threadIdx.x & 31;
  if (lane < 8) {
    float4* p = reinterpret_cast<float4*>(as) + lane * kStride4;
#pragma unroll
    for (int j = 0; j < kChunk / 4; ++j) {
      float4 x = p[j];
      a2 = fmaf(x.x, x.x, a2);
      a2 = fmaf(x.y, x.y, a2);
      a2 = fmaf(x.z, x.z, a2);
      a2 = fmaf(x.w, x.w, a2);
      if constexpr (BF16)
        p[j] = make_float4(bf16_round(x.x), bf16_round(x.y),
                           bf16_round(x.z), bf16_round(x.w));
    }
  }
  __syncwarp();
}

// acc[r][c] += a_r . b_c and b2[c] += |b_c|^2 over nj4 float4 steps of one
// staged chunk: a_r is row r of `as` (the warp's 8 rows), b_c the staged
// row at bs + 32 c * kStride (bs: the lane's first vocabulary row). Under
// BF16 the b operands are rounded after their norm is taken (`as` holds
// rounded a already, see prep_rows).
template <int C, bool BF16>
__device__ __forceinline__ void fma_chunk(const float* as, const float* bs,
                                          int nj4, float (&acc)[8][C],
                                          float (&b2)[C]) {
  const float4* a4 = reinterpret_cast<const float4*>(as);
  const float4* b4 = reinterpret_cast<const float4*>(bs);
#pragma unroll 2
  for (int j = 0; j < nj4; ++j) {
    float4 bv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      bv[c] = b4[c * 32 * kStride4 + j];
      b2[c] = fmaf(bv[c].x, bv[c].x, b2[c]);
      b2[c] = fmaf(bv[c].y, bv[c].y, b2[c]);
      b2[c] = fmaf(bv[c].z, bv[c].z, b2[c]);
      b2[c] = fmaf(bv[c].w, bv[c].w, b2[c]);
      if constexpr (BF16)
        bv[c] = make_float4(bf16_round(bv[c].x), bf16_round(bv[c].y),
                            bf16_round(bv[c].z), bf16_round(bv[c].w));
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 av = a4[r * kStride4 + j];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[r][c] = fmaf(av.x, bv[c].x, acc[r][c]);
        acc[r][c] = fmaf(av.y, bv[c].y, acc[r][c]);
        acc[r][c] = fmaf(av.z, bv[c].z, acc[r][c]);
        acc[r][c] = fmaf(av.w, bv[c].w, acc[r][c]);
      }
    }
  }
}

}  // namespace cdist_ring
