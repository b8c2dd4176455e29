// K6 for Hopper: the block-sparse (BSR) SDDMM.
//
// Replaces: src/repro/kernels/bsr_sddmm.py, bsr_sddmm_blocks (pallas_call
// body _kernel), reached through its caller bsr_sddmm, which gathers the
// per-block panels with XLA and launches the kernel once.
//
// For every retained (bv, bn) tile b of the sparse doc matrix c, at tile
// coordinate (brow[b], bcol[b]):
//   w[b] = c[b] * (Kt rows brow[b]*bv .. +bv  (bv, v_r)
//                  @ u columns bcol[b]*bn .. +bn  (v_r, bn))
// in fp32, full FFMA (no TF32), the product computed for every element,
// also where c = 0: an inf product times a zero c is NaN, as in the
// reference. Two entry points run one kernel:
//   bsr_sddmm_blocks_launch  the panels given, ktb (nb, bv, v_r) and
//                            ub (nb, v_r, bn), as the Pallas kernel takes
//                            them;
//   bsr_sddmm_launch         kt (V, v_r) and u (v_r, N) with brow/bcol: the
//                            kernel gathers the panels in its tile load
//                            (rows of kt at or past V and columns of u at
//                            or past N read as 0), so no (nb, bv, v_r) or
//                            (nb, v_r, bn) copy is made. The wrapper
//                            ops.bsr_sddmm uses this one.
//
// What bounds it on the H100: bytes. Each element of c is read once and of
// w written once, against 2 * v_r flops for it: at the paper's v_r = 23,
// ~11 flops per 8 bytes, far below the card's 67 TFLOP/s : 3.35 TB/s
// (20 flops per byte) in fp32. At the paper corpus's 128 x 128 tiles (28
// 277 tiles, 90% of all) c and w are 1.85 GB each, ~1.1 ms.
//
// What the design does about it: one thread block per 64 x 64 output tile
// (a 128 x 128 tile is four), 256 threads each keeping a 4 x 4 register
// sub-tile; the two panels are staged through shared memory in v_r chunks
// of 32, so any v_r fits, and the c multiply runs in the epilogue, which
// reads c and writes w once, four consecutive floats a thread (a warp
// covers two 256-byte row segments). The panels are a few percent of the
// bytes and mostly hit L2 (the four quarter tiles share them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // output tile: kTile x kTile
constexpr int kChunk = 32;     // v_r chunk staged per pass
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// a (rows of the Kt panel) and b (columns of the u panel) with their
// strides: A(m, k) = a[a_off + m * a_rs + k], B(k, n) = b[b_off + k * b_rs
// + n]; rows m >= a_rows and columns n >= b_cols read as 0
__global__ void __launch_bounds__(kThreads)
bsr_sddmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ w,
                 const int* __restrict__ brow, const int* __restrict__ bcol,
                 int bv, int bn, int vr, int V, int N) {
  __shared__ __align__(16) float As[kChunk][kTile];
  __shared__ __align__(16) float Bs[kChunk][kTile];

  const int64_t blk = blockIdx.x;
  const int tiles_n = (bn + kTile - 1) / kTile;
  const int m0 = (blockIdx.y / tiles_n) * kTile;
  const int n0 = (blockIdx.y % tiles_n) * kTile;

  int64_t a_off, a_rs, b_off, b_rs;
  int a_rows, b_cols;
  if (brow == nullptr) {                       // panels given
    a_off = blk * bv * vr;
    a_rs = vr;
    a_rows = bv;
    b_off = blk * vr * bn;
    b_rs = bn;
    b_cols = bn;
  } else {                                     // gather in the load
    const int64_t r0 = (int64_t)brow[blk] * bv;
    const int64_t c0 = (int64_t)bcol[blk] * bn;
    a_off = r0 * vr;
    a_rs = vr;
    a_rows = r0 + bv <= V ? bv : (int)(V - r0);
    b_off = c0;
    b_rs = N;
    b_cols = c0 + bn <= N ? bn : (int)(N - c0);
  }

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < vr; k0 += kChunk) {
    // stage both panels: element e -> (kk = e / kTile, m or n = e % kTile),
    // so neighbouring threads write neighbouring shared words
    for (int e = tid; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile, i = e % kTile;
      const int k = k0 + kk, m = m0 + i, n = n0 + i;
      As[kk][i] = (k < vr && m < bv && m < a_rows)
                      ? a[a_off + (int64_t)m * a_rs + k] : 0.f;
      Bs[kk][i] = (k < vr && n < bn && n < b_cols)
                      ? b[b_off + (int64_t)k * b_rs + n] : 0.f;
    }
    __syncthreads();
    const int kn = min(kChunk, vr - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bw = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: w = c * prod for every element of the tile
  const int64_t cbase = blk * bv * bn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= bv) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < bn) {
        const int64_t o = cbase + (int64_t)m * bn + n;
        w[o] = c[o] * acc[i][j];
      }
    }
  }
}

cudaError_t launch(const float* a, const float* b, const float* c, float* w,
                   const int* brow, const int* bcol, int nb, int bv, int bn,
                   int vr, int V, int N, cudaStream_t s) {
  if (nb == 0) return cudaSuccess;
  const int tiles = ((bv + kTile - 1) / kTile) * ((bn + kTile - 1) / kTile);
  dim3 grid(nb, tiles);
  bsr_sddmm_kernel<<<grid, kThreads, 0, s>>>(a, b, c, w, brow, bcol, bv, bn,
                                             vr, V, N);
  return cudaGetLastError();
}

}  // namespace

// ktb (nb, bv, vr), ub (nb, vr, bn), cblk (nb, bv, bn) -> w (nb, bv, bn);
// fp32, contiguous, on the device. Returns the cudaError_t of the launch.
extern "C" int bsr_sddmm_blocks_launch(const float* ktb, const float* ub,
                                       const float* cblk, float* w, int nb,
                                       int bv, int bn, int vr,
                                       void* stream) {
  return (int)launch(ktb, ub, cblk, w, nullptr, nullptr, nb, bv, bn, vr, 0,
                     0, static_cast<cudaStream_t>(stream));
}

// kt (V, vr), u (vr, N), cblk (nb, bv, bn), brow/bcol (nb,) int32 tile
// coordinates -> w (nb, bv, bn); the panels are gathered in the load.
extern "C" int bsr_sddmm_launch(const float* kt, const float* u,
                                const float* cblk, const int* brow,
                                const int* bcol, float* w, int nb, int bv,
                                int bn, int vr, int V, int N, void* stream) {
  return (int)launch(kt, u, cblk, w, brow, bcol, nb, bv, bn, vr, V, N,
                     static_cast<cudaStream_t>(stream));
}
