// K2 for Hopper: masked min-over-support cdist, the RWMD prune bound.
//
// Replaces: src/repro/kernels/rwmd.py, rwmd_min_cdist (pallas_call body
// _kernel), reached from repro.core.prune.RwmdPruner.lower_bounds through
// repro.kernels.ops.rwmd_min_cdist.
//
//   minM[q, v] = min over k with mask[q, k] > 0 of ||a[q, k] - b[v]||
//              = sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0)), +inf if no live k.
//
// What bounds it on the H100: the a.b^T product. At the main path's
// widest chunk shape (Q = 4, B <= 48, w = 300, V = 100 000) it is
// 2*Q*B*w*V ~ 11.5 GFLOP, ~0.17 ms at the 67 TFLOP/s fp32 rate outside the
// tensor cores; reading b once is 120 MB, ~36 us at 3.35 TB/s. So it is
// bound by operations. Full fp32 FFMA, no TF32: the bound decides which
// documents are pruned and must match the fp32 reference.
//
// What the design does about it: a register-tiled FFMA GEMM with the
// sqrt / mask / min epilogue fused in, so the (Q*B, V) distance block never
// leaves the SM. One block per (query, tile of 128 vocabulary rows), with
// 2*BMAX threads, each owning an 8 (support rows) x 8 (vocabulary rows)
// tile of partial dot products in registers (the product is
// cdist_tile.cuh's, shared with K3). Masked rows drop out of the min, the
// ragged V edge is masked, w is not padded. Each block reads the whole of
// b's tile for its query, so b is read Q times in all (4x the bound's
// bytes at Q = 4): acceptable while the kernel is bound by operations. A
// query wider than 128 support rows runs as one launch per 128-row chunk
// on the same stream; every chunk after the first folds its min into the
// output already written (min is exact in any order).
//
// K2s, the same kernel over a candidate subset of the vocabulary.
// Replaces: src/repro/kernels/rwmd.py, rwmd_min_cdist_subset, reached from
// repro.core.prune.CascadePruner._rwmd_prep (the IVF cascade's RWMD stage)
// through repro.kernels.ops.rwmd_min_cdist(..., vocab_ids=...).
//
//   minM[q, c] = min over live k of ||a[q, k] - b[vocab_ids[c]]||, (Q, Vc).
//
// The Pallas version lets XLA gather b[vocab_ids] into a new (Vc, w) array
// before the launch. Here the gather is in the b-tile load
// (cdist_tile::product with `rows`): tile row c reads b's row
// vocab_ids[c], so the (Vc, w) copy is never written. Everything else
// (norms, clamp, sqrt, mask, min epilogue, 128-row chunks) is K2's code.
// vocab_ids are int64 (the wrapper checks); Vc needs no padding, the
// ragged edge is masked. At the cascade's shape (Q = 16 padded queries,
// B <= 48, w = 300, Vc of a few hundred to a few thousand) the product is
// ~0.3 GFLOP at Vc = 1024, ~5 us at 67 TFLOP/s: bound by operations, and
// small enough that the launch and the host staging around it may cost
// more than the kernel.

#include <cuda_runtime.h>
#include <math.h>

#include "cdist_tile.cuh"

namespace {

using cdist_tile::kTileV;

template <int BMAX, bool GATHER>
__global__ void __launch_bounds__(2 * BMAX)
rwmd_min_cdist_kernel(const float* __restrict__ a,
                      const float* __restrict__ mask,
                      const float* __restrict__ b,
                      const long long* __restrict__ ids,
                      float* __restrict__ out, int B, int LDB, int W,
                      int V, int Vb, int accumulate) {
  constexpr int KG = BMAX / 8;          // support-row groups of 8
  constexpr int NT = KG * 16;           // 16 vocabulary groups of 8
  __shared__ __align__(16) cdist_tile::Staging<BMAX> st;
  __shared__ float a2s[BMAX], ms[BMAX];

  const int q = blockIdx.y;
  const int v0 = blockIdx.x * kTileV;
  const int tid = threadIdx.x;
  const int vg = tid % 16, kg = tid / 16;
  const float* aq = a + (size_t)q * LDB * W;   // B of the query's LDB rows

  float acc[8][8], b2[8], a2;
  cdist_tile::product<BMAX, GATHER>(aq, B, b, v0, W, V, st, acc, b2, a2,
                                    ids, Vb);
  if (tid < BMAX) {
    a2s[tid] = a2;
    ms[tid] = tid < B ? mask[(size_t)q * LDB + tid] : 0.f;
  }
  __syncthreads();                      // also: every read of bT is done

  // min over this thread's 8 rows, then over the KG row groups
  float* red = st.bT;                   // (KG, kTileV)
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float best = INFINITY;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = kg * 8 + r;
      if (ms[k] > 0.f) {
        const float d2 = a2s[k] + b2[c] - 2.f * acc[r][c];
        best = fminf(best, sqrtf(fmaxf(d2, 0.f)));
      }
    }
    red[kg * kTileV + vg * 8 + c] = best;
  }
  __syncthreads();
  for (int v = tid; v < kTileV; v += NT) {
    float best = INFINITY;
    for (int gi = 0; gi < KG; ++gi) best = fminf(best, red[gi * kTileV + v]);
    if (v0 + v < V) {
      float* o = out + (size_t)q * V + v0 + v;
      *o = accumulate ? fminf(*o, best) : best;
    }
  }
}

constexpr int kMaxB = 128;   // support rows per launch

// Output columns v0.. of out (Q, V); with ids, column v is b's row ids[v]
// of Vb rows, else b's row v.
struct Args {
  const float* a;
  const float* mask;
  const float* b;
  const long long* ids;
  float* out;
  int Q, B, LDB, W, V, Vb, accumulate;
};

template <int BMAX>
cudaError_t launch(const Args& x, cudaStream_t stream) {
  dim3 grid((x.V + kTileV - 1) / kTileV, x.Q);
  if (x.ids)
    rwmd_min_cdist_kernel<BMAX, true><<<grid, 2 * BMAX, 0, stream>>>(
        x.a, x.mask, x.b, x.ids, x.out, x.B, x.LDB, x.W, x.V, x.Vb,
        x.accumulate);
  else
    rwmd_min_cdist_kernel<BMAX, false><<<grid, 2 * BMAX, 0, stream>>>(
        x.a, x.mask, x.b, x.ids, x.out, x.B, x.LDB, x.W, x.V, x.Vb,
        x.accumulate);
  return cudaGetLastError();
}

// One launch over x.B <= kMaxB consecutive support rows of every query;
// x.a and x.mask point at the chunk's first row, x.LDB is the rows per
// query.
cudaError_t launch_chunk(const Args& x, cudaStream_t s) {
  switch (x.B <= 64 ? ((x.B + 7) / 8) * 8 : ((x.B + 15) / 16) * 16) {
    case 8: return launch<8>(x, s);
    case 16: return launch<16>(x, s);
    case 24: return launch<24>(x, s);
    case 32: return launch<32>(x, s);
    case 40: return launch<40>(x, s);
    case 48: return launch<48>(x, s);
    case 56: return launch<56>(x, s);
    case 64: return launch<64>(x, s);
    case 80: return launch<80>(x, s);
    case 96: return launch<96>(x, s);
    case 112: return launch<112>(x, s);
    case 128: return launch<128>(x, s);
    default: return cudaErrorInvalidValue;
  }
}

// Every 128-row chunk of the support axis, one launch each.
int launch_all(Args x, cudaStream_t s) {
  if (x.Q == 0 || x.V == 0) return 0;
  if (x.B < 1) return (int)cudaErrorInvalidValue;
  const int B = x.B;
  const float* a = x.a;
  const float* mask = x.mask;
  x.LDB = B;
  for (int k0 = 0; k0 < B; k0 += kMaxB) {
    x.a = a + (size_t)k0 * x.W;
    x.mask = mask + k0;
    x.B = B - k0 < kMaxB ? B - k0 : kMaxB;
    x.accumulate = k0 > 0;
    const cudaError_t err = launch_chunk(x, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// a (Q, B, W), mask (Q, B), b (V, W), out (Q, V); all fp32, contiguous,
// on the device, B >= 1. Returns the cudaError_t of the first launch that
// failed, else 0.
extern "C" int rwmd_min_cdist_launch(const float* a, const float* mask,
                                     const float* b, float* out, int Q,
                                     int B, int W, int V, void* stream) {
  return launch_all({a, mask, b, nullptr, out, Q, B, B, W, V, V, 0},
                    static_cast<cudaStream_t>(stream));
}

// K2s: a (Q, B, W), mask (Q, B), b (Vb, W), vocab_ids (Vc,) int64 with
// every id in [0, Vb), out (Q, Vc); fp32, contiguous, on the device,
// B >= 1. Returns the cudaError_t of the first launch that failed, else 0.
extern "C" int rwmd_min_cdist_subset_launch(const float* a,
                                            const float* mask,
                                            const float* b,
                                            const long long* vocab_ids,
                                            float* out, int Q, int B, int W,
                                            int Vb, int Vc, void* stream) {
  return launch_all({a, mask, b, vocab_ids, out, Q, B, B, W, Vc, Vb, 0},
                    static_cast<cudaStream_t>(stream));
}
