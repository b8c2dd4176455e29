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
// leaves the SM. One block per tile of 128 vocabulary rows serves every
// query's live rows, so b is read once per 64 queries (a launch each) and
// masked rows are never computed; cp.async stages the next 32 coordinates
// during the FFMAs (rwmd_min_cdist_stacked_kernel's comment below). At the
// main path's chunk on an H100 at 700 W it took 0.24 ms where the
// per-query design it replaced took 0.56 (PERF.md). The ragged V edge is
// masked and w is not padded.
//
// K2s, the same function over a candidate subset of the vocabulary.
// Replaces: src/repro/kernels/rwmd.py, rwmd_min_cdist_subset, reached from
// repro.core.prune.CascadePruner._rwmd_prep (the IVF cascade's RWMD stage)
// through repro.kernels.ops.rwmd_min_cdist(..., vocab_ids=...).
//
//   minM[q, c] = min over live k of ||a[q, k] - b[vocab_ids[c]]||, (Q, Vc).
//
// The Pallas version lets XLA gather b[vocab_ids] into a new (Vc, w) array
// before the launch. Here the gather is in the load: a block reads its 32
// ids once and copies those rows of b whole, so the (Vc, w) copy is never
// written. What bounds it: nothing of the card's rates. At the cascade's
// widest RWMD stage (Q = 4 padded queries, B = 24, w = 300, Vc = 128) the
// product is ~7 MFLOP and the distinct rows ~0.1 MB, well under a
// microsecond at either peak; the kernel's time is the latency of one
// block's walk over w. So the design spreads the walk over many blocks and
// keeps every load in flight (rwmd_min_cdist_subset_kernel's comment).

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "cdist_ring.cuh"
#include "device_attr.cuh"

namespace {

// K2s: one block per (query, 32 output columns), a lane per column and a
// warp per 8 support rows, 16 warps. The block streams w through a 2-stage
// cp.async ring (cdist_ring.cuh): its rows of a and its 32 gathered rows of
// b, 16-byte copies of whole rows when w % 4 == 0 and the bases are
// aligned, 4-byte ones otherwise, so no thread waits on a load of its own
// and the next chunk is in flight during the FFMAs of the current one. A
// query wider than 128 support rows runs its rows in passes of 128 inside
// the block, each folding into the lanes' running min (min is exact in
// any order), so any B runs in one launch. On an H100 16 warps beat 8 at
// 200 rows (two passes instead of four) and cost about a microsecond at
// the cascade's 24, and a deeper ring gained nothing (PERF.md). Warps whose rows are all masked
// (the cascade's filler queries) skip the FFMAs. An id outside [0, Vb)
// loads as a zero row: a wrong column, never an out-of-bounds read.
constexpr int kSubCols = 32;                // output columns per block
constexpr int kSubWarps = 16;
constexpr int kSubRows = 8 * kSubWarps;     // support rows per pass
constexpr int kSubStages = 2;
constexpr int kSubStaged = kSubRows + kSubCols;
constexpr size_t kSubSmem =
    sizeof(float) * kSubStages * kSubStaged * cdist_ring::kStride;

__global__ void __launch_bounds__(32 * kSubWarps)
rwmd_min_cdist_subset_kernel(const float* __restrict__ a,
                             const float* __restrict__ mask,
                             const float* __restrict__ b,
                             const long long* __restrict__ ids,
                             float* __restrict__ out, int B, int W, int Vb,
                             int Vc, int vec4) {
  using cdist_ring::kChunk;
  using cdist_ring::kStride;
  constexpr int NT = 32 * kSubWarps;
  extern __shared__ __align__(16) float smem[];
  __shared__ long long rows[kSubCols];      // b's row per column, or -1
  __shared__ float red[kSubWarps][kSubCols];

  const int q = blockIdx.y;
  const int c0 = blockIdx.x * kSubCols;
  const int nc = min(kSubCols, Vc - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < kSubCols) {
    const long long id = threadIdx.x < nc ? ids[c0 + threadIdx.x] : -1;
    rows[threadIdx.x] = id >= 0 && id < Vb ? id : -1;
  }
  __syncthreads();
  const float* aq = a + (size_t)q * B * W;
  const float* mq = mask + (size_t)q * B;
  const int n_chunks = (W + kChunk - 1) / kChunk;
  float best = INFINITY;

  for (int p0 = 0; p0 < B; p0 += kSubRows) {
    const int nr = min(kSubRows, B - p0);
    auto row = [&](int i) -> const float* {
      if (i < kSubRows) return i < nr ? aq + (size_t)(p0 + i) * W : nullptr;
      const long long id = rows[i - kSubRows];
      return id >= 0 ? b + (size_t)id * W : nullptr;
    };
    // the warp takes part in the product if one of its rows is live
    const int k = warp * 8 + (lane & 7);
    const bool live =
        __any_sync(0xffffffffu, k < nr && mq[p0 + min(k, nr - 1)] > 0.f);
    for (int s = 0; s < kSubStages - 1 && s < n_chunks; ++s) {
      cdist_ring::stage<NT>(smem + s * kSubStaged * kStride, kSubStaged,
                            row, b, s * kChunk, W, vec4);
      async_copy::commit();
    }
    float acc[8][1], b2[1] = {0.f}, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int next = ch + kSubStages - 1;
      if (next < n_chunks)
        cdist_ring::stage<NT>(smem + (next % kSubStages) * kSubStaged * kStride,
                              kSubStaged, row, b, next * kChunk, W, vec4);
      async_copy::commit();
      async_copy::wait<kSubStages - 1>();
      __syncthreads();                  // chunk ch is in for every thread
      float* st = smem + (ch % kSubStages) * kSubStaged * kStride;
      if (live) {
        cdist_ring::prep_rows<false>(st + warp * 8 * kStride, a2);
        const int nj4 = (min(kChunk, W - ch * kChunk) + 3) / 4;
        cdist_ring::fma_chunk<1, false>(st + warp * 8 * kStride,
                                        st + (kSubRows + lane) * kStride,
                                        nj4, acc, b2);
      }
      __syncthreads();                  // the stage is read before it refills
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a2k = __shfl_sync(0xffffffffu, a2, i);
        const float d2 = a2k + b2[0] - 2.f * acc[i][0];
        const int kk = warp * 8 + i;
        if (kk < nr && mq[p0 + kk] > 0.f)
          best = fminf(best, sqrtf(fmaxf(d2, 0.f)));
      }
    }
  }
  red[warp][lane] = best;
  __syncthreads();
  if (warp == 0 && lane < nc) {
    float m = red[0][lane];
#pragma unroll
    for (int w = 1; w < kSubWarps; ++w) m = fminf(m, red[w][lane]);
    out[(size_t)q * Vc + c0 + lane] = m;
  }
}

// K2's stacked-query kernel.
// One block per tile of kStTileV vocabulary rows serves every query of the
// chunk: it stacks the chunk's live support rows (mask > 0, in order, each
// with its query id; compacted on the device from mask by the block
// itself) in groups of RB, reads its b tile once per group through a
// two-stage cp.async ring, computes the group's a.b^T in registers (each
// of 2 * RB threads owns 8 rows x 8 vocabulary rows, full fp32 FFMA), and
// folds each query's min over its own rows into a (Q, kStTileV) shared
// array with atomicMin on the bits of the non-negative distances (min is
// exact in any order). A group after the first re-reads the tile (from L2)
// and folds into the same array; rows of no query stay out, so a query
// without a live row comes out +inf. Masked rows are never computed: the
// threads of row groups past the live rows skip the FFMAs.
//
// Shared layout: a and b chunks row-major, kStChunk coordinates per row at
// a stride of kStChunk + 4 floats (16-byte rows: 16-byte cp.async copies,
// and float4 reads along the coordinates, which a thread's 8 vocabulary
// rows v0 + vg + 16 c keep free of bank conflicts).
constexpr int kStTileV = 128;
constexpr int kStChunk = 32;
constexpr int kStStride = kStChunk + 4;
constexpr int kStMaxQ = 64;  // queries the shared min array holds

template <int RB>
constexpr size_t stacked_smem_bytes(int Q) {
  return sizeof(float) * (2 * (RB + kStTileV) * kStStride + RB) +
         sizeof(int) * (2 * RB + 4) + sizeof(unsigned) * Q * kStTileV;
}

template <int RB>
__global__ void __launch_bounds__(2 * RB, 2)
rwmd_min_cdist_stacked_kernel(const float* __restrict__ a,
                              const float* __restrict__ mask,
                              const float* __restrict__ b,
                              float* __restrict__ out, int Q, int B, int W,
                              int V, int vec4) {
  constexpr int NT = 2 * RB;
  constexpr int S4 = kStStride / 4;     // float4 per staged row
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                                  // (2, RB, stride)
  float* bs = as + 2 * RB * kStStride;               // (2, TV, stride)
  float* a2s = bs + 2 * kStTileV * kStStride;        // (RB,)
  int* rows = reinterpret_cast<int*>(a2s + RB);      // (RB,) row of a
  int* qids = rows + RB;                             // (RB,) its query
  int* meta = qids + RB;                             // cursor, rows
  unsigned* red = reinterpret_cast<unsigned*>(meta + 4);   // (Q, TV)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = tid / 16, vg = tid % 16;
  const int v0 = blockIdx.x * kStTileV;
  const int QB = Q * B;
  const int n_chunks = (W + kStChunk - 1) / kStChunk;
  for (int i = tid; i < Q * kStTileV; i += NT) red[i] = 0x7f800000u;  // +inf
  if (tid == 0) meta[0] = 0;

  for (;;) {
    __syncthreads();            // meta set; the last group's reads done
    if (tid < 32) {             // the next group: up to RB live rows
      int cur = meta[0], cnt = 0;
      while (cnt < RB && cur < QB) {
        const int i = cur + lane;
        const bool live = i < QB && mask[i] > 0.f;
        const unsigned bal = __ballot_sync(0xffffffffu, live);
        const int n_live = __popc(bal);
        const int take = min(n_live, RB - cnt);
        if (live) {
          const int pos = __popc(bal & ((1u << lane) - 1u));
          if (pos < take) {
            rows[cnt + pos] = i;
            qids[cnt + pos] = i / B;
          }
        }
        if (take < n_live) {    // resume at the first row not taken
          unsigned rest = bal;
          for (int t = 0; t < take; ++t) rest &= rest - 1u;
          cur += __ffs(rest) - 1;
        } else {
          cur += 32;
        }
        cnt += take;
      }
      if (lane == 0) {
        meta[0] = cur;
        meta[1] = cnt;
      }
    }
    __syncthreads();
    const int rg_rows = meta[1];
    if (rg_rows == 0) break;
    const bool active = rg * 8 < rg_rows;

    auto stage = [&](int ch, int st) {
      const int j0 = ch * kStChunk;
      const int wc = min(kStChunk, W - j0);
      float* ad = as + st * RB * kStStride;
      float* bd = bs + st * kStTileV * kStStride;
      if (vec4) {
        for (int i = tid; i < (RB + kStTileV) * (kStChunk / 4); i += NT) {
          const int rr = i / (kStChunk / 4), jc = i % (kStChunk / 4);
          const int bytes = max(0, min(16, (wc - 4 * jc) * 4));
          if (rr < RB) {
            const bool ok = rr < rg_rows;
            async_copy::copy16(
                ad + rr * kStStride + 4 * jc,
                a + (size_t)(ok ? rows[rr] : 0) * W + j0 + 4 * jc,
                ok ? bytes : 0);
          } else {
            const int v = v0 + rr - RB;
            async_copy::copy16(
                bd + (rr - RB) * kStStride + 4 * jc,
                b + (size_t)(v < V ? v : 0) * W + j0 + 4 * jc,
                v < V ? bytes : 0);
          }
        }
      } else {
        for (int i = tid; i < (RB + kStTileV) * kStChunk; i += NT) {
          const int rr = i / kStChunk, j = i % kStChunk;
          const bool in_w = j < wc;
          if (rr < RB) {
            const bool ok = rr < rg_rows && in_w;
            async_copy::copy4(
                ad + rr * kStStride + j,
                a + (size_t)(ok ? rows[rr] : 0) * W + (ok ? j0 + j : 0),
                ok ? 4 : 0);
          } else {
            const int v = v0 + rr - RB;
            const bool ok = v < V && in_w;
            async_copy::copy4(bd + (rr - RB) * kStStride + j,
                              b + (size_t)(ok ? v : 0) * W + (ok ? j0 + j : 0),
                              ok ? 4 : 0);
          }
        }
      }
    };

    float acc[8][8], b2[8], a2 = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) b2[c] = 0.f;

    stage(0, 0);
    async_copy::commit();
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (ch + 1 < n_chunks) stage(ch + 1, (ch + 1) & 1);
      async_copy::commit();
      async_copy::wait<1>();
      __syncthreads();
      const float4* a4 = reinterpret_cast<const float4*>(
          as + (ch & 1) * RB * kStStride);
      const float4* b4 = reinterpret_cast<const float4*>(
          bs + (ch & 1) * kStTileV * kStStride);
      const int nj4 = (min(kStChunk, W - ch * kStChunk) + 3) / 4;
      if (tid < RB && tid < rg_rows) {
        for (int j = 0; j < nj4; ++j) {
          const float4 x = a4[tid * S4 + j];
          a2 = fmaf(x.x, x.x, a2);
          a2 = fmaf(x.y, x.y, a2);
          a2 = fmaf(x.z, x.z, a2);
          a2 = fmaf(x.w, x.w, a2);
        }
      }
      if (active) {
        for (int j = 0; j < nj4; ++j) {
          float4 bv[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            bv[c] = b4[(vg + 16 * c) * S4 + j];
            b2[c] = fmaf(bv[c].x, bv[c].x, b2[c]);
            b2[c] = fmaf(bv[c].y, bv[c].y, b2[c]);
            b2[c] = fmaf(bv[c].z, bv[c].z, b2[c]);
            b2[c] = fmaf(bv[c].w, bv[c].w, b2[c]);
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 av = a4[(rg * 8 + r) * S4 + j];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              acc[r][c] = fmaf(av.x, bv[c].x, acc[r][c]);
              acc[r][c] = fmaf(av.y, bv[c].y, acc[r][c]);
              acc[r][c] = fmaf(av.z, bv[c].z, acc[r][c]);
              acc[r][c] = fmaf(av.w, bv[c].w, acc[r][c]);
            }
          }
        }
      }
      __syncthreads();          // the stage is consumed before it refills
    }
    if (tid < RB) a2s[tid] = a2;
    __syncthreads();

    // each query's min over its rows in this thread, then across threads
    if (active) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int qc = -1;
        float best = INFINITY;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int k = rg * 8 + r;
          if (k < rg_rows) {
            const float d2 = a2s[k] + b2[c] - 2.f * acc[r][c];
            const float d = sqrtf(fmaxf(d2, 0.f)) + 0.f;   // no -0
            if (qids[k] != qc) {
              if (qc >= 0)
                atomicMin(red + qc * kStTileV + vg + 16 * c,
                          __float_as_uint(best));
              qc = qids[k];
              best = d;
            } else {
              best = fminf(best, d);
            }
          }
        }
        if (qc >= 0)
          atomicMin(red + qc * kStTileV + vg + 16 * c, __float_as_uint(best));
      }
    }
    if (rg_rows < RB) break;    // no row is left after a short group
  }
  __syncthreads();
  for (int i = tid; i < Q * kStTileV; i += NT) {
    const int q = i / kStTileV, v = i % kStTileV;
    if (v0 + v < V) out[(size_t)q * V + v0 + v] = __uint_as_float(red[i]);
  }
}

// a (Q, B, W), mask (Q, B), b (V, W), out (Q, V); the kernel's
// arguments for one launch over every query of the call or of a slice.
struct Args {
  const float* a;
  const float* mask;
  const float* b;
  float* out;
  int Q, B, W, V;
};

template <int RB>
cudaError_t launch_stacked(const Args& x, cudaStream_t stream) {
  auto kernel = rwmd_min_cdist_stacked_kernel<RB>;
  const size_t smem = stacked_smem_bytes<RB>(x.Q);
  // the largest size, once per device
  const cudaError_t err =
      device_attr::allow_smem(kernel, stacked_smem_bytes<RB>(kStMaxQ));
  if (err != cudaSuccess) return err;
  const int vec4 = x.W % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(x.a) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(x.b) % 16 == 0;
  kernel<<<(x.V + kStTileV - 1) / kStTileV, 2 * RB, smem, stream>>>(
      x.a, x.mask, x.b, x.out, x.Q, x.B, x.W, x.V, vec4);
  return cudaGetLastError();
}

}  // namespace

// K2: a (Q, B, W), mask (Q, B), b (V, W), out (Q, V); all fp32,
// contiguous, on the device, B >= 1. The stacked-query kernel runs one
// launch per kStMaxQ queries (the shared min array's room), each writing
// its own rows of out, for any number of support rows. Returns the
// cudaError_t of the first launch that failed, else 0.
extern "C" int rwmd_min_cdist_launch(const float* a, const float* mask,
                                     const float* b, float* out, int Q,
                                     int B, int W, int V, void* stream) {
  if (Q == 0 || V == 0) return 0;
  if (B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int q0 = 0; q0 < Q; q0 += kStMaxQ) {
    const Args x{a + (size_t)q0 * B * W, mask + (size_t)q0 * B, b,
                 out + (size_t)q0 * V, Q - q0 < kStMaxQ ? Q - q0 : kStMaxQ,
                 B, W, V};
    const cudaError_t err = (long long)x.Q * B <= 64
                                ? launch_stacked<64>(x, s)
                                : launch_stacked<128>(x, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// K2s: a (Q, B, W), mask (Q, B), b (Vb, W), vocab_ids (Vc,) int64, out
// (Q, Vc); fp32, contiguous, on the device, B >= 1, Q <= 65535. One
// launch at any B, Vc and W. Returns the cudaError_t of the launch.
extern "C" int rwmd_min_cdist_subset_launch(const float* a,
                                            const float* mask,
                                            const float* b,
                                            const long long* vocab_ids,
                                            float* out, int Q, int B, int W,
                                            int Vb, int Vc, void* stream) {
  if (Q == 0 || Vc == 0) return 0;
  if (B < 1 || Q > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      device_attr::allow_smem(rwmd_min_cdist_subset_kernel, kSubSmem);
  if (err != cudaSuccess) return (int)err;
  const int vec4 = W % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(b) % 16 == 0;
  const dim3 grid((Vc + kSubCols - 1) / kSubCols, Q);
  rwmd_min_cdist_subset_kernel<<<grid, 32 * kSubWarps, kSubSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      a, mask, b, vocab_ids, out, B, W, Vb, Vc, vec4);
  return (int)cudaGetLastError();
}
