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
// leaves the SM. One block per tile of 128 vocabulary rows and 64 queries
// serves every live row of those queries, so b is read once per 64
// queries (one launch at any Q) and masked rows are never computed;
// cp.async stages the next 32 coordinates during the FFMAs
// (rwmd_min_cdist_stacked_kernel's comment below). At the main path's
// chunk on an H100 at 700 W it took 0.24 ms where the per-query design it
// replaced took 0.56 (PERF.md). The ragged V edge is masked and w is not
// padded.
//
// K2s, the same function over a candidate subset of the vocabulary.
// Replaces: src/repro/kernels/rwmd.py, rwmd_min_cdist_subset, reached from
// repro.core.prune.CascadePruner._rwmd_prep (the IVF cascade's RWMD stage)
// through repro.kernels.ops.rwmd_min_cdist(..., vocab_ids=...).
//
//   minM[q, c] = min over live k of ||a[q, k] - b[vocab_ids[c]]||, (Q, Vc).
//
// The Pallas version lets XLA gather b[vocab_ids] into a new (Vc, w) array
// before the launch. Here the gather is in the load: a block reads its ids
// once and copies those rows of b, so the (Vc, w) copy is never written.
// Two kinds of call meet it, and one design does not serve both:
//
// - Wide candidate vocabularies, from a cascade that keeps most of the
//   corpus: the paper corpus's 10-query stage (Q = 16 padded queries, six
//   of them filler, 182 live rows, Vc = 53 862 distinct words) and a
//   served one-query stage (21 live rows, Vc = 54 381). What bounds them:
//   first reading the gathered rows (65 MB, 19 us at 3.35 TB/s), then the
//   FFMAs (2 * 182 * 300 * 53 862 = 5.9 GFLOP, 88 us at 67 TFLOP/s). The
//   stacked kernel takes them, its b stage copying row ids[c] in place of
//   row c: each gathered row is read once per group of live rows of all
//   the queries, not once per query; filler queries stage no row; an 8 x 8
//   register tile per thread takes 16 shared loads for 256 FFMAs. On an
//   H100 at 700 W (tools/time_kernel_variants.py k2s) the 10-query stage
//   went from 2.11 ms (PR 17's kernel below) to 0.313, the served one from
//   0.168 to 0.065; the FFMAs alone take 0.292 and 0.050 there, the ring
//   alone 0.107 and 0.043, so the product's issue rate (~30% of the FFMA
//   peak) bounds them now, not the bytes.
// - Narrow ones: the dedup cascade (Q = 4, B = 24, Vc = 81) and 2 queries
//   of 200 rows against 2048 words. The product is microseconds at either
//   peak, and the time is the latency of a block's walk over w; the
//   stacked layout gives one block per 128 columns, too few to hide it
//   (0.046 and 0.125 ms against 0.014 and 0.044). PR 17's kernel, a block
//   per (query, 32 columns), spreads the walk over many blocks.
//
// subset_stacked() routes each call by its queries, support rows and
// 128-column tiles; the timings that set the switch stand beside it.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
#include "cdist_ring.cuh"
#include "device_attr.cuh"

namespace {

// K2s at narrow candidate vocabularies: one block per (query, 32 output
// columns), a lane per column and a warp per 8 support rows, 16 warps.
// The block streams w through a 2-stage cp.async ring (cdist_ring.cuh):
// its rows of a and its 32 gathered rows of b, 16-byte copies of whole
// rows when w % 4 == 0 and the bases are aligned, 4-byte ones otherwise,
// so no thread waits on a load of its own and the next chunk is in flight
// during the FFMAs of the current one. A query wider than 128 support rows
// runs its rows in passes of 128 inside the block, each folding into the
// lanes' running min (min is exact in any order), so any B runs in one
// launch. On an H100 16 warps beat 8 at 200 rows (two passes instead of
// four) and cost about a microsecond at the cascade's 24, and a deeper
// ring gained nothing (PERF.md). Warps whose rows are all masked (the
// cascade's filler queries) skip the FFMAs. An id outside [0, Vb) loads
// as a zero row: a wrong column, never an out-of-bounds read.
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

// The stacked-query kernel: K2, and K2s at wide candidate vocabularies.
// One block per (tile of kStTileV output columns, block of kStMaxQ
// queries) serves every live row of its queries: it stacks their live
// support rows (mask > 0, in order, each with its query id; compacted on
// the device from mask by the block itself) in groups of RB, reads its b
// tile once per group through a two-stage cp.async ring, computes the
// group's a.b^T in registers (each of 2 * RB threads owns 8 rows x 8
// columns, full fp32 FFMA), and folds each query's min over its own rows
// into a (queries, kStTileV) shared array with atomicMin on the bits of
// the non-negative distances (min is exact in any order). A group after
// the first re-reads the tile (from L2) and folds into the same array;
// rows of no query stay out, so a query without a live row comes out +inf.
// Nothing a block does not need is staged: masked rows are neither copied
// nor computed (a block whose queries are all filler copies no b row at
// all), and the a stage stops at the group's live rows rounded up to the
// 8 of a thread's tile.
//
// Column c of the output is row c of b, or with `ids` row ids[c]: the tile
// reads its kStTileV row numbers once, and the b stage copies those rows.
// An id outside [0, Vb), like a column past N, loads as a zero row: a
// wrong column, never an out-of-bounds read.
//
// Shared layout: a and b chunks row-major, kStChunk coordinates per row at
// a stride of kStChunk + 4 floats (16-byte rows: 16-byte cp.async copies,
// and float4 reads along the coordinates, which a thread's 8 columns
// vg + 16 c keep free of bank conflicts).
constexpr int kStTileV = 128;
constexpr int kStChunk = 32;
constexpr int kStStride = kStChunk + 4;
constexpr int kStMaxQ = 64;  // queries a block serves (its min array's room)

template <int RB>
constexpr size_t stacked_smem_bytes(int Q) {
  return sizeof(float) * (2 * (RB + kStTileV) * kStStride + RB) +
         sizeof(int) * (2 * RB + kStTileV + 4) +
         sizeof(unsigned) * Q * kStTileV;
}

template <int RB>
__global__ void __launch_bounds__(2 * RB, 2)
rwmd_min_cdist_stacked_kernel(const float* __restrict__ a,
                              const float* __restrict__ mask,
                              const float* __restrict__ b,
                              const long long* __restrict__ ids,
                              float* __restrict__ out, int Q, int B, int W,
                              int Vb, int N, int vec4) {
  constexpr int NT = 2 * RB;
  constexpr int S4 = kStStride / 4;     // float4 per staged row
  constexpr int C4 = kStChunk / 4;      // 16-byte copies per staged row
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                                  // (2, RB, stride)
  float* bs = as + 2 * RB * kStStride;               // (2, TV, stride)
  float* a2s = bs + 2 * kStTileV * kStStride;        // (RB,)
  int* rows = reinterpret_cast<int*>(a2s + RB);      // (RB,) row of a
  int* qids = rows + RB;                             // (RB,) its query
  int* brow = qids + RB;                             // (TV,) row of b or -1
  int* meta = brow + kStTileV;                       // cursor, rows
  unsigned* red = reinterpret_cast<unsigned*>(meta + 4);   // (nq, TV)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = tid / 16, vg = tid % 16;
  const int v0 = blockIdx.x * kStTileV;
  const int q0 = blockIdx.y * kStMaxQ;
  const int nq = min(kStMaxQ, Q - q0);
  const int QB = nq * B;
  const float* aq = a + (size_t)q0 * B * W;
  const float* mq = mask + (size_t)q0 * B;
  const int n_chunks = (W + kStChunk - 1) / kStChunk;
  for (int i = tid; i < nq * kStTileV; i += NT) red[i] = 0x7f800000u;  // +inf
  for (int i = tid; i < kStTileV; i += NT) {
    const int c = v0 + i;
    const long long id = c < N ? (ids != nullptr ? ids[c] : c) : -1;
    brow[i] = id >= 0 && id < Vb ? (int)id : -1;
  }
  if (tid == 0) meta[0] = 0;

  for (;;) {
    __syncthreads();            // meta set; the last group's reads done
    if (tid < 32) {             // the next group: up to RB live rows
      int cur = meta[0], cnt = 0;
      while (cnt < RB && cur < QB) {
        const int i = cur + lane;
        const bool live = i < QB && mq[i] > 0.f;
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
    const int ra = (rg_rows + 7) & ~7;  // a rows the active threads read

    auto stage = [&](int ch, int st) {
      const int j0 = ch * kStChunk;
      const int wc = min(kStChunk, W - j0);
      float* ad = as + st * RB * kStStride;
      float* bd = bs + st * kStTileV * kStStride;
      if (vec4) {
        for (int i = tid; i < (ra + kStTileV) * C4; i += NT) {
          const int rr = i / C4, jc = i % C4;
          const int bytes = max(0, min(16, (wc - 4 * jc) * 4));
          if (rr < ra) {
            const bool ok = rr < rg_rows;
            async_copy::copy16(
                ad + rr * kStStride + 4 * jc,
                aq + (size_t)(ok ? rows[rr] : 0) * W + j0 + 4 * jc,
                ok ? bytes : 0);
          } else {
            const int v = brow[rr - ra];
            async_copy::copy16(
                bd + (rr - ra) * kStStride + 4 * jc,
                b + (size_t)(v >= 0 ? v : 0) * W + j0 + 4 * jc,
                v >= 0 ? bytes : 0);
          }
        }
      } else {
        for (int i = tid; i < (ra + kStTileV) * kStChunk; i += NT) {
          const int rr = i / kStChunk, j = i % kStChunk;
          const bool in_w = j < wc;
          if (rr < ra) {
            const bool ok = rr < rg_rows && in_w;
            async_copy::copy4(
                ad + rr * kStStride + j,
                aq + (size_t)(ok ? rows[rr] : 0) * W + (ok ? j0 + j : 0),
                ok ? 4 : 0);
          } else {
            const int v = brow[rr - ra];
            const bool ok = v >= 0 && in_w;
            async_copy::copy4(bd + (rr - ra) * kStStride + j,
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
  for (int i = tid; i < nq * kStTileV; i += NT) {
    const int q = i / kStTileV, v = i % kStTileV;
    if (v0 + v < N) out[(size_t)(q0 + q) * N + v0 + v] = __uint_as_float(red[i]);
  }
}

// a (Q, B, W), mask (Q, B), b (Vb, W), ids (N,) or null, out (Q, N): one
// stacked launch's arguments.
struct Args {
  const float* a;
  const float* mask;
  const float* b;
  const long long* ids;
  float* out;
  int Q, B, W, Vb, N;
};

template <int RB>
cudaError_t launch_stacked_rb(const Args& x, cudaStream_t stream) {
  auto kernel = rwmd_min_cdist_stacked_kernel<RB>;
  const int qb = x.Q < kStMaxQ ? x.Q : kStMaxQ;
  // the largest size, once per device
  const cudaError_t err =
      device_attr::allow_smem(kernel, stacked_smem_bytes<RB>(kStMaxQ));
  if (err != cudaSuccess) return err;
  const int vec4 = x.W % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(x.a) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(x.b) % 16 == 0;
  const dim3 grid((x.N + kStTileV - 1) / kStTileV,
                  (x.Q + kStMaxQ - 1) / kStMaxQ);
  kernel<<<grid, 2 * RB, stacked_smem_bytes<RB>(qb), stream>>>(
      x.a, x.mask, x.b, x.ids, x.out, x.Q, x.B, x.W, x.Vb, x.N, vec4);
  return cudaGetLastError();
}

// The group size: the least of 32, 64 and 128 live rows that holds a
// block's support rows, else 128. A smaller group is a smaller block, so
// more of them share an SM.
cudaError_t launch_stacked(const Args& x, cudaStream_t stream) {
  const long long rows = (long long)(x.Q < kStMaxQ ? x.Q : kStMaxQ) * x.B;
  if (rows <= 32) return launch_stacked_rb<32>(x, stream);
  if (rows <= 64) return launch_stacked_rb<64>(x, stream);
  return launch_stacked_rb<128>(x, stream);
}

// K2s's route, set from timings on an H100 80GB HBM3 at 700 W
// (tools/time_kernel_variants.py k2s, its sweep of Vc at 1 to 16 queries
// of 24 support rows). PR 17's kernel costs ~0.39 us per (query, 128
// columns) once a call has more than ~64 of them (16 queries x 8 tiles:
// 0.045 ms, x 24: 0.119, x 32: 0.162); the stacked kernel ~40 us per
// group of 128 support rows while its blocks fit one wave (1 query:
// 0.045 ms at 8 to 128 tiles; 16 queries, two groups: 0.108). So the
// stacked kernel takes a call where Q * tiles >= 112 per group, the groups
// counted from Q * B (the live rows are on the device). The measured
// crossovers at 1, 2, 4, 8 and 16 queries: ~110, ~48, ~27, ~33 and ~22
// tiles; the rule's: 112, 56, 28, 28 and 21.
constexpr long long kStRouteTiles = 112;

bool subset_stacked(int tiles, int Q, int B) {
  const long long groups = ((long long)Q * B + 127) / 128;
  return (long long)Q * tiles >= kStRouteTiles * groups;
}

constexpr long long kMaxGridY = 65535;

}  // namespace

// K2: a (Q, B, W), mask (Q, B), b (V, W), out (Q, V); all fp32,
// contiguous, on the device, B >= 1. One launch of the stacked kernel at
// any Q (up to 64 * 65535), B and W. Returns the cudaError_t of the
// launch, else 0.
extern "C" int rwmd_min_cdist_launch(const float* a, const float* mask,
                                     const float* b, float* out, int Q,
                                     int B, int W, int V, void* stream) {
  if (Q == 0 || V == 0) return 0;
  if (B < 1 || (Q + kStMaxQ - 1) / kStMaxQ > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  return (int)launch_stacked(Args{a, mask, b, nullptr, out, Q, B, W, V, V},
                             static_cast<cudaStream_t>(stream));
}

// K2s: a (Q, B, W), mask (Q, B), b (Vb, W), vocab_ids (Vc,) int64, out
// (Q, Vc); fp32, contiguous, on the device, B >= 1, Q <= 65535. One
// launch at any B, Vc and W, of the kernel subset_stacked() picks.
// Returns the cudaError_t of the launch.
extern "C" int rwmd_min_cdist_subset_launch(const float* a,
                                            const float* mask,
                                            const float* b,
                                            const long long* vocab_ids,
                                            float* out, int Q, int B, int W,
                                            int Vb, int Vc, void* stream) {
  if (Q == 0 || Vc == 0) return 0;
  if (B < 1 || Q > kMaxGridY) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (subset_stacked((Vc + kStTileV - 1) / kStTileV, Q, B))
    return (int)launch_stacked(Args{a, mask, b, vocab_ids, out, Q, B, W, Vb,
                                    Vc}, s);
  cudaError_t err =
      device_attr::allow_smem(rwmd_min_cdist_subset_kernel, kSubSmem);
  if (err != cudaSuccess) return (int)err;
  const int vec4 = W % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(b) % 16 == 0;
  const dim3 grid((Vc + kSubCols - 1) / kSubCols, Q);
  rwmd_min_cdist_subset_kernel<<<grid, 32 * kSubWarps, kSubSmem, s>>>(
      a, mask, b, vocab_ids, out, B, W, Vb, Vc, vec4);
  return (int)cudaGetLastError();
}

// 1 where rwmd_min_cdist_subset_launch takes the stacked kernel for these
// sizes, 0 where it takes the per-(query, 32 columns) one.
extern "C" int rwmd_min_cdist_subset_stacked(int Q, int B, int Vc) {
  return subset_stacked((Vc + kStTileV - 1) / kStTileV, Q, B) ? 1 : 0;
}
