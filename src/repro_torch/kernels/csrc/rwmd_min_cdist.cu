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
// leaves the SM. Two designs compute it:
// - stacked (rwmd_min_cdist_stacked_kernel, what the wrapper runs by
//   default): one block per tile of 128 vocabulary rows serves
//   every query's live rows, so b is read once per 64 queries (a launch
//   each) and masked rows are never computed; cp.async stages the next 32
//   coordinates during the FFMAs (its comment below). At the main path's
//   chunk on an H100 at 700 W it takes 0.24 ms where the per-query design
//   takes 0.56 (PERF.md).
// - per query (rwmd_min_cdist_kernel, the earlier design): one block per
//   (query, tile of 128 vocabulary rows), with 2*BMAX threads, each owning
//   an 8 (support rows) x 8 (vocabulary rows) tile of partial dot products
//   in registers (the product is cdist_tile.cuh's, shared with K3); masked
//   rows are computed and dropped. Each block reads the whole of b's tile
//   for its query, so b is read Q times in all. A query wider than 128
//   support rows runs as one launch per 128-row chunk on the same stream;
//   every chunk after the first folds its min into the output already
//   written (min is exact in any order).
// Both mask the ragged V edge and do not pad w.
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
// (norms, clamp, sqrt, mask, min epilogue, 128-row chunks) is the
// per-query K2's code.
// vocab_ids are int64 (the wrapper checks); Vc needs no padding, the
// ragged edge is masked. At the cascade's shape (Q = 16 padded queries,
// B <= 48, w = 300, Vc of a few hundred to a few thousand) the product is
// ~0.3 GFLOP at Vc = 1024, ~5 us at 67 TFLOP/s: bound by operations, and
// small enough that the launch and the host staging around it may cost
// more than the kernel.

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"
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

// K2's stacked-query kernel (the redesign; K2s keeps the kernel above).
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

template <int RB>
cudaError_t launch_stacked(const Args& x, cudaStream_t stream) {
  auto kernel = rwmd_min_cdist_stacked_kernel<RB>;
  const size_t smem = stacked_smem_bytes<RB>(x.Q);
  static bool attr = false;     // the largest size, set once
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)stacked_smem_bytes<RB>(kStMaxQ));
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const int vec4 = x.W % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(x.a) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(x.b) % 16 == 0;
  kernel<<<(x.V + kStTileV - 1) / kStTileV, 2 * RB, smem, stream>>>(
      x.a, x.mask, x.b, x.out, x.Q, x.B, x.W, x.V, vec4);
  return cudaGetLastError();
}

// The stacked-query kernel: one launch per kStMaxQ queries (the shared
// min array's room), each writing its own rows of out, for any number of
// support rows.
int launch_stacked_all(Args x, cudaStream_t s) {
  if (x.Q == 0 || x.V == 0) return 0;
  if (x.B < 1) return (int)cudaErrorInvalidValue;
  const int Q = x.Q;
  const float* a = x.a;
  const float* mask = x.mask;
  float* out = x.out;
  for (int q0 = 0; q0 < Q; q0 += kStMaxQ) {
    x.a = a + (size_t)q0 * x.B * x.W;
    x.mask = mask + (size_t)q0 * x.B;
    x.out = out + (size_t)q0 * x.V;
    x.Q = Q - q0 < kStMaxQ ? Q - q0 : kStMaxQ;
    const cudaError_t err = (long long)x.Q * x.B <= 64
                                ? launch_stacked<64>(x, s)
                                : launch_stacked<128>(x, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
// on the device, B >= 1. stacked != 0 runs the stacked-query kernel (a
// launch per 64 queries), else the per-query one (a launch per 128
// support rows). Returns the cudaError_t of the first launch that failed,
// else 0.
extern "C" int rwmd_min_cdist_launch(const float* a, const float* mask,
                                     const float* b, float* out, int Q,
                                     int B, int W, int V, int stacked,
                                     void* stream) {
  const Args x{a, mask, b, nullptr, out, Q, B, B, W, V, V, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stacked ? launch_stacked_all(x, s) : launch_all(x, s);
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
